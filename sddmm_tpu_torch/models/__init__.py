"""Model families on the port's kernels: the serving path of the two
attention models.  ``SparseFactorizationModel`` waits for the training
slice (ROADMAP Queue 1: 'Autograd for the hybrid op')."""

from sddmm_tpu_torch.models.block_sparse_attention import (
    BlockSparseAttention, BlockSparseAttentionParams,
    dense_reference_attention, make_attention_mask)
from sddmm_tpu_torch.models.graph_attention import (GraphAttentionLayer,
                                                    GraphAttentionParams,
                                                    segment_softmax)

__all__ = ["GraphAttentionLayer", "GraphAttentionParams", "segment_softmax",
           "BlockSparseAttention", "BlockSparseAttentionParams",
           "dense_reference_attention", "make_attention_mask"]

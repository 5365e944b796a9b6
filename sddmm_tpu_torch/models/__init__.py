"""Model families on the port's kernels: the two attention models (serving
and training), the hybrid sliding-window and full attention stack with
grouped-query heads (MiMo-V2-Flash's), all three on one attention core
(``hybrid_attention.AttentionCore``), and the factorization trainer."""

from sddmm_tpu_torch.models.block_sparse_attention import (
    BlockSparseAttention, BlockSparseAttentionParams,
    dense_reference_attention, make_attention_mask)
from sddmm_tpu_torch.models.factorization import (
    DistributedSparseFactorizationModel, FactorizationParams,
    SparseFactorizationModel)
from sddmm_tpu_torch.models.graph_attention import (GraphAttentionLayer,
                                                    GraphAttentionParams,
                                                    segment_softmax)
from sddmm_tpu_torch.models.hybrid_attention import (AttentionKind,
                                                     HybridAttentionLayer,
                                                     HybridAttentionStack,
                                                     causal_mask)

__all__ = ["GraphAttentionLayer", "GraphAttentionParams", "segment_softmax",
           "BlockSparseAttention", "BlockSparseAttentionParams",
           "dense_reference_attention", "make_attention_mask",
           "FactorizationParams", "SparseFactorizationModel",
           "DistributedSparseFactorizationModel", "AttentionKind",
           "HybridAttentionLayer", "HybridAttentionStack", "causal_mask"]

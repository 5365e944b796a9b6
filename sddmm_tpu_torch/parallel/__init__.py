"""The multi-device path over ``torch.distributed``: the mesh
(``make_mesh``), the ranks' launcher (``launch.spawn``), the sharded
hybrid SDDMM and dense class (``DistributedHybridSDDMM``,
``DistributedDenseSDDMM``) and the multi-device dry run
(``dryrun.dryrun_multichip``)."""

from sddmm_tpu_torch.parallel.dist import (DistributedDenseSDDMM,
                                           DistributedHybridSDDMM)
from sddmm_tpu_torch.parallel.launch import spawn
from sddmm_tpu_torch.parallel.mesh import Mesh, make_mesh

__all__ = ["make_mesh", "Mesh", "spawn", "DistributedHybridSDDMM",
           "DistributedDenseSDDMM"]

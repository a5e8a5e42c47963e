"""Multi-device distribution: meshes and modular collectives.

Port of the reference package's ``parallel/``. The protocol's parallelism
axes map onto the axes of a torch ``DeviceMesh``, one process per device:

- participants      -> data axis ``"p"`` (rows of the participation matrix)
- clerks / shares   -> share axis ``"c"`` (per-clerk combine)
- packed batches    -> dimension axis ``"d"`` (independent batches, lanes)
- transposition     -> an all-to-all over ``"c"``
- communication     -> ``torch.distributed`` collectives (NCCL on the card,
  gloo on the CPU) with limb-level modular adds
"""

from sda_tpu_torch.parallel.collectives import psum_mod, reduce_scatter_mod
from sda_tpu_torch.parallel.mesh import ShardedAggregationPipeline, make_mesh

__all__ = ["psum_mod", "reduce_scatter_mod", "make_mesh", "ShardedAggregationPipeline"]

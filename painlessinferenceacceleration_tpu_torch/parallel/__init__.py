"""Parallelism over ``torch.distributed``: rank grids, each rank's shard of
the parameters and of the KV arena, and the rank-ordered collectives of
the parallel forward.

Port of ``painlessinferenceacceleration_tpu/parallel/``. JAX places global
arrays over a device mesh and GSPMD inserts the collectives; here each
process is one rank, computes on its own shard and meets the others in the
collectives of ``parallel/comm.py``, whose sums run in rank order.
"""

from painlessinferenceacceleration_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    kv_shardings,
    make_mesh,
    param_shardings,
    shard_kv,
    shard_params,
)

"""Multi-chip / multi-host scaling: device meshes, sharded scans, collective merges.

The reference's only parallelism is OpenMP threads over database points
(SURVEY.md section 2.5). Here that axis becomes a first-class ``jax.sharding.Mesh``
("data" = database shard): each chip ADC-scans its code shard, computes a local
top-k, and the shards are merged with an all-gather + final top-k — collectives
ride the device interconnect, overlapping with the next block's scan under
XLA's scheduler.
"""

from rii_tpu.parallel.mesh import (make_mesh, make_mesh_hc, put_sharded,
                                   shard_database)
from rii_tpu.parallel.sharded import (
    make_sharded_linear_scan,
    make_sharded_pqkmeans_step,
)
from rii_tpu.parallel.build import (
    fit_on_mesh,
    predict_on_mesh,
    reconfigure_on_mesh,
)
from rii_tpu.parallel.distributed import ShardedRii, init_distributed

__all__ = [
    "make_mesh",
    "make_mesh_hc",
    "put_sharded",
    "shard_database",
    "make_sharded_linear_scan",
    "make_sharded_pqkmeans_step",
    "fit_on_mesh",
    "predict_on_mesh",
    "reconfigure_on_mesh",
    "ShardedRii",
    "init_distributed",
]

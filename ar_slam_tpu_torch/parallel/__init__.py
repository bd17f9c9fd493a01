"""Distributed bundle adjustment and data-parallel detection: mesh
helpers, the tag-sharded LM, multi-process support (port of
ar_slam_tpu/parallel)."""

from ar_slam_tpu_torch.parallel import multihost  # noqa: F401
from ar_slam_tpu_torch.parallel.dist_lm import (  # noqa: F401
    TagShardedProblem,
    lm_solve_dist,
    make_dist_wave_solver,
    make_tag_sharded_hooks,
)
from ar_slam_tpu_torch.parallel.mesh import (  # noqa: F401
    BLOCK_AXIS,
    block_mesh,
    shard_blocks,
)
from ar_slam_tpu_torch.parallel.partition import (  # noqa: F401
    partition_blocks,
    prepare_tag_shards,
)

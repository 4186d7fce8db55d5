"""Multi-device execution: meshes, sharded compute paths and the
data-parallel training step (the port of the JAX package's parallel/)."""

from deep_cartograph_torch.parallel.mesh import (
    Mesh,
    get_mesh,
    init_distributed,
    local_shard,
    mesh_for,
    use_mesh,
)
from deep_cartograph_torch.parallel.sharding import (
    lag_pairs_with_halo,
    sharded_covariances,
    sharded_feature_matrix_stats,
)

from pysteps_tpu_torch.parallel.mesh import (  # noqa: F401
    ens_sharding,
    make_mesh,
    make_mesh_multihost,
    replicated,
    shard_ensemble,
)

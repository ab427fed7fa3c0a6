from awesome_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    fit_priors_sharded,
    fit_spatiotemporal_sharded,
    make_mesh,
    maybe_shard,
    mesh_from_config,
    replicate,
    shard_batched,
    shard_leading_stacked,
)

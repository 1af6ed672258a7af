from .mesh import grid_sharding, make_grid_mesh, place

__all__ = ["make_grid_mesh", "grid_sharding", "place"]

# Heavier distributed drivers live in submodules (imported lazily by users):
#   dist.shard_cycle.sharded_solve        — jnp local ops, 1 halo ring/sweep

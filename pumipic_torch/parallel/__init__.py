# ``group`` stands for the JAX package's ``mesh_axis``: the rank group and
# its collectives in place of a jax.sharding mesh
from pumipic_torch.parallel import group  # noqa: F401

from pumipic_torch.ops import geometry, interpolate, push, scatter, search  # noqa: F401

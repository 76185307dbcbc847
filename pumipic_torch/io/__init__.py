from pumipic_torch.io import checkpoint  # noqa: F401

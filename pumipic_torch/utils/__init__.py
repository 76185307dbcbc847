from pumipic_torch.utils import plog, timing, types  # noqa: F401
from pumipic_torch.utils.types import LID_DTYPE, GID_DTYPE, REAL_DTYPE  # noqa: F401

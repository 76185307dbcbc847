"""pumipic_torch — the PyTorch/CUDA port of ``pumipic_tpu``.

Module names mirror the JAX package:

- ``mesh``      host-built triangle meshes frozen into tensors, the gmsh
                reader, generators and the cartesian locator grid.
- ``ops``       the pushes, the 2D and 3D adjacency walks with their
                boundary handlers, exit records and recovery, the gyro
                scatter and the charge deposit, each a wrapper over a
                hand-written CUDA kernel with its plain PyTorch version
                beside it.
- ``particles`` the four particle structures (Sell-C-σ, CSR, CabM, DPS)
                with rebuild, reshuffle and overflow handling.
- ``parallel``  the distributed runtime over a ``torch.distributed`` group
                (``group``, the JAX package's ``mesh_axis``): picparts,
                migration, owner reductions, the load balancer and the
                FULL-mode field sum over ranks.
- ``models``    the pseudoXGCm FULL-mode step and single-device app, and
                the search2d driver.
- ``io``        the VTK writer, particle and structure checkpoints (the
                JAX package's files) and ``.osh`` mesh files.
- ``utils``     device resolution, timing, memory, the live-tensor audit,
                logging, types.
- ``kernels``   the CUDA sources and their build (nvcc + ctypes).
- ``interop``   carries the JAX reference's arrays (as numpy) across.

The package imports torch and numpy, never JAX.  A wrapper runs its plain
PyTorch version for CPU tensors and launches its kernel for CUDA tensors.
Entry points run on the CUDA card unless ``device="cpu"`` is passed.
"""

__version__ = "0.1.0"

from pumipic_torch.utils import timing, plog  # noqa: F401

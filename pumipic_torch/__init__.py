"""pumipic_torch — the PyTorch/CUDA port of ``pumipic_tpu``.

Module names mirror the JAX package:

- ``mesh``      host-built triangle meshes frozen into tensors, the gmsh
                reader, generators and the cartesian locator grid.
- ``ops``       the elliptical push, the BCC adjacency walk and the gyro
                scatter, each a wrapper over a hand-written CUDA kernel with
                its plain PyTorch version beside it.
- ``parallel``  the FULL-mode field sum over ranks.
- ``models``    the pseudoXGCm FULL-mode particle-parallel step.
- ``kernels``   the CUDA sources and their build (nvcc + ctypes).
- ``interop``   carries the JAX reference's arrays (as numpy) across.

The package imports torch and numpy, never JAX.  A wrapper runs its plain
PyTorch version for CPU tensors and launches its kernel for CUDA tensors.
"""

__version__ = "0.1.0"

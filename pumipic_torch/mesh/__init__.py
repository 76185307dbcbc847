from pumipic_torch.mesh.core import Mesh2D, Mesh3D  # noqa: F401
from pumipic_torch.mesh.generate import (  # noqa: F401
    annulus_mesh,
    disk_mesh,
    rectangle_mesh,
    box_tet_mesh,
)

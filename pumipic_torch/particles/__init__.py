from pumipic_torch.particles.structure import (  # noqa: F401
    ParticleStructure,
    CSR,
    DPS,
    CabM,
    SellCSigma,
    SCSInput,
    create_member_fields,
)
from pumipic_torch.particles import distribute, pfile  # noqa: F401

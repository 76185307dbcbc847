"""The JAX package's picparts arms on the structured annulus, on 4 virtual
CPU devices (the reference for scripts/annulus_arms_cpu.py):

    JAX_PLATFORMS=cpu python3 scripts/annulus_arms_jax.py [N]

The analytic locate and the walk (``analytic_locate="off"``), the
balancer, cap factor 1.5, N particles (default 1M); prints (alive, sent)
after each of 4 steps."""
import dataclasses
import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
import numpy as np  # noqa: E402

from pumipic_tpu.mesh import generate as gen  # noqa: E402
from pumipic_tpu.models import pseudo_xgcm as px  # noqa: E402
from pumipic_tpu.parallel.mesh_axis import make_device_mesh  # noqa: E402

N = int(sys.argv[1]) if len(sys.argv) > 1 else 1_000_000
n_rings = max(int(np.sqrt(24000 / 8)), 2)
coords, tris, cls = gen.annulus_mesh(n_rings, 24000 // (2 * n_rings), 0.3, 1.0)
cfg = px.XGCmConfig(num_ptcls=N, mdl_face=max(int(cls.max()) // 2, 2),
                    deg_per_push=15.0, max_search_iters=64)
for c in (cfg, dataclasses.replace(cfg, analytic_locate="off")):
    pp, st, _, step = px.make_picparts_setup(coords, tris, cls, c, make_device_mesh(4),
                                             use_lb=True, cap_factor=1.5)
    out = []
    for _ in range(4):
        st, fwd, stats = step(st)
        out.append((int(stats["alive"]), int(stats["sent"])))
    print(c.analytic_locate, out)

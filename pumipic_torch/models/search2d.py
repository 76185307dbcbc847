"""search2d — 2D search correctness driver (port of
``pumipic_tpu.models.search2d``, the ``test/search2d.cpp`` analog).

Seeds points at element centroids, pushes them toward random destinations in
the mesh, runs the 2D walk (kernel L on the card), and verifies containment
with barycentric checks.  Returns the failure count like the reference's
``main``.  Runs on the mesh's device.
"""
from __future__ import annotations

import numpy as np
import torch

from pumipic_torch.mesh.core import Mesh2D
from pumipic_torch.ops import geometry as geo
from pumipic_torch.ops import search as search_ops


def run(mesh: Mesh2D, num_ptcls: int = 1000, seed: int = 0,
        max_iters: int = 200) -> int:
    rng = np.random.default_rng(seed)
    elems = rng.integers(0, mesh.nelems, size=num_ptcls)
    cent = mesh.elem_centroids.cpu().numpy()
    orig = cent[elems]

    # random destinations = centroids of other random elements
    dst_elems = rng.integers(0, mesh.nelems, size=num_ptcls)
    dest = cent[dst_elems]

    dev = mesh.device
    dest_t = torch.as_tensor(dest, device=dev)
    res = search_ops.search_mesh_2d(
        mesh,
        torch.as_tensor(orig, device=dev),
        dest_t,
        torch.as_tensor(elems, dtype=torch.int32, device=dev),
        torch.ones(num_ptcls, dtype=torch.bool, device=dev),
        max_iters,
    )
    got = res.elem_ids
    e_safe = torch.clamp(got, min=0).long()
    w = geo.bcc_2d(mesh.elem_inv_basis[e_safe], mesh.elem_v0[e_safe], dest_t)
    contained = geo.all_positive(w, tol=1e-5) & (got >= 0)
    return int((~contained).sum())

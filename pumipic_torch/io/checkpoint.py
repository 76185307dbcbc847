"""Checkpoint / resume of particle state (port of the particle and structure
parts of ``pumipic_tpu.io.checkpoint``).

Reference parity: ``pumipic::write/read`` (``src/pumipic_file.cpp:46-207``)
persists picparts; particle state is not checkpointed by the reference
(apps own it), the JAX package checkpoints it too.  The files are the JAX
package's format, one compressed ``.npz`` per artifact: the state arrays
as ``f.<name>`` and a JSON sidecar ``__meta__`` (format version, step,
field names) as uint8, so that a file written by either package is read by
the other.  A particle structure adds its layout and padding settings as
the ``__layout__`` entry and is rebuilt in that layout on read.

Picparts (``write_picparts``/``read_picparts``) wait for the port's
picparts.
"""
from __future__ import annotations

import json
from typing import Dict, Tuple

import numpy as np
import torch

FORMAT_VERSION = 1


def _host(v) -> np.ndarray:
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _json_bytes(obj) -> np.ndarray:
    return np.frombuffer(json.dumps(obj).encode(), dtype=np.uint8)


def write_particles(path: str, state: Dict[str, object], step: int = 0) -> str:
    """Persist a flat particle-state dict (tensors or arrays; a particle
    structure's ``copy_to_host()``) to ``path`` (``.npz`` appended where
    missing); returns the path written."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    meta = {"version": FORMAT_VERSION, "step": step, "fields": sorted(state.keys())}
    arrays = {f"f.{k}": _host(v) for k, v in state.items()}
    arrays["__meta__"] = _json_bytes(meta)
    np.savez_compressed(path, **arrays)
    return path


def read_particles(path: str) -> Tuple[Dict[str, np.ndarray], int]:
    """(state as host arrays, step) of a file :func:`write_particles` (of
    either package) wrote."""
    data = np.load(path)
    meta = json.loads(bytes(data["__meta__"]).decode())
    if meta["version"] > FORMAT_VERSION:
        raise ValueError(f"checkpoint version {meta['version']} newer than "
                         f"supported {FORMAT_VERSION}")
    state = {k[2:]: data[k] for k in data.files if k.startswith("f.")}
    return state, meta["step"]


def write_particle_structure(path: str, ps, step: int = 0) -> str:
    """Checkpoint a :class:`~pumipic_torch.particles.ParticleStructure`:
    its slots (fields, ``elem``, ``active``) and its layout, rebuilt on
    read."""
    host = ps.copy_to_host()
    host["__layout__"] = _json_bytes({
        "layout": ps.layout, "num_elems": ps.num_elems,
        "capacity": ps.capacity, "soa_width": ps.soa_width,
        "chunk_size": ps.chunk_size, "sigma": min(ps.sigma, 2**30),
        "extra_padding": ps.scs_extra_padding,
        "pad_strategy": ps.scs_pad_strategy,
        "cabm_extra_padding": ps.cabm_extra_padding,
        "name": ps.name,
    })
    return write_particles(path, host, step)


def read_particle_structure(path: str, device=None):
    """(structure, step) of a file :func:`write_particle_structure` (of
    either package) wrote: the active slots' particles placed into a new
    structure of the stored layout, capacity and padding settings on
    ``device``."""
    from pumipic_torch.particles.structure import CSR, DPS, CabM, SCSInput, SellCSigma

    state, step = read_particles(path)
    cfg = json.loads(bytes(state.pop("__layout__")).decode())
    active = state.pop("active")
    elem = np.where(active, state.pop("elem"), -1)
    fields = {k: torch.from_numpy(np.array(v)) for k, v in state.items()}
    common = dict(fields=fields, capacity=cfg["capacity"], name=cfg["name"],
                  device=device)
    if cfg["layout"] == "scs":
        ps = SellCSigma(
            cfg["num_elems"], elem,
            scs_input=SCSInput(
                chunk_size=cfg["chunk_size"], sigma=cfg["sigma"],
                extra_padding=cfg.get("extra_padding", 0.0),
                pad_strategy=cfg.get("pad_strategy", "proportionally")),
            **common)
    elif cfg["layout"] == "cabm":
        ps = CabM(cfg["num_elems"], elem, soa_width=cfg["soa_width"],
                  extra_padding=cfg.get("cabm_extra_padding", 0.0), **common)
    else:
        builder = {"csr": CSR, "dps": DPS}[cfg["layout"]]
        ps = builder(cfg["num_elems"], elem, **common)
    return ps, step

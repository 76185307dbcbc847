"""Omega_h-style ``.osh`` binary mesh I/O (numpy copy of
``pumipic_tpu.io.osh``; the files are the same bytes).

Reference parity: the reference's meshes and checkpoints are Omega_h binary
directories — ``pumipic::write/read`` wraps ``Omega_h::binary::write/read``
plus a versioned comm-metadata blob with zlib compression and endian
handling (``src/pumipic_file.cpp:46-207``); the XGC 24k/120k workloads ship
as ``.osh`` directories (``test/testing.cmake:114-130``).

A ``<name>.osh/`` directory holds ``nparts``/``version`` text files and
per-rank binary streams, each stream ``magic | version | compression flag
| meta | typed zlib-compressed arrays`` written little-endian regardless of
host byte order.  The byte layout follows Omega_h's ``Omega_h_file.cpp``
design (magic ``0xa1 0x1a``, version int, per-array compressed blocks) but
is self-described (typed array headers), strictly versioned and
round-trip tested; exact interchange with upstream-written files is not
claimed.  ``read_osh`` raises on any stream it cannot interpret.

:func:`load_mesh` reads a mesh file (``.osh`` or Gmsh ``.msh``/``.msh.gz``)
into the port's :class:`~pumipic_torch.mesh.core.Mesh2D` or
:class:`~pumipic_torch.mesh.core.Mesh3D`; :func:`load_mesh_arrays` returns
the host arrays as the JAX package's ``load_mesh`` does.
"""
from __future__ import annotations

import os
import struct
import zlib
from typing import Dict, Optional

import numpy as np

MAGIC = b"\xa1\x1a"
VERSION = 10
_DTYPES = {0: np.int8, 2: np.int32, 3: np.int64, 5: np.float64,
           6: np.float32}
_DTYPE_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}


def _write_value(f, fmt: str, v) -> None:
    f.write(struct.pack("<" + fmt, v))


def _read_value(f, fmt: str):
    size = struct.calcsize("<" + fmt)
    buf = f.read(size)
    if len(buf) != size:
        raise ValueError("truncated .osh stream")
    return struct.unpack("<" + fmt, buf)[0]


def _write_array(f, arr: np.ndarray, compress: bool) -> None:
    arr = np.ascontiguousarray(arr)
    code = _DTYPE_CODES.get(arr.dtype)
    if code is None:
        raise TypeError(f"unsupported .osh array dtype {arr.dtype}")
    # little-endian on disk regardless of host order
    data = arr.astype(arr.dtype.newbyteorder("<"), copy=False).tobytes()
    _write_value(f, "q", arr.size)
    _write_value(f, "b", code)
    if compress:
        z = zlib.compress(data, 6)
        _write_value(f, "q", len(z))
        f.write(z)
    else:
        f.write(data)


def _read_array(f, compress: bool) -> np.ndarray:
    n = _read_value(f, "q")
    code = _read_value(f, "b")
    if code not in _DTYPES:
        raise ValueError(f"unknown .osh array dtype code {code}")
    dt = np.dtype(_DTYPES[code]).newbyteorder("<")
    nbytes = n * dt.itemsize
    if compress:
        zb = _read_value(f, "q")
        data = zlib.decompress(f.read(zb))
        if len(data) != nbytes:
            raise ValueError(".osh array decompressed to wrong size")
    else:
        data = f.read(nbytes)
        if len(data) != nbytes:
            raise ValueError("truncated .osh array")
    return np.frombuffer(data, dt).astype(_DTYPES[code])


def _write_string(f, s: str) -> None:
    b = s.encode()
    _write_value(f, "i", len(b))
    f.write(b)


def _read_string(f) -> str:
    n = _read_value(f, "i")
    return f.read(n).decode()


def write_osh_stream(f, coords: np.ndarray, elem2verts: np.ndarray,
                     class_id: Optional[np.ndarray] = None,
                     vert_tags: Optional[Dict[str, np.ndarray]] = None,
                     elem_tags: Optional[Dict[str, np.ndarray]] = None,
                     compress: bool = True) -> None:
    dim = elem2verts.shape[1] - 1
    f.write(MAGIC)
    _write_value(f, "i", VERSION)
    _write_value(f, "b", 1 if compress else 0)
    _write_value(f, "b", 0)            # family: 0 = simplex
    _write_value(f, "i", dim)
    _write_value(f, "q", coords.shape[0])
    _write_array(f, np.asarray(coords, np.float64).reshape(-1), compress)
    _write_value(f, "q", elem2verts.shape[0])
    _write_array(f, np.asarray(elem2verts, np.int32).reshape(-1), compress)

    etags = dict(elem_tags or {})
    if class_id is not None:
        etags.setdefault("class_id", np.asarray(class_id, np.int32))
    for tags in (vert_tags or {}, etags):
        _write_value(f, "i", len(tags))
        for name in sorted(tags):
            arr = np.asarray(tags[name])
            ncomps = 1 if arr.ndim == 1 else arr.shape[1]
            _write_string(f, name)
            _write_value(f, "i", ncomps)
            _write_array(f, arr.reshape(-1), compress)


def read_osh_stream(f):
    if f.read(2) != MAGIC:
        raise ValueError("not an .osh stream (bad magic)")
    version = _read_value(f, "i")
    if version > VERSION:
        raise ValueError(f".osh version {version} newer than supported "
                         f"{VERSION}")
    compress = bool(_read_value(f, "b"))
    family = _read_value(f, "b")
    if family != 0:
        raise ValueError(f"unsupported .osh family {family} (simplex only)")
    dim = _read_value(f, "i")
    nverts = _read_value(f, "q")
    coords = _read_array(f, compress).reshape(nverts, dim)
    nelems = _read_value(f, "q")
    ev = _read_array(f, compress).reshape(nelems, dim + 1)

    def read_tags():
        tags = {}
        for _ in range(_read_value(f, "i")):
            name = _read_string(f)
            ncomps = _read_value(f, "i")
            arr = _read_array(f, compress)
            tags[name] = arr if ncomps == 1 else arr.reshape(-1, ncomps)
        return tags

    vert_tags = read_tags()
    elem_tags = read_tags()
    class_id = elem_tags.pop("class_id", np.ones(nelems, np.int32))
    return coords, ev, class_id, vert_tags, elem_tags


def write_osh(path: str, coords: np.ndarray, elem2verts: np.ndarray,
              class_id: Optional[np.ndarray] = None,
              vert_tags: Optional[Dict[str, np.ndarray]] = None,
              elem_tags: Optional[Dict[str, np.ndarray]] = None,
              nparts: int = 1, rank: int = 0,
              compress: bool = True) -> None:
    """Write one part of an ``.osh`` directory (Omega_h binary::write
    layout: ``path/nparts``, ``path/version``, ``path/<rank>.osh``)."""
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "nparts"), "w") as f:
        f.write(f"{nparts}\n")
    with open(os.path.join(path, "version"), "w") as f:
        f.write(f"{VERSION}\n")
    with open(os.path.join(path, f"{rank}.osh"), "wb") as f:
        write_osh_stream(f, coords, elem2verts, class_id, vert_tags,
                         elem_tags, compress)


def read_osh(path: str, rank: int = 0):
    """Read one part of an ``.osh`` directory.  Returns
    (coords, elem2verts, class_id, vert_tags, elem_tags)."""
    nparts_file = os.path.join(path, "nparts")
    if os.path.isdir(path) and os.path.exists(nparts_file):
        with open(nparts_file) as f:
            nparts = int(f.read().strip())
        if rank >= nparts:
            raise ValueError(f"rank {rank} >= nparts {nparts}")
        stream_path = os.path.join(path, f"{rank}.osh")
    else:
        stream_path = path      # bare stream file
    with open(stream_path, "rb") as f:
        return read_osh_stream(f)


def load_mesh_arrays(path: str, dim: Optional[int] = None):
    """Dispatch a mesh file to the right reader: ``.osh`` directories/streams
    or Gmsh ``.msh``/``.msh.gz``.  Returns (coords, elem2verts, class_id)."""
    if path.endswith(".osh") or os.path.isdir(path):
        coords, ev, cls, _, _ = read_osh(path)
        return coords, ev, cls
    from pumipic_torch.mesh.gmsh import read_msh

    return read_msh(path, dim)


def load_mesh(path: str, dim: Optional[int] = None, device=None):
    """The port's :class:`Mesh2D` (triangles) or :class:`Mesh3D` (tets) of
    a mesh file, on ``device`` (the card where there is one, unless the
    caller asks for the CPU)."""
    from pumipic_torch.mesh.core import Mesh2D, Mesh3D

    coords, ev, cls = load_mesh_arrays(path, dim)
    cls_ = Mesh2D if np.asarray(ev).shape[1] == 3 else Mesh3D
    return cls_.from_arrays(np.asarray(coords, np.float64), np.asarray(ev), cls,
                            device=device)

"""The port's import surface against the JAX package's.

Each ``pumipic_tpu`` ``__init__`` re-exports names (modules, classes,
constants); every one of them resolves in the counterpart ``pumipic_torch``
subpackage, with ``parallel.group`` standing for ``parallel.mesh_axis``.
``mesh_axis``'s own names resolve in ``group`` too, apart from its
``jax.sharding`` helpers, which have no counterpart (the group replaces the
device mesh).  The JAX ``__init__`` files are read as source, so the names
are compared without importing either package's subpackages first.

Importing the port loads no JAX, nothing of ``pumipic_tpu`` and no kernel
library: each subpackage is imported first in a fresh interpreter.
"""
import ast
import importlib
import json
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
SUBPACKAGES = ["", "io", "mesh", "models", "ops", "parallel", "particles", "utils"]
# the JAX module name -> the port's
RENAMED = {"mesh_axis": "group"}
# mesh_axis's jax.sharding helpers (ROADMAP queue 1) and its alias of JAX
# axis names: no counterpart
EXCUSED = {"make_device_mesh", "mesh_axes", "particle_sharding", "replicated",
           "RANK_AXIS", "SLICE_AXIS", "AxisName"}


def _exports(sub: str):
    """(name, is_module) of every name the JAX ``__init__`` of ``sub``
    imports."""
    init = ROOT / "pumipic_tpu" / sub / "__init__.py"
    out = []
    for node in ast.parse(init.read_text()).body:
        if isinstance(node, ast.ImportFrom):
            # `from pkg import mod` imports a module where pkg/mod.py exists
            pkg = ROOT.joinpath(*node.module.split("."))
            for a in node.names:
                out.append((a.name, (pkg / f"{a.name}.py").exists()))
    return out


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_every_jax_export_resolves_in_the_port(sub):
    names = _exports(sub)
    assert names or sub in ("",), f"no exports read from pumipic_tpu/{sub}"
    port = importlib.import_module("pumipic_torch" + (f".{sub}" if sub else ""))
    missing = []
    for name, is_module in names:
        got = getattr(port, RENAMED.get(name, name), None)
        if got is None or isinstance(got, types.ModuleType) != is_module:
            missing.append(name)
    assert not missing, f"pumipic_torch.{sub} lacks {missing}"


def test_group_stands_for_mesh_axis():
    from pumipic_torch.parallel import group

    src = (ROOT / "pumipic_tpu" / "parallel" / "mesh_axis.py").read_text()
    public = set()
    for node in ast.parse(src).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            public.add(node.name)
        elif isinstance(node, ast.Assign):
            public.update(t.id for t in node.targets if isinstance(t, ast.Name))
    public = {n for n in public if not n.startswith("_")}
    assert EXCUSED <= public
    assert [n for n in sorted(public - EXCUSED) if not hasattr(group, n)] == []


def test_types_match_the_reference():
    from pumipic_tpu.utils import types as jt
    from pumipic_torch.utils import types as tt

    for name in ("LID_DTYPE", "GID_DTYPE", "REAL_DTYPE"):
        assert np.dtype(getattr(jt, name)) == torch.empty(
            0, dtype=getattr(tt, name)).numpy().dtype, name
    assert tt.GID_HOST_DTYPE is jt.GID_HOST_DTYPE is np.int64
    assert tt.INVALID == jt.INVALID
    for a in (0, 1, 7, 8, 9, 1023, 1024, 10**9 + 7):
        for b in (1, 3, 8, 1024):
            assert tt.cdiv(a, b) == jt.cdiv(a, b) and tt.round_up(a, b) == jt.round_up(a, b)


_PROBE = """
import importlib, json, sys
mod = importlib.import_module(sys.argv[1])
import pumipic_torch
from pumipic_torch.kernels import _build
print(json.dumps({
    "jax": sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")),
    "ref": sorted(m for m in sys.modules if m.startswith("pumipic_tpu")),
    "lib": _build._LIB is not None,
    "timing": hasattr(pumipic_torch, "timing") and hasattr(pumipic_torch, "plog"),
}))
"""


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_importing_the_port_loads_no_jax(sub):
    """Each subpackage imported first, in a fresh interpreter: no import
    cycle, no JAX, nothing of the JAX package and no kernel library."""
    name = "pumipic_torch" + (f".{sub}" if sub else "")
    res = subprocess.run([sys.executable, "-c", _PROBE, name], capture_output=True,
                         text=True, cwd=ROOT, timeout=120)
    assert res.returncode == 0, res.stderr
    got = json.loads(res.stdout.strip().splitlines()[-1])
    assert got == {"jax": [], "ref": [], "lib": False, "timing": True}, got

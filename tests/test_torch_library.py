"""The port's ``Library`` (``pumipic_torch.library``) against the JAX
package's: the same names (``num_ranks`` for ``num_devices``, since the
port's ranks are processes), ``world_size``, ``summarize``, ``finalize``;
its debug checks against ``jax_debug_nans``: both raise
``FloatingPointError`` where an operation makes a NaN and neither where a
tensor is made from data holding one; the port's check also sees a NaN
only at a torch function's output, so one written through a host view
(as a hand-written kernel writes, through a pointer) raises at the next
torch function whose output holds it."""
import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pumipic_tpu.library import Library as JLibrary
from pumipic_torch.library import Library, NanCheck
from pumipic_torch.parallel import group
from pumipic_torch.utils import timing

sys.path.insert(0, os.path.dirname(__file__))
HERE = os.path.dirname(os.path.abspath(__file__))


def test_library_names_match_jax():
    ours = {f.name for f in dataclasses.fields(Library)}
    theirs = {f.name for f in dataclasses.fields(JLibrary)}
    assert theirs - ours == {"num_devices"} and "num_ranks" in ours
    for name in ("world_size", "summarize", "finalize"):
        assert hasattr(Library, name) and hasattr(JLibrary, name)


def test_library_without_a_group_is_one_rank_and_sets_timing():
    lib = Library(enable_timing=False)
    assert lib.world_size == 1 and not group.initialized()
    assert not timing.get_registry().enabled
    lib.finalize()
    lib = Library()
    assert timing.get_registry().enabled
    timing.record_time("library test op", 0.25)
    assert "library test op" in lib.summarize()
    lib.finalize()


def _raises_in_jax(fn) -> bool:
    jax.config.update("jax_debug_nans", True)
    try:
        jax.block_until_ready(fn())
        return False
    except FloatingPointError:
        return True
    finally:
        jax.config.update("jax_debug_nans", False)


def test_debug_checks_raise_where_jax_debug_nans_does():
    nan = np.asarray([np.nan, 1.0], np.float32)
    assert _raises_in_jax(lambda: jnp.zeros(2) / 0.0)
    assert not _raises_in_jax(lambda: jnp.asarray(nan))
    lib = Library(debug_checks=True)
    try:
        with pytest.raises(FloatingPointError, match="div"):
            torch.zeros(2) / 0.0
        t = torch.as_tensor(nan)                       # made from data: no raise
        assert torch.isnan(t).any()
        ok = torch.ones(3) * 2.0                        # no NaN: no raise
        ok.numpy()[1] = np.nan                          # a host write: not seen here
        with pytest.raises(FloatingPointError, match="add"):
            ok + 1.0                                    # ... but at the next output
    finally:
        lib.finalize()
    assert torch.isnan(torch.zeros(1) / 0.0).all()    # finalize ended the checks


def test_nan_check_is_a_torch_function_mode():
    with NanCheck():
        torch.ones(2).sum()
        with pytest.raises(FloatingPointError):
            torch.sqrt(torch.tensor([-1.0]))


def test_library_joins_the_group_and_leaves_it_to_its_owner():
    out = group.launch("torch_ranks:library_rank", 2, {}, backend="gloo",
                       device="cpu", timeout=120, extra_paths=[HERE])
    assert [o["world_size"] for o in out] == [2, 2]
    assert [o["rank"] for o in out] == [0, 1]
    assert all(o["refused"] and o["still_initialized"] for o in out)

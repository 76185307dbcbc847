"""The rank group (port of ``pumipic_tpu.parallel.mesh_axis``).

The JAX package runs one SPMD program over a ``("ranks",)`` device mesh;
here every rank is a process of a ``torch.distributed`` group holding its
own picpart and particles on its own device.  ``psum``/``pmax`` become
``all_reduce`` (or one ``all_gather`` reduced in rank order),
``all_gather`` stays ``all_gather``, and ``lax.all_to_all``/``ppermute``
become ``all_to_all_single``: the three collectives that both NCCL and gloo
take for CUDA tensors.  A group of ``slices`` slices (``init(slices=)`` or
:func:`set_slices`: the JAX package's ``("slice", "ranks")`` mesh, flat
rank ``slice · ranks_per_slice + r``) adds one sub-group per slice and one
per rank coordinate, over which :func:`hier_all_to_all` and
:func:`hier_ragged_all_to_all` route an exchange in two stages (within
the slice by destination rank coordinate, then one exchange across the
slices), equal to the flat exchange bit for bit.  The backend is the
caller's explicit choice (``nccl`` on the card, ``gloo`` for the CPU and
for several ranks sharing one card); nothing switches backend or device
after an error.

Without an initialized group the process is rank 0 of 1 and every
collective is the identity.  :func:`launch` starts ``n`` rank processes
of a function on one machine and returns their results; it fails when a
rank fails or the deadline passes.
"""
from __future__ import annotations

import contextlib
import os
import pickle
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional

import torch
import torch.distributed as dist

_DEVICE: Optional[torch.device] = None
# the ("slice", "ranks") topology: slices, and per slice count the
# sub-groups (this rank's slice, its rank coordinate across the slices)
_SLICES = 1
_SUBGROUPS: Dict[int, tuple] = {}


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    """This process's rank (0 without a group)."""
    return dist.get_rank() if initialized() else 0


def num_ranks() -> int:
    """The group's size (1 without a group)."""
    return dist.get_world_size() if initialized() else 1


def slices() -> int:
    """Slices of the ``("slice", "ranks")`` topology (1: flat)."""
    return _SLICES


def set_slices(n: int) -> None:
    """Split the group into ``n`` slices of consecutive ranks (every rank
    calls it: the first call for an ``n`` creates the sub-groups); 1 makes
    it flat again."""
    global _SLICES
    R = num_ranks()
    if n < 1 or R % n:
        raise ValueError(f"{R} ranks do not split into {n} slices")
    if n > 1 and n not in _SUBGROUPS:
        rs = R // n
        me_slice, me_coord = divmod(rank(), rs)
        by_slice = [dist.new_group(list(range(a * rs, (a + 1) * rs))) for a in range(n)]
        by_coord = [dist.new_group(list(range(c, R, rs))) for c in range(rs)]
        _SUBGROUPS[n] = (by_slice[me_slice], by_coord[me_coord])
    _SLICES = n


def init(backend: str, rank: Optional[int] = None,
         world_size: Optional[int] = None, init_method: Optional[str] = None,
         device=None, slices: int = 1) -> torch.device:
    """Join the process group and pick this rank's device.

    Without ``rank``/``world_size``/``init_method`` they come from
    ``torchrun``'s environment (``RANK``, ``WORLD_SIZE``, ``env://``).
    ``device``: ``"cpu"`` for the CPU, else ``cuda:<local rank % cards>``
    (``LOCAL_RANK``, or the rank) made the current CUDA device; without a
    card that raises.  ``slices``: :func:`set_slices`.  Returns the device
    (also :func:`device`)."""
    global _DEVICE
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend must be 'gloo' or 'nccl', got {backend!r}")
    if rank is None:
        rank = int(os.environ["RANK"])
    if world_size is None:
        world_size = int(os.environ["WORLD_SIZE"])
    if init_method is None:
        init_method = "env://"
    local = int(os.environ.get("LOCAL_RANK", rank))
    if device is not None and torch.device(device).type == "cpu":
        dev = torch.device("cpu")
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available: pass device=\"cpu\"")
        dev = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("the nccl backend needs CUDA devices")
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size)
    _DEVICE = dev
    set_slices(slices)
    return dev


def device() -> torch.device:
    """The device :func:`init` chose (the CUDA card without a group)."""
    if _DEVICE is not None:
        return _DEVICE
    from pumipic_torch.utils.device import resolve_device

    return resolve_device(None)


def finalize() -> None:
    global _DEVICE, _SLICES
    if initialized():
        dist.destroy_process_group()
    _DEVICE = None
    _SLICES = 1
    _SUBGROUPS.clear()


# ---------------------------------------------------------------------------
# collectives (identity on one rank), each timed as "collective" by an
# active SplitTimer
# ---------------------------------------------------------------------------

def world_all_to_all(rows: torch.Tensor) -> torch.Tensor:
    """``lax.all_to_all(rows, split_axis=0, concat_axis=0)``: row p of the
    (R, ...) input goes to rank p; row q of the output came from rank q."""
    if num_ranks() == 1:
        return rows
    if rows.shape[0] != num_ranks():
        raise ValueError(f"world_all_to_all: {rows.shape[0]} rows for "
                         f"{num_ranks()} ranks")
    with split("collective"):
        rows = rows.contiguous()
        out = torch.empty_like(rows)
        dist.all_to_all_single(out, rows)
    return out


def ragged_all_to_all(send: torch.Tensor, send_rows: List[int],
                      recv_rows: List[int]) -> torch.Tensor:
    """``all_to_all_single`` with host-known split sizes: the first
    ``send_rows[0]`` rows go to rank 0, the next ``send_rows[1]`` to rank 1,
    ...; the output holds ``recv_rows[q]`` rows from each rank q in rank
    order."""
    with split("collective"):
        out = send.new_empty((sum(recv_rows),) + tuple(send.shape[1:]))
        dist.all_to_all_single(out, send.contiguous(), recv_rows, send_rows)
    return out


def hier_all_to_all(rows: torch.Tensor) -> torch.Tensor:
    """:func:`world_all_to_all` routed in two stages over the slices
    (``mesh_axis.hier_all_to_all``): stage A within the slice sends each
    rank coordinate the rows bound for it in every slice, stage B is one
    exchange across the slices; row q of the output came from flat rank
    q, as from the flat exchange.  Flat without slices."""
    if _SLICES == 1 or num_ranks() == 1:
        return world_all_to_all(rows)
    R, S = num_ranks(), _SLICES
    rs = R // S
    if rows.shape[0] != R:
        raise ValueError(f"hier_all_to_all: {rows.shape[0]} rows for {R} ranks")
    in_slice, across = _SUBGROUPS[S]
    rest = tuple(rows.shape[1:])
    with split("collective"):
        # stage A: chunk j (rows for coordinate j of every slice) to rank j
        a_in = rows.reshape((S, rs) + rest).transpose(0, 1).contiguous()
        a_out = torch.empty_like(a_in)
        dist.all_to_all_single(a_out, a_in, group=in_slice)
        # a_out[i, s2]: from coordinate i of my slice, bound for (s2, mine);
        # stage B: chunk s2 to slice s2
        b_in = a_out.transpose(0, 1).contiguous()
        b_out = torch.empty_like(b_in)
        dist.all_to_all_single(b_out, b_in, group=across)
    return b_out.reshape(rows.shape)


def hier_ragged_all_to_all(send: torch.Tensor, send_rows: List[int],
                           recv_rows: List[int]) -> torch.Tensor:
    """:func:`ragged_all_to_all` routed in two stages over the slices.  A
    stage-A receiver does not know how many rows each rank of its slice
    holds for each slice, so the ranks first exchange those counts (one
    (ranks_per_slice, slices) exchange within the slice).  The output
    holds ``recv_rows[q]`` rows from each flat rank q in rank order, as the
    flat exchange's.  Flat without slices."""
    if _SLICES == 1 or num_ranks() == 1:
        return ragged_all_to_all(send, send_rows, recv_rows)
    R, S = num_ranks(), _SLICES
    rs = R // S
    in_slice, across = _SUBGROUPS[S]
    rest = tuple(send.shape[1:])
    off = [0]
    for n in send_rows:
        off.append(off[-1] + n)
    with split("collective"):
        # stage A: coordinate j gets my rows for (s2, j), s2 = 0..S-1
        cnt = torch.tensor([[send_rows[s2 * rs + j] for s2 in range(S)] for j in range(rs)],
                           dtype=torch.int64, device=send.device)
        got = torch.empty_like(cnt)
        dist.all_to_all_single(got, cnt, group=in_slice)
        got = got.tolist()              # got[i][s2]: from (mine, i) for (s2, mine)
        a_in = torch.cat([send[off[s2 * rs + j]:off[s2 * rs + j + 1]]
                          for j in range(rs) for s2 in range(S)])
        a_out = send.new_empty((sum(map(sum, got)),) + rest)
        dist.all_to_all_single(a_out, a_in.contiguous(), [sum(g) for g in got],
                               [sum(send_rows[s2 * rs + j] for s2 in range(S))
                                for j in range(rs)], group=in_slice)
        # stage B: slice s2 gets the blocks (i, s2), i = 0..rs-1
        aoff, pos = {}, 0
        for i in range(rs):
            for s2 in range(S):
                aoff[i, s2] = (pos, pos + got[i][s2])
                pos += got[i][s2]
        b_in = torch.cat([a_out[slice(*aoff[i, s2])] for s2 in range(S) for i in range(rs)])
        out = send.new_empty((sum(recv_rows),) + rest)
        dist.all_to_all_single(out, b_in.contiguous(),
                               [sum(recv_rows[s1 * rs:(s1 + 1) * rs]) for s1 in range(S)],
                               [sum(got[i][s2] for i in range(rs)) for s2 in range(S)],
                               group=across)
    return out


def all_gather(x: torch.Tensor) -> torch.Tensor:
    """(R, ...) stack of every rank's ``x`` in rank order."""
    if num_ranks() == 1:
        return x[None]
    with split("collective"):
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(num_ranks())]
        dist.all_gather(parts, x)
    return torch.stack(parts)


def all_sum(x: torch.Tensor) -> torch.Tensor:
    """``psum``: the sum over ranks (a new tensor)."""
    x = x.clone()
    if num_ranks() > 1:
        with split("collective"):
            dist.all_reduce(x, op=dist.ReduceOp.SUM)
    return x


# ---------------------------------------------------------------------------
# per-step split on the device's clock
# ---------------------------------------------------------------------------

class SplitTimer:
    """Splits a CUDA stream's time into labelled parts with CUDA events:
    each span between two consecutive marks belongs to the innermost
    :meth:`part` open at its end.  Read with :meth:`totals` (ms per label,
    after a synchronize)."""

    def __init__(self):
        self.events = []
        self.stack = ["other"]

    def _mark(self):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        self.events.append((e, self.stack[-1]))

    @contextlib.contextmanager
    def part(self, label: str):
        self._mark()
        self.stack.append(label)
        try:
            yield
        finally:
            self._mark()
            self.stack.pop()

    def totals(self) -> Dict[str, float]:
        torch.cuda.synchronize()
        out: Dict[str, float] = {}
        for (e0, _), (e1, label) in zip(self.events, self.events[1:]):
            out[label] = out.get(label, 0.0) + e0.elapsed_time(e1)
        self.events = []
        return out


_TIMER: Optional[SplitTimer] = None
_RECORD = False


def set_split_timer(timer: Optional[SplitTimer], record: bool = False) -> None:
    """Make ``timer`` receive the parts of the steps that follow (None:
    stop timing); with ``record``, each part is also a profiler range
    ``pp:<label>`` (torch.profiler's ``record_function``)."""
    global _TIMER, _RECORD
    _TIMER, _RECORD = timer, record


def split(label: str):
    """The active :class:`SplitTimer`'s part ``label`` (and its profiler
    range), or nothing."""
    if _TIMER is None and not _RECORD:
        return contextlib.nullcontext()
    stack = contextlib.ExitStack()
    if _TIMER is not None:
        stack.enter_context(_TIMER.part(label))
    if _RECORD:
        stack.enter_context(torch.profiler.record_function("pp:" + label))
    return stack


# ---------------------------------------------------------------------------
# rank processes on one machine
# ---------------------------------------------------------------------------

def _to_host(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def _call(target: str, kwargs: dict):
    import importlib

    mod, fn = target.split(":")
    return getattr(importlib.import_module(mod), fn)(**kwargs)


def launch(target: str, n: int, kwargs: Optional[dict] = None,
           backend: str = "nccl", device: str = "cuda", timeout: float = 600.0,
           workdir: Optional[str] = None, extra_paths=()) -> list:
    """Run ``target`` ("module:function") as ``n`` rank processes of one
    group and return their results in rank order.

    Each process joins the group through a file in ``workdir`` (a new
    temporary directory by default), with ``backend`` and ``device``
    (``"cuda"``: rank r takes card ``r % cards``, and fails without one;
    or ``"cpu"`` when asked; several ranks on one card need ``"gloo"``),
    runs with one CPU thread, calls ``function(**kwargs)`` and returns
    what it returned (tensors moved to the CPU).  ``extra_paths`` are put in front of the ranks' module path.  A rank that exits with an error or a run
    that passes ``timeout`` seconds kills every rank and raises, with the
    failing ranks' logs."""
    own = workdir is None
    workdir = tempfile.mkdtemp(prefix="pp_ranks_") if own else workdir
    os.makedirs(workdir, exist_ok=True)
    with open(os.path.join(workdir, "call.pkl"), "wb") as f:
        pickle.dump((target, kwargs or {}), f)
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [*map(os.path.abspath, extra_paths), root]
        + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    env["OMP_NUM_THREADS"] = "1"
    procs, logs = [], []
    for r in range(n):
        log = open(os.path.join(workdir, f"rank{r}.log"), "w")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "pumipic_torch.parallel.group", workdir,
             str(r), str(n), backend, device],
            stdout=log, stderr=subprocess.STDOUT, env=env))
    deadline = time.monotonic() + timeout
    failed = None
    try:
        while True:
            codes = [p.poll() for p in procs]
            bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if bad:
                # the others' errors follow the first; let them land
                grace = time.monotonic() + 3.0
                while time.monotonic() < grace and any(p.poll() is None for p in procs):
                    time.sleep(0.05)
                failed = [(r, f"exit code {p.poll()}") for r, p in enumerate(procs)
                          if p.poll() not in (None, 0)]
                break
            if all(c == 0 for c in codes):
                break
            if time.monotonic() > deadline:
                failed = [(r, f"no result after {timeout:.0f} s")
                          for r, c in enumerate(codes) if c is None]
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
        for log in logs:
            log.close()
    if failed is not None:
        msg = []
        for r, why in failed:
            with open(os.path.join(workdir, f"rank{r}.log")) as f:
                msg.append(f"rank {r} of {n} ({target}) failed: {why}\n"
                           f"{f.read()[-4000:]}")
        raise RuntimeError("\n".join(msg))
    out = []
    for r in range(n):
        with open(os.path.join(workdir, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    if own:
        import shutil

        shutil.rmtree(workdir, ignore_errors=True)
    return out


def _rank_main(argv) -> None:
    workdir, r, n, backend, dev = argv[0], int(argv[1]), int(argv[2]), argv[3], argv[4]
    torch.set_num_threads(1)
    with open(os.path.join(workdir, "call.pkl"), "rb") as f:
        target, kwargs = pickle.load(f)
    init(backend, rank=r, world_size=n,
         init_method="file://" + os.path.join(workdir, "group"), device=dev)
    try:
        result = _to_host(_call(target, kwargs))
        dist.barrier()
    finally:
        finalize()
    tmp = os.path.join(workdir, f"rank{r}.pkl.tmp")
    with open(tmp, "wb") as f:
        pickle.dump(result, f)
    os.replace(tmp, os.path.join(workdir, f"rank{r}.pkl"))


if __name__ == "__main__":
    # run as the imported module, whose globals the rank's callers read
    from pumipic_torch.parallel import group as _group

    _group._rank_main(sys.argv[1:])

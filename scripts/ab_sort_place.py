"""A/B of kernels C (the rebuild's stable sort), X3 (the arrivals'
placement), X1 (rank within key) and X2 (the send buffer's rows) on one
CUDA GPU: this checkout's ``rebuild.cu`` and ``exchange.cu`` against other
versions', in turns.

    python3 scripts/ab_sort_place.py OTHER[,OTHER...] [OUT_JSON]
        [--variants NAME=DEFINE:VALUE[,DEFINE:VALUE...][;NAME=...]] [--profile]
        [--kernels C,X3,X1,X2] [--x2-saved PATH]

Each ``OTHER`` is a directory holding another version's ``rebuild.cu``
and ``exchange.cu`` (either may be missing), for example a parent
commit's, written out with ``git show`` into a git-ignored directory such
as ``chip_tree/``; its name in the output is the directory's base name.
This checkout's own build is ``new``; ``--variants`` adds builds of this
checkout's sources with some of their ``#define`` constants set otherwise
in the text written to the variant's build directory
(``NAME=DEFINE:VALUE``, e.g. ``min3=KS_MIN_BLOCKS:3`` or
``w8c16=KS_WARPS:8,KS_CHUNKS:16``).  Every build uses the package's nvcc
flags.  A version whose ``pp_key_sort`` has no ``elem`` argument is the
first C (four launches a pass, keys in [0, K] only): its fused cases run
``torch.where`` first, as its callers did.  A version
whose ``pp_place_arrivals`` takes ``free_rank`` is the first X3 (out of
place, the free slots' ranks from kernel X1): it is timed with X1's launch
and alone.  A version without ``pp_rank_in_key_scratch`` is the first X1
(a tile pass, a scan and an add; scratch of (K + 2) words a tile).
``--kernels`` picks the kernels timed (default all four).

Inputs: C at the app's width (11,999,376 keys in [0, 122,603], 5% of them
the sentinel): elements sorted with 1% of the keys moved (the app's
locality), the same keys in a random order, K = 2, the 0/1 partition, the
fused mode on (elem, active, E) and on (active, 1) keeping the key, and
100 keys outside [0, K]; X3 at phase c's shape (``chip_smoke.
check_place_arrivals``'s main case: 3.75M slots, rank 0's picpart of the
4-rank 120k arm, its arrivals); X1 at ``chip_smoke.check_rank_in_key``'s
four timed cases (the buckets, 2 keys, 33 keys, 101 keys: the wide mode),
each ranked and counts only, beside ``torch.bincount`` for the counts; X2
at ``chip_smoke.check_pack_send``'s two timed cases (the picparts step's
own leaver layout, ``chip_smoke.x2_step_case``, and leavers at random),
each with its leavers, the share of warps holding one and the mean run,
and on the inputs of a step saved by ``scripts/profile_picparts.py
--save-x2`` where ``--x2-saved PATH`` names them; each version is timed
behind the -1 fill of the buffer its wrapper makes and alone.  Every
version must equal the
plain version bit for bit.  Each is timed on the device alone
(``chip_smoke.device_ms``, the mean of ``REPS`` calls) in turns, in the
order built and then reversed, beside ``torch.sort``'s time for C;
``--profile`` adds each version's kernels by name (torch.profiler).
Prints the card, each build's ptxas report, one JSON line per case and a
summary; writes them all to ``OUT_JSON`` where one is given.
"""
from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import os
import re
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)
sys.path.insert(0, HERE)

import chip_smoke as cs  # noqa: E402  (inputs, timing and bound helpers)
from ab_boris_trace3d import same  # noqa: E402

REPS = 20
P = ctypes.c_void_p
I, L = ctypes.c_int, ctypes.c_longlong
SOURCES = ("rebuild.cu", "exchange.cu")
E_APP = 122_603
N_APP = 11_999_376
# the first C's and X3's C interfaces
OLD_SIGNATURES = {
    "pp_key_sort": [P, L, I, P, P, P, P, P, P, P, P],
    "pp_key_sort_tiles": [L],
    "pp_place_arrivals": [P, P, P, P, L, P, L, I, P, P, I, I, P, P, P, P, P, P, P, P, P,
                          P, P],
    "pp_rank_in_key_tiles": [L],
}


@dataclasses.dataclass
class Version:
    name: str
    texts: dict                 # source file -> text
    lib: object = None
    report: str = ""

    def old_sort(self) -> bool:
        return "const int* elem" not in self.texts["rebuild.cu"]

    def old_place(self) -> bool:
        return "free_rank" in self.texts["exchange.cu"]

    def old_rank(self) -> bool:
        return "pp_rank_in_key_scratch" not in self.texts["exchange.cu"]


def build_all(versions) -> None:
    """Each version's two sources, one nvcc each, all at once; linked into
    a library of its own (the package's other sources are not needed)."""
    from pumipic_torch.kernels import _build

    nvcc = _build.nvcc_path()
    jobs = []
    for v in versions:
        out_dir = _build.BUILD_DIR / f"ab_{re.sub(r'[^A-Za-z0-9_]+', '_', v.name)}"
        out_dir.mkdir(parents=True, exist_ok=True)
        for fname, text in v.texts.items():
            path = out_dir / fname
            path.write_text(text)
            obj = out_dir / (path.stem + ".o")
            cmd = [nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o", str(obj),
                   str(path)]
            jobs.append((v, fname, obj, out_dir, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    objs = {}
    for v, fname, obj, out_dir, proc in jobs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc {v.name} {fname}:\n{err}")
        v.report += f"{v.name} {fname}:\n{err}"
        objs.setdefault(v.name, (v, out_dir, []))[2].append(str(obj))
    for v, out_dir, obj_list in objs.values():
        lib_path = out_dir / "lib.so"
        subprocess.run([nvcc, "-shared", "-o", str(lib_path), *obj_list], check=True)
        v.lib = ctypes.CDLL(str(lib_path))
        names = {"pp_key_sort", "pp_key_sort_scratch", "pp_key_sort_tiles",
                 "pp_place_arrivals", "pp_place_arrivals_scratch", "pp_rank_in_key",
                 "pp_rank_in_key_tiles", "pp_rank_in_key_scratch", "pp_pack_send"}
        for name in names:
            if not hasattr(v.lib, name):
                continue
            fn = getattr(v.lib, name)
            old = (name.startswith("pp_key_sort") and v.old_sort()) or (
                name == "pp_place_arrivals" and v.old_place())
            fn.argtypes = (OLD_SIGNATURES[name] if old or name not in _build.SIGNATURES
                           else _build.SIGNATURES[name])
            fn.restype = ctypes.c_int


def ptr(t):
    return P(None if t is None else t.data_ptr())


def stream():
    from pumipic_torch.kernels import stream_handle

    return P(stream_handle())


def sort_fn(v: Version, n: int, dev, max_key: int, key=None, elem=None, active=None,
            fill: int = 0, keep_key: bool = False):
    """``v``'s kernel C on its scratch, allocated once (the calls then time
    the device alone); returns a function giving (order[, key])."""
    bits = max(int(max_key).bit_length(), 1)
    order = torch.empty(n, dtype=torch.int32, device=dev)
    bufs = [torch.empty(n, dtype=torch.int32, device=dev) for _ in range(4)]
    if v.old_sort():
        tiles = v.lib.pp_key_sort_tiles(n)
        counts = torch.empty(512 * tiles, dtype=torch.int32, device=dev)
        totals = torch.empty(512, dtype=torch.int32, device=dev)

        def run():
            k = key if active is None else torch.where(
                active, elem if elem is not None else 0, fill).to(torch.int32)
            err = v.lib.pp_key_sort(ptr(k), n, bits, ptr(order), ptr(counts), ptr(totals),
                                    *(ptr(b) for b in bufs), stream())
            if err:
                raise RuntimeError(f"{v.name} pp_key_sort: cudaError {err}")
            return (order, k) if keep_key else (order,)
        return run
    scratch = torch.empty(v.lib.pp_key_sort_scratch(n), dtype=torch.int32, device=dev)
    spare = torch.empty(n, dtype=torch.int32, device=dev)
    key_out = torch.empty(n, dtype=torch.int32, device=dev) if keep_key else None

    def run():
        err = v.lib.pp_key_sort(ptr(key), ptr(elem), ptr(active), fill, n, bits,
                                ptr(key_out), ptr(order), ptr(scratch),
                                *(ptr(b) for b in bufs), ptr(spare), stream())
        if err:
            raise RuntimeError(f"{v.name} pp_key_sort: cudaError {err}")
        return (order, key_out) if keep_key else (order,)
    return run


PROFILE = False


def kernel_ms(fn, calls: int = 5) -> dict:
    """Device ms a call of each kernel (and memset) ``fn`` launches, from
    torch.profiler over ``calls`` calls."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            name = ev.key.replace("(anonymous namespace)::", "").split("(")[0][:60]
            out[name] = out.get(name, 0.0) + ev.self_device_time_total / 1e3 / calls
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def timed_case(name: str, fns: dict, want, extra: dict) -> dict:
    """Check each version against ``want`` (twice), then time all in turns
    (the order given, then reversed); with ``--profile``, each version's
    kernels by name."""
    for vname, fn in fns.items():
        for _ in range(2):
            got = fn()
            if not all(same(a, b) for a, b in zip(got, want)):
                raise AssertionError(f"{name}: {vname} differs from its plain version")
    order = list(fns)
    turns = {v: [] for v in order}
    for vname in order + order[::-1]:
        turns[vname].append(cs.device_ms(fns[vname], REPS))
    ms = {v: sum(t) / len(t) for v, t in turns.items()}
    rec = {"case": name, "device_ms": ms, "device_ms_turns": turns, **extra}
    if PROFILE:
        rec["kernels"] = {v: kernel_ms(fns[v]) for v in order}
    print(json.dumps(rec), flush=True)
    return rec


def sort_cases(versions, dev) -> list:
    from pumipic_torch.ops import rebuild as rb

    g = torch.Generator(device=dev).manual_seed(5)
    n, E = N_APP, E_APP
    elem = torch.sort(torch.randint(0, E, (n,), generator=g, device=dev,
                                    dtype=torch.int32)).values
    moved = torch.randperm(n, generator=g, device=dev)[:n // 100]
    elem[moved] = torch.randint(0, E, (moved.shape[0],), generator=g, device=dev,
                                dtype=torch.int32)
    active = torch.rand(n, generator=g, device=dev) < 0.95
    elem = torch.where(active, elem, -1)
    key = torch.where(active, elem, E).to(torch.int32)
    few = key.clone()
    few[torch.randperm(n, generator=g, device=dev)[:100]] = torch.randint(
        -2**31, 2**31 - 1, (100,), generator=g, device=dev, dtype=torch.int32)
    cases = [
        ("app locality", dict(key=key), E),
        ("random order", dict(key=key[torch.randperm(n, generator=g, device=dev)]), E),
        ("K = 2", dict(key=torch.randint(0, 3, (n,), generator=g, device=dev,
                                         dtype=torch.int32)), 2),
        ("0/1 partition", dict(key=(~active).to(torch.int32)), 1),
        ("fused, app locality, key kept", dict(elem=elem, active=active, fill=E,
                                              keep_key=True), E),
        ("fused, 0/1 partition", dict(active=active, fill=1), 1),
        ("app locality, 100 keys outside [0, K]", dict(key=few), E),
    ]
    out = []
    for name, kw, K in cases:
        fused = "active" in kw
        if fused:
            o, k = rb.masked_key_sort_plain(kw.get("elem"), kw["active"], kw["fill"])
            want = (o, k) if kw.get("keep_key") else (o,)
            lib_key = k
        else:
            want = (rb.key_sort_plain(kw["key"], K),)
            lib_key = kw["key"]
        fns = {}
        for v in versions:
            if v.old_sort() and not fused and int(((lib_key < 0) | (lib_key > K)).sum()):
                continue                  # the first C sorts keys in [0, K] only
            fns[v.name] = sort_fn(v, n, dev, K, **kw)
        lib_ms = cs.device_ms(lambda: torch.sort(lib_key, stable=True), REPS)
        passes = len(rb.key_sort_passes(K))
        floor = (2 * (5 if fused else 4) + 4 * kw.get("keep_key", False)
                 + 16 * (passes - 1) + 4) * n / cs.PEAK_BYTES_PER_S * 1e3
        bound = (n * (5 if fused else 4) + 4 * n) / cs.PEAK_BYTES_PER_S * 1e3
        rec = timed_case(f"C {name}", fns, want, {
            "library": "torch.sort(key, stable=True)", "library_ms": lib_ms,
            "bound_ms": bound, "design_floor_ms": floor})
        out.append(rec)
    return out


def place_case(versions, dev) -> list:
    from pumipic_torch.ops import exchange as ex

    lpp = cs.exchange_picpart(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(cs.X_SEED)
    D, cap, n = cs.X_RANKS - 1, cs.X_SLOTS // 8, cs.X_SLOTS
    E = int(lpp.elem_gid.shape[0])
    gs, gp = lpp.elem_gid_sorted, lpp.elem_gid_perm
    st = cs.exchange_state(n, gen, dev, E)
    key = cs.exchange_keys(st, cs.X_LEAVER_SHARE, D, gen)
    rank, counts = ex.rank_in_key(key, D)
    quota = torch.clamp(counts[:D], max=cap)
    ne = torch.where(st["active"], st["elem"], -1)
    recv, _, leaving, _, fs = ex.pack_send(st, key, rank, counts, quota, quota.tolist(),
                                           cap, ne, lpp.elem_gid)
    stay = st["active"] & ~leaving
    m, width = recv.shape
    args = (st, stay, ne, recv, fs, gs, gp)
    plain, num_recv, num_unres, over = ex.place_arrivals_plain(*args)
    want = (plain["elem"], plain["active"], *(plain[f] for f in fs), num_recv.reshape(1),
            num_unres.reshape(1), over.reshape(1))
    fns = {}
    for v in versions:
        elem = torch.empty(n, dtype=torch.int32, device=dev)
        active = torch.empty(n, dtype=torch.bool, device=dev)
        stats = torch.empty(2, dtype=torch.int32, device=dev)
        ovf = torch.empty(1, dtype=torch.bool, device=dev)
        if v.old_place():
            outs = {f: torch.empty_like(st[f]) for f in fs}
            k, srcs, dsts, lanes, is_bool, offs = ex._fields(st, fs, outs)
            scratch = torch.empty(2 * m, dtype=torch.int32, device=dev)
            free_rank = torch.empty(n, dtype=torch.int32, device=dev)
            free_counts = torch.empty(3, dtype=torch.int32, device=dev)
            tiles = v.lib.pp_rank_in_key_tiles(n)
            x1_scratch = torch.empty(3 * tiles, dtype=torch.int32, device=dev)
            stay32 = stay.to(torch.int32)

            def run(v=v, outs=outs, k=k, srcs=srcs, dsts=dsts, lanes=lanes,
                    is_bool=is_bool, offs=offs, scratch=scratch, free_rank=free_rank,
                    free_counts=free_counts, x1_scratch=x1_scratch, elem=elem,
                    active=active, stats=stats, ovf=ovf, with_x1=True):
                if with_x1:
                    v.lib.pp_rank_in_key(ptr(stay32), n, 2, ptr(free_rank),
                                         ptr(free_counts), ptr(x1_scratch), stream())
                err = v.lib.pp_place_arrivals(
                    ptr(stay), ptr(ne), ptr(free_rank), ptr(free_counts), n, ptr(recv), m,
                    width, ptr(gs), ptr(gp), gs.shape[0], k, srcs, dsts, lanes, is_bool,
                    offs, ptr(scratch), ptr(stats), ptr(ovf), ptr(elem), ptr(active),
                    stream())
                if err:
                    raise RuntimeError(f"{v.name} pp_place_arrivals: cudaError {err}")
                return (elem, active, *(outs[f] for f in fs), stats[:1], stats[1:],
                        ovf)
            fns[f"{v.name} (X1 + X3)"] = run
            run()
            fns[f"{v.name} (X3 alone)"] = lambda run=run: run(with_x1=False)
        else:
            fields = {f: st[f].clone() for f in fs}       # written in place
            k, _, dsts, lanes, is_bool, offs = ex._fields(fields, fs, fields)
            scratch = torch.empty(v.lib.pp_place_arrivals_scratch(n, m), dtype=torch.int32,
                                  device=dev)

            def run(v=v, fields=fields, k=k, dsts=dsts, lanes=lanes, is_bool=is_bool,
                    offs=offs, scratch=scratch, elem=elem, active=active, stats=stats,
                    ovf=ovf):
                err = v.lib.pp_place_arrivals(
                    ptr(stay), ptr(ne), n, ptr(recv), m, width, ptr(gs), ptr(gp),
                    gs.shape[0], k, dsts, lanes, is_bool, offs, ptr(scratch), ptr(stats),
                    ptr(ovf), ptr(elem), ptr(active), stream())
                if err:
                    raise RuntimeError(f"{v.name} pp_place_arrivals: cudaError {err}")
                return (elem, active, *(fields[f] for f in fs), stats[:1], stats[1:],
                        ovf)
            fns[v.name] = run
    n_stay = int(stay.sum())
    slot_bytes = sum(cs.nbytes(st[f]) for f in fs) // n
    in_place = (cs.nbytes(stay, recv, gs, gp, elem, active) + 4 * n_stay
                + (n - n_stay) * slot_bytes)
    out_of_place = (cs.nbytes(stay, ne, recv, gs, gp, elem, active) + n_stay * slot_bytes
                    + n * slot_bytes)
    return [timed_case("X3 phase c main case", fns, want, {
        "slots": n, "arrivals": m, "free_slots": n - n_stay,
        "bound_ms": in_place / cs.PEAK_BYTES_PER_S * 1e3,
        "out_of_place_bound_ms": out_of_place / cs.PEAK_BYTES_PER_S * 1e3})]


def rank_fn(v: Version, key, K: int, ranks: bool):
    """``v``'s kernel X1 on its scratch, allocated once; returns a function
    giving (rank, counts) or (counts,)."""
    n, dev = key.shape[0], key.device
    rank = torch.empty(n, dtype=torch.int32, device=dev) if ranks else None
    counts = torch.empty(K + 2, dtype=torch.int32, device=dev)
    if v.old_rank():
        words = (K + 2) * v.lib.pp_rank_in_key_tiles(n)
    else:
        words = v.lib.pp_rank_in_key_scratch(n, K + 1, int(ranks))
    scratch = torch.empty(max(words, 1), dtype=torch.int32, device=dev)

    def run():
        err = v.lib.pp_rank_in_key(ptr(key), n, K + 1, ptr(rank), ptr(counts),
                                   ptr(scratch), stream())
        if err:
            raise RuntimeError(f"{v.name} pp_rank_in_key: cudaError {err}")
        return (rank, counts[:-1]) if ranks else (counts[:-1],)
    return run


def rank_cases(versions, dev) -> list:
    from pumipic_torch.ops import exchange as ex

    gen = torch.Generator(device=dev)
    gen.manual_seed(cs.X_SEED)
    n, D = cs.X_SLOTS, cs.X_RANKS - 1
    st = cs.exchange_state(n, gen, dev, 10)
    cases = [("buckets", cs.exchange_keys(st, cs.X_LEAVER_SHARE, D, gen), D),
             ("2 keys", st["active"].to(torch.int32), 1),
             ("33 keys", torch.randint(0, 34, (n,), generator=gen, device=dev,
                                       dtype=torch.int32), 33),
             ("101 keys", torch.randint(0, 101, (n,), generator=gen, device=dev,
                                        dtype=torch.int32), 100)]
    out = []
    for name, key, K in cases:
        for ranks in (True, False):
            rank, counts = ex.rank_in_key_plain(key, K, ranks)
            want = (rank, counts) if ranks else (counts,)
            fns = {v.name: rank_fn(v, key, K, ranks) for v in versions}
            extra = {"keys": K + 1, "bound_ms": cs.nbytes(key, rank, counts)
                     / cs.PEAK_BYTES_PER_S * 1e3}
            if not ranks:
                extra.update(library="torch.bincount(key, minlength=K + 1)",
                             library_ms=cs.device_ms(
                                 lambda: torch.bincount(key, minlength=K + 1), REPS))
            out.append(timed_case(f"X1 {name}, {'ranked' if ranks else 'counts only'}",
                                  fns, want, extra))
    return out


def pack_inputs(dev, saved: str = "") -> list:
    """X2's cases: phase c's main case (the picparts step's own leaver
    layout, ``chip_smoke.x2_step_case``), leavers at random (phase c's
    second case) and, with ``saved``, the inputs
    ``scripts/profile_picparts.py --save-x2`` saved from a step."""
    from pumipic_torch.ops import exchange as ex

    mesh = cs.exchange_mesh()
    lpp = cs.exchange_picpart(dev, mesh)
    gen = torch.Generator(device=dev)
    gen.manual_seed(cs.X_SEED)
    D, cap, n = cs.X_RANKS - 1, cs.X_SLOTS // 8, cs.X_SLOTS
    step_state, step_key, step_elem = cs.x2_step_case(dev, lpp, mesh)
    st = cs.exchange_state(n, gen, dev, int(lpp.elem_gid.shape[0]))
    key = cs.exchange_keys(st, cs.X_LEAVER_SHARE, D, gen)
    out = []
    for name, s, k, ne in (("X2 the picparts step's leaver layout", step_state, step_key,
                            step_elem),
                           ("X2 leavers at random", st, key,
                            torch.where(st["active"], st["elem"], -1))):
        rank, counts = ex.rank_in_key_plain(k, D)
        quota = torch.clamp(counts[:D], max=cap)
        out.append((name, (s, k, rank, counts, quota, quota.tolist(), cap, ne, lpp.elem_gid)))
    if saved:
        a = torch.load(saved)
        to = {k: (v.to(dev) if isinstance(v, torch.Tensor) else v) for k, v in a.items()}
        st = {f: t.to(dev) for f, t in a["state"].items()}
        out.append((f"X2 saved step inputs ({os.path.basename(saved)})",
                    (st, to["key"], to["rank"], to["counts"], to["quota"], a["rows"], a["cap"],
                     to["new_elem"], to["elem_gid"])))
    return out


def pack_case(versions, dev, saved: str = "") -> list:
    from pumipic_torch.ops import exchange as ex

    recs = []
    for name, args in pack_inputs(dev, saved):
        want = ex.pack_send_plain(*args)[:4]
        fns = {}
        for v in versions:
            fns[f"{v.name} (fill + X2)"] = cs.x2_launcher(v.lib, ex, *args, fill=True)
            fns[f"{v.name} (X2 alone)"] = cs.x2_launcher(v.lib, ex, *args)
        D = len(args[5])
        lay = cs.leaver_layout(want[2])
        print(f"{name}: {lay['leavers']} admitted leavers, warps holding one "
              f"{lay['warp_share']:.4f}, mean run {lay['mean_run']:.2f}", flush=True)
        recs.append(timed_case(name, fns, want, {
            "slots": args[1].shape[0], "admitted": int(want[0].shape[0]),
            "width": int(want[0].shape[1]), "layout": lay,
            "bound_ms": cs.x2_bound_bytes(args[1], want[1], want[2], want[0], D)
            / cs.PEAK_BYTES_PER_S * 1e3}))
    return recs


def make_versions(others, variants: str) -> list:
    def read(d):
        return {f: open(os.path.join(d, f)).read() for f in SOURCES
                if os.path.exists(os.path.join(d, f))}

    versions = [Version(os.path.basename(os.path.normpath(d)), read(d)) for d in others]
    csrc = os.path.join(ROOT, "pumipic_torch", "kernels", "csrc")
    versions.append(Version("new", read(csrc)))
    for spec in filter(None, variants.split(";")):
        name, _, defines = spec.partition("=")
        texts = read(csrc)
        for item in defines.split(","):
            macro, _, value = item.partition(":")
            pattern = re.compile(rf"^#define {re.escape(macro)} .*$", re.M)
            hits = {f: len(pattern.findall(t)) for f, t in texts.items()}
            if sum(hits.values()) != 1:
                raise ValueError(f"variant {name}: #define {macro} found {hits}")
            texts = {f: pattern.sub(f"#define {macro} {value}", t) for f, t in texts.items()}
        versions.append(Version(f"new {name}", texts))
    return versions


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("others", help="directories of other versions, comma-separated")
    ap.add_argument("out_json", nargs="?")
    ap.add_argument("--variants", default="",
                    help="builds of this checkout's sources with #define constants "
                         "changed: NAME=DEFINE:VALUE[,DEFINE:VALUE...][;NAME=...]")
    ap.add_argument("--profile", action="store_true",
                    help="each version's kernels by name (torch.profiler)")
    ap.add_argument("--kernels", default="C,X3,X1,X2",
                    help="the kernels timed, comma-separated (C, X3, X1, X2)")
    ap.add_argument("--x2-saved", default="",
                    help="X2 also on the inputs scripts/profile_picparts.py --save-x2 "
                         "saved (a .pt file)")
    args = ap.parse_args()
    global PROFILE
    PROFILE = args.profile
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device")
    smi = cs.smi_query("name,power.limit")
    print(f"card: {smi}", flush=True)
    versions = make_versions([d for d in args.others.split(",") if d], args.variants)
    build_all(versions)
    for v in versions:
        print(v.report, flush=True)
    dev = torch.device("cuda")
    picked = set(args.kernels.split(","))
    cases = []
    for name, run in (("C", sort_cases), ("X3", place_case), ("X1", rank_cases),
                      ("X2", lambda vs, d: pack_case(vs, d, args.x2_saved))):
        if name in picked:
            cases += run(versions, dev)
    for c in cases:
        print(f"{c['case']}: bound {c['bound_ms']:.4f} ms"
              + (f", design floor {c['design_floor_ms']:.4f} ms" if "design_floor_ms" in c
                 else "")
              + (f", {c['library']} {c['library_ms']:.4f} ms" if "library_ms" in c else ""),
              flush=True)
        for vname, t in c["device_ms"].items():
            print(f"  {vname:28s} {t:9.4f} ms  {c['bound_ms'] / t:6.1%}", flush=True)
            for kname, kms in c.get("kernels", {}).get(vname, {}).items():
                print(f"      {kname:58s} {kms:8.4f}", flush=True)
    if args.out_json:
        with open(args.out_json, "w") as f:
            json.dump({"card": smi, "reps": REPS,
                       "ptxas": {v.name: cs.ptxas_functions(v.report) for v in versions},
                       "cases": cases}, f, indent=1)


if __name__ == "__main__":
    main()

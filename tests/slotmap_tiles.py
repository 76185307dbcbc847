"""numpy model of how kernel S (``pumipic_torch/kernels/csrc/slotmap.cu``)
splits the C slots of the sorted rebuild's slot map, and the corner cases
the tests hold it to.

The kernel gives each block a tile of ``SLOT_THREADS * SLOTS_PER_THREAD``
consecutive slots.  Two warps find the segments s0 and s1 of the tile's
first and last slot with 32 probes a round; the block stages offsets[s0..s1]
(in shared memory when at most ``WINDOW_CAP`` entries, else in place);
thread t takes the slots t0 + t·SLOTS_PER_THREAD + u, searching the window
for its first slot and again only where a later slot enters a later
segment.  Slots past ``needed = offsets[-1]`` belong to the last segment
like any other (the tail)."""
import re
from pathlib import Path

import numpy as np
import torch

SLOTMAP_CU = (Path(__file__).resolve().parents[1] / "pumipic_torch" / "kernels" / "csrc"
              / "slotmap.cu")


def kernel_constants() -> dict:
    """SLOT_THREADS, SLOTS_PER_THREAD and WINDOW_CAP as slotmap.cu defines
    them."""
    text = SLOTMAP_CU.read_text()
    return {k: int(re.search(rf"#define {k} (\d+)", text).group(1))
            for k in ("SLOT_THREADS", "SLOTS_PER_THREAD", "WINDOW_CAP")}


def _warp_upper_bound(off, lo: int, hi: int, j: int) -> int:
    """The first k in [lo, hi) with off[k] > j, or hi, round by round as a
    warp's 32 probes find it."""
    while lo < hi:
        step = (hi - lo + 31) // 32
        p = lo + np.arange(32) * step
        le = (p < hi) & (off[np.minimum(p, hi - 1)] <= j)
        c = int(le.sum())
        assert le[:c].all(), "probes at or below j must be a prefix of the lanes"
        if c == 0:
            return lo
        above = lo + c * step
        lo += (c - 1) * step + 1
        if above < hi:
            hi = above
    return lo


def _upper_bound(off, lo: int, hi: int, j: int) -> int:
    while lo < hi:
        mid = (lo + hi) // 2
        if off[mid] <= j:
            lo = mid + 1
        else:
            hi = mid
    return lo


def slot_map_tiles(layout, order, start, offsets, row_to_elem, chunk, C, M,
                   consts=None):
    """(src, elem_c, pre_valid, stats) of every slot as kernel S's tiles
    compute them; stats counts the tiles, the tiles whose window exceeds
    ``WINDOW_CAP`` and the tiles a segment spans.  Every slot must be
    written exactly once."""
    k = consts or kernel_constants()
    threads, per = k["SLOT_THREADS"], k["SLOTS_PER_THREAD"]
    tile = threads * per
    order, start, off = (np.asarray(a, np.int64) for a in (order, start, offsets))
    r2e = None if row_to_elem is None else np.asarray(row_to_elem, np.int64)
    n_seg, E = off.size - 1, start.size - 1
    needed = off[n_seg]
    src = np.zeros(C, np.int64)
    elem_c = np.zeros(C, np.int64)
    pre_valid = np.zeros(C, bool)
    written = np.zeros(C, np.int64)
    n_tiles = -(-C // tile)
    stats = {"tiles": n_tiles, "windows_over_cap": 0, "longest_segment_tiles": 0}
    seg_tiles = {}
    for t in range(n_tiles):
        t0 = t * tile
        t_last = min(t0 + tile, C) - 1
        s0 = _warp_upper_bound(off, 1, n_seg, t0) - 1
        s1 = _warp_upper_bound(off, 1, n_seg, t_last) - 1
        stats["windows_over_cap"] += int(s1 - s0 + 1 > k["WINDOW_CAP"])
        for s in range(s0, s1 + 1):
            seg_tiles[s] = seg_tiles.get(s, 0) + 1
        for th in range(threads):
            j0 = t0 + th * per
            if j0 >= C:
                break
            s = _upper_bound(off, s0 + 1, s1 + 1, j0) - 1
            for u in range(per):
                j = j0 + u
                if s < s1 and off[s + 1] <= j:
                    s = _upper_bound(off, s + 2, s1 + 1, j) - 1
                o = j - off[s]
                if layout == "cabm":
                    elem_j, rank = s, o
                else:
                    rank, lr = divmod(o, chunk)
                    elem_j = r2e[min(s * chunk + lr, r2e.size - 1)]
                ec = min(max(elem_j, 0), E - 1)
                pos0 = start[ec] + rank
                if j < C:
                    written[j] += 1
                    src[j] = order[min(pos0, M - 1)]
                    elem_c[j] = ec
                    pre_valid[j] = (0 <= elem_j < E and rank >= 0 and j < needed
                                    and pos0 <= M - 1)
    assert (written == 1).all(), "each slot is written by exactly one thread"
    stats["longest_segment_tiles"] = max(seg_tiles.values(), default=0)
    return src, elem_c, pre_valid, stats


# corner cases: name -> (E, per-element counts rule); every case also runs
# with needed < C (a tail), needed == C and needed > C (overflow)
SLOT_CASES = ("wide segment", "empty segments", "sparse window")
SLOT_FILLS = ("tail", "exact", "overflow")


def slot_inputs(layout: str, case: str, fill: str, chunk: int = 8, seed: int = 0,
                device="cpu"):
    """(order, start, offsets, row_to_elem, C, M) of one corner case:

    - "wide segment": E = 97 (SCS: pad rows 97..103), one element holding
      half of 3,000 particles, so its segment spans several tiles;
    - "empty segments": E = 400 over 300 particles, most elements empty
      (repeated offsets; SCS chunks of width 0);
    - "sparse window": E = 9,001 (SCS: 1,126 chunks, pad rows) with
      particles only in the first and last ten elements, so one tile's
      window holds more segments than WINDOW_CAP.

    C is needed + 13 ("tail"), needed ("exact") or needed - 37
    ("overflow")."""
    from pumipic_torch.particles import structure as st

    rng = np.random.default_rng(seed)
    if case == "wide segment":
        E, elems = 97, rng.integers(0, 97, 3000)
        elems[rng.uniform(size=elems.size) < 0.5] = 41
    elif case == "empty segments":
        E, elems = 400, rng.integers(0, 400, 300) // 7 * 7
    else:
        E = 9001
        elems = np.concatenate([rng.integers(0, 10, 300), rng.integers(E - 10, E, 300)])
    elems = np.concatenate([elems, -np.ones(50, np.int64)])      # inactive rows
    elems = elems[rng.permutation(elems.size)].astype(np.int32)
    M = elems.size
    counts = np.bincount(elems[elems >= 0], minlength=E).astype(np.int32)
    key = np.where(elems >= 0, elems, E)
    order = np.argsort(key, kind="stable").astype(np.int32)
    start = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    if layout == "cabm":
        seg = -(-counts // chunk) * chunk
        r2e = None
    else:
        r2e_t, _, cw = st._scs_row_order(torch.as_tensor(counts), 2**30, chunk, E)
        r2e, seg = r2e_t.numpy(), chunk * cw.numpy()
    offsets = np.concatenate([[0], np.cumsum(seg)]).astype(np.int32)
    needed = int(offsets[-1])
    C = {"tail": needed + 13, "exact": needed, "overflow": needed - 37}[fill]
    dev = torch.device(device)
    t = lambda a: None if a is None else torch.as_tensor(a, device=dev)  # noqa: E731
    return t(order), t(start), t(offsets), t(r2e), C, M

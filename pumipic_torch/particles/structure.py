"""Mesh-aware particle containers (port of ``pumipic_tpu.particles.structure``).

Reference parity (``particle_structs/src/``): the abstract
``ParticleStructure<DataTypes>`` (particle_structure.hpp:18-144) and its four
layouts — **SellCSigma** (Sell-C-σ: elements sorted by particle count within
σ windows, grouped into chunks of C rows, each chunk padded to its longest
row, particles stored transposed within a chunk), **CSR** (dense
element-sorted), **CabM** (element-sorted, each segment padded to the SoA
width) and **DPS** (unsorted, parent element per particle).

As in the JAX package, all four are one structure: a fixed-capacity
structure of arrays with an ``active`` mask, a per-slot parent element, and
a layout policy that decides which slot each particle takes at rebuild.  A
frozen dataclass of tensors stands in for the pytree; every update returns a
new structure.  ``num_ptcls`` and ``overflowed`` stay 0-d device tensors, so
a ``rebuild`` never waits for the host (``mode="auto"`` does: it reads the
fits check to pick reshuffle or sort).  One update is in place, where that
saves memory: the reshuffle of ``mode="auto"`` writes the movers' rows into
the structure's own field tensors (see :meth:`ParticleStructure.rebuild`).

Kernels on the card: the stable element sort of every sorted rebuild and
of ``get_pids`` is kernel C, the destinations' check and count of every
rebuild and the output mask and count of the sorted ones are kernel Q
(``ops/rebuild.py``), the slot map of the sorted SCS/CabM rebuild is kernel
S, every field move is kernel G (columns form: the fields in place plus the
key lane), particles per element is kernel H.  The SCS row order is kernel
C over kernel Z's row key, then Z's maps; the reshuffle of
``mode="auto"`` is kernel U1 (split, counts, fits, mover list), C (the
movers by destination), G (their rows staged) and U2 (placement).  The
offsets' cumsums are torch calls at element rate.

Knobs the JAX package needs only on the TPU are accepted and mapped onto the
one GPU path: ``PACKED_REBUILD_GATHER`` and ``PACKED_REBUILD_BYTES_LIMIT``
(the pack exists to cut the TPU's fixed cost per gather; kernel G moves the
fields in place, with or without it); slot validity always comes from the
gathered key lane (the JAX package's ``SCS_VALID_FROM_KEYLANE``).  Fields
whose rows are not whole 4-byte words (1- and 2-byte dtypes) move by torch
indexing, as the JAX package moves them by per-field gathers outside its
pack.

Capacity: construction sizes capacity = max(num_ptcls × padding, minimum);
a rebuild whose survivors exceed capacity sets ``overflowed`` — sticky, so a
later fitting rebuild cannot hide a loss.  :func:`rebuild_checked` retries
from the pre-rebuild state on a grown structure; :func:`grow_if_overflowed`
only adds headroom for future rebuilds.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from pumipic_torch.ops import rebuild as rebuild_ops
from pumipic_torch.ops import rows as rows_ops
from pumipic_torch.utils.device import resolve_device
from pumipic_torch.utils.types import LID_DTYPE, round_up

LID = LID_DTYPE


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def create_member_fields(capacity: int, spec: Dict[str, Tuple[tuple, object]],
                         device=None):
    """``createMemberViews`` analog (MemberTypeLibraries.h:33-41): a zeroed
    field dict from {name: (inner_shape, dtype)} (torch dtypes)."""
    device = resolve_device(device)
    return {name: torch.zeros((capacity,) + tuple(shape), dtype=dtype, device=device)
            for name, (shape, dtype) in spec.items()}


@dataclass(frozen=True)
class SCSInput:
    """Sell-C-σ tuning (scs/scs_input.hpp:15-64); same fields and defaults
    as the JAX package's.  ``extra_padding`` reserves ~extra_padding×N more
    slots per element (``pad_strategy``: evenly | proportionally |
    inversely) so the reshuffle path has holes; ``padding_factor`` is the
    capacity floor as a multiple of the particle count."""

    chunk_size: int = 8
    sigma: Optional[int] = None
    vertical_slice: int = 64
    extra_padding: float = 0.0
    pad_strategy: str = "proportionally"
    padding_factor: float = 1.2


@dataclass(frozen=True)
class ParticleStructure:
    """Fixed-capacity SoA particle container (all layouts).

    Slots ``[0, capacity)``; ``active[s]`` marks live particles; ``elem[s]``
    is the parent element (-1 where inactive).  CSR/CabM hold the (E+1,)
    slot offsets per element in ``elem_offsets``; SCS holds the (E,) slot of
    each element's rank-0 particle, plus its row order; DPS holds None.
    """

    fields: Dict[str, torch.Tensor]
    elem: torch.Tensor            # (C,) int32
    active: torch.Tensor          # (C,) bool
    num_ptcls: torch.Tensor       # () int32
    elem_offsets: Optional[torch.Tensor]
    row_to_elem: Optional[torch.Tensor]    # (R,) SCS row order
    elem_to_row: Optional[torch.Tensor]    # (E,)
    overflowed: torch.Tensor      # () bool — a rebuild has EVER dropped particles
    # per-element slot capacity of the current layout (scs: chunk width of
    # the element's chunk; cabm: padded segment width); None for dps/csr
    # and before the first rebuild
    seg_cap: Optional[torch.Tensor] = None
    num_elems: int = 0
    capacity: int = 0
    layout: str = "dps"            # dps | csr | cabm | scs
    soa_width: int = 8             # CabM SoA width
    chunk_size: int = 8            # SCS C
    sigma: int = 2**30             # SCS σ
    scs_extra_padding: float = 0.0
    scs_pad_strategy: str = "proportionally"
    cabm_extra_padding: float = 0.0
    name: str = "ptcls"

    # ---------------------------------------------------------------- API
    @property
    def device(self) -> torch.device:
        return self.elem.device

    def get(self, key) -> torch.Tensor:
        """``ps->get<N>()`` analog; accepts field name or index."""
        if isinstance(key, int):
            return self.fields[list(self.fields.keys())[key]]
        return self.fields[key]

    def set(self, key, value) -> "ParticleStructure":
        name = list(self.fields.keys())[key] if isinstance(key, int) else key
        f = dict(self.fields)
        f[name] = value
        return dataclasses.replace(self, fields=f)

    def n_ptcls(self) -> int:
        return int(self.num_ptcls)

    @property
    def n_elems(self) -> int:
        return self.num_elems

    def num_rows(self) -> int:
        """numRows: padded row count (SCS pads to a chunk multiple)."""
        if self.layout == "scs":
            return round_up(self.num_elems, self.chunk_size)
        return self.num_elems

    def map(self, fn: Callable, *extra) -> "ParticleStructure":
        """``ps::parallel_for`` analog: ``fn(elem, active, fields, *extra)``
        returns a dict of updated field tensors (missing keys unchanged)."""
        updates = fn(self.elem, self.active, self.fields, *extra)
        f = dict(self.fields)
        f.update(updates)
        return dataclasses.replace(self, fields=f)

    def ppe(self) -> torch.Tensor:
        """Particles per element (E,) int32 (kernel H on the card)."""
        from pumipic_torch.ops.scatter import histogram

        return histogram(self.elem, self.active, self.num_elems)

    def get_pids(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """getPIDs analog (ps_for.hpp:63-85): element-sorted slot ids +
        per-element offsets (inactive slots sorted to the tail)."""
        order, _ = rebuild_ops.masked_key_sort(self.elem, self.active, self.num_elems)
        counts = self.ppe()
        offsets = torch.cat([counts.new_zeros(1),
                             torch.cumsum(counts, 0, dtype=counts.dtype)])
        return order, offsets

    def copy_to_host(self) -> Dict[str, np.ndarray]:
        """``copy<HostSpace>()`` analog: materialize to numpy."""
        out = {k: v.cpu().numpy() for k, v in self.fields.items()}
        out["elem"] = self.elem.cpu().numpy()
        out["active"] = self.active.cpu().numpy()
        return out

    # ------------------------------------------------------------- rebuild
    def rebuild(self, new_elem: torch.Tensor,
                new_ptcl_elems: Optional[torch.Tensor] = None,
                new_ptcl_fields: Optional[Dict[str, torch.Tensor]] = None,
                mode: str = "sort") -> "ParticleStructure":
        """Reassign particles to elements; negative or out-of-range
        ``new_elem`` removes.  Optionally appends a batch of new particles
        (active where ``new_ptcl_elems`` is in range).  ``mode="sort"`` is
        the full re-construction; ``mode="auto"`` first tries the in-place
        reshuffle (scs/cabm, no additions) and falls back to the sort when
        the new counts do not fit the current layout.

        In place: where the reshuffle runs (it moves at least one
        particle), the movers' rows are written into this structure's field
        tensors themselves, which the new structure shares; its ``elem``,
        ``active`` and counts are new tensors.  This structure's fields then
        hold the new layout's rows in the filled slots, so a caller that
        reads the old structure's fields after the rebuild (or shares a
        field tensor with other code, e.g. through :meth:`set`) copies them
        first.  The sort rebuild writes new tensors."""
        return _rebuild(self, new_elem, new_ptcl_elems, new_ptcl_fields,
                        mode=mode)

    def migrate(self, new_elem: torch.Tensor, new_process: torch.Tensor,
                my_rank: int = 0) -> "ParticleStructure":
        """Single-process semantics of ``ps->migrate``: particles assigned
        to another process are removed; the rest rebuild."""
        keep = new_process == my_rank
        return self.rebuild(torch.where(keep, new_elem, -1))

    # ------------------------------------------------------------- metrics
    def metrics(self) -> Dict[str, torch.Tensor]:
        """printMetrics analog (SellCSigma.h:465-524): padded-slot fraction
        and empty rows (device tensors)."""
        counts = self.ppe()
        n = self.num_ptcls
        cap = torch.tensor(self.capacity, dtype=torch.int32, device=self.device)
        return {
            "num_ptcls": n,
            "capacity": cap,
            "padded_fraction": 1.0 - n / torch.clamp(cap, min=1),
            "empty_rows": torch.sum(counts == 0),
        }

    def print_format(self, max_elems: int = 32) -> str:
        """printFormat analog (SellCSigma.h:403-463): per element, the slots
        its particles occupy."""
        from pumipic_torch.utils.plog import print_info

        h = self.copy_to_host()
        lines = [f"{self.name} ({self.layout}) capacity={self.capacity} "
                 f"nPtcls={int(h['active'].sum())}"]
        live = np.flatnonzero(h["active"])
        live_elem = h["elem"][live]
        shown = min(self.num_elems, max_elems)
        sel = live_elem < shown
        order = np.argsort(live_elem[sel], kind="stable")
        sl, se = live[sel][order], live_elem[sel][order]
        starts = np.searchsorted(se, np.arange(shown + 1))
        for e in range(shown):
            slots = sl[starts[e]:starts[e + 1]]
            lines.append(
                f"  elem {e:>6d}: {len(slots):>4d} ptcls @ {slots[:16].tolist()}")
        out = "\n".join(lines)
        print_info("%s", out)
        return out

    def print_metrics(self) -> None:
        from pumipic_torch.utils.plog import print_info

        m = {k: (float(v) if "fraction" in k else int(v))
             for k, v in self.metrics().items()}
        print_info(
            "%s (%s): nPtcls %d capacity %d padded %.1f%% emptyRows %d",
            self.name, self.layout, m["num_ptcls"], m["capacity"],
            100 * m["padded_fraction"], m["empty_rows"],
        )


# ---------------------------------------------------------------------------
# layout machinery
# ---------------------------------------------------------------------------

def _scs_pad_counts(counts, extra_padding: float, strategy: str):
    """Per-element extra padding (scs_input.hpp:4-11): reserve
    ~extra_padding×N more slots so holes exist for the reshuffle path.
    Takes int32 tensors (in the rebuild) or numpy arrays (host capacity
    sizing), in the JAX package's f32 order; divisors of tensors are 0-d
    tensors (torch's CUDA division by a Python scalar multiplies by its
    reciprocal)."""
    if extra_padding <= 0.0:
        return counts
    if isinstance(counts, np.ndarray):
        total = np.sum(counts)
        if strategy == "evenly":
            E = max(counts.shape[0], 1)
            pad_val = np.ceil(
                total.astype(np.float32) * extra_padding / E).astype(counts.dtype)
            pad = np.zeros_like(counts) + pad_val
        elif strategy == "inversely":
            w = 1.0 / (counts.astype(np.float32) + 1.0)
            pad = np.ceil(extra_padding * total.astype(np.float32) * w
                          / np.sum(w)).astype(counts.dtype)
        else:  # proportionally
            pad = np.ceil(counts * (extra_padding * 1.0)).astype(counts.dtype)
        return counts + pad
    f32 = torch.float32
    total = torch.sum(counts).to(f32)
    if strategy == "evenly":
        E = max(counts.shape[0], 1)
        pad_val = torch.ceil(total * extra_padding / total.new_full((), E)).to(counts.dtype)
        pad = torch.zeros_like(counts) + pad_val
    elif strategy == "inversely":
        w = 1.0 / (counts.to(f32) + 1.0)
        pad = torch.ceil(extra_padding * total * w / torch.sum(w)).to(counts.dtype)
    else:
        pad = torch.ceil(counts * (extra_padding * 1.0)).to(counts.dtype)
    return counts + pad


def _scs_count_bits(num_ptcls: int, extra_padding: float) -> int:
    """Bits that hold every padded count of ``num_ptcls`` particles: a
    count is at most num_ptcls, its pad at most extra_padding·num_ptcls + 1
    (rounded up in f32)."""
    pad = int(num_ptcls * max(extra_padding, 0.0) * (1.0 + 1e-6)) + 2
    return max((num_ptcls + pad).bit_length(), 1)


def _scs_key_bits(nwin: int, num_elems: int, num_ptcls: int,
                  extra_padding: float) -> int:
    """The count bits b of the Sell-C-σ row key: over windows, every
    padded count of ``num_ptcls`` particles; in one window, 8x the mean
    count (a larger count's key is negative and still sorts first).  Only
    the plain version's key reads it: kernel Z takes its bits from the
    counts."""
    if nwin == 1:
        return min(max((8 * -(-num_ptcls // max(num_elems, 1))).bit_length(), 1), 30)
    return min(_scs_count_bits(num_ptcls, extra_padding), 30)


def _scs_row_order(counts: torch.Tensor, sigma: int, chunk: int,
                   num_elems: int, extra_padding: float = 0.0,
                   pad_strategy: str = "proportionally",
                   num_ptcls: Optional[int] = None):
    """Sigma-sort elements by descending count within windows of σ, pad rows
    to a chunk multiple.  Returns (row_to_elem (R,), elem_to_row (E,),
    chunk_width (R/chunk,)) (SCS_sort.h:3-49, SCS_buildFns.h:18-100).

    Kernel Z on the card (``ops.rebuild.scs_row_order``: one launch);
    its plain version on the CPU sorts one key a row, window·2^(b+1) +
    (2^b - 1 - count), the padding rows' count -1, b from
    :func:`_scs_key_bits` for ``num_ptcls`` particles (2^29 where None)."""
    counts = _scs_pad_counts(counts, extra_padding, pad_strategy).to(LID)
    E = num_elems
    R = round_up(max(E, 1), chunk)
    sigma = min(sigma, R)
    nwin = -(-R // sigma)
    bound = num_ptcls if num_ptcls is not None else 2**29
    bits = _scs_key_bits(nwin, E, bound, extra_padding)
    return rebuild_ops.scs_row_order(counts, R, sigma, chunk, bits)


# Accepted for API parity with the JAX package and mapped onto kernel G's
# columns form (see the module docstring): they change no result.
PACKED_REBUILD_GATHER = True
PACKED_REBUILD_BYTES_LIMIT = 1.5e9


def _gather_fields(fields, take, extra=()):
    """out[j] = in[take[j]] for every field, plus ``extra`` (M,) 4-byte
    columns riding the same rows.  Returns (out_fields, out_extra).  Every
    array whose rows are whole 4-byte words moves through one kernel G
    launch (columns form, sharing ``take``); others by torch indexing."""
    take = take.to(LID)
    names = list(fields)
    cols = [fields[k] for k in names] + list(extra)
    wide = [i for i, c in enumerate(cols) if rows_ops.lanes_of(c) > 0]
    out = [None] * len(cols)
    if wide:
        moved = rows_ops.row_gather([cols[i].contiguous() for i in wide], take)
        for i, m in zip(wide, moved):
            out[i] = m
    for i, c in enumerate(cols):
        if out[i] is None:
            out[i] = c[take.long()]
    return dict(zip(names, out[:len(names)])), tuple(out[len(names):])


def _rebuild(ps: ParticleStructure, new_elem: torch.Tensor,
             new_ptcl_elems: Optional[torch.Tensor],
             new_ptcl_fields: Optional[Dict[str, torch.Tensor]],
             mode: str = "sort") -> ParticleStructure:
    from pumipic_torch.ops.scatter import histogram

    C = ps.capacity
    dev = ps.device
    # out-of-range destinations (>= num_elems) are removals, exactly like
    # negatives, in every layout
    ne = torch.as_tensor(new_elem, device=dev).to(LID).contiguous()
    elem, active, n_kept = rebuild_ops.rebuild_mask_dps(ne, ps.active, ps.num_elems)
    fields = ps.fields

    if ps.layout == "dps" and new_ptcl_elems is None:
        # DPS rebuild (dps_rebuild.hpp): rewrite parent element and
        # activity in place; no sorting, no field movement
        return dataclasses.replace(ps, elem=elem, active=active, num_ptcls=n_kept)

    if new_ptcl_elems is not None:
        ape = torch.as_tensor(new_ptcl_elems, device=dev).to(LID)
        ape = torch.where(ape < ps.num_elems, ape, -1)
        elem = torch.cat([elem, ape])
        active = torch.cat([active, ape >= 0])
        fields = {k: torch.cat([v, torch.as_tensor(new_ptcl_fields[k], device=dev)])
                  for k, v in fields.items()}

    if ps.layout in ("csr", "dps"):
        # gather formulation: the stable sorted order IS the slot order
        E = ps.num_elems
        if ps.layout == "csr":
            order, key = rebuild_ops.masked_key_sort(elem, active, E, keep_key=True)
            counts = histogram(elem, active, E)
            start = torch.cat([counts.new_zeros(1),
                               torch.cumsum(counts, 0, dtype=LID)])
            elem_offsets = start
            needed = start[E]
        else:
            key = elem
            order, _ = rebuild_ops.masked_key_sort(None, active, 1)
            elem_offsets = None
            needed = torch.sum(active, dtype=LID)
        take = order[:C]
        out_fields, (sk,) = _gather_fields(fields, take, extra=(key,))
        # count the OUTPUT mask: under overflow the input count exceeds the
        # placed survivors
        out_elem, out_active, n = rebuild_ops.rebuild_mask_prefix(sk, needed)
        return dataclasses.replace(
            ps, fields=out_fields, elem=out_elem, active=out_active, num_ptcls=n,
            elem_offsets=elem_offsets, row_to_elem=None, elem_to_row=None,
            overflowed=ps.overflowed | (needed > C))

    if (mode == "auto" and new_ptcl_elems is None and ps.seg_cap is not None
            and ps.num_elems > 0):
        return _rebuild_auto(ps, elem, active)
    return _rebuild_sorted(ps, elem, active, fields)


def _rebuild_sorted(ps: ParticleStructure, elem: torch.Tensor,
                    active: torch.Tensor,
                    fields: Dict[str, torch.Tensor]) -> ParticleStructure:
    """Full re-construction for SCS/CabM, gather formulation: a stable
    element sort, the per-element counts (kernel H), the slot map (kernel
    S), then one gather of every field plus the key lane (kernel G); a slot
    holds its particle iff the gathered key equals the slot's element."""
    from pumipic_torch.ops.scatter import histogram

    C = ps.capacity
    dev = ps.device
    E, M = ps.num_elems, elem.shape[0]
    order, key = rebuild_ops.masked_key_sort(elem, active, E, keep_key=True)
    counts = histogram(elem, active, E)
    start = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0, dtype=LID)])

    if ps.layout == "cabm":
        counts_eff = _scs_pad_counts(counts, ps.cabm_extra_padding,
                                     "proportionally")
        seg = ((counts_eff + ps.soa_width - 1) // ps.soa_width) * ps.soa_width
        offsets = torch.cat([seg.new_zeros(1), torch.cumsum(seg, 0, dtype=LID)])
        src, elem_c, pre_valid = rows_ops.slot_map(
            "cabm", order, start, offsets, None, 1, C, M)
        elem_offsets = offsets
        row_to_elem = elem_to_row = None
        seg_cap = seg.to(LID)
        needed = offsets[E]
    else:  # scs
        chunk = ps.chunk_size
        row_to_elem, elem_to_row, chunk_width = _scs_row_order(
            counts, ps.sigma, chunk, E, ps.scs_extra_padding,
            ps.scs_pad_strategy, num_ptcls=M)
        nchunks = chunk_width.shape[0]
        chunk_off = torch.cat([chunk_width.new_zeros(1),
                               torch.cumsum(chunk * chunk_width, 0, dtype=LID)])
        src, elem_c, pre_valid = rows_ops.slot_map(
            "scs", order, start, chunk_off, row_to_elem, chunk, C, M)
        if E > 0:
            e2c = torch.div(elem_to_row, chunk, rounding_mode="floor").long()
            elem_offsets = (chunk_off[e2c] + elem_to_row % chunk).to(LID)
            seg_cap = chunk_width[e2c].to(LID)
        else:
            elem_offsets = seg_cap = torch.zeros(0, dtype=LID, device=dev)
        needed = chunk_off[nchunks]

    # padding-slot validity from the gathered particle's own key: segments
    # are key-sorted, so a rank past the element's count lands on a larger
    # key (or the E sentinel)
    out_fields, (key_src,) = _gather_fields(fields, src, extra=(key,))
    out_elem, valid, n = rebuild_ops.rebuild_mask_epilogue(pre_valid, key_src, elem_c)
    return dataclasses.replace(
        ps, fields=out_fields, elem=out_elem, active=valid, num_ptcls=n,
        elem_offsets=elem_offsets, row_to_elem=row_to_elem,
        elem_to_row=elem_to_row, seg_cap=seg_cap,
        overflowed=ps.overflowed | (needed > C))


# Static mover budget of the reshuffle path, as a fraction of capacity; a
# step that moves more particles falls back to the sort rebuild.
RESHUFFLE_MOVER_FRACTION = 0.125


def _reshuffle_mover_budget(capacity: int) -> int:
    return min(capacity, round_up(
        max(1024, int(capacity * RESHUFFLE_MOVER_FRACTION)), 8))


def _rebuild_auto(ps: ParticleStructure, elem: torch.Tensor,
                  active: torch.Tensor) -> ParticleStructure:
    """Reshuffle-or-rebuild (SCS_rebuild.h:3-120): keep every unmoved
    particle in its slot and place only the movers into free slots of their
    destination segments; fall back to the sort re-construction when the
    new counts don't fit the current layout.  The split, the counts and the
    fits check are kernel U1; the host reads (fits, n_mov) once."""
    MB = _reshuffle_mover_budget(ps.capacity)
    counted = rebuild_ops.reshuffle_count(elem, ps.elem, ps.seg_cap, MB)
    fits, n_mov = counted.info.tolist()
    if fits:
        return _reshuffle(ps, elem, active, counted, n_mov)
    return _rebuild_sorted(ps, elem, active, ps.fields)


def _reshuffle(ps: ParticleStructure, elem, active, counted, n_mov: int
               ) -> ParticleStructure:
    """In-place reshuffle (fits already verified): the movers (U1's list,
    in slot order) grouped by destination, stable, by kernel U3 on U1's
    starts, which writes their slots in that order; their rows staged by kernel G
    (a mover's source slot can be another mover's destination); then
    kernel U2 walks each segment's slots in q order (a Sell-C-σ chunk's
    rows together, 32 consecutive slots a round; the segment for CabM),
    gives the r-th hole of element e the r-th staged mover of e and writes
    its rows into ``ps``'s field tensors IN PLACE (a field that is not
    contiguous is replaced by a contiguous copy first); the new structure
    shares them.  With no movers the destinations' check (kernel Q) is the
    result: every kept particle stays."""
    if n_mov == 0:
        return dataclasses.replace(ps, elem=elem, active=active, num_ptcls=counted.num)
    take = rebuild_ops.reshuffle_order(counted.mkey[:n_mov], counted.msrc[:n_mov],
                                       counted.mov_start)
    fields = {k: v.contiguous() for k, v in ps.fields.items()}
    staged, _ = _gather_fields(fields, take)
    stride = ps.chunk_size if ps.layout == "scs" else 1
    new_elem, new_active, new_fields, n, ovf = rebuild_ops.reshuffle_place(
        elem, ps.elem, ps.elem_offsets, ps.seg_cap, counted.mov_cnt, counted.mov_start,
        fields, staged, stride, ps.overflowed, ps.row_to_elem)
    return dataclasses.replace(ps, fields=new_fields, elem=new_elem,
                               active=new_active, num_ptcls=n, overflowed=ovf)


# ---------------------------------------------------------------------------
# constructors
# ---------------------------------------------------------------------------

def _build(layout: str, num_elems: int, ptcl_elems, fields, field_spec,
           capacity: Optional[int], padding_factor: float, name: str, device,
           **layout_kw) -> ParticleStructure:
    """Common constructor: place ``len(ptcl_elems)`` particles (elem ids may
    be -1 for none) into a fresh structure on ``device``."""
    device = resolve_device(device)
    ptcl_elems = torch.as_tensor(_host(ptcl_elems).astype(np.int32), device=device)
    n = ptcl_elems.shape[0]
    for reserved in ("elem", "active"):
        if (fields is not None and reserved in fields) or (
                field_spec is not None and reserved in field_spec):
            raise ValueError(f"{name}: member field name {reserved!r} is reserved")
    if capacity is None:
        capacity = max(int(n * padding_factor), n + 8, 64)
    capacity = round_up(capacity, 8)

    if fields is None:
        fields = create_member_fields(n, field_spec or {}, device)
    fields = {k: torch.as_tensor(v, device=device) for k, v in fields.items()}
    empty = ParticleStructure(
        fields={k: torch.zeros((capacity,) + tuple(v.shape[1:]), dtype=v.dtype,
                               device=device) for k, v in fields.items()},
        elem=torch.full((capacity,), -1, dtype=LID, device=device),
        active=torch.zeros(capacity, dtype=torch.bool, device=device),
        num_ptcls=torch.zeros((), dtype=torch.int32, device=device),
        elem_offsets=None, row_to_elem=None, elem_to_row=None,
        overflowed=torch.zeros((), dtype=torch.bool, device=device),
        num_elems=num_elems, capacity=capacity, layout=layout, name=name,
        **layout_kw)
    if n == 0:
        return empty
    ps = empty.rebuild(torch.full((capacity,), -1, dtype=LID, device=device),
                       new_ptcl_elems=ptcl_elems, new_ptcl_fields=fields)
    if bool(ps.overflowed):
        raise ValueError(f"{name}: initial particles need more than capacity {capacity}")
    return ps


def DPS(num_elems, ptcl_elems, fields=None, field_spec=None, capacity=None,
        padding_factor=1.2, name="ptcls", device=None):
    """Unsorted flat container (dps/dps.hpp:15-418)."""
    return _build("dps", num_elems, ptcl_elems, fields, field_spec, capacity,
                  padding_factor, name, device)


def CSR(num_elems, ptcl_elems, fields=None, field_spec=None, capacity=None,
        padding_factor=1.2, name="ptcls", device=None):
    """Element-sorted CSR container (csr/CSR.hpp:16-113)."""
    return _build("csr", num_elems, ptcl_elems, fields, field_spec, capacity,
                  padding_factor, name, device)


def CabM(num_elems, ptcl_elems, fields=None, field_spec=None, capacity=None,
         padding_factor=1.2, soa_width=8, extra_padding=0.0, name="ptcls",
         device=None):
    """AoSoA-flavoured container: element segments padded to the SoA width
    (cabm/cabm.hpp:15-186).  Capacity sizes from the SoA-padded layout
    (×1.1) with a ``padding_factor``×N floor; ``extra_padding`` reserves
    per-segment headroom for the reshuffle path."""
    if capacity is None:
        pe = _host(ptcl_elems)
        ppe = np.bincount(pe[pe >= 0], minlength=num_elems)
        ppe = _scs_pad_counts(ppe.astype(np.int64), extra_padding, "proportionally")
        needed = int((((ppe + soa_width - 1) // soa_width) * soa_width).sum())
        n = int((pe >= 0).sum())
        capacity = max(int(needed * 1.1) + 8, int(n * padding_factor), 64)
    return _build("cabm", num_elems, ptcl_elems, fields, field_spec, capacity,
                  padding_factor, name, device, soa_width=soa_width,
                  cabm_extra_padding=extra_padding)


def scs_layout_size(ppe: np.ndarray, chunk: int, sigma: int,
                    extra_padding: float = 0.0,
                    pad_strategy: str = "proportionally") -> int:
    """Host-side padded slot count of the Sell-C-σ layout for given
    particles-per-element (the reference sizes capacity from
    ``constructOffsets``'s final entry)."""
    E = len(ppe)
    ppe = _scs_pad_counts(np.asarray(ppe, np.int64), extra_padding, pad_strategy)
    R = round_up(max(E, 1), chunk)
    sigma = min(sigma, R)
    cpad = np.full(R, -1, np.int64)
    cpad[:E] = ppe
    nwin = -(-R // sigma)
    cpad2 = np.full(nwin * sigma, -1, np.int64)
    cpad2[:R] = cpad
    win = np.sort(cpad2.reshape(nwin, sigma), axis=1)[:, ::-1]
    counts = np.maximum(win.reshape(-1)[:R], 0)
    chunk_width = counts.reshape(R // chunk, chunk).max(axis=1)
    return int((chunk * chunk_width).sum())


def SellCSigma(num_elems, ptcl_elems, fields=None, field_spec=None,
               capacity=None, scs_input: SCSInput = SCSInput(), name="ptcls",
               device=None):
    """Sell-C-σ container (scs/SellCSigma.h:25-227)."""
    sigma = scs_input.sigma if scs_input.sigma is not None else 2**30
    if capacity is None:
        pe = _host(ptcl_elems)
        ppe = np.bincount(pe[pe >= 0], minlength=num_elems)
        needed = scs_layout_size(ppe, scs_input.chunk_size, sigma,
                                 scs_input.extra_padding, scs_input.pad_strategy)
        n = int((pe >= 0).sum())
        capacity = max(int(needed * 1.1) + 8, int(n * scs_input.padding_factor), 64)
    return _build(
        "scs", num_elems, ptcl_elems, fields, field_spec, capacity,
        scs_input.padding_factor, name, device,
        chunk_size=scs_input.chunk_size, sigma=sigma,
        scs_extra_padding=scs_input.extra_padding,
        scs_pad_strategy=scs_input.pad_strategy)


def rebuild_checked(ps: ParticleStructure, new_elem: torch.Tensor,
                    new_ptcl_elems: Optional[torch.Tensor] = None,
                    new_ptcl_fields: Optional[Dict[str, torch.Tensor]] = None,
                    growth: float = 1.5) -> ParticleStructure:
    """Host-side rebuild that recovers from overflow without data loss: an
    overflowed rebuild is re-issued on a larger structure built from the
    pre-rebuild state, whose constructor sizes capacity from the survivors
    and additions, so one retry cannot overflow again."""
    out = ps.rebuild(new_elem, new_ptcl_elems, new_ptcl_fields)
    if not bool(out.overflowed):
        return out
    # ``overflowed`` is sticky, so decide the retry on THIS call's
    # arithmetic: did every expected survivor land?
    dev = ps.device
    ne = torch.as_tensor(new_elem, device=dev).to(LID)
    expected = int(torch.sum(ps.active & (ne >= 0) & (ne < ps.num_elems)))
    if new_ptcl_elems is not None:
        ape = torch.as_tensor(new_ptcl_elems, device=dev).to(LID)
        expected += int(torch.sum((ape >= 0) & (ape < ps.num_elems)))
    if int(out.num_ptcls) == expected:
        return out

    h = ps.copy_to_host()
    ne = _host(new_elem)
    keep = h["active"] & (ne >= 0)
    elems = ne[keep]
    fields = {k: v[keep] for k, v in h.items() if k not in ("elem", "active")}
    if new_ptcl_elems is not None:
        ane = _host(new_ptcl_elems)
        akeep = ane >= 0
        elems = np.concatenate([elems, ane[akeep]])
        fields = {k: np.concatenate([v, _host(new_ptcl_fields[k])[akeep]])
                  for k, v in fields.items()}
    fields = {k: torch.as_tensor(v, device=dev) for k, v in fields.items()}
    n = len(elems)
    cap_hint = max(int(ps.capacity * growth), int(n * growth)) + 64
    if ps.layout == "scs":
        out = SellCSigma(
            ps.num_elems, elems, fields=fields, capacity=None,
            scs_input=SCSInput(chunk_size=ps.chunk_size, sigma=ps.sigma,
                               padding_factor=growth,
                               extra_padding=ps.scs_extra_padding,
                               pad_strategy=ps.scs_pad_strategy),
            name=ps.name, device=dev)
    elif ps.layout == "cabm":
        out = CabM(ps.num_elems, elems, fields=fields, capacity=None,
                   padding_factor=growth, soa_width=ps.soa_width,
                   extra_padding=ps.cabm_extra_padding, name=ps.name, device=dev)
    else:
        builder = {"dps": DPS, "csr": CSR}[ps.layout]
        out = builder(ps.num_elems, elems, fields=fields, capacity=cap_hint,
                      name=ps.name, device=dev)
    # the retry is lossless from the pre-rebuild state, but earlier sticky
    # history must survive it
    return dataclasses.replace(out, overflowed=out.overflowed | ps.overflowed)


def _grow(ps: ParticleStructure, growth: float) -> ParticleStructure:
    dev = ps.device
    host = ps.copy_to_host()
    elems = np.where(host["active"], host["elem"], -1)
    fields = {k: torch.as_tensor(v, device=dev) for k, v in host.items()
              if k not in ("elem", "active")}
    new_cap = int(ps.capacity * growth) + 64
    if ps.layout == "scs":
        try:
            return SellCSigma(
                ps.num_elems, elems, fields=fields, capacity=new_cap,
                scs_input=SCSInput(chunk_size=ps.chunk_size, sigma=ps.sigma,
                                   extra_padding=ps.scs_extra_padding,
                                   pad_strategy=ps.scs_pad_strategy),
                name=ps.name, device=dev)
        except ValueError:
            # skewed layouts can pad past new_cap: size from the layout
            return SellCSigma(
                ps.num_elems, elems, fields=fields, capacity=None,
                scs_input=SCSInput(chunk_size=ps.chunk_size, sigma=ps.sigma,
                                   padding_factor=growth,
                                   extra_padding=ps.scs_extra_padding,
                                   pad_strategy=ps.scs_pad_strategy),
                name=ps.name, device=dev)
    if ps.layout == "cabm":
        try:
            return CabM(ps.num_elems, elems, fields=fields, capacity=new_cap,
                        soa_width=ps.soa_width,
                        extra_padding=ps.cabm_extra_padding, name=ps.name,
                        device=dev)
        except ValueError:
            return CabM(ps.num_elems, elems, fields=fields, capacity=None,
                        padding_factor=growth, soa_width=ps.soa_width,
                        extra_padding=ps.cabm_extra_padding, name=ps.name,
                        device=dev)
    builder = {"dps": DPS, "csr": CSR}[ps.layout]
    return builder(ps.num_elems, elems, fields=fields, capacity=new_cap,
                   name=ps.name, device=dev)


def grow_if_overflowed(ps: ParticleStructure, growth: float = 1.5) -> ParticleStructure:
    """Host-side capacity headroom: if a rebuild overflowed, re-materialize
    the surviving particles into a larger structure (clears the sticky
    flag: growing acknowledges the recorded loss).  Cannot recover what the
    overflowed rebuild dropped; use :func:`rebuild_checked` for that."""
    if not bool(ps.overflowed):
        return ps
    return _grow(ps, growth)

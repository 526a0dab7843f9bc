"""Panel-streamed pairwise engine for sample counts beyond one device matrix.

Counterpart of ``kspider_tpu/ops/tiled_pairwise.py``.  Samples are cut into
panels of ``panel`` ids.  A color contributes to panel pair (I, J) only if
it has a member in each panel (two members in I for the diagonal pair),
so :func:`build_panel_plan` decomposes the color CSR into per-pair work
lists once, on the host.  Each panel pair then runs the hand-written Gram
kernel through :func:`cooccurrence_tiles` on two compact sides:

- a diagonal pair (I, I) runs the upper tiles of one side (the TPU's
  ``cooccurrence_pallas_tri``);
- an off-diagonal pair (I, J) runs all tiles of a rectangle from two
  sides (the TPU's ``cooccurrence_pallas_rect``).

The limbs are recombined into an int64 tile on the device, ``min_shared``
and (on diagonal pairs) ``row < col`` are applied there, and only the
surviving entries cross to the host.  Rows stream to the pairwise TSV
sorted by (source_1, source_2): panel row I covers every pair i < j with i
in panel I exactly once.

Exactness: every chunk of at most ``_MAX_COLORS_PER_CALL`` colors keeps
each limb's int32 sum exact, and chunks add up in int64, so one extract
serves every weight range.

Several devices (a device list, ``parallel/mesh.make_mesh``), by JAX's
rule: with at least two pairs per device and the side cache off, whole
pairs go round-robin to the devices (pair-parallel, no reduction);
otherwise each pair's color blocks are split over the devices and the
partial tiles summed on the first (per-pair sharding).  Extraction stays in
plan order either way, so the TSV bytes do not change.  Panel rows
partition the stream (:func:`filter_plan_rows`), which is how the
multi-process runs of ``parallel/multiprocess.py`` split it.

Threads: one worker packs pair p + 1 on the host (numpy and the native
OpenMP packer) while the calling thread places sides on the devices, looks
up the side cache, launches and extracts; all device work, and so every
update of the launch counters in ``ops/cuda_pairwise.py``, is issued from
the calling thread.
"""

import hashlib
import threading
import time
from collections import OrderedDict, deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from kspider_tpu_torch.ops import bitmask as bm
from kspider_tpu_torch.ops import cuda_pairwise as cp
from kspider_tpu_torch.ops import pairwise as pw
from kspider_tpu_torch.parallel.mesh import make_mesh

#: panel pairs dispatched ahead of the one being extracted, on one device
#: or with per-pair sharding; pair-parallel runs keep max(2, devices)
INFLIGHT = 4


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclass
class PanelPlan:
    """Preprocessed color->panel decomposition (all host-side numpy)."""

    n: int
    panel: int
    n_panels: int
    mem_s: np.ndarray  # postings sorted by (color, member)
    seg_start: np.ndarray  # per (color, panel) segment -> start into mem_s
    seg_count: np.ndarray
    seg_color: np.ndarray  # compacted color id per segment
    w_limbs: np.ndarray  # (C_kept, L) base-128 limbs
    pair_keys: np.ndarray  # sorted unique pi * n_panels + pj (pi <= pj)
    pair_off: np.ndarray  # CSR offsets into ent_* per pair
    ent_sega: np.ndarray  # per entry: segment index of the row-panel side
    ent_segb: np.ndarray  # per entry: segment index of the col-panel side
    max_weight_sum: int  # upper bound on any S entry (= sum of kept weights)
    # (n, len(offsets), len(members)) of the source CSR, so a reused plan
    # built from another index is detected (see stream_pairwise_tsv)
    src_shape: tuple = ()

    @property
    def n_limbs(self) -> int:
        return self.w_limbs.shape[1]


def build_panel_plan(
    offsets: np.ndarray,
    members: np.ndarray,
    weights: np.ndarray,
    n: int,
    panel: int,
) -> PanelPlan:
    """Decompose the color CSR into per-panel-pair work lists."""
    offsets = np.asarray(offsets, dtype=np.int64)
    members = np.asarray(members)  # sample ids < n always fit int32
    weights = np.asarray(weights, dtype=np.int64)
    degrees = np.diff(offsets)
    keep = np.flatnonzero(degrees >= 2)
    n_panels = max(1, _cdiv(n, panel))

    empty = PanelPlan(
        n=n, panel=panel, n_panels=n_panels,
        mem_s=np.zeros(0, np.int32),
        seg_start=np.zeros(0, np.int64), seg_count=np.zeros(0, np.int64),
        seg_color=np.zeros(0, np.int64),
        w_limbs=np.zeros((0, 1), np.int8),
        pair_keys=np.zeros(0, np.int64),
        pair_off=np.zeros(1, np.int64),
        ent_sega=np.zeros(0, np.int64), ent_segb=np.zeros(0, np.int64),
        max_weight_sum=0,
        src_shape=(int(n), len(offsets), len(members)),
    )
    if len(keep) == 0 or n == 0:
        return empty

    # ColorIndex CSRs keep each color's members ascending.  Then segments
    # are computed on the posting array itself (color boundaries are the
    # CSR offsets) and mem_s aliases the caller's members; only external
    # CSRs with unsorted colors pay for a compacting 2-key sort.
    viol = (np.flatnonzero(members[1:] < members[:-1]) + 1
            if len(members) > 1 else np.zeros(0, np.int64))
    unsorted_within = bool(len(viol)) and not bool(
        np.isin(viol, offsets[1:-1]).all()
    )
    if unsorted_within:
        kept_deg = degrees[keep]
        new_off = np.zeros(len(keep) + 1, dtype=np.int64)
        np.cumsum(kept_deg, out=new_off[1:])
        gather = np.repeat(offsets[keep], kept_deg) + (
            np.arange(int(kept_deg.sum())) - np.repeat(new_off[:-1], kept_deg)
        )
        mem = members[gather].astype(np.int32, copy=False)
        cid = np.repeat(np.arange(len(keep), dtype=np.int32), kept_deg)
        order = np.lexsort((mem, cid))
        mem_s = mem[order]
        cid_s = cid[order]
        pan_s = mem_s // np.int32(panel)
        new_seg = np.empty(len(cid_s), dtype=bool)
        new_seg[0] = True
        np.not_equal(cid_s[1:], cid_s[:-1], out=new_seg[1:])
        np.logical_or(new_seg[1:], pan_s[1:] != pan_s[:-1],
                      out=new_seg[1:])
        seg_start = np.flatnonzero(new_seg)
        seg_count = np.diff(np.append(seg_start, len(cid_s)))
        seg_color = cid_s[seg_start].astype(np.int64)
        seg_panel = pan_s[seg_start]
    else:
        mem_s = members.astype(np.int32, copy=False)
        total = len(mem_s)
        pan_s = mem_s // np.int32(panel)
        new_seg = np.empty(total, dtype=bool)
        new_seg[0] = True
        np.not_equal(pan_s[1:], pan_s[:-1], out=new_seg[1:])
        bounds = offsets[1:-1]
        new_seg[bounds[bounds < total]] = True  # color starts
        seg_start = np.flatnonzero(new_seg)
        seg_count = np.diff(np.append(seg_start, total))
        seg_color_orig = np.searchsorted(offsets, seg_start, side="right") - 1
        seg_panel = pan_s[seg_start]
        del pan_s
        # drop segments of degree<2 colors; remap color ids to the
        # kept-compacted space the weight limbs are built over
        seg_keep = degrees[seg_color_orig] >= 2
        seg_start = seg_start[seg_keep]
        seg_count = seg_count[seg_keep]
        seg_panel = seg_panel[seg_keep]
        kidx = np.zeros(len(degrees), np.int64)
        kidx[keep] = np.arange(len(keep))
        seg_color = kidx[seg_color_orig[seg_keep]]

    # per color: its contiguous run of segments (seg_color is nondecreasing)
    if len(seg_color):
        first_mask = np.empty(len(seg_color), dtype=bool)
        first_mask[0] = True
        np.not_equal(seg_color[1:], seg_color[:-1], out=first_mask[1:])
        col_first = np.flatnonzero(first_mask)
        col_t = np.diff(np.append(col_first, len(seg_color)))
    else:
        col_first = np.zeros(0, np.int64)
        col_t = np.zeros(0, np.int64)

    ent_pa, ent_pb, ent_sa, ent_sb = [], [], [], []
    for t in np.unique(col_t):
        t = int(t)
        rows = np.flatnonzero(col_t == t)
        segidx = col_first[rows][:, None] + np.arange(t)  # (m, t)
        pans = seg_panel[segidx]
        cnts = seg_count[segidx]
        ia, ib = np.triu_indices(t)
        valid = np.ones((len(rows), len(ia)), dtype=bool)
        diag = ia == ib
        if diag.any():
            valid[:, diag] = cnts[:, ia[diag]] >= 2
        pa, pb = pans[:, ia], pans[:, ib]
        sa, sb = segidx[:, ia], segidx[:, ib]
        ent_pa.append(pa[valid])
        ent_pb.append(pb[valid])
        ent_sa.append(sa[valid])
        ent_sb.append(sb[valid])

    pa = np.concatenate(ent_pa)
    pb = np.concatenate(ent_pb)
    sa = np.concatenate(ent_sa)
    sb = np.concatenate(ent_sb)
    if len(pa) == 0:
        return empty
    pk = pa.astype(np.int64) * n_panels + pb
    order2 = np.argsort(pk, kind="stable")
    pk_s, sa_s, sb_s = pk[order2], sa[order2], sb[order2]
    pair_keys, pair_first, pair_cnt = np.unique(
        pk_s, return_index=True, return_counts=True
    )
    pair_off = np.zeros(len(pair_keys) + 1, dtype=np.int64)
    np.cumsum(pair_cnt, out=pair_off[1:])

    kept_w = weights[keep]
    return PanelPlan(
        n=n, panel=panel, n_panels=n_panels,
        mem_s=mem_s,
        seg_start=seg_start.astype(np.int64),
        seg_count=seg_count.astype(np.int64),
        seg_color=seg_color,
        w_limbs=pw.weight_limbs(kept_w),
        pair_keys=pair_keys,
        pair_off=pair_off,
        ent_sega=sa_s.astype(np.int64),
        ent_segb=sb_s.astype(np.int64),
        max_weight_sum=int(kept_w.sum()),
        src_shape=(int(n), len(offsets), len(members)),
    )


def panel_row_work(plan: PanelPlan) -> np.ndarray:
    """Per-panel-row pair-entry counts: the load estimate by which whole
    panel rows are assigned to processes (parallel/multiprocess.py)."""
    lengths = np.diff(plan.pair_off)
    pis = plan.pair_keys // plan.n_panels
    work = np.zeros(plan.n_panels, dtype=np.int64)
    np.add.at(work, pis.astype(np.int64), lengths)
    return work


def filter_plan_rows(plan: PanelPlan, rows) -> PanelPlan:
    """Restrict a plan to the panel pairs whose row panel is in ``rows``.

    Shares the posting and segment arrays with the parent plan; only the
    pair CSR is rebuilt.  A sample pair (gi, gj) with gi < gj comes from
    exactly one panel pair, (gi // panel, gj // panel), so panel rows
    partition the streamed output into disjoint, contiguous blocks of the
    global (gi, gj) order: rows computed by different processes,
    concatenated in row order, give the single-process stream."""
    rows = np.asarray(sorted({int(r) for r in np.asarray(rows).ravel()}))
    pis = plan.pair_keys // plan.n_panels
    keep = np.flatnonzero(np.isin(pis, rows))
    lengths = np.diff(plan.pair_off)
    new_off = np.zeros(len(keep) + 1, dtype=np.int64)
    np.cumsum(lengths[keep], out=new_off[1:])
    ent_idx = np.repeat(plan.pair_off[keep], lengths[keep]) + (
        np.arange(int(new_off[-1])) - np.repeat(new_off[:-1], lengths[keep])
    )
    return PanelPlan(
        n=plan.n, panel=plan.panel, n_panels=plan.n_panels,
        mem_s=plan.mem_s,
        seg_start=plan.seg_start, seg_count=plan.seg_count,
        seg_color=plan.seg_color, w_limbs=plan.w_limbs,
        pair_keys=plan.pair_keys[keep],
        pair_off=new_off,
        ent_sega=plan.ent_sega[ent_idx],
        ent_segb=plan.ent_segb[ent_idx],
        max_weight_sum=plan.max_weight_sum,
        src_shape=plan.src_shape,
    )


# ---- host packing of one panel side ---------------------------------------


def _gather_side(plan: PanelPlan, segs: np.ndarray):
    """Selected segments -> (local CSR offsets, member ids)."""
    cnt = plan.seg_count[segs]
    off = np.zeros(len(segs) + 1, dtype=np.int64)
    np.cumsum(cnt, out=off[1:])
    idx = np.repeat(plan.seg_start[segs], cnt) + (
        np.arange(int(off[-1])) - np.repeat(off[:-1], cnt)
    )
    return off, plan.mem_s[idx]


def _pack_side(off, mem_local, n_blocks: int, block: int,
               panel_pad: int) -> np.ndarray:
    """Local CSR -> bitmask blocks u8[n_blocks, panel_pad/8, block]."""
    n_colors = len(off) - 1
    pad_colors = n_blocks * block - n_colors
    if pad_colors:
        off = np.concatenate([off, np.full(pad_colors, off[-1], dtype=np.int64)])
    bits = bm.pack_bitmask_blocks(off, mem_local, panel_pad, block)
    return np.ascontiguousarray(bits.transpose(0, 2, 1))


def _pack_panel_side(
    plan: PanelPlan, panel_id: int, segs_slice: np.ndarray, n_blocks: int,
    block: int, panel_pad: int,
) -> np.ndarray:
    """Pack one panel pair side straight from the plan's segment CSR into
    the kernel's layout u8[n_blocks, panel_pad/8, block].

    Goes through the native OpenMP packer ``ks_pack_segments``, shared with
    the JAX package, which writes the transposed layout directly; a failure
    is reported by ``native.report_fallback`` (an error under
    ``KSPIDER_NATIVE=force``) and the numpy packer takes over."""
    from kspider_tpu_torch.io import native

    if native.enabled():
        try:
            if not native.available():
                raise RuntimeError(
                    f"native library failed to load: {native.load_error()!r}"
                )
            return native.pack_segments(
                plan.mem_s,
                plan.seg_start[segs_slice],
                plan.seg_count[segs_slice],
                panel_id * plan.panel,
                panel_pad // 8,
                block,
                n_blocks,
                True,
            )
        except native.NativeRequiredError:
            raise
        except Exception as exc:
            native.report_fallback("pack_segments", exc)
    off, mem = _gather_side(plan, segs_slice)
    return _pack_side(off, mem - panel_id * plan.panel, n_blocks, block,
                      panel_pad)


def _postings_keys(
    plan: PanelPlan, panel_id: int, segs_slice: np.ndarray, panel_pad: int,
    n_blocks: int, block: int,
) -> Optional[np.ndarray]:
    """Selected segments -> sorted unique i32 scatter keys, bucket-padded.

    Key = local_segment_index * panel_pad + local_member; pad values are
    ascending out-of-range bit positions.  None when the bit-position space
    would overflow int32, or when the keys are not strictly increasing (a
    CSR with duplicate (color, member) postings): the caller then packs on
    the host."""
    cnt = plan.seg_count[segs_slice]
    m = int(cnt.sum())
    total_bits = n_blocks * block * panel_pad
    bucket = bm.key_bucket(m)
    if total_bits + bucket >= 2**31:
        return None
    off = np.zeros(len(segs_slice) + 1, dtype=np.int64)
    np.cumsum(cnt, out=off[1:])
    idx = np.repeat(plan.seg_start[segs_slice], cnt) + (
        np.arange(m) - np.repeat(off[:-1], cnt)
    )
    seg_local = np.repeat(np.arange(len(segs_slice), dtype=np.int64), cnt)
    keys = seg_local * panel_pad + (
        plan.mem_s[idx].astype(np.int64) - panel_id * plan.panel
    )
    if len(keys) > 1 and not (keys[1:] > keys[:-1]).all():
        return None
    out = np.empty(bucket, dtype=np.int32)
    out[:m] = keys
    out[m:] = total_bits + np.arange(bucket - m, dtype=np.int32)
    return out


def _pad_limbs(wl: np.ndarray, n_blocks: int, block: int) -> np.ndarray:
    """(colors, L) limbs -> i8[n_blocks, L, block], zero-padded colors."""
    n_limbs = wl.shape[1]
    out = np.zeros((n_blocks * block, n_limbs), dtype=np.int8)
    out[: len(wl)] = wl
    out = out.reshape(n_blocks, block, n_limbs)
    return np.ascontiguousarray(out.transpose(0, 2, 1))


class _PostingsSide(tuple):
    """A panel side shipped as posting keys and packed on the device:
    ``(payload, n_blocks)`` where payload is raw i32 keys (exact length),
    ``("d16", first, i16 deltas, count)`` or
    ``("d8", first, u8 deltas, i32 exceptions, count)``."""

    __slots__ = ()


class _CachedSide(tuple):
    """A cacheable side: ``(key, host array or None, pack)``.  The worker
    leaves the host array None when the cache already held the key; the
    dispatch thread calls ``pack()`` itself if the entry was evicted in
    between."""

    __slots__ = ()


class _DeviceSideCache:
    """Device-resident LRU of packed panel sides, bounded in bytes.

    A side depends only on (panel, selected segments, block count), and
    colors that span many panels make off-diagonal pairs re-select the same
    sides; a hit skips both the pack and the H2D copy.  Entries are the
    device tensors themselves, so an evicted entry frees its memory once
    the last pending launch that reads it has run.  A budget of 0 disables
    it.  ``contains`` may be called from the packing worker; every other
    method runs on the dispatch thread."""

    def __init__(self, budget_bytes: int):
        self.budget = budget_bytes
        self.entries = OrderedDict()
        self.nbytes = 0
        self.hits = 0
        self.misses = 0
        self._lock = threading.Lock()

    def contains(self, key) -> bool:
        with self._lock:
            return key in self.entries

    def lookup(self, key):
        with self._lock:
            ent = self.entries.get(key)
            if ent is None:
                self.misses += 1
                return None
            self.entries.move_to_end(key)
            self.hits += 1
            return ent[0]

    def put(self, key, arr, nbytes: int):
        if self.budget <= 0 or nbytes > self.budget:
            return
        with self._lock:
            while self.nbytes + nbytes > self.budget and self.entries:
                _, (_, old_bytes) = self.entries.popitem(last=False)
                self.nbytes -= old_bytes
            self.entries[key] = (arr, nbytes)
            self.nbytes += nbytes


def _segs_digest(segs: np.ndarray) -> bytes:
    return hashlib.blake2b(
        np.ascontiguousarray(segs).tobytes(), digest_size=16
    ).digest()


def _chunk_acc(bits_a, bits_b, wl, diag: bool, panel_pad: int):
    """One chunk's per-limb int32 accumulators i32[L, panel_pad, panel_pad].

    A diagonal pair computes the upper tiles of one side (lower tiles stay
    zero: extraction keeps only row < col); an off-diagonal pair computes
    all tiles of the rectangle."""
    nt = panel_pad // cp.TILE
    tiles = cp.upper_triangle_tiles(nt) if diag else cp.all_tiles(nt, nt)
    acc = torch.zeros((wl.shape[1], panel_pad, panel_pad), dtype=torch.int32,
                      device=bits_a.device)
    return cp.cooccurrence_tiles(bits_a, bits_b, wl, *tiles, tile=cp.TILE,
                                 out=acc)


def _chunk_acc_sharded(bits_a, bits_b, wl, diag: bool, panel_pad: int,
                       devices):
    """One chunk's accumulators with its color blocks split evenly over
    ``devices`` (block count a multiple of their number): each device runs
    :func:`_chunk_acc` on its slice, every launch is issued before any
    partial is copied, and the partials are summed on ``bits_a``'s device.
    The counterpart of JAX's ``_gram_rect_sharded``."""
    per = bits_a.shape[0] // len(devices)
    accs = []
    for k, dev in enumerate(devices):
        rows = slice(k * per, (k + 1) * per)
        a = bits_a[rows].to(dev)
        b = a if bits_b is bits_a else bits_b[rows].to(dev)
        accs.append(_chunk_acc(a, b, wl[rows].to(dev), diag, panel_pad))
    acc = accs[0].to(bits_a.device)
    for other in accs[1:]:
        acc += other.to(acc.device)
    return acc


def iter_panel_pairs(
    plan: PanelPlan,
    *,
    device,
    block: int = 1024,
    min_shared: int = 1,
    cache_bytes: int = 0,
    stats: Optional[dict] = None,
    device_pack: Optional[str] = None,
) -> Iterator[Tuple[int, int, np.ndarray, np.ndarray, np.ndarray]]:
    """Yield ``(pi, pj, gi, gj, shared)`` for every panel pair with work,
    in plan order.

    ``gi``/``gj`` are global 0-based int64 sample ids with gi < gj, in
    row-major order within the pair; ``shared`` the exact int64 counts
    >= max(1, min_shared).  The Gram product runs on ``device``, one
    device or a device list: with at least two pairs per device and the
    side cache off, pair p runs on ``devices[p % len(devices)]``; otherwise
    each pair's color blocks are split over the devices and the partial
    tiles summed on ``devices[0]``.  ``cache_bytes`` bounds the device side
    cache (0: off; its entries live on ``devices[0]``).
    ``device_pack`` (auto/force/off; None reads ``KSPIDER_DEVICE_PACK``)
    ships sparse single-use sides as posting keys packed on the device.
    Pass a dict as ``stats`` for per-stage times, payload and cache
    counters and the device layout (``devices``, ``pair_parallel``)."""
    devices = make_mesh(device)
    n_pairs = len(plan.pair_keys)
    pair_parallel = (len(devices) > 1 and n_pairs >= 2 * len(devices)
                     and cache_bytes <= 0)
    shards = 1 if pair_parallel else len(devices)
    n_limbs = plan.n_limbs
    panel_pad = max(cp.TILE, _cdiv(plan.panel, cp.TILE) * cp.TILE)
    sup = pw._MAX_COLORS_PER_CALL - (pw._MAX_COLORS_PER_CALL % block)
    floor = max(1, int(min_shared))
    cache = _DeviceSideCache(cache_bytes)
    dp_policy, dp_ratio = bm.device_pack_policy(device_pack)
    xfer = dict(bits_bytes=0, keys_bytes=0, bits_sides=0, keys_sides=0)

    # ---- worker thread: host packing only --------------------------------

    def _keys_side(panel_id, segs_slice, n_blocks):
        """Posting keys for a side, or None to pack it on the host."""
        if dp_policy == "off":
            return None
        m = int(plan.seg_count[segs_slice].sum())
        bitmask_bytes = n_blocks * block * panel_pad // 8
        if dp_policy == "auto" and 4 * bm.key_bucket(m) * dp_ratio > bitmask_bytes:
            return None
        keys = _postings_keys(plan, panel_id, segs_slice, panel_pad,
                              n_blocks, block)
        if keys is None:
            return None
        enc = bm.encode_keys_best(keys, m)
        if enc is None:
            payload = keys[:m]
        elif enc[0] == "d8":
            payload = ("d8", enc[1], enc[2][:m], enc[3], m)
        else:
            payload = ("d16", enc[1], enc[2][:m], m)
        return _PostingsSide((payload, n_blocks))

    def _bits_side(panel_id, segs_slice, n_blocks):
        return _pack_panel_side(plan, panel_id, segs_slice, n_blocks, block,
                                panel_pad)

    def _cached(key, pack):
        return _CachedSide((key, None if cache.contains(key) else pack(), pack))

    def _side(panel_id, segs_slice, n_blocks, cacheable):
        if cache.budget <= 0 or not cacheable:
            keys = _keys_side(panel_id, segs_slice, n_blocks)
            return keys if keys is not None else _bits_side(
                panel_id, segs_slice, n_blocks)
        key = ("bits", panel_id, _segs_digest(segs_slice), n_blocks)
        return _cached(key, lambda: _bits_side(panel_id, segs_slice, n_blocks))

    def _limbs(segs_slice, n_blocks, cacheable):
        colors = plan.seg_color[segs_slice]

        def pack():
            return _pad_limbs(plan.w_limbs[colors], n_blocks, block)

        if cache.budget <= 0 or not cacheable:
            return pack()
        return _cached(("wl", _segs_digest(colors), n_blocks), pack)

    def prepare(p: int):
        pk = int(plan.pair_keys[p])
        pi, pj = pk // plan.n_panels, pk % plan.n_panels
        e0, e1 = int(plan.pair_off[p]), int(plan.pair_off[p + 1])
        segs_a = plan.ent_sega[e0:e1]
        segs_b = plan.ent_segb[e0:e1]
        # diagonal pairs' sides are selected by exactly one pair, so only
        # off-diagonal sides (panel-spanning colors) go through the cache
        cacheable = pi != pj
        chunks = []
        for cs in range(0, e1 - e0, sup):
            ce = min(cs + sup, e1 - e0)
            n_blocks = pw._round_up(_cdiv(ce - cs, block), shards)
            side_a = _side(pi, segs_a[cs:ce], n_blocks, cacheable)
            side_b = side_a if pi == pj else _side(
                pj, segs_b[cs:ce], n_blocks, cacheable)
            chunks.append((side_a, side_b,
                           _limbs(segs_a[cs:ce], n_blocks, cacheable)))
        return pi, pj, chunks

    def timed_prepare(p: int):
        t0 = time.perf_counter()
        out = prepare(p)
        return out, time.perf_counter() - t0

    # ---- dispatch thread: every device operation -------------------------

    def _to_device(side, device):
        """Place a prepared side (or limbs) on ``device``; counts the
        sides that cross H2D as posting keys or packed u8 bits (i8 limbs
        are not counted)."""
        if isinstance(side, _PostingsSide):
            payload, n_blocks = side
            xfer["keys_sides"] += 1
            xfer["keys_bytes"] += sum(
                a.nbytes for a in (payload if isinstance(payload, tuple)
                                   else (payload,))
                if isinstance(a, np.ndarray))
            geometry = (n_blocks, block, panel_pad)
            if isinstance(payload, np.ndarray):
                return bm.scatter_pack_device(payload, *geometry, device=device)
            if payload[0] == "d8":
                _, first, d8, exc, count = payload
                return bm.scatter_pack_device_delta8(
                    first, d8, exc, count, *geometry, device=device)
            _, first, d16, count = payload
            return bm.scatter_pack_device_delta(
                first, d16, count, *geometry, device=device)
        if isinstance(side, _CachedSide):
            key, host, pack = side
            arr = cache.lookup(key)
            if arr is None:
                host = pack() if host is None else host
                arr = torch.from_numpy(host).to(device)
                cache.put(key, arr, host.nbytes)
                if key[0] == "bits":
                    xfer["bits_sides"] += 1
                    xfer["bits_bytes"] += host.nbytes
            return arr
        if side.dtype == np.uint8:
            xfer["bits_sides"] += 1
            xfer["bits_bytes"] += side.nbytes
        return torch.from_numpy(side).to(device)

    def dispatch(pi: int, pj: int, chunks, device):
        """Launch every chunk; returns (int64 tile, keep mask) on
        ``device``."""
        diag = pi == pj
        total = None
        for side_a, side_b, wl in chunks:
            bits_a = _to_device(side_a, device)
            bits_b = bits_a if side_b is side_a else _to_device(side_b, device)
            wl = _to_device(wl, device)
            if shards > 1:
                acc = _chunk_acc_sharded(bits_a, bits_b, wl, diag, panel_pad,
                                         devices)
            else:
                acc = _chunk_acc(bits_a, bits_b, wl, diag, panel_pad)
            if total is None:
                total = torch.zeros((panel_pad, panel_pad), dtype=torch.int64,
                                    device=device)
            for l in range(n_limbs):
                total.add_(acc[l], alpha=128**l)
        keep = total >= floor
        if diag:
            keep = torch.triu(keep, diagonal=1)
        return total, keep

    def extract(pi: int, pj: int, handle):
        total, keep = handle
        idx = torch.nonzero(keep.view(-1)).squeeze(1)
        if idx.numel() == 0:
            return None
        vals = total.view(-1)[idx].cpu().numpy()
        idx = idx.cpu().numpy()
        gi = pi * plan.panel + idx // panel_pad
        gj = pj * plan.panel + idx % panel_pad
        return gi, gj, vals

    t_pack = t_dispatch = t_extract = 0.0
    inflight = max(2, len(devices)) if pair_parallel else INFLIGHT
    pending = deque()  # (pi, pj, handle), oldest first
    ex = ThreadPoolExecutor(max_workers=1)
    try:
        fut = ex.submit(timed_prepare, 0) if n_pairs else None
        for p in range(n_pairs):
            (pi, pj, chunks), dt = fut.result()
            t_pack += dt
            if p + 1 < n_pairs:
                fut = ex.submit(timed_prepare, p + 1)
            t0 = time.perf_counter()
            device = devices[p % len(devices)] if pair_parallel else devices[0]
            pending.append((pi, pj, dispatch(pi, pj, chunks, device)))
            del chunks
            t_dispatch += time.perf_counter() - t0
            while len(pending) > inflight or (p + 1 == n_pairs and pending):
                t0 = time.perf_counter()
                done = pending.popleft()
                out = extract(*done)
                t_extract += time.perf_counter() - t0
                if out is not None:
                    yield done[0], done[1], *out
    finally:
        ex.shutdown(wait=True, cancel_futures=True)
    if stats is not None:
        stats.update(
            cache_hits=cache.hits, cache_misses=cache.misses,
            cache_bytes=cache.nbytes,
            t_pack=t_pack, t_dispatch=t_dispatch, t_extract=t_extract,
            devices=len(devices), pair_parallel=pair_parallel,
            **xfer,
        )


def stream_pairwise_tsv(
    index,
    prefix: str,
    *,
    device,
    panel: int = 4096,
    block: int = 1024,
    min_shared: int = 1,
    echo_progress: bool = False,
    cache_bytes: Optional[int] = None,
    stats: Optional[dict] = None,
    plan: Optional[PanelPlan] = None,
    device_pack: Optional[str] = None,
) -> int:
    """Compute pairwise at any N and stream ``{p}_kSpider_pairwise.tsv``.

    Rows come out sorted by (source_1, source_2), byte-identical to the
    dense writer.  Returns the pair-row count.  ``plan`` reuses a prebuilt
    :func:`build_panel_plan` result; its panel and source shape must match.
    ``device`` is one device or a device list (see :func:`iter_panel_pairs`).
    ``cache_bytes=None`` gives a 2 GB device side cache on one CUDA device
    and none on the CPU or on a device list, as kspider_tpu keeps it off on
    several devices; pass 0 to force it off, or a byte budget.  Pass a
    dict as ``stats`` (or set ``echo_progress``) for the stage breakdown:
    pack (host, overlapped), dispatch, extract (device wait + D2H), tsv."""
    from kspider_tpu_torch.core.pairwise import write_pairwise_rows_coo

    devices = make_mesh(device)
    if cache_bytes is None:
        cache_bytes = 2 << 30 if (
            len(devices) == 1 and devices[0].type == "cuda") else 0

    if plan is None:
        plan = build_panel_plan(
            index.color_offsets, index.color_members, index.color_counts,
            index.num_groups, panel,
        )
    elif plan.panel != panel:
        raise ValueError(
            f"prebuilt plan has panel={plan.panel}, called with panel={panel}"
        )
    else:
        want = (
            int(index.num_groups),
            len(index.color_offsets),
            len(index.color_members),
        )
        if plan.n != index.num_groups or (
            plan.src_shape and tuple(plan.src_shape) != want
        ):
            raise ValueError(
                f"prebuilt plan was built from a different index: plan has "
                f"n={plan.n}, src_shape={plan.src_shape}; index has "
                f"(n, offsets, postings)={want}"
            )
    counts = np.where(index.group_kmer_count < 0, 0, index.group_kmer_count)
    path = prefix + "_kSpider_pairwise.tsv"

    total = 0
    first = True
    t_tsv = 0.0
    run_stats: dict = {} if stats is None else stats
    current_row = -1
    buf_i, buf_j, buf_v = [], [], []

    def flush():
        nonlocal total, first, t_tsv
        if not buf_i:
            return
        t0 = time.perf_counter()
        gi = np.concatenate(buf_i)
        gj = np.concatenate(buf_j)
        sv = np.concatenate(buf_v)
        order = np.lexsort((gj, gi))
        write_pairwise_rows_coo(
            path, gi[order], gj[order], sv[order], counts, header=first
        )
        first = False
        total += len(gi)
        buf_i.clear()
        buf_j.clear()
        buf_v.clear()
        t_tsv += time.perf_counter() - t0

    for pi, pj, gi, gj, vals in iter_panel_pairs(
        plan, device=devices, block=block, min_shared=min_shared,
        cache_bytes=cache_bytes, stats=run_stats, device_pack=device_pack,
    ):
        if pi != current_row:
            flush()
            current_row = pi
            if echo_progress:
                print(f"  panel row {pi + 1}/{plan.n_panels}", flush=True)
        buf_i.append(gi)
        buf_j.append(gj)
        buf_v.append(vals)
    flush()
    if first:  # no pairs at all: still write the header
        write_pairwise_rows_coo(
            path,
            np.zeros(0, np.int64), np.zeros(0, np.int64),
            np.zeros(0, np.int64), counts, header=True,
        )
    run_stats["t_tsv"] = t_tsv
    if echo_progress:
        print(
            f"  stage breakdown: pack {run_stats['t_pack']:.3f}s "
            f"(overlapped) | dispatch {run_stats['t_dispatch']:.3f}s | "
            f"extract (device wait + D2H) {run_stats['t_extract']:.3f}s | "
            f"tsv {t_tsv:.3f}s",
            flush=True,
        )
        print(
            f"  side payload: {run_stats['bits_sides']} host-packed sides "
            f"({run_stats['bits_bytes'] / 1e6:.1f}MB) + "
            f"{run_stats['keys_sides']} device-packed sides "
            f"({run_stats['keys_bytes'] / 1e6:.1f}MB posting keys)",
            flush=True,
        )
        if len(devices) > 1:
            layout = ("pair-parallel round-robin" if run_stats["pair_parallel"]
                      else "color blocks of each pair split")
            print(f"  devices: {', '.join(map(str, devices))} ({layout})",
                  flush=True)
        if cache_bytes:
            print(
                f"  device side-cache: {run_stats['cache_hits']} hits / "
                f"{run_stats['cache_misses']} misses "
                f"({run_stats['cache_bytes'] / 1e6:.1f}MB resident)",
                flush=True,
            )
    return total

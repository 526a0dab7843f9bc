"""Panel-streamed pairwise engine for sample counts beyond one device matrix.

Counterpart of ``kspider_tpu/ops/tiled_pairwise.py``.  Samples are cut into
panels of ``panel`` ids.  A color contributes to panel pair (I, J) only if
it has a member in each panel (two members in I for the diagonal pair),
so :func:`build_panel_plan` decomposes the color CSR into per-pair work
lists once, on the host (in C++, ``csrc/panel_plan.cpp``).  Each panel pair then runs the hand-written Gram
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
rule: with at least two pairs per device, whole pairs go round-robin to
the devices (pair-parallel, no reduction); otherwise each pair's color
blocks are split over the devices and the partial tiles summed on the
first (per-pair sharding).  Extraction stays in plan order either way, so
the TSV bytes do not change.  Panel rows partition the stream
(:func:`filter_plan_rows`), which is how the multi-process runs of
``parallel/multiprocess.py`` split it.

Threads: one worker packs pair p + 1 on the host (numpy and the native
OpenMP packer) while the calling thread places sides on the devices,
launches and extracts; all device work, and so every update of the launch
counters in ``ops/cuda_pairwise.py``, is issued from the calling thread.

Streams, on a CUDA device (:class:`_Lane`): nothing in the loop drains a
stream, so ``INFLIGHT`` pairs stay queued on the device while the host
extracts and writes.  The worker packs into a ring of pinned host buffers
(:class:`_HostSlots`); the sides, limbs and posting keys cross on a copy
stream with ``non_blocking=True``, and the compute stream waits on the
copy's event.  Right after its kernels, each pair's kept entries are
compacted on the device (:func:`compact_kept`) and its count starts its
D2H into pinned memory behind one event.  Extract waits on that pair's
event only, then fetches the first ``count`` entries on a D2H stream that
waits on the same event, not behind the pairs queued after it.  On the CPU
the same code runs without pinning or streams.
"""

import ctypes
import functools
import os
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Iterator, Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from kspider_tpu_torch.io import native
from kspider_tpu_torch.io import pairwise_tsv as pw_tsv
from kspider_tpu_torch.ops import _build
from kspider_tpu_torch.ops import bitmask as bm
from kspider_tpu_torch.ops import cuda_pairwise as cp
from kspider_tpu_torch.ops import pairwise as pw
from kspider_tpu_torch.parallel.mesh import make_mesh
from kspider_tpu_torch.utils.timing import profile_trace, timed

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
    """Decompose the color CSR into per-panel-pair work lists.

    The segments and entries come from ``csrc/panel_plan.cpp``; where its
    library cannot build or load (``native.report_fallback`` says so), under
    ``KSPIDER_NATIVE=off``, or with more than ``PLAN_TABLE_KEYS`` panel
    pairs, numpy builds the same arrays under the ``kspider.plan_numpy``
    range."""
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
    if offsets[0] != 0 or offsets[-1] != len(members) or (degrees < 0).any():
        raise ValueError("color offsets must rise from 0 to len(members)")

    lib = (_plan_library() if n_panels * n_panels <= PLAN_TABLE_KEYS
           else None)
    if lib is not None:
        parts = _native_plan(lib, offsets, members, degrees, keep, n, panel,
                             n_panels)
    else:
        with timed("kspider.plan_numpy"):
            parts = _numpy_plan(offsets, members, degrees, keep, panel,
                                n_panels)
    if parts is None:
        return empty
    mem_s, seg_start, seg_count, seg_color, pair_keys, pair_off, sa, sb = parts
    kept_w = weights[keep]
    return PanelPlan(
        n=n, panel=panel, n_panels=n_panels,
        mem_s=mem_s,
        seg_start=seg_start,
        seg_count=seg_count,
        seg_color=seg_color,
        w_limbs=pw.weight_limbs(kept_w),
        pair_keys=pair_keys,
        pair_off=pair_off,
        ent_sega=sa,
        ent_segb=sb,
        max_weight_sum=int(kept_w.sum()),
        src_shape=(int(n), len(offsets), len(members)),
    )


def _compact_sorted(offsets, members, degrees, keep):
    """The kept colors' postings as a CSR sorted by (color, member): its
    offsets, int32 members and int32 color ids, for a CSR whose colors do
    not keep their members ascending."""
    kept_deg = degrees[keep]
    new_off = np.zeros(len(keep) + 1, dtype=np.int64)
    np.cumsum(kept_deg, out=new_off[1:])
    gather = np.repeat(offsets[keep], kept_deg) + (
        np.arange(int(kept_deg.sum())) - np.repeat(new_off[:-1], kept_deg)
    )
    mem = members[gather].astype(np.int32, copy=False)
    cid = np.repeat(np.arange(len(keep), dtype=np.int32), kept_deg)
    order = np.lexsort((mem, cid))
    return new_off, mem[order], cid[order]


def _numpy_plan(offsets, members, degrees, keep, panel, n_panels):
    """The plan's posting, segment and entry arrays in numpy, or None
    where no panel pair has work."""
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
        _, mem_s, cid_s = _compact_sorted(offsets, members, degrees, keep)
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
        return None
    pk = pa.astype(np.int64) * n_panels + pb
    order2 = np.argsort(pk, kind="stable")
    pk_s, sa_s, sb_s = pk[order2], sa[order2], sb[order2]
    pair_keys, pair_cnt = np.unique(pk_s, return_counts=True)
    pair_off = np.zeros(len(pair_keys) + 1, dtype=np.int64)
    np.cumsum(pair_cnt, out=pair_off[1:])
    return (mem_s, seg_start.astype(np.int64), seg_count.astype(np.int64),
            seg_color, pair_keys, pair_off, sa_s.astype(np.int64),
            sb_s.astype(np.int64))


# ---- the panel plan in host C++ --------------------------------------------

_PLAN_SOURCE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc", "panel_plan.cpp")
#: the most panel pairs (``n_panels ** 2``) whose entry counts the native
#: plan keeps in one table; more take the numpy plan
PLAN_TABLE_KEYS = 1 << 22


@functools.lru_cache(maxsize=None)
def _load_plan_library():
    """(library, None) once built and bound, else (None, the exception):
    a failed build is tried once a process."""
    try:
        lib = ctypes.CDLL(_build.build_host(_build.BUILD_DIR,
                                            "libkspider_plan", _PLAN_SOURCE))
    except Exception as exc:
        return None, exc
    vp, i64 = ctypes.c_void_p, ctypes.c_int64
    # offsets, n_colors, members, n, panel, seg_start, seg_count,
    # seg_color, seg_panel, col_t, n_kept
    lib.ks_plan_segments.restype = i64
    lib.ks_plan_segments.argtypes = [vp, i64, vp, i64, i64] + [vp] * 5 + [
        ctypes.POINTER(i64)]
    # col_t, n_kept, seg_count, seg_panel, n_panels, key_count, ent_sega,
    # ent_segb
    lib.ks_plan_entries.restype = i64
    lib.ks_plan_entries.argtypes = [vp, i64, vp, vp, i64, vp, vp, vp]
    return lib, None


def _plan_library():
    """The native plan's library, or None where numpy builds the plan:
    under ``KSPIDER_NATIVE=off``, or (reported) where it cannot load."""
    if not native.enabled():
        return None
    lib, exc = _load_plan_library()
    if exc is not None:
        native.report_fallback("panel_plan", exc)
    return lib


def _native_plan(lib, offsets, members, degrees, keep, n, panel, n_panels):
    """:func:`_numpy_plan`'s arrays from ``csrc/panel_plan.cpp``: each pass
    once to count, so every array is allocated at its size, once to fill."""
    mem_s = np.ascontiguousarray(members, dtype=np.int32)
    n_kept = ctypes.c_int64()

    def segments(off, outs=(None,) * 5):
        return lib.ks_plan_segments(
            off.ctypes.data, len(off) - 1, mem_s.ctypes.data, n, panel,
            *[None if o is None else o.ctypes.data for o in outs],
            ctypes.byref(n_kept))

    n_segs = segments(offsets)
    if n_segs == -1:  # a color's members are not ascending
        offsets, mem_s, _ = _compact_sorted(offsets, members, degrees, keep)
        n_segs = segments(offsets)
    if n_segs < 0:
        raise ValueError(f"a color member lies outside [0, {n})")
    seg_start, seg_count, seg_color = (np.empty(n_segs, np.int64)
                                       for _ in range(3))
    seg_panel = np.empty(n_segs, np.int32)
    col_t = np.empty(n_kept.value, np.int32)
    segments(offsets, (seg_start, seg_count, seg_color, seg_panel, col_t))

    key_count = np.zeros(n_panels * n_panels, np.int64)

    def entries(sega=None, segb=None):
        return lib.ks_plan_entries(
            col_t.ctypes.data, len(col_t), seg_count.ctypes.data,
            seg_panel.ctypes.data, n_panels, key_count.ctypes.data,
            None if sega is None else sega.ctypes.data,
            None if segb is None else segb.ctypes.data)

    n_ent = entries()
    if n_ent == 0:
        return None
    ent_sega, ent_segb = np.empty(n_ent, np.int64), np.empty(n_ent, np.int64)
    entries(ent_sega, ent_segb)
    pair_keys = np.flatnonzero(key_count)
    pair_off = np.zeros(len(pair_keys) + 1, dtype=np.int64)
    np.cumsum(key_count[pair_keys], out=pair_off[1:])
    return (mem_s, seg_start, seg_count, seg_color, pair_keys, pair_off,
            ent_sega, ent_segb)


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
    return bm.pack_bitmask_blocks_t(off, mem_local, panel_pad, block)


def _pack_panel_side(
    plan: PanelPlan, panel_id: int, segs_slice: np.ndarray, n_blocks: int,
    block: int, panel_pad: int, out: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Pack one panel pair side straight from the plan's segment CSR into
    the kernel's layout u8[n_blocks, panel_pad/8, block]; into ``out``
    (zeroed here) when given.

    Goes through the native OpenMP packer ``ks_pack_segments``, shared with
    the JAX package, which writes the transposed layout directly; a failure
    is reported by ``native.report_fallback`` (an error under
    ``KSPIDER_NATIVE=force``) and the numpy packer takes over."""
    from kspider_tpu_torch.io import native

    if out is not None:
        out.fill(0)
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
                out=out,
            )
        except native.NativeRequiredError:
            raise
        except Exception as exc:
            native.report_fallback("pack_segments", exc)
            if out is not None:
                out.fill(0)  # the failed call may have set bits
    off, mem = _gather_side(plan, segs_slice)
    bits = _pack_side(off, mem - panel_id * plan.panel, n_blocks, block,
                      panel_pad)
    if out is None:
        return bits
    out[...] = bits
    return out


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


def _pad_limbs(wl: np.ndarray, n_blocks: int, block: int,
               out: Optional[np.ndarray] = None) -> np.ndarray:
    """(colors, L) limbs -> i8[n_blocks, L, block], zero-padded colors;
    written into ``out`` when given."""
    n_limbs = wl.shape[1]
    padded = np.zeros((n_blocks * block, n_limbs), dtype=np.int8)
    padded[: len(wl)] = wl
    padded = padded.reshape(n_blocks, block, n_limbs).transpose(0, 2, 1)
    if out is None:
        return np.ascontiguousarray(padded)
    out[...] = padded
    return out


class _PostingsSide(tuple):
    """A panel side shipped as posting keys and packed on the device:
    ``(payload, n_blocks)`` where payload is raw i32 keys (exact length),
    ``("d16", first, i16 deltas, count)`` or
    ``("d8", first, u8 deltas, i32 exceptions, count)``."""

    __slots__ = ()


# ---- host staging, streams and the device compaction ------------------------

#: byte alignment of the arrays handed out by a pinned staging slot
_ALIGN = 64


def _pow2(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


def _pinned_page(nbytes: int) -> torch.Tensor:
    return torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)


class _Slot:
    """The host arrays of one panel pair in flight.

    Pinned: views into pinned pages, handed out in order; a page that
    overflows is followed by a bigger one, and :meth:`reset` merges them.
    ``event`` marks the last H2D copy that reads the slot.  Not pinned:
    fresh numpy arrays."""

    def __init__(self, pinned: bool):
        self.pinned = pinned
        self.pages = []
        self.used = 0  # bytes handed out from the last page
        self.total = 0  # bytes handed out since the last reset
        self.event = None

    def reset(self):
        """Wait until the copies of the slot's last pair have read it."""
        if self.event is not None:
            self.event.synchronize()
            self.event = None
        if len(self.pages) > 1:
            self.pages = [_pinned_page(_pow2(self.total))]
        self.used = self.total = 0

    def empty(self, shape, dtype) -> np.ndarray:
        dtype = np.dtype(dtype)
        if not self.pinned:
            return np.empty(shape, dtype)
        nbytes = int(np.prod(shape)) * dtype.itemsize
        padded = _cdiv(max(nbytes, 1), _ALIGN) * _ALIGN
        if not self.pages or self.used + padded > self.pages[-1].numel():
            last = self.pages[-1].numel() if self.pages else 0
            self.pages.append(_pinned_page(_pow2(max(padded, 2 * last,
                                                     1 << 20))))
            self.used = 0
        view = self.pages[-1][self.used:self.used + nbytes].numpy()
        self.used += padded
        self.total += padded
        return view.view(dtype).reshape(shape)

    def put(self, arr: np.ndarray) -> np.ndarray:
        """``arr`` staged in the slot (itself when not pinned)."""
        if not self.pinned:
            return arr
        out = self.empty(arr.shape, arr.dtype)
        out[...] = arr
        return out


class _HostSlots:
    """A ring of ``depth`` staging slots, one per panel pair in flight: the
    pack worker refills slot ``p % depth`` for pair p only after the H2D
    copies of pair ``p - depth`` have completed."""

    def __init__(self, depth: int, pinned: bool):
        self.pinned = pinned
        self.slots = [_Slot(pinned) for _ in range(depth)]

    def begin(self, p: int) -> _Slot:
        slot = self.slots[p % len(self.slots)]
        slot.reset()
        return slot


def compact_kept(total: torch.Tensor, keep: torch.Tensor,
                 iota: Optional[torch.Tensor] = None):
    """The kept entries of a tile, compacted on its device with no host
    sync: ``(flat indices, values, count)``, the first ``count`` entries of
    each in row-major order (as ``torch.nonzero``), ``count`` a one-element
    int64 tensor.  A cumsum of the mask ranks the kept entries from 1;
    multiplied by the mask, it sends every dropped entry to rank 0, the one
    spare slot at the front of each buffer, so the scatters need no
    boolean indexing, ``nonzero`` or ``masked_select`` (each of which
    syncs).  ``iota`` is ``arange(keep.numel())`` on the device, when the
    caller keeps one."""
    flat = keep.reshape(-1)
    size = flat.numel()
    pos = torch.cumsum(flat, 0)
    count = pos[-1:].clone()
    dst = pos.mul_(flat)
    if iota is None:
        iota = torch.arange(size, device=total.device)
    idx = torch.empty(size + 1, dtype=torch.int64, device=total.device)
    idx.scatter_(0, dst, iota)
    vals = torch.empty(size + 1, dtype=total.dtype, device=total.device)
    vals.scatter_(0, dst, total.reshape(-1))
    return idx[1:], vals[1:], count


@functools.lru_cache(maxsize=None)
def _side_streams(device: torch.device):
    """The copy (H2D) and D2H streams of a CUDA device, one pair for the
    process: the caching allocator keeps blocks per stream, so new streams
    on every call would strand the blocks of the old ones."""
    return torch.cuda.Stream(device), torch.cuda.Stream(device)


class _Lane:
    """One device's side of the panel loop.

    On a CUDA device: a copy stream for the H2D of the staged host arrays, a
    D2H stream for the extracts, a pinned ring of per-pair counts and a
    pinned fetch buffer; the compute stream is the current one.  On the
    CPU: none of these, and the same calls run in order."""

    def __init__(self, device: torch.device, depth: int, staged_reused: bool):
        self.device = device
        self.cuda = device.type == "cuda"
        # a CPU lane reading from reused (pinned) staging must copy
        self.clone = staged_reused and not self.cuda
        self.uploaded = False
        self.iota = None
        if self.cuda:
            self.copy, self.d2h = _side_streams(device)
            self.counts = torch.empty(depth, dtype=torch.int64, pin_memory=True)
            self.next_count = 0
            self.fetched = torch.empty(0, dtype=torch.int64, pin_memory=True)

    def upload(self, host: np.ndarray) -> torch.Tensor:
        """Start the H2D of a staged host array on the copy stream; the
        device tensor is readable on the compute stream after
        :meth:`wait_uploads`."""
        t = torch.from_numpy(host)
        if not self.cuda:
            return t.clone() if self.clone else t.to(self.device)
        with torch.cuda.stream(self.copy):
            d = t.to(self.device, non_blocking=True)
        d.record_stream(torch.cuda.current_stream(self.device))
        self.uploaded = True
        return d

    def wait_uploads(self):
        """Make the compute stream wait for the uploads issued so far;
        returns their event (None when there were none, or on the CPU)."""
        if not self.uploaded:
            return None
        ev = torch.cuda.Event()
        ev.record(self.copy)
        torch.cuda.current_stream(self.device).wait_event(ev)
        self.uploaded = False
        return ev

    def phase_a(self, total: torch.Tensor, keep: torch.Tensor):
        """Compact the kept entries and start the count's D2H; returns the
        pair's handle for :meth:`fetch`."""
        if self.iota is None or self.iota.numel() != keep.numel():
            self.iota = torch.arange(keep.numel(), device=self.device)
        idx, vals, count = compact_kept(total, keep, self.iota)
        if not self.cuda:
            return idx, vals, count, None
        k = self.next_count
        self.next_count = (k + 1) % len(self.counts)
        host = self.counts[k:k + 1]
        host.copy_(count, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.device))
        return idx, vals, host, ev

    def fetch(self, handle):
        """(flat indices, values) as int64 numpy arrays of one pair's kept
        entries; waits on that pair's events only."""
        idx, vals, count, ev = handle
        if not self.cuda:
            c = int(count)
            return idx[:c].numpy().copy(), vals[:c].numpy().copy()
        ev.synchronize()
        c = int(count)
        if c == 0:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        if self.fetched.numel() < 2 * c:
            self.fetched = torch.empty(_pow2(2 * c), dtype=torch.int64,
                                       pin_memory=True)
        out = self.fetched
        self.d2h.wait_event(ev)
        with torch.cuda.stream(self.d2h):
            out[:c].copy_(idx[:c], non_blocking=True)
            out[c:2 * c].copy_(vals[:c], non_blocking=True)
            done = torch.cuda.Event()
            done.record(self.d2h)
        idx.record_stream(self.d2h)
        vals.record_stream(self.d2h)
        done.synchronize()
        host = out.numpy()
        return host[:c].copy(), host[c:2 * c].copy()


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
    stats: Optional[dict] = None,
    device_pack: Optional[str] = None,
) -> Iterator[Tuple[int, int, np.ndarray, np.ndarray, np.ndarray]]:
    """Yield ``(pi, pj, gi, gj, shared)`` for every panel pair with work,
    in plan order.

    ``gi``/``gj`` are global 0-based int64 sample ids with gi < gj, in
    row-major order within the pair; ``shared`` the exact int64 counts
    >= max(1, min_shared).  The Gram product runs on ``device``, one
    device or a device list: with at least two pairs per device, pair p
    runs on ``devices[p % len(devices)]``; otherwise each pair's color
    blocks are split over the devices and the partial tiles summed on
    ``devices[0]``.  ``device_pack`` (auto/force/off; None reads
    ``KSPIDER_DEVICE_PACK``) ships sparse sides as posting keys packed on
    the device, by ``ops/bitmask.prefer_keys``; the others are packed on
    the host.  Pass a dict as ``stats`` for per-stage times, payload
    counters and the device layout (``devices``, ``pair_parallel``)."""
    devices = make_mesh(device)
    n_pairs = len(plan.pair_keys)
    pair_parallel = len(devices) > 1 and n_pairs >= 2 * len(devices)
    shards = 1 if pair_parallel else len(devices)
    n_limbs = plan.n_limbs
    panel_pad = max(cp.TILE, _cdiv(plan.panel, cp.TILE) * cp.TILE)
    sup = pw._MAX_COLORS_PER_CALL - (pw._MAX_COLORS_PER_CALL % block)
    floor = max(1, int(min_shared))
    dp_policy, dp_ratio = bm.device_pack_policy(device_pack)
    xfer = dict(bits_bytes=0, keys_bytes=0, bits_sides=0, keys_sides=0)
    inflight = max(2, len(devices)) if pair_parallel else INFLIGHT
    # a slot is packed (p + 1) while pair p dispatches and the window holds
    # inflight more: two past the window, the worker seldom waits on a copy
    slots = _HostSlots(inflight + 2,
                       pinned=any(d.type == "cuda" for d in devices))
    lanes = {d: _Lane(d, inflight + 2, slots.pinned) for d in devices}

    # ---- worker thread: host packing only, into the pair's staging slot --

    def _keys_side(slot, panel_id, segs_slice, n_blocks):
        """Posting keys for a side, or None to pack it on the host."""
        m = int(plan.seg_count[segs_slice].sum())
        if not bm.prefer_keys(dp_policy, dp_ratio, m,
                              n_blocks * block * panel_pad // 8):
            return None
        keys = _postings_keys(plan, panel_id, segs_slice, panel_pad,
                              n_blocks, block)
        if keys is None:
            return None
        enc = bm.encode_keys_best(keys, m)
        if enc is None:
            payload = slot.put(keys[:m])
        elif enc[0] == "d8":
            payload = ("d8", enc[1], slot.put(enc[2][:m]), slot.put(enc[3]), m)
        else:
            payload = ("d16", enc[1], slot.put(enc[2][:m]), m)
        return _PostingsSide((payload, n_blocks))

    def _bits_side(slot, panel_id, segs_slice, n_blocks):
        out = slot.empty((n_blocks, panel_pad // 8, block), np.uint8)
        return _pack_panel_side(plan, panel_id, segs_slice, n_blocks, block,
                                panel_pad, out=out)

    def _side(slot, panel_id, segs_slice, n_blocks):
        keys = _keys_side(slot, panel_id, segs_slice, n_blocks)
        return keys if keys is not None else _bits_side(
            slot, panel_id, segs_slice, n_blocks)

    def _limbs(slot, segs_slice, n_blocks):
        out = slot.empty((n_blocks, n_limbs, block), np.int8)
        return _pad_limbs(plan.w_limbs[plan.seg_color[segs_slice]], n_blocks,
                          block, out=out)

    def prepare(p: int):
        slot = slots.begin(p)
        pk = int(plan.pair_keys[p])
        pi, pj = pk // plan.n_panels, pk % plan.n_panels
        e0, e1 = int(plan.pair_off[p]), int(plan.pair_off[p + 1])
        segs_a = plan.ent_sega[e0:e1]
        segs_b = plan.ent_segb[e0:e1]
        chunks = []
        for cs in range(0, e1 - e0, sup):
            ce = min(cs + sup, e1 - e0)
            n_blocks = pw._round_up(_cdiv(ce - cs, block), shards)
            side_a = _side(slot, pi, segs_a[cs:ce], n_blocks)
            side_b = side_a if pi == pj else _side(
                slot, pj, segs_b[cs:ce], n_blocks)
            chunks.append((side_a, side_b,
                           _limbs(slot, segs_a[cs:ce], n_blocks)))
        return pi, pj, chunks, slot

    def timed_prepare(p: int):
        t0 = time.perf_counter()
        with record_function("kspider.pack"):
            out = prepare(p)
        return out, time.perf_counter() - t0

    # ---- dispatch thread: every device operation -------------------------

    def _upload(side, lane):
        """Start the H2D of a prepared side (or limbs) on the lane: a device
        tensor, or for posting keys ``(payload tensors, n_blocks)`` to be
        packed by :func:`_bits`; counts the sides that cross as posting
        keys or packed u8 bits (i8 limbs are not counted)."""
        if isinstance(side, _PostingsSide):
            payload, n_blocks = side
            xfer["keys_sides"] += 1
            if isinstance(payload, np.ndarray):
                xfer["keys_bytes"] += payload.nbytes
                return _PostingsSide((lane.upload(payload), n_blocks))
            xfer["keys_bytes"] += sum(a.nbytes for a in payload
                                      if isinstance(a, np.ndarray))
            return _PostingsSide((tuple(
                lane.upload(a) if isinstance(a, np.ndarray) else a
                for a in payload), n_blocks))
        if side.dtype == np.uint8:
            xfer["bits_sides"] += 1
            xfer["bits_bytes"] += side.nbytes
        return lane.upload(side)

    def _bits(placed):
        """An uploaded side as bits on the device: posting keys are packed
        there (on the compute stream, after :meth:`_Lane.wait_uploads`)."""
        if not isinstance(placed, _PostingsSide):
            return placed
        payload, n_blocks = placed
        geometry = (n_blocks, block, panel_pad)
        if isinstance(payload, torch.Tensor):
            return bm.scatter_pack_device(payload, *geometry)
        if payload[0] == "d8":
            _, first, d8, exc, count = payload
            return bm.scatter_pack_device_delta8(first, d8, exc, count,
                                                 *geometry)
        _, first, d16, count = payload
        return bm.scatter_pack_device_delta(first, d16, count, *geometry)

    def dispatch(pi: int, pj: int, chunks, slot, lane):
        """Launch every chunk, then phase A (:meth:`_Lane.phase_a`);
        returns the pair's extract handle.  Records on the slot the event
        of the last H2D copy that reads it."""
        diag = pi == pj
        total = None
        for side_a, side_b, wl in chunks:
            placed_a = _upload(side_a, lane)
            placed_b = placed_a if side_b is side_a else _upload(side_b, lane)
            wl = _upload(wl, lane)
            slot.event = lane.wait_uploads() or slot.event
            bits_a = _bits(placed_a)
            bits_b = bits_a if placed_b is placed_a else _bits(placed_b)
            if shards > 1:
                acc = _chunk_acc_sharded(bits_a, bits_b, wl, diag, panel_pad,
                                         devices)
            else:
                acc = _chunk_acc(bits_a, bits_b, wl, diag, panel_pad)
            if total is None:
                total = torch.zeros((panel_pad, panel_pad), dtype=torch.int64,
                                    device=lane.device)
            for l in range(n_limbs):
                total.add_(acc[l], alpha=128**l)
        keep = total >= floor
        if diag:
            keep = torch.triu(keep, diagonal=1)
        return lane.phase_a(total, keep)

    def extract(pi: int, pj: int, lane, handle):
        idx, vals = lane.fetch(handle)
        if len(idx) == 0:
            return None
        gi = pi * plan.panel + idx // panel_pad
        gj = pj * plan.panel + idx % panel_pad
        return gi, gj, vals

    t_pack = t_dispatch = t_extract = 0.0
    pending = deque()  # (pi, pj, lane, handle), oldest first
    ex = ThreadPoolExecutor(max_workers=1)
    try:
        fut = ex.submit(timed_prepare, 0) if n_pairs else None
        for p in range(n_pairs):
            with timed("kspider.pack_wait"):
                (pi, pj, chunks, slot), dt = fut.result()
            t_pack += dt
            if p + 1 < n_pairs:
                fut = ex.submit(timed_prepare, p + 1)
            t0 = time.perf_counter()
            lane = lanes[devices[p % len(devices)] if pair_parallel
                         else devices[0]]
            with record_function("kspider.dispatch"):
                pending.append((pi, pj, lane,
                                dispatch(pi, pj, chunks, slot, lane)))
            del chunks
            t_dispatch += time.perf_counter() - t0
            while len(pending) > inflight or (p + 1 == n_pairs and pending):
                t0 = time.perf_counter()
                done = pending.popleft()
                with record_function("kspider.extract"):
                    out = extract(*done)
                t_extract += time.perf_counter() - t0
                if out is not None:
                    yield done[0], done[1], *out
    finally:
        ex.shutdown(wait=True, cancel_futures=True)
    if stats is not None:
        stats.update(
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
    stats: Optional[dict] = None,
    plan: Optional[PanelPlan] = None,
    device_pack: Optional[str] = None,
) -> int:
    """Compute pairwise at any N and stream ``{p}_kSpider_pairwise.tsv``.

    Rows come out sorted by (source_1, source_2), byte-identical to the
    dense writer.  Returns the pair-row count.  ``plan`` reuses a prebuilt
    :func:`build_panel_plan` result; its panel and source shape must match.
    ``device`` is one device or a device list (see :func:`iter_panel_pairs`).
    Pass a dict as ``stats`` (or set ``echo_progress``) for the stage
    breakdown: pack (host, overlapped), dispatch, extract (device wait +
    D2H), tsv (the writes); the same stages, with the plan, the waits for
    the pack thread and each row's sort (``kspider.tsv`` too), are
    ``kspider.*`` ranges in a ``torch.profiler`` trace.  Rows are grouped
    and sorted by ``io/pairwise_tsv.iter_panel_rows`` and written by its
    ``write_rows_coo``.  With ``KSPIDER_PROFILE`` set, the panel loop and
    its writes run under ``utils.timing.profile_trace`` (a no-op inside
    another one, as under ``core.pairwise.run_pairwise``)."""
    devices = make_mesh(device)
    if plan is None:
        with timed("kspider.plan"):
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
    counts = pw_tsv.kmer_counts(index)
    path = prefix + "_kSpider_pairwise.tsv"
    empty = np.zeros(0, np.int64)
    pw_tsv.write_rows_coo(path, empty, empty, empty, counts, header=True)

    total = 0
    t_tsv = 0.0
    run_stats: dict = {} if stats is None else stats
    with profile_trace(devices):
        for pi, gi, gj, sv in pw_tsv.iter_panel_rows(iter_panel_pairs(
            plan, device=devices, block=block, min_shared=min_shared,
            stats=run_stats, device_pack=device_pack,
        )):
            if echo_progress:
                print(f"  panel row {pi + 1}/{plan.n_panels}", flush=True)
            t0 = time.perf_counter()
            with record_function("kspider.tsv"):
                pw_tsv.write_rows_coo(path, gi, gj, sv, counts, header=False)
            total += len(gi)
            t_tsv += time.perf_counter() - t0
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
    return total

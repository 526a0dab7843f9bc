"""Reader/writer for parallel-hashmap (``phmap_dump``) binary files.

The reference persists sketches and index artifacts as raw dumps of
``phmap::flat_hash_set`` / ``flat_hash_map`` tables
(kSpider/src/index.cpp:341-363, kSpider/sig_to_bin.cpp:62-63).
The on-disk layout of one flat table is::

    [u64 version]   (only in phmap >= 1.3.x; value >= 2**64 - 11)
    u64 size        (number of elements)
    u64 capacity    (slot-array length; 2**k - 1 by phmap's growth policy)
    -- nothing more if size == 0 --
    i8  ctrl[capacity + 17]   (control bytes: >=0 full, 0x80 empty,
                               0xFE deleted, 0xFF sentinel at [capacity],
                               then 16 cloned bytes for SIMD wraparound)
    u8  slots[capacity * slot_size]  (raw slot payload, empties undefined)

Reading scans the control bytes and gathers full slots — this is exactly how
phmap iterates, so we can decode dumps from any element placement.  Writing
produces a layout the reference can *iterate* (its only use of loaded
tables: bins_indexing.cpp:182, check_bin.cpp, export_bin.cpp): elements are
placed densely from slot 0.  Because phmap's ``find()`` depends on its
internal hash placement, files we write are documented as iteration-
compatible, which covers every load site in the reference.

``parallel_flat_hash_map`` dumps are a u64 submap count followed by each
submap's flat dump; both layouts are supported.

Everything is vectorized numpy; no Python per-element loops.
"""

import io
import os
from typing import BinaryIO, Tuple, Union

import numpy as np

# phmap >= 1.3.x writes `s_version_base <= version <= s_version_base + 10`
# as the first word; s_version_base == 2**64 - 11.
_VERSION_BASE = (1 << 64) - 11
_CTRL_EMPTY = 0x80  # -128
_CTRL_DELETED = 0xFE  # -2
_CTRL_SENTINEL = 0xFF  # -1
_GROUP_WIDTH = 16  # SSE2 group width used by phmap on x86


def _normalize_capacity(n: int) -> int:
    """Smallest phmap capacity (2**k - 1) whose max load (7/8) fits n."""
    if n == 0:
        return 1
    cap = 1
    # growth limit of a capacity c (power-of-two minus one) is c - c/8
    while cap - cap // 8 < n:
        cap = cap * 2 + 1
    return cap


def _read_u64(f: BinaryIO) -> int:
    raw = f.read(8)
    if len(raw) != 8:
        raise EOFError("truncated phmap dump")
    return int(np.frombuffer(raw, dtype="<u8")[0])


class PhmapReader:
    """Sequentially decodes phmap dumps from a binary stream."""

    def __init__(self, f: Union[BinaryIO, str, os.PathLike]):
        if isinstance(f, (str, os.PathLike)):
            self._own = open(f, "rb")
            self.f = self._own
        else:
            self._own = None
            self.f = f

    def close(self) -> None:
        if self._own is not None:
            self._own.close()

    def __enter__(self) -> "PhmapReader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def load_u64(self) -> int:
        """One trivially-copyable u64 (BinaryInputArchive::loadBinary)."""
        return _read_u64(self.f)

    def load_flat_table(self, slot_dtype: np.dtype) -> np.ndarray:
        """Decode one flat_hash_{set,map} dump into an array of full slots.

        ``slot_dtype`` describes one slot (e.g. ``np.dtype('<u8')`` for
        flat_hash_set<uint64_t>, ``np.dtype([('k','<u4'),('v','<u4')])``
        for flat_hash_map<uint32_t,uint32_t>).
        """
        first = _read_u64(self.f)
        if first >= _VERSION_BASE:  # versioned dump: next word is size
            size = _read_u64(self.f)
        else:
            size = first
        capacity = _read_u64(self.f)
        slot_dtype = np.dtype(slot_dtype)
        if size == 0:
            return np.empty(0, dtype=slot_dtype)
        ctrl = np.frombuffer(self.f.read(capacity + _GROUP_WIDTH + 1), dtype=np.uint8)
        if ctrl.size != capacity + _GROUP_WIDTH + 1:
            raise EOFError("truncated phmap ctrl array")
        raw = self.f.read(capacity * slot_dtype.itemsize)
        if len(raw) != capacity * slot_dtype.itemsize:
            raise EOFError("truncated phmap slot array")
        slots = np.frombuffer(raw, dtype=slot_dtype)
        full = ctrl[:capacity] < 0x80  # high bit clear == full slot
        out = slots[full]
        if out.size != size:
            raise ValueError(
                f"phmap dump inconsistent: header size {size}, "
                f"{out.size} full slots"
            )
        return out.copy()

    def load_parallel_table(self, slot_dtype: np.dtype) -> np.ndarray:
        """Decode a parallel_flat_hash_{set,map} dump (submap count + dumps)."""
        num_submaps = _read_u64(self.f)
        parts = [self.load_flat_table(slot_dtype) for _ in range(num_submaps)]
        return np.concatenate(parts) if parts else np.empty(0, dtype=slot_dtype)


class PhmapWriter:
    """Sequentially encodes phmap dumps to a binary stream.

    Writes the un-versioned layout, which every phmap release can load
    (newer releases detect the missing version word for backward compat).
    """

    def __init__(self, f: Union[BinaryIO, str, os.PathLike]):
        if isinstance(f, (str, os.PathLike)):
            self._own = open(f, "wb")
            self.f = self._own
        else:
            self._own = None
            self.f = f

    def close(self) -> None:
        if self._own is not None:
            self._own.close()

    def __enter__(self) -> "PhmapWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def save_u64(self, v: int) -> None:
        self.f.write(np.uint64(v).tobytes())

    def save_flat_table(self, slots: np.ndarray) -> None:
        """Encode an array of slots as one flat_hash_{set,map} dump."""
        size = int(slots.size)
        capacity = _normalize_capacity(size)
        self.f.write(np.uint64(size).tobytes())
        self.f.write(np.uint64(capacity).tobytes())
        if size == 0:
            return
        ctrl = np.full(capacity + _GROUP_WIDTH + 1, _CTRL_EMPTY, dtype=np.uint8)
        # Dense placement from slot 0; ctrl byte is a 7-bit H2 marker.  We
        # derive it from the slot bytes so dumps are deterministic.
        h2 = (
            np.frombuffer(slots.tobytes(), dtype=np.uint8)
            .reshape(size, slots.dtype.itemsize)[:, 0]
            & 0x7F
        )
        ctrl[:size] = h2
        ctrl[capacity] = _CTRL_SENTINEL
        # cloned bytes: mirror of ctrl[0:16] for SIMD wraparound probes
        ctrl[capacity + 1 :] = ctrl[:_GROUP_WIDTH]
        self.f.write(ctrl.tobytes())
        buf = np.zeros(capacity, dtype=slots.dtype)
        buf[:size] = slots
        self.f.write(buf.tobytes())


# ---------------------------------------------------------------------------
# Convenience top-level functions for the artifact formats used by kSpider.
# ---------------------------------------------------------------------------

def read_hash_set(path) -> np.ndarray:
    """Read a sample ``.bin`` (flat_hash_set<uint64_t> dump) -> u64 array.

    Reference writer: kSpider/sig_to_bin.cpp:62-63.
    """
    with PhmapReader(path) as r:
        return np.sort(r.load_flat_table(np.dtype("<u8")))


def write_hash_set(path, hashes: np.ndarray) -> None:
    """Write hashes as a reference-iterable ``.bin`` file."""
    arr = np.ascontiguousarray(np.asarray(hashes, dtype="<u8"))
    with PhmapWriter(path) as w:
        w.save_flat_table(arr)


def read_u32_u32_map(path) -> Tuple[np.ndarray, np.ndarray]:
    """Read flat_hash_map<u32,u32> dump (e.g. _groupID_to_kmerCount.bin)."""
    dt = np.dtype([("k", "<u4"), ("v", "<u4")])
    with PhmapReader(path) as r:
        t = r.load_flat_table(dt)
    order = np.argsort(t["k"], kind="stable")
    return t["k"][order].astype(np.int64), t["v"][order].astype(np.int64)


def write_u32_u32_map(path, keys: np.ndarray, values: np.ndarray) -> None:
    dt = np.dtype([("k", "<u4"), ("v", "<u4")])
    t = np.empty(len(keys), dtype=dt)
    t["k"] = keys
    t["v"] = values
    with PhmapWriter(path) as w:
        w.save_flat_table(t)


def read_u64_u64_map(path) -> Tuple[np.ndarray, np.ndarray]:
    """Read flat_hash_map<u64,u64> dump (e.g. _color_count.bin)."""
    dt = np.dtype([("k", "<u8"), ("v", "<u8")])
    with PhmapReader(path) as r:
        t = r.load_flat_table(dt)
    order = np.argsort(t["k"], kind="stable")
    return t["k"][order].astype(np.uint64), t["v"][order].astype(np.uint64)


def write_u64_u64_map(path, keys: np.ndarray, values: np.ndarray) -> None:
    dt = np.dtype([("k", "<u8"), ("v", "<u8")])
    t = np.empty(len(keys), dtype=dt)
    t["k"] = keys
    t["v"] = values
    with PhmapWriter(path) as w:
        w.save_flat_table(t)


def read_phmap_sketch(prefix: str):
    """Best-effort reader for kProcessor ``.phmap`` sketch files.

    kSpider's sketch stage persists a ``kDataFramePHMAP`` (k-mer hash ->
    count map) via ``kf->save(prefix)`` (kSpider/src/fastx_to_kf.cpp:97).
    The kProcessor submodule is absent from the reference snapshot, so the
    exact container cannot be confirmed; the natural layout — and the one
    this reader decodes — is a single ``flat_hash_map<uint64_t, uint64_t>``
    phmap dump.  Returns ``(hashes u64 sorted, counts u64)`` or raises
    ValueError when the file does not parse as that layout.
    """
    path = prefix + ".phmap" if not str(prefix).endswith(".phmap") else str(prefix)
    dt = np.dtype([("k", "<u8"), ("v", "<u8")])
    with PhmapReader(path) as r:
        try:
            t = r.load_flat_table(dt)
            trailing = r.f.read(1)
        except (EOFError, ValueError) as e:
            raise ValueError(
                f"{path}: does not parse as a flat_hash_map<u64,u64> dump "
                f"({e}); the kProcessor build that wrote it may use a "
                "different layout — re-sketch with `kspider sketch`"
            )
    if trailing:
        raise ValueError(
            f"{path}: trailing bytes after the hash-map dump; unsupported "
            "kProcessor serialization variant"
        )
    order = np.argsort(t["k"], kind="stable")
    return t["k"][order].copy(), t["v"][order].copy()


def read_color_to_sources(path):
    """Read ``_color_to_sources.bin``: u64 record count, then per record a
    u64 color id followed by a flat_hash_set<u32> dump of source group ids.

    Reference writer: kSpider/src/index.cpp:353-359; reader:
    kSpider/src/pairwise.cpp:95-111.

    Returns ``(colors u64[C], offsets i64[C+1], members i64[P])`` with each
    color's members sorted ascending.
    """
    from kspider_tpu_torch.io import native

    if native.enabled():
        try:
            if not native.available():
                raise RuntimeError(
                    f"native library failed to load: {native.load_error()!r}"
                )
            return native.read_color_to_sources(path)
        except native.NativeRequiredError:
            raise
        except Exception as exc:
            native.report_fallback("read_color_to_sources", exc)
    colors = []
    member_arrays = []
    with PhmapReader(path) as r:
        count = r.load_u64()
        for _ in range(count):
            colors.append(r.load_u64())
            m = r.load_flat_table(np.dtype("<u4"))
            member_arrays.append(np.sort(m).astype(np.int64))
    colors = np.asarray(colors, dtype=np.uint64)
    lengths = np.array([len(m) for m in member_arrays], dtype=np.int64)
    offsets = np.zeros(len(colors) + 1, dtype=np.int64)
    np.cumsum(lengths, out=offsets[1:])
    members = (
        np.concatenate(member_arrays)
        if member_arrays
        else np.empty(0, dtype=np.int64)
    )
    return colors, offsets, members


def write_color_to_sources(path, colors, offsets, members) -> None:
    from kspider_tpu_torch.io import native

    if native.enabled():
        try:
            if not native.available():
                raise RuntimeError(
                    f"native library failed to load: {native.load_error()!r}"
                )
            native.write_color_to_sources(path, colors, offsets, members)
            return
        except native.NativeRequiredError:
            raise
        except Exception as exc:
            native.report_fallback("write_color_to_sources", exc)
    with PhmapWriter(path) as w:
        w.save_u64(len(colors))
        for i, c in enumerate(colors):
            w.save_u64(int(c))
            seg = np.ascontiguousarray(
                members[offsets[i] : offsets[i + 1]], dtype="<u4"
            )
            w.save_flat_table(seg)

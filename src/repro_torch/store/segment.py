"""The on-disk segment format: packed serving data + manifest + checksums.

A *segment* is one directory holding an immutable z-sorted snapshot of a
dataset, laid out so serving can attach without rebuilding:

    MANIFEST.json   — schema version, shape, curve spec (curve JSON),
                      per-array CRC32 checksums, build provenance
    xs.bin          — (n, d) '<u8' rows, z-sorted then sort-dim-ordered
                      per page (exactly `LMSFCIndex.xs` order)
    starts.bin      — (P+1,) '<i8' page row offsets
    mbrs.bin        — (P, d, 2) '<i8' page MBRs
    sort_dims.bin   — (P,) '<i4' per-page sort dimension
    page_zmin.bin   — (P,) '<u8' first z-address per page
    page_zmax.bin   — (P,) '<u8' last z-address per page

`open_segment` memory-maps `xs.bin` read-only and loads only the page
*metadata* (a few dozen bytes per page) into memory; `Segment.as_index()`
then yields a regular `LMSFCIndex` whose `xs` is the memmap — the CPU
engine, DeltaStore, and the executor's CPU exactness net all work
unchanged, touching pages on demand.  The metadata arrays are loaded as
writable copies on purpose: `DeltaStore` folds inserts into
`index.mbrs`/`page_zmin`/`page_zmax` in place, and those edits must never
write through to the immutable file.

Integrity: every array carries a CRC32 in the manifest.  Metadata arrays
are always verified on open; the (large) row store is verified when
``verify="full"`` (the default — at 10M x 3 rows that is one ~240MB
streaming pass) and size-checked only under ``verify="meta"``.  Any
mismatch raises `StoreCorruptionError` naming the file and the expected/
actual checksum.

`SegmentWriter` is the streaming producer used by `build.py`: it accepts
key-ascending row chunks, cuts fixed `page_rows` pages incrementally
(never holding more than one chunk + one partial page), and on `finalize`
runs the per-page sort-dimension pass in windowed rewrites of the row
file — the same `choose_sort_dims` policy the in-memory build applies —
accumulating the checksum inline.  `write_segment_from_index` converts an already-built in-memory
index into a segment with identical paging (handy for tests and for
migrating a live Database to disk).
"""
from __future__ import annotations

import dataclasses
import json
import os
import zlib

import numpy as np

from ..core import pgm as pgm_mod
from ..core import sortdim as sortdim_mod
from ..core.curve import MonotonicCurve, as_curve, curve_from_json
from ..core.index import IndexConfig, LMSFCIndex

# the JAX package's format name and version: a segment written by either
# package opens in the other
FORMAT = "repro.store.segment"
VERSION = 1
_CRC_CHUNK = 1 << 22          # 4 MiB streaming-checksum blocks


class StoreCorruptionError(RuntimeError):
    """A segment file failed validation (missing, truncated, or its bytes
    do not match the manifest checksum)."""


# ---------------------------------------------------------------------------
# checksums + array IO
# ---------------------------------------------------------------------------


def _crc32_file(path: str) -> int:
    crc = 0
    with open(path, "rb") as f:
        while True:
            blk = f.read(_CRC_CHUNK)
            if not blk:
                return crc & 0xFFFFFFFF
            crc = zlib.crc32(blk, crc)


def _crc32_memmap(mm: np.ndarray) -> int:
    flat = mm.reshape(-1).view(np.uint8)
    crc = 0
    for s in range(0, flat.size, _CRC_CHUNK):
        crc = zlib.crc32(flat[s:s + _CRC_CHUNK], crc)
    return crc & 0xFFFFFFFF


def _write_array(dirpath: str, fname: str, arr: np.ndarray) -> dict:
    arr = np.ascontiguousarray(arr)
    path = os.path.join(dirpath, fname)
    with open(path, "wb") as f:
        f.write(arr.tobytes())
    return {"file": fname, "dtype": arr.dtype.str,
            "shape": list(arr.shape),
            "crc32": zlib.crc32(arr.tobytes()) & 0xFFFFFFFF}


def _read_array(dirpath: str, name: str, entry: dict, *,
                verify: bool = True, writable: bool = True) -> np.ndarray:
    path = os.path.join(dirpath, entry["file"])
    dtype = np.dtype(entry["dtype"])
    shape = tuple(entry["shape"])
    want = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
    if not os.path.exists(path):
        raise StoreCorruptionError(f"segment array {name!r}: missing file "
                                   f"{path}")
    got = os.path.getsize(path)
    if got != want:
        raise StoreCorruptionError(
            f"segment array {name!r}: {path} holds {got} bytes, manifest "
            f"says {want} ({dtype.str} x {shape})")
    if verify:
        crc = _crc32_file(path)
        if crc != int(entry["crc32"]):
            raise StoreCorruptionError(
                f"segment array {name!r}: checksum mismatch on {path} "
                f"(manifest {int(entry['crc32']):#010x}, file {crc:#010x})")
    arr = np.fromfile(path, dtype=dtype).reshape(shape)
    if not writable:
        arr.flags.writeable = False
    return arr


def _z64_pair(z_u64: np.ndarray) -> np.ndarray:
    """uint64 -> (..., 2) int32 [hi, lo] (numpy-local twin of
    `zorder64.u64_to_z64`, kept here so packing stays device-free)."""
    z = np.asarray(z_u64, dtype=np.uint64)
    hi = (z >> np.uint64(32)).astype(np.uint32)
    lo = (z & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    return np.stack([hi, lo], axis=-1).view(np.int32)


# ---------------------------------------------------------------------------
# Segment
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Segment:
    """An opened on-disk segment: memmapped rows + in-memory page metadata."""

    path: str
    manifest: dict
    curve: MonotonicCurve
    xs: np.ndarray          # (n, d) uint64 read-only memmap
    starts: np.ndarray      # (P+1,) int64
    mbrs: np.ndarray        # (P, d, 2) int64
    sort_dims: np.ndarray   # (P,) int32
    page_zmin: np.ndarray   # (P,) uint64
    page_zmax: np.ndarray   # (P,) uint64
    _index: LMSFCIndex = dataclasses.field(default=None, repr=False)

    # -- shape ---------------------------------------------------------
    @property
    def n(self) -> int:
        return int(self.manifest["n"])

    @property
    def d(self) -> int:
        return int(self.manifest["d"])

    @property
    def K(self) -> int:
        return int(self.manifest["K"])

    @property
    def num_pages(self) -> int:
        return len(self.starts) - 1

    @property
    def cap(self) -> int:
        """Largest page row count (the per-page point capacity)."""
        return int(self.manifest["cap"])

    def data_bytes(self) -> int:
        return self.n * self.d * 8

    # -- serving views -------------------------------------------------
    def as_index(self, cfg: IndexConfig = None) -> LMSFCIndex:
        """An `LMSFCIndex` over the memmapped rows (PGM rebuilt on first
        call — page counts are small enough that persisting it would buy
        nothing).  Cached; `Database.from_segment` serves through this."""
        if self._index is None or cfg is not None:
            cfg = cfg or IndexConfig()
            index = LMSFCIndex(
                curve=self.curve, cfg=cfg, K=self.K, xs=self.xs,
                starts=self.starts, mbrs=self.mbrs,
                sort_dims=self.sort_dims, page_zmin=self.page_zmin,
                page_zmax=self.page_zmax,
                pgm=pgm_mod.build_pgm(self.page_zmin, eps=cfg.pgm_eps))
            if self._index is not None:
                return index
            self._index = index
        return self._index

    def num_groups(self, group_pages: int) -> int:
        return -(-self.num_pages // group_pages)

    def group_nbytes(self, group_pages: int) -> int:
        """Host/device size of one packed page-group block."""
        d, cap = self.d, self.cap
        per_page = d * cap * 4 + 2 * 4 + 2 * 4 + d * 2 * 4 + 4
        return group_pages * per_page

    def pack_group(self, g: int, group_pages: int) -> dict:
        """Pack page group `g` (pages [g*G, (g+1)*G)) into the page-major
        block layout of `core.serve.ServingArrays`, reading only those
        pages from the memmap.  The final group is padded to exactly G
        pages with dead pages (impossible MBR, +inf zmin) so every block
        has one static shape — the property the query-fn cache needs.
        Returns plain numpy arrays (points/page_zmin/page_zmax/page_mbr/
        page_size); the cache owns the device transfer."""
        G = int(group_pages)
        p0 = g * G
        p1 = min(p0 + G, self.num_pages)
        if not (0 <= p0 < self.num_pages):
            raise IndexError(f"group {g} out of range "
                             f"({self.num_groups(G)} groups of {G} pages)")
        d, cap = self.d, self.cap
        m = p1 - p0
        pts = np.zeros((G, d, cap), dtype=np.uint32)
        size = np.zeros(G, dtype=np.int32)
        sizes = np.diff(self.starts[p0:p1 + 1]).astype(np.int64)
        size[:m] = sizes
        rows = np.asarray(self.xs[self.starts[p0]:self.starts[p1]],
                          dtype=np.uint64)
        off = np.concatenate([[0], np.cumsum(sizes)])
        for j in range(m):
            pts[j, :, :sizes[j]] = \
                rows[off[j]:off[j + 1]].astype(np.uint32).T
        mbr = np.zeros((G, d, 2), dtype=np.uint32)
        mbr[:m] = self.mbrs[p0:p1].astype(np.uint32)
        mbr[m:, :, 0] = np.uint32(0xFFFFFFFF)   # dead: lo > hi, never matches
        zmin = np.full((G, 2), np.int32(-1))    # dead: +inf unsigned
        zmax = np.zeros((G, 2), dtype=np.int32)
        zmin[:m] = _z64_pair(self.page_zmin[p0:p1])
        zmax[:m] = _z64_pair(self.page_zmax[p0:p1])
        return {"points": pts.view(np.int32), "page_zmin": zmin,
                "page_zmax": zmax, "page_mbr": mbr.view(np.int32),
                "page_size": size}

    def verify(self) -> None:
        """Re-run the full checksum pass (metadata + row store)."""
        for name, entry in self.manifest["arrays"].items():
            _read_array(self.path, name, entry, verify=(name != "xs"))
        entry = self.manifest["arrays"]["xs"]
        crc = _crc32_memmap(self.xs)
        if crc != int(entry["crc32"]):
            raise StoreCorruptionError(
                f"segment array 'xs': checksum mismatch on "
                f"{os.path.join(self.path, entry['file'])} (manifest "
                f"{int(entry['crc32']):#010x}, file {crc:#010x})")


def open_segment(path: str, *, verify: str = "full") -> Segment:
    """Open a segment directory.  ``verify``: ``"full"`` checksums every
    array including the row store (default), ``"meta"`` checksums only the
    page metadata and size-checks the row store, ``"none"`` size-checks
    only."""
    if verify not in ("full", "meta", "none"):
        raise ValueError(f"verify must be 'full' | 'meta' | 'none'; "
                         f"got {verify!r}")
    mpath = os.path.join(path, "MANIFEST.json")
    if not os.path.exists(mpath):
        raise StoreCorruptionError(f"no segment at {path!r}: MANIFEST.json "
                                   f"missing")
    try:
        with open(mpath) as f:
            manifest = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        raise StoreCorruptionError(f"unreadable manifest {mpath}: {e}") from e
    if manifest.get("format") != FORMAT:
        raise StoreCorruptionError(f"{mpath}: not a segment manifest "
                                   f"(format={manifest.get('format')!r})")
    if int(manifest.get("version", -1)) > VERSION:
        raise StoreCorruptionError(
            f"{mpath}: segment version {manifest['version']} is newer than "
            f"this reader (supports <= {VERSION})")
    arrays = manifest["arrays"]
    meta_verify = verify != "none"
    # metadata loads as writable in-memory copies (DeltaStore folds deltas
    # into mbrs/zmin/zmax in place; the file must stay untouched)
    starts = _read_array(path, "starts", arrays["starts"], verify=meta_verify)
    mbrs = _read_array(path, "mbrs", arrays["mbrs"], verify=meta_verify)
    sort_dims = _read_array(path, "sort_dims", arrays["sort_dims"],
                            verify=meta_verify)
    page_zmin = _read_array(path, "page_zmin", arrays["page_zmin"],
                            verify=meta_verify)
    page_zmax = _read_array(path, "page_zmax", arrays["page_zmax"],
                            verify=meta_verify)
    xe = arrays["xs"]
    xpath = os.path.join(path, xe["file"])
    dtype = np.dtype(xe["dtype"])
    shape = tuple(xe["shape"])
    want = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
    if not os.path.exists(xpath):
        raise StoreCorruptionError(f"segment array 'xs': missing file "
                                   f"{xpath}")
    if os.path.getsize(xpath) != want:
        raise StoreCorruptionError(
            f"segment array 'xs': {xpath} holds {os.path.getsize(xpath)} "
            f"bytes, manifest says {want}")
    xs = np.memmap(xpath, dtype=dtype, mode="r", shape=shape)
    seg = Segment(path=path, manifest=manifest,
                  curve=curve_from_json(manifest["curve"]), xs=xs,
                  starts=starts, mbrs=mbrs, sort_dims=sort_dims,
                  page_zmin=page_zmin, page_zmax=page_zmax)
    if verify == "full":
        crc = _crc32_memmap(xs)
        if crc != int(xe["crc32"]):
            raise StoreCorruptionError(
                f"segment array 'xs': checksum mismatch on {xpath} "
                f"(manifest {int(xe['crc32']):#010x}, file {crc:#010x})")
    return seg


# ---------------------------------------------------------------------------
# SegmentWriter — the streaming producer
# ---------------------------------------------------------------------------


class SegmentWriter:
    """Stream key-ascending row chunks into a segment.

    Feed `append_sorted(rows, keys)` with chunks whose keys never decrease
    (equal keys across or within chunks are deduplicated — first
    occurrence wins, matching `np.unique`'s pick on z-sorted data); rows
    are packed into fixed `page_rows` pages as they arrive and written
    straight to disk, so peak memory is one chunk + one partial page.
    `finalize()` applies the per-page sort-dimension ordering in windowed
    rewrites of the row file (workload-driven when given, dimension 0
    otherwise — identical policy to `LMSFCIndex.build`), seals checksums,
    and writes the manifest.
    """

    def __init__(self, path: str, *, curve, page_rows: int = 256,
                 build_info: dict = None):
        if page_rows < 1:
            raise ValueError(f"page_rows must be >= 1; got {page_rows}")
        self.path = path
        self.curve = as_curve(curve)
        self.page_rows = int(page_rows)
        self.build_info = dict(build_info or {})
        os.makedirs(path, exist_ok=True)
        self._xs_path = os.path.join(path, "xs.bin")
        self._xs_f = open(self._xs_path, "wb")
        self._n = 0
        self._last_key = None           # largest key written so far
        self._pend_rows = np.empty((0, self.curve.d), dtype=np.uint64)
        self._pend_keys = np.empty(0, dtype=np.uint64)
        self._page_sizes = []
        self._page_zmin = []
        self._page_zmax = []
        self._mbr_lo = []
        self._mbr_hi = []
        self._sealed = False

    # ------------------------------------------------------------------
    def append_sorted(self, rows: np.ndarray, keys: np.ndarray = None):
        """Append a chunk of rows sorted ascending by curve key.  `keys`
        (uint64 z-addresses under the writer's curve) are encoded here
        when omitted.  Duplicate keys — within the chunk or against
        already-written data — are dropped."""
        if self._sealed:
            raise RuntimeError("SegmentWriter already finalized")
        rows = np.asarray(rows, dtype=np.uint64)
        if rows.ndim != 2 or rows.shape[1] != self.curve.d:
            raise ValueError(f"rows must be (m, {self.curve.d}); "
                             f"got {rows.shape}")
        if len(rows) == 0:
            return
        keys = (self.curve.encode_np(rows) if keys is None
                else np.asarray(keys, dtype=np.uint64))
        if keys.shape != (len(rows),):
            raise ValueError(f"keys shape {keys.shape} != ({len(rows)},)")
        if len(keys) > 1 and np.any(keys[1:] < keys[:-1]):
            raise ValueError("chunk keys must be ascending")
        keep = np.empty(len(keys), dtype=bool)
        keep[0] = self._last_key is None or keys[0] != self._last_key
        keep[1:] = keys[1:] != keys[:-1]
        if self._last_key is not None and keys[0] < self._last_key:
            raise ValueError(
                f"chunk starts below already-written keys "
                f"({int(keys[0])} < {int(self._last_key)})")
        rows, keys = rows[keep], keys[keep]
        if len(rows) == 0:
            return
        self._last_key = keys[-1]
        if len(self._pend_rows):       # rows/keys are fresh copies (rows[keep])
            rows = np.concatenate([self._pend_rows, rows])
            keys = np.concatenate([self._pend_keys, keys])
        self._pend_rows, self._pend_keys = rows, keys
        self._emit_pages(final=False)

    def _emit_pages(self, final: bool):
        pr = self.page_rows
        B = len(self._pend_rows)
        n_full = B // pr
        cut = n_full * pr
        if final and cut < B:
            n_full += 1                  # trailing short page
            cut = B
        if n_full == 0:
            return
        rows = self._pend_rows[:cut]
        keys = self._pend_keys[:cut]
        self._xs_f.write(memoryview(np.ascontiguousarray(rows)).cast("B"))
        self._n += cut
        bounds = np.arange(0, cut + pr, pr)
        bounds[-1] = cut
        for i in range(n_full):
            s, e = bounds[i], bounds[i + 1]
            self._page_sizes.append(int(e - s))
            self._page_zmin.append(keys[s])
            self._page_zmax.append(keys[e - 1])
            self._mbr_lo.append(rows[s:e].min(axis=0))
            self._mbr_hi.append(rows[s:e].max(axis=0))
        # .copy(): a plain [cut:] view would pin the whole emitted window
        # as its base array until the next append
        self._pend_rows = self._pend_rows[cut:].copy()
        self._pend_keys = self._pend_keys[cut:].copy()

    # ------------------------------------------------------------------
    def finalize(self, workload=None) -> str:
        """Seal the segment: flush the tail page, apply per-page sort-dim
        ordering over the memmapped rows, write metadata + manifest.
        Returns the segment path."""
        if self._sealed:
            raise RuntimeError("SegmentWriter already finalized")
        self._emit_pages(final=True)
        self._xs_f.close()
        self._sealed = True
        if self._n == 0:
            raise ValueError("cannot finalize an empty segment")
        d, K = self.curve.d, self.curve.K
        sizes = np.asarray(self._page_sizes, dtype=np.int64)
        starts = np.concatenate([[0], np.cumsum(sizes)])
        mbrs = np.stack([np.asarray(self._mbr_lo, dtype=np.int64),
                         np.asarray(self._mbr_hi, dtype=np.int64)], axis=-1)
        if workload is not None:
            qL, qU = workload
            sort_dims = sortdim_mod.choose_sort_dims(
                mbrs, np.asarray(qL), np.asarray(qU), 2**K)
        else:
            sort_dims = np.zeros(len(sizes), dtype=np.int32)
        # pass 2: in-place per-page reorder by sort dimension (stable, so
        # z-order stays the tie-break — same as sortdim.apply_sort_dims),
        # done in ~32 MB read/rewrite windows of whole pages with the
        # checksum accumulated inline; regular file I/O instead of a
        # full-file memmap keeps touched pages out of the process RSS
        row_bytes = d * 8
        win_rows = max(self.page_rows, (1 << 25) // row_bytes)
        xs_crc = 0
        P = len(sizes)
        with open(self._xs_path, "r+b") as f:
            p = 0
            while p < P:
                q = p + 1
                while q < P and starts[q + 1] - starts[p] <= win_rows:
                    q += 1
                s, e = int(starts[p]), int(starts[q])
                f.seek(s * row_bytes)
                buf = np.fromfile(f, dtype="<u8",
                                  count=(e - s) * d).reshape(e - s, d)
                for j in range(p, q):
                    ls, le = int(starts[j]) - s, int(starts[j + 1]) - s
                    pg = buf[ls:le]
                    order = np.argsort(pg[:, sort_dims[j]], kind="stable")
                    buf[ls:le] = pg[order]
                mv = memoryview(buf).cast("B")
                f.seek(s * row_bytes)
                f.write(mv)
                xs_crc = zlib.crc32(mv, xs_crc)
                p = q
        arrays = {"xs": {"file": "xs.bin", "dtype": "<u8",
                         "shape": [self._n, d], "crc32": xs_crc}}
        arrays["starts"] = _write_array(self.path, "starts.bin",
                                        starts.astype("<i8"))
        arrays["mbrs"] = _write_array(self.path, "mbrs.bin",
                                      mbrs.astype("<i8"))
        arrays["sort_dims"] = _write_array(self.path, "sort_dims.bin",
                                           sort_dims.astype("<i4"))
        arrays["page_zmin"] = _write_array(
            self.path, "page_zmin.bin",
            np.asarray(self._page_zmin, dtype="<u8"))
        arrays["page_zmax"] = _write_array(
            self.path, "page_zmax.bin",
            np.asarray(self._page_zmax, dtype="<u8"))
        manifest = {
            "format": FORMAT, "version": VERSION,
            "n": self._n, "d": d, "K": K,
            "num_pages": len(sizes), "page_rows": self.page_rows,
            "cap": int(sizes.max()),
            "curve": self.curve.to_json(),
            "arrays": arrays,
            "build": self.build_info,
        }
        tmp = os.path.join(self.path, "MANIFEST.json.tmp")
        with open(tmp, "w") as f:
            json.dump(manifest, f, indent=1)
        os.replace(tmp, os.path.join(self.path, "MANIFEST.json"))
        return self.path


def write_segment_from_index(index: LMSFCIndex, path: str,
                             build_info: dict = None) -> str:
    """Persist an already-built in-memory index as a segment with
    identical paging (row order, page boundaries, MBRs, and sort dims are
    preserved bit-for-bit, so the reopened segment serves the same pages
    the live index did)."""
    os.makedirs(path, exist_ok=True)
    xs = np.ascontiguousarray(np.asarray(index.xs, dtype=np.uint64))
    sizes = np.diff(index.starts).astype(np.int64)
    arrays = {
        "xs": _write_array(path, "xs.bin", xs.astype("<u8")),
        "starts": _write_array(path, "starts.bin",
                               np.asarray(index.starts).astype("<i8")),
        "mbrs": _write_array(path, "mbrs.bin",
                             np.asarray(index.mbrs).astype("<i8")),
        "sort_dims": _write_array(path, "sort_dims.bin",
                                  np.asarray(index.sort_dims).astype("<i4")),
        "page_zmin": _write_array(path, "page_zmin.bin",
                                  np.asarray(index.page_zmin).astype("<u8")),
        "page_zmax": _write_array(path, "page_zmax.bin",
                                  np.asarray(index.page_zmax).astype("<u8")),
    }
    manifest = {
        "format": FORMAT, "version": VERSION,
        "n": index.n, "d": index.d, "K": index.K,
        "num_pages": index.num_pages,
        "page_rows": int(sizes.max()) if len(sizes) else 0,
        "cap": int(sizes.max()) if len(sizes) else 0,
        "curve": index.curve.to_json(),
        "arrays": arrays,
        "build": dict(build_info or {}, source="in-memory index"),
    }
    tmp = os.path.join(path, "MANIFEST.json.tmp")
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=1)
    os.replace(tmp, os.path.join(path, "MANIFEST.json"))
    return path

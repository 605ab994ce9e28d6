"""Execution engines behind `Database.query`, unified under one registry.

Every engine consumes uint64 query rectangles and produces host-numpy
results (`run` for COUNT, `run_range` for retrieval); `Database` layers
the exactness policy (overflow escalation + CPU fallback), the staleness
policy (DeltaStore epoch vs the engine's packed arrays), and the query
planner on top.

Each engine class declares which query kinds of the algebra
(`repro_torch.api.queries`) it executes natively via `capabilities`,
recorded in the registry at registration time (`engine_capabilities()`);
the Database planner routes a query whose kind an engine lacks to the CPU
engine, so every query type is answerable — exactly — on every configured
engine.

  cpu    — the faithful per-query engine (core/query.py); always reads the
           live index + DeltaStore, never stale, never overflows.
  torch  — single-shard batched engine (core/serve.py) on the plain-torch
           twins of the kernels, on any device (the reference's 'xla').
  cuda   — the same engine on the hand-written CUDA kernels (the
           reference's 'pallas').  Its device must be a CUDA device: it
           raises at attach otherwise, and never serves through the twins.

  distributed — the batched engine page-sharded over a mesh (a sequence
           of devices, one shard each, driven by one process); counts and
           overflow summed over the shards.  Backend 'cuda' (the kernels,
           the default on an all-CUDA mesh) raises on a mesh that holds a
           CPU device; 'torch' runs the twins.
  store  — segment-backed out-of-core serving through cached device page
           groups (`repro_torch.store.engine`; registered on first use).

Device engines keep a host-side copy of their `ServingArrays` plus the
DeltaStore epoch they were packed at; `sync()` re-packs only the pages
dirtied since that epoch (growing the point capacity when a delta page
overflows it) and re-uploads.  Query fns do NOT live on the engine: they
come from the Database's `Executor` (repro_torch.api.exec) — a bounded,
shape-bucketed cache shared across engines, so overflow escalation cannot
leak a fresh fn per budget pair.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import obs
from ..core.device import resolve_device
from ..core.query import QueryStats, query_count, query_range
from ..core.serve import (bucket_pow2, knn_seed_radius,
                          make_distributed_query_fn, make_query_fn,
                          make_range_fn, mesh_devices, pack_query_rects,
                          pack_serving_arrays, refresh_shards,
                          shard_serving_arrays, upload_serving_arrays)
from ..core.zorder64 import u64_to_z64
from .result import EngineConfig

_ENGINES = {}
_CAPABILITIES = {}
_RENAMED = {"xla": "torch", "pallas": "cuda"}


class StaleServingError(RuntimeError):
    """Device serving arrays predate the DeltaStore epoch and the engine
    was configured with ``on_stale='error'``."""


def register_engine(name: str):
    def deco(cls):
        _ENGINES[name] = cls
        _CAPABILITIES[name] = frozenset(cls.capabilities)
        cls.name = name
        return cls
    return deco


def engine_names() -> list:
    return sorted(_ENGINES)


def engine_capabilities() -> dict:
    """name -> frozenset of natively executed query kinds ('count',
    'range', 'point', 'knn'); the planner's routing table."""
    return dict(_CAPABILITIES)


def make_engine(name: str, db, config: EngineConfig = None):
    if name == "store" and name not in _ENGINES:
        from ..store import engine as _store_engine  # noqa: F401 — registers
    if name not in _ENGINES:
        hint = (f"; the port's engine for {name!r} is {_RENAMED[name]!r}"
                if name in _RENAMED else "")
        raise KeyError(f"unknown engine {name!r}; registered: "
                       f"{engine_names()}{hint}")
    return _ENGINES[name](db, config or EngineConfig())


class BaseEngine:
    """Interface: run a uint64 rect batch, report staleness, invalidate.

    `capabilities` names the query kinds the engine executes natively;
    anything else is routed to the CPU engine by the Database planner.
    """

    name = "?"
    capabilities = frozenset({"count"})

    def __init__(self, db, cfg: EngineConfig):
        self.db = db
        self.cfg = cfg

    # -- lifecycle ---------------------------------------------------------
    def sync(self, on_stale: str = "refresh") -> None:
        """Bring engine state up to the DeltaStore epoch (no-op on CPU)."""

    def invalidate(self) -> None:
        """Drop all packed/compiled state (after an index rebuild)."""

    # -- execution ---------------------------------------------------------
    @property
    def overflow_free_cand(self) -> int:
        """A max_cand at/above which candidate overflow cannot occur."""
        return 0

    @property
    def overflow_free_hits(self) -> int:
        """A max_hits at/above which hit-buffer overflow cannot occur."""
        return 0

    def run(self, Ls, Us, max_cand: int = None):
        """(Q, d) uint64 bounds -> (counts int64, overflow int32, stats)."""
        raise NotImplementedError

    def run_range(self, Ls, Us, max_cand: int = None, max_hits: int = None):
        """(Q, d) uint64 bounds -> (rows_list — one (m_i, d) uint64 array
        per query, engine order — cand_over int32, hit_over int32, stats)."""
        raise NotImplementedError


@register_engine("cpu")
class CpuEngine(BaseEngine):
    """Per-query CPU engine; exact by construction, delta-aware, stat-rich."""

    capabilities = frozenset({"count", "range", "point", "knn"})

    def run(self, Ls, Us, max_cand=None):
        stats = QueryStats()
        counts = np.zeros(len(Ls), dtype=np.int64)
        for i, (qL, qU) in enumerate(zip(Ls, Us)):
            st = query_count(self.db.index, qL, qU)
            counts[i] = st.result
            stats.merge(st)
        return counts, np.zeros(len(Ls), dtype=np.int32), stats

    def run_range(self, Ls, Us, max_cand=None, max_hits=None):
        stats = QueryStats()
        rows_list = []
        for qL, qU in zip(Ls, Us):
            rows, st = query_range(self.db.index, qL, qU)
            rows_list.append(rows)
            stats.merge(st)
        zeros = np.zeros(len(Ls), dtype=np.int32)
        return rows_list, zeros, zeros.copy(), stats


@register_engine("torch")
class TorchEngine(BaseEngine):
    """Single-shard batched engine (`core/serve.py`) on the plain-torch
    twins of the kernels, on `cfg.device` (else the Database's device,
    else CUDA).

    Natively counts, retrieves (the id-emitting range pipeline), and —
    through the ring-seeded range refinement the `Executor` orchestrates
    over this engine's packed arrays — serves point and kNN queries.
    """

    default_backend = "torch"
    backends = ("torch",)
    capabilities = frozenset({"count", "range", "point", "knn"})

    def __init__(self, db, cfg):
        super().__init__(db, cfg)
        if self.backend not in self.backends:
            raise ValueError(f"engine {self.name!r} takes backend in "
                             f"{self.backends}; got {self.backend!r}")
        self.device = self._resolve_device()
        self._host = None        # numpy ServingArrays (pack source of truth)
        self._arrays = None      # device ServingArrays
        self.built_epoch = -1
        # query fns live on the Database's Executor (a bounded,
        # shape-bucketed cache shared across engines) — not on the engine

    # -- config ------------------------------------------------------------
    def _resolve_device(self):
        cfg = self.cfg
        return resolve_device(cfg.device if cfg.device is not None
                              else self.db.device)

    @property
    def backend(self) -> str:
        return self.cfg.backend or self.default_backend

    @property
    def pad_pages_to(self) -> int:
        return self.cfg.pad_pages_to or 1

    # -- lifecycle ---------------------------------------------------------
    def invalidate(self):
        self._host = None
        self._arrays = None
        self.db.executor.evict(self)
        self.built_epoch = -1

    def sync(self, on_stale: str = "refresh"):
        store = self.db.store
        if self._host is None:
            # first pack is a build, not a stale serve: fold in any deltas
            # accumulated before the engine attached, whatever the policy
            with obs.span("engine.sync", engine=self.name, mode="build"):
                self._host = pack_serving_arrays(
                    self.db.index, pad_pages_to=self.pad_pages_to,
                    cap=self.cfg.cap)
                self.built_epoch = 0
                self._repack_dirty(store)
                self.built_epoch = store.epoch
                self._upload()
            return
        if self.built_epoch >= store.epoch:
            if self._arrays is None:
                self._upload()
            return
        if on_stale == "serve_stale":
            if self._arrays is None:
                self._upload()
            return
        if on_stale == "error":
            raise StaleServingError(
                f"{self.name} arrays at epoch {self.built_epoch} < store "
                f"epoch {store.epoch}; call refresh() or use "
                f"on_stale='refresh'")
        with obs.span("engine.sync", engine=self.name, mode="refresh"):
            self._repack_dirty(store)
            self.built_epoch = store.epoch
            self._upload()

    def _repack_dirty(self, store):
        """Re-pack only the pages dirtied since `built_epoch` into the host
        arrays, growing the point capacity when a delta page overflows it.
        Returns the pages re-packed, or None after a full repack at a grown
        capacity."""
        index = self.db.index
        dirty = store.dirty_since(self.built_epoch)
        if not dirty:
            return set()
        live = {p: store.live_page_rows(p) for p in dirty}
        cap = self._host.points.shape[2]
        need = max(len(r) for r in live.values())
        if need > cap:
            # capacity overflow: full repack at the grown cap.  The fresh
            # pack holds only base rows, so EVERY page ever mutated (not
            # just the ones dirty since built_epoch) must be re-applied,
            # else earlier-folded deltas/tombstones would silently revert.
            grown = max(need, 2 * cap)
            self._host = pack_serving_arrays(
                index, pad_pages_to=self.pad_pages_to, cap=grown)
            self.db.executor.evict(self)   # cap is a static shape: drop the
            dirty = None                   # fns launched at the old cap
            live = {p: store.live_page_rows(p)
                    for p in store.dirty_since(0)}
        h = self._host
        pts_u32 = h.points.view(np.uint32)
        mbr_u32 = h.page_mbr.view(np.uint32)
        for p, rows in live.items():
            k = len(rows)
            pts_u32[p] = 0
            pts_u32[p, :, :k] = rows.astype(np.uint32).T
            h.page_size[p] = k
            mbr_u32[p] = index.mbrs[p].astype(np.uint32)
            h.page_zmin[p] = u64_to_z64(index.page_zmin[p:p + 1])[0]
            h.page_zmax[p] = u64_to_z64(index.page_zmax[p:p + 1])[0]
        return None if dirty is None else set(dirty)

    def _upload(self):
        with obs.span("engine.upload", engine=self.name):
            self._arrays = upload_serving_arrays(self._host, self.device)
            if obs.enabled() and self.device.type == "cuda":
                torch.cuda.synchronize(self.device)

    # -- execution ---------------------------------------------------------
    @property
    def overflow_free_cand(self) -> int:
        if self._host is None:
            self.sync()
        return int(self._host.page_size.shape[0])

    @property
    def overflow_free_hits(self) -> int:
        if self._host is None:
            self.sync()
        return max(1, int(self._host.page_size.sum()))

    def live_row_total(self) -> int:
        """Total live rows in the packed arrays (kNN truncation bound)."""
        if self._host is None:
            self.sync()
        return int(np.asarray(self._host.page_size, dtype=np.int64).sum())

    def knn_radius(self, centers, k: int, metric: str = "l2") -> list:
        """Per-center covering-box half-widths for exact kNN (ring-seeded
        over the packed host arrays; see `core.serve.knn_seed_radius`)."""
        if self._host is None:
            self.sync()
        return knn_seed_radius(self._host, self.db.index.curve, centers, k,
                               metric)

    def _build_qfn(self, max_cand):
        return make_query_fn(
            self.db.index.curve, k_maxsplit=self.cfg.k_maxsplit,
            max_cand=max_cand, q_chunk=self.cfg.q_chunk,
            backend=self.backend)

    def _build_rfn(self, max_cand, max_hits):
        return make_range_fn(
            self.db.index.curve, k_maxsplit=self.cfg.k_maxsplit,
            max_cand=max_cand, max_hits=max_hits, q_chunk=self.cfg.q_chunk,
            backend=self.backend)

    def _device_queries(self, Ls, Us):
        """Pack a uint64 rect batch as a padded (Qp, d, 2) int32 tensor on
        the engine's device.  Qp is the batch's *shape bucket* (q_chunk *
        2^j), so varying traffic sizes hit a bounded set of shapes."""
        Qp = bucket_pow2(len(Ls), self.cfg.q_chunk)
        with obs.span("serve.upload", engine=self.name):
            return torch.from_numpy(pack_query_rects(Ls, Us, Qp)).to(
                self.device)

    def run(self, Ls, Us, max_cand=None):
        if len(Ls) == 0:      # nothing to pad or launch (off-bucket shape)
            return (np.empty(0, dtype=np.int64),
                    np.empty(0, dtype=np.int32), None)
        if self._arrays is None:
            self.sync()
        Q = len(Ls)
        q = self._device_queries(Ls, Us)
        fn = self.db.executor.count_fn(self, max_cand or self.cfg.max_cand)
        counts, over = fn(self._arrays, q)
        with obs.span("serve.readback", engine=self.name, kind="count"):
            return (counts.cpu().numpy()[:Q].astype(np.int64),
                    over.cpu().numpy()[:Q].astype(np.int32), None)

    def run_range(self, Ls, Us, max_cand=None, max_hits=None):
        if len(Ls) == 0:      # nothing to pad or launch (off-bucket shape)
            zeros = np.empty(0, dtype=np.int32)
            return [], zeros, zeros.copy(), None
        if self._arrays is None:
            self.sync()
        P_pad, _, slot_cap = self._host.points.shape
        if P_pad * slot_cap >= 2**31:
            # gid = page*cap + slot must fit int32; wrapping would drop
            # rows silently while still reporting exact
            raise ValueError(
                f"range retrieval needs pages*cap < 2^31 for int32 row "
                f"ids; got {P_pad} pages x cap {slot_cap}")
        Q = len(Ls)
        q = self._device_queries(Ls, Us)
        fn = self.db.executor.range_fn(
            self, max_cand or self.cfg.max_cand,
            max_hits or self.cfg.max_hits)
        ids, n_hits, co, ho = fn(self._arrays, q)
        with obs.span("serve.readback", engine=self.name, kind="range"):
            ids = ids.cpu().numpy()[:Q]
            co = co.cpu().numpy()[:Q].astype(np.int32)
            ho = ho.cpu().numpy()[:Q].astype(np.int32)
        # resolve global row ids (page * cap + slot) against the host copy
        with obs.span("serve.resolve_rows", engine=self.name):
            pts_u32 = np.ascontiguousarray(self._host.points).view(np.uint32)
            cap = pts_u32.shape[2]
            rows_list = []
            for i in range(Q):
                gid = ids[i][ids[i] >= 0].astype(np.int64)
                rows_list.append(
                    pts_u32[gid // cap, :, gid % cap].astype(np.uint64))
        return rows_list, co, ho, None


@register_engine("cuda")
class CudaEngine(TorchEngine):
    """Single-shard batched engine on the hand-written CUDA kernels
    (`window_filter`, `window_match`, `split_zranges`).

    The kernel wrappers take their plain twins for CPU tensors, so an
    engine on the CPU would serve through the twins while claiming the
    kernels: this one raises at attach unless its device is CUDA, and
    accepts no backend but 'cuda'.
    """

    default_backend = "cuda"
    backends = ("cuda",)

    def __init__(self, db, cfg):
        super().__init__(db, cfg)
        if self.device.type != "cuda":
            raise ValueError(
                f"the 'cuda' engine runs the CUDA kernels and needs a CUDA "
                f"device; got {self.device} (use the 'torch' engine for "
                f"the plain-torch path on the host)")


@register_engine("distributed")
class DistributedEngine(TorchEngine):
    """Page-sharded engine over a mesh; counts and overflow summed over the
    shards (`core.serve.make_distributed_query_fn`).

    `EngineConfig.mesh` is the sequence of devices, one page shard each
    (default: every visible CUDA device; ``(cpu,)`` under ``device="cpu"``).
    Pages pad to a multiple of the shard count.  Point queries lower to
    one-cell counts; range retrieval and kNN are not sharded — the planner
    serves them via the CPU engine, as in the reference.  Backend 'cuda'
    (the default unless every mesh device is the CPU) raises at attach on
    a mesh that holds a CPU device, and never serves through the twins.
    """

    backends = ("cuda", "torch")
    capabilities = frozenset({"count", "point"})

    def __init__(self, db, cfg):
        self._stale_pages = None   # host pages to copy into their shards
        self._mesh = None
        super().__init__(db, cfg)
        if self.backend == "cuda" and any(d.type != "cuda"
                                          for d in self.mesh):
            raise ValueError(
                f"the 'distributed' engine's 'cuda' backend runs the CUDA "
                f"kernels on every shard; the mesh holds "
                f"{[str(d) for d in self.mesh]} (use backend='torch' for "
                f"the plain-torch twins)")

    @property
    def mesh(self) -> tuple:
        if self._mesh is None:
            mesh = self.cfg.mesh
            if mesh is None:      # every visible card, else the one device
                dev = super()._resolve_device()
                mesh = ([torch.device("cuda", i)
                         for i in range(torch.cuda.device_count())]
                        if dev.type == "cuda" and dev.index is None
                        else [dev])
            self._mesh = mesh_devices(mesh)
        return self._mesh

    def _resolve_device(self):
        return self.mesh[0]        # queries and the summed counts live here

    @property
    def default_backend(self) -> str:
        # the twins only where no shard is on a card: a mixed mesh takes
        # 'cuda' and so raises at attach
        return ("torch" if all(d.type == "cpu" for d in self.mesh)
                else "cuda")

    @property
    def pad_pages_to(self) -> int:
        return self.cfg.pad_pages_to or len(self.mesh)

    def _repack_dirty(self, store):
        # None (a grown capacity re-packed every page): upload shards whole
        self._stale_pages = super()._repack_dirty(store)

    def _upload(self):
        with obs.span("engine.upload", engine=self.name):
            if self._arrays is not None and self._stale_pages is not None:
                refresh_shards(self._arrays, self._host, self.mesh,
                               self._stale_pages)
            else:
                self._arrays = shard_serving_arrays(self._host, self.mesh)
            self._stale_pages = None
            if obs.enabled():
                for dev in set(self.mesh):
                    if dev.type == "cuda":
                        torch.cuda.synchronize(dev)

    def _build_qfn(self, max_cand):
        fn, _ = make_distributed_query_fn(
            self.db.index.curve, self.mesh, k_maxsplit=self.cfg.k_maxsplit,
            max_cand=max_cand, q_chunk=self.cfg.q_chunk,
            backend=self.backend)
        return fn

    def _build_rfn(self, max_cand, max_hits):
        raise NotImplementedError(
            "the 'distributed' engine does not shard range retrieval; the "
            "planner serves Range and kNN through the CPU engine")

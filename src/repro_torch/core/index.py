"""LMSFC index construction (paper §5, Fig. 4).

Pipeline: learn/choose θ → encode & sort by z-address → cost-based paging →
page-level sort dimensions → PGM forward index over page z-mins.

Updates (paper §7.11) live in `repro_torch.api.deltas.DeltaStore`; the free
functions at the end of this module are thin shims over it.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from . import paging as paging_mod
from . import pgm as pgm_mod
from . import sortdim as sortdim_mod
from .curve import GlobalTheta, MonotonicCurve, as_curve
from .theta import Theta, default_K, zorder


@dataclasses.dataclass
class IndexConfig:
    paging: str = "heuristic"      # 'fixed' | 'heuristic' | 'dp'
    page_bytes: int = 8192          # B
    fill_factor: float = 0.25       # f
    alpha: float = 1.5              # heuristic MBR growth bound
    k_maxsplit: int = 4             # recursive query splitting depth
    pgm_eps: int = 128              # PGM error bound
    use_sort_dim: bool = True
    use_query_split: bool = True
    skipping: str = "rqs"           # 'rqs' | 'fnz' | 'none'


@dataclasses.dataclass
class LMSFCIndex:
    curve: MonotonicCurve
    cfg: IndexConfig
    K: int
    xs: np.ndarray          # (n, d) uint64, z-sorted then sort-dim-ordered per page
    starts: np.ndarray      # (P+1,)
    mbrs: np.ndarray        # (P, d, 2) int64
    sort_dims: np.ndarray   # (P,)
    page_zmin: np.ndarray   # (P,) uint64
    page_zmax: np.ndarray   # (P,) uint64
    pgm: pgm_mod.PGMIndex

    # ------------------------------------------------------------------
    @property
    def theta(self) -> Theta:
        """Legacy accessor: the single global θ (pre-curve call sites).
        Only meaningful for `GlobalTheta` indexes."""
        if isinstance(self.curve, GlobalTheta):
            return self.curve.theta
        raise AttributeError(
            f"index was built with a {type(self.curve).__name__} curve, "
            f"which has no single θ; use index.curve")

    @property
    def n(self) -> int:
        return len(self.xs)

    @property
    def d(self) -> int:
        return self.xs.shape[1]

    @property
    def num_pages(self) -> int:
        return len(self.starts) - 1

    def index_size_bytes(self) -> int:
        """Forward-index + page-metadata size (excludes the data itself),
        mirroring the paper's Table 6 accounting."""
        per_page = 8 + 8 + self.d * 2 * 8 + 4 + 8  # zmin zmax mbr sortdim start
        return self.pgm.size_bytes() + self.num_pages * per_page

    def page_of(self, z_u64) -> np.ndarray:
        """Page index containing z (last page with zmin <= z; clipped to 0)."""
        p = pgm_mod.lookup_le(self.pgm, self.page_zmin, z_u64)
        return np.clip(p, 0, self.num_pages - 1)

    # ------------------------------------------------------------------
    @staticmethod
    def build(data: np.ndarray, theta=None, cfg: IndexConfig = None,
              workload=None, K: int = None, *,
              curve=None, z: np.ndarray = None,
              device=None) -> "LMSFCIndex":
        """data: (n, d) non-negative ints < 2^K, duplicate-free.

        The SFC is given as `curve` (any `MonotonicCurve`, a legacy `Theta`,
        or curve JSON); `theta=` remains as an alias for pre-curve call
        sites.  Default: z-order over K = default_K(d) bits.  `z`, when
        given, is the curve's uint64 keys of `data` (n,) computed elsewhere
        (the SMBO evaluator encodes a whole pool in one device launch); it
        must equal ``curve.encode_np(data)``, and the index is then the same.
        `device` is where ``paging="dp"`` runs above 200k rows (CUDA unless
        the caller passes ``device="cpu"``); every other build stays on the
        host.
        """
        cfg = cfg or IndexConfig()
        data = np.asarray(data, dtype=np.uint64)
        d = data.shape[1]
        if curve is not None and theta is not None:
            raise ValueError("pass either curve= or the legacy theta=, not both")
        curve = as_curve(curve if curve is not None else theta)
        if curve is None:
            K = K or default_K(d)
            curve = GlobalTheta(zorder(d, K))
        elif K is not None and K != curve.K:
            raise ValueError(f"K={K} conflicts with curve.K={curve.K}")
        K = curve.K
        if curve.d != d:
            raise ValueError(f"curve.d={curve.d} != data dimension {d}")

        if z is None:
            z = curve.encode_np(data)
        else:
            z = np.asarray(z, dtype=np.uint64)
            if z.shape != data.shape[:1]:
                raise ValueError(f"z has shape {z.shape}; data has "
                                 f"{len(data)} rows")
        order = np.argsort(z, kind="stable")
        xs = data[order]
        zs = z[order]

        pg = paging_mod.make_paging(
            xs.astype(np.int64), cfg.paging, K,
            page_bytes=cfg.page_bytes, fill_factor=cfg.fill_factor,
            alpha=cfg.alpha, device=device)
        starts = pg.starts
        page_zmin = zs[starts[:-1]]
        page_zmax = zs[starts[1:] - 1]

        if cfg.use_sort_dim and workload is not None:
            qL, qU = workload
            sort_dims = sortdim_mod.choose_sort_dims(pg.mbrs, qL, qU, 2**K)
        else:
            sort_dims = np.zeros(pg.num_pages, dtype=np.int32)
        xs = sortdim_mod.apply_sort_dims(xs, starts, sort_dims)

        pgm = pgm_mod.build_pgm(page_zmin, eps=cfg.pgm_eps)
        return LMSFCIndex(curve=curve, cfg=cfg, K=K, xs=xs, starts=starts,
                          mbrs=pg.mbrs, sort_dims=sort_dims,
                          page_zmin=page_zmin, page_zmax=page_zmax, pgm=pgm)


# ---------------------------------------------------------------------------
# updates (paper §7.11): delta pages (LMSFCb) + tombstones + rebuild (LMSFCa)
#
# Update state lives in an explicit `repro_torch.api.deltas.DeltaStore`
# (with a staleness epoch that serving engines check); the free functions
# below are thin shims, the reference's pre-facade call sites.
# Prefer `repro_torch.api.Database.insert/delete/rebuild`.
# ---------------------------------------------------------------------------


def _store(index: "LMSFCIndex"):
    from ..api.deltas import get_delta_store  # lazy: api imports core
    return get_delta_store(index)


def insert(index: "LMSFCIndex", x) -> int:
    """LMSFCb-style insertion: append to the target page's unsorted delta
    array (located via the learned forward index); queries scan deltas.
    Returns the page id."""
    return _store(index).insert(x)


def delete(index: "LMSFCIndex", x) -> None:
    """Tombstone deletion (paper: 'mark a record as deleted')."""
    _store(index).delete(x)


def delta_count(index: "LMSFCIndex", p: int, qL, qU) -> int:
    """Extra matches from page p's delta array (minus tombstones)."""
    if not hasattr(index, "_delta_store"):
        return 0
    return _store(index).delta_count(p, qL, qU)


def needs_rebuild(index: "LMSFCIndex", frac: float = 0.1) -> bool:
    return _store(index).n_inserted > frac * index.n


def rebuild(index: "LMSFCIndex", workload=None) -> "LMSFCIndex":
    """Merge deltas, drop tombstones (vectorized row-set membership),
    rebuild paging/sort-dims/PGM (the paper's LMSFCa periodic maintenance;
    callers may re-run learn_sfc for a fresh θ before calling this)."""
    data = _store(index).merged_data()
    return LMSFCIndex.build(data, curve=index.curve, cfg=index.cfg,
                            workload=workload)

"""ZM-index baseline [37]: fixed z-order curve + learned (PGM) forward index
+ fixed-size paging.  Exactly our LMSFCIndex with θ = θ_z and every LMSFC
optimization disabled — which is the point: the ablation's common substrate."""
from __future__ import annotations

import numpy as np

from ..core.index import IndexConfig, LMSFCIndex
from ..core.theta import default_K, zorder


def build_zm_index(data: np.ndarray, *, K: int = None, page_bytes: int = 8192,
                   use_query_split: bool = False, paging: str = "fixed",
                   skipping: str = "none", workload=None) -> LMSFCIndex:
    d = data.shape[1]
    K = K or default_K(d)
    cfg = IndexConfig(paging=paging, page_bytes=page_bytes,
                      use_sort_dim=False, use_query_split=use_query_split,
                      skipping=skipping)
    return LMSFCIndex.build(data, theta=zorder(d, K), cfg=cfg,
                            workload=workload, K=K)

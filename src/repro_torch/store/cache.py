"""`PageGroupCache`: an LRU of device-resident page groups over a segment.

The unit of caching is a *page group* — `group_pages` consecutive pages
packed into one fixed-shape `ServingArrays` block of torch tensors on the
cache's device (the final group is padded with dead pages, so every block
has one static shape and the executor's query-fn cache sees a bounded
shape set).  The `store` engine asks for the groups a query batch's
z-candidate ranges touch; hits come off the device unchanged, misses are
packed from the memmap and uploaded on demand.

The byte budget is a hard invariant, not a target: resident bytes never
exceed `budget_bytes`.  When a single batch pins more groups than the
budget holds, the overflow blocks are served *transiently* — uploaded,
used, and dropped without entering the LRU (counted as `bypass`) — so a
pathological batch degrades to streaming instead of breaking the bound.

Observability (`repro_torch.obs`, off by default):
  store.cache.hits / misses / evictions / bypass   — counters
  store.cache.resident_bytes                       — gauge
  store.cache.upload span per miss (labels: group, bytes)
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict

import numpy as np
import torch

from .. import obs
from ..core.device import resolve_device
from ..core.serve import ServingArrays
from .segment import Segment


@dataclasses.dataclass
class PageGroupCacheStats:
    """Host-side counters (always on; obs mirrors them when enabled)."""

    hits: int = 0         # group served from the device LRU
    misses: int = 0       # group packed + uploaded (cached or transient)
    evictions: int = 0    # LRU blocks dropped to respect the budget
    bypass: int = 0       # of the misses: served transiently (over budget)

    @property
    def lookups(self) -> int:
        return self.hits + self.misses

    def snapshot(self) -> "PageGroupCacheStats":
        return dataclasses.replace(self)


class PageGroupCache:
    """LRU of device-resident page-group blocks with a strict byte budget.

    Blocks live on `device` (CUDA unless the caller passes
    ``device="cpu"``)."""

    def __init__(self, segment: Segment, *, group_pages: int = 64,
                 budget_bytes: int = 256 << 20, device=None):
        self.segment = segment
        self.group_pages = int(group_pages)
        self.block_bytes = segment.group_nbytes(self.group_pages)
        self.budget_bytes = int(budget_bytes)
        if self.budget_bytes < self.block_bytes:
            raise ValueError(
                f"cache budget {self.budget_bytes} bytes is smaller than "
                f"one page-group block ({self.block_bytes} bytes = "
                f"{self.group_pages} pages x cap {segment.cap} x "
                f"d {segment.d}); raise cache_bytes or shrink group_pages")
        self.device = resolve_device(device)
        self.stats = PageGroupCacheStats()
        self._lru = OrderedDict()       # group id -> device ServingArrays
        self._dead = None

    # ------------------------------------------------------------------
    @property
    def num_groups(self) -> int:
        return self.segment.num_groups(self.group_pages)

    @property
    def resident_bytes(self) -> int:
        return len(self._lru) * self.block_bytes

    @property
    def resident_groups(self) -> int:
        return len(self._lru)

    def _upload(self, g: int) -> ServingArrays:
        with obs.span("store.cache.upload", group=g,
                      bytes=self.block_bytes):
            host = self.segment.pack_group(g, self.group_pages)
            blk = ServingArrays(**{k: torch.from_numpy(v).to(self.device)
                                   for k, v in host.items()})
            if obs.enabled() and self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            return blk

    def dead_block(self) -> ServingArrays:
        """One all-dead-pages device block (impossible MBRs, +inf zmin,
        size 0) for padding a batch's block list up to its shape bucket.
        Shared and never evicted; its bytes are not billed to the budget
        (it is a single constant per cache)."""
        if self._dead is None:
            G, d, cap = self.group_pages, self.segment.d, self.segment.cap
            mbr = np.zeros((G, d, 2), dtype=np.uint32)
            mbr[:, :, 0] = np.uint32(0xFFFFFFFF)
            dev = self.device
            self._dead = ServingArrays(
                points=torch.zeros((G, d, cap), dtype=torch.int32,
                                   device=dev),
                page_zmin=torch.full((G, 2), -1, dtype=torch.int32,
                                     device=dev),
                page_zmax=torch.zeros((G, 2), dtype=torch.int32, device=dev),
                page_mbr=torch.from_numpy(mbr.view(np.int32)).to(dev),
                page_size=torch.zeros(G, dtype=torch.int32, device=dev))
        return self._dead

    def get(self, groups) -> list:
        """Device blocks for `groups` (ordered, unique group ids).  The
        whole request is pinned for the call: evictions only ever remove
        groups NOT in `groups`, and if the request alone exceeds the
        budget the excess blocks bypass the LRU entirely."""
        groups = [int(g) for g in groups]
        pinned = set(groups)
        out = {}
        misses = []
        for g in groups:
            blk = self._lru.get(g)
            if blk is not None:
                self._lru.move_to_end(g)
                out[g] = blk
                self.stats.hits += 1
            else:
                misses.append(g)
        if obs.enabled() and len(groups):
            obs.inc("store.cache.hits", len(groups) - len(misses))
            obs.inc("store.cache.misses", len(misses))
        for g in misses:
            self.stats.misses += 1
            blk = self._upload(g)
            out[g] = blk
            # evict unpinned LRU victims until the block fits ...
            while (self.resident_bytes + self.block_bytes
                   > self.budget_bytes):
                victim = next((v for v in self._lru if v not in pinned),
                              None)
                if victim is None:
                    break
                del self._lru[victim]
                self.stats.evictions += 1
                obs.inc("store.cache.evictions")
            # ... and serve transiently when pinned blocks alone fill it
            if (self.resident_bytes + self.block_bytes
                    <= self.budget_bytes):
                self._lru[g] = blk
            else:
                self.stats.bypass += 1
                obs.inc("store.cache.bypass")
        obs.set_gauge("store.cache.resident_bytes", self.resident_bytes)
        obs.set_gauge("store.cache.resident_groups", len(self._lru))
        return [out[g] for g in groups]

    def clear(self) -> None:
        self.stats.evictions += len(self._lru)
        self._lru.clear()
        self._dead = None
        obs.set_gauge("store.cache.resident_bytes", 0)
        obs.set_gauge("store.cache.resident_groups", 0)

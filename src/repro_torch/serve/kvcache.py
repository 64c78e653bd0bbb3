"""KV-cache allocation for the serving engine, in PyTorch.

The port of ``repro/serve/kvcache.py`` without its mesh/rules sharding
(that waits for the multi-device layer).  Two layers:

- ``init_cache``/``cache_bytes`` — the contiguous cache: one
  (L, batch, capacity, KV, hd) block per k/v leaf.  ``ServingEngine``
  (fixed-batch) decodes against it directly.

- Paged serving (continuous batching): the physical store is a *page pool* —
  the very same ``init_cache`` schema instantiated with ``batch=n_pages`` and
  ``capacity=page_tokens``.  ``PageAllocator`` hands out pages to requests
  (per-request page tables, alloc on admit, free on finish; no page is ever
  owned by two live requests), and the gather/scatter helpers materialize a
  contiguous per-lane view for ``decode_step`` and write the appended
  token's KV back through the page table.

``scatter_token`` and ``write_pages`` update the pool in place (the
reference returns a new pool); they also return it, so call sites read the
same as the reference's.

Page 0 is reserved as a scratch page: batch lanes with no live request keep
decoding (the batch shape is fixed) and their KV write is redirected there
via an all-zero page-table row, so a dead lane can never corrupt a live
request's pages.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence

import torch

from repro_torch._device import as_dtype
from repro_torch.models.layers import tree_leaves, tree_map, zeros


def init_cache(api, batch: int, capacity: int, device) -> Any:
    """Concrete zeroed cache on ``device``."""
    return zeros(api.cache_schema(batch, capacity), device)


def cache_bytes(api, batch: int, capacity: int) -> int:
    return sum(math.prod(s.shape) * as_dtype(s.dtype).itemsize
               for s in tree_leaves(api.cache_schema(batch, capacity)))


# ---------------------------------------------------------------------------
# Paged pool (continuous batching)
# ---------------------------------------------------------------------------


SCRATCH_PAGE = 0  # never allocated; dead-lane writes land here


def init_paged_cache(api, n_pages: int, page_tokens: int, device):
    """Physical page pool: the ``init_cache`` schema at ``batch=n_pages``,
    ``capacity=page_tokens`` — leaves (L, n_pages, page_tokens, KV, hd)."""
    return init_cache(api, n_pages, page_tokens, device)


class PageAllocator:
    """Fixed-size-page allocator with per-request page tables.

    Pages are integer ids into the pool's page axis; ``alloc(req, n_tokens)``
    reserves ``ceil(n_tokens / page_tokens)`` pages for ``req`` (returning
    None — request stays queued — when the pool can't satisfy it), and
    ``free(req)`` returns every page to the free list on finish.  Page
    ``SCRATCH_PAGE`` is reserved and never handed out.
    """

    def __init__(self, n_pages: int, page_tokens: int):
        if n_pages < 2:
            raise ValueError("paged pool needs >= 2 pages (page 0 is scratch)")
        if page_tokens < 1:
            raise ValueError(f"page_tokens must be >= 1, got {page_tokens}")
        self.n_pages = n_pages
        self.page_tokens = page_tokens
        # LIFO free list: a just-freed request's pages are reused first,
        # which keeps the working set of hot pages small
        self._free: List[int] = list(range(n_pages - 1, SCRATCH_PAGE, -1))
        self.tables: Dict[Any, List[int]] = {}

    def pages_for(self, n_tokens: int) -> int:
        return -(-max(1, int(n_tokens)) // self.page_tokens)

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return (self.n_pages - 1) - len(self._free)

    def can_alloc(self, n_tokens: int) -> bool:
        return self.pages_for(n_tokens) <= len(self._free)

    def alloc(self, req_id, n_tokens: int) -> Optional[List[int]]:
        """Reserve pages covering ``n_tokens`` for ``req_id``; None when the
        pool is exhausted (the caller queues the request, never drops it)."""
        if req_id in self.tables:
            raise ValueError(f"request {req_id!r} already holds pages")
        k = self.pages_for(n_tokens)
        if k > len(self._free):
            return None
        pages = [self._free.pop() for _ in range(k)]
        self.tables[req_id] = pages
        return list(pages)

    def grow(self, req_id, n_tokens: int) -> Optional[List[int]]:
        """Extend ``req_id``'s table to cover ``n_tokens`` total; returns the
        full table, or None (caller must retire or wait) on exhaustion."""
        held = self.tables.get(req_id)
        if held is None:
            raise KeyError(f"request {req_id!r} holds no pages")
        need = self.pages_for(n_tokens) - len(held)
        if need <= 0:
            return list(held)
        if need > len(self._free):
            return None
        held.extend(self._free.pop() for _ in range(need))
        return list(held)

    def free(self, req_id) -> int:
        """Return ``req_id``'s pages to the pool; returns the count freed."""
        pages = self.tables.pop(req_id)
        self._free.extend(pages)
        return len(pages)

    def check_invariants(self) -> None:
        """No page owned twice, none leaked, scratch never handed out."""
        owned: List[int] = [p for t in self.tables.values() for p in t]
        assert len(owned) == len(set(owned)), "page owned by two live requests"
        assert SCRATCH_PAGE not in owned, "scratch page handed out"
        assert SCRATCH_PAGE not in self._free, "scratch page in free list"
        assert len(owned) + len(self._free) == self.n_pages - 1, "pages leaked"
        assert not (set(owned) & set(self._free)), "page both free and owned"


# -- gather/scatter (leaves are (L, P, pt, ...) blocks) -----------------------


def gather_view(pool, tables: torch.Tensor):
    """Materialize a contiguous per-lane cache view from the page pool.

    ``tables`` is (B, max_pages) int — lane b's pages in order, padded with
    ``SCRATCH_PAGE`` (padded positions are masked by the lane's length).
    Leaves (L, P, pt, ...) -> (L, B, max_pages*pt, ...), the exact layout
    ``decode_step`` expects.  The view is a copy.
    """
    B, maxp = tables.shape

    def g(x):
        v = x[:, tables.long()]  # (L, B, maxp, pt, ...)
        return v.reshape(v.shape[0], B, maxp * x.shape[2], *x.shape[3:])

    return tree_map(g, pool)


def scatter_token(pool, view, tables: torch.Tensor, lens: torch.Tensor):
    """Write the KV entry each lane appended at position ``lens[b]`` of the
    gathered ``view`` back into that lane's page of the pool, in place.
    Lanes whose table row is all-``SCRATCH_PAGE`` (no live request) write
    to scratch."""
    tables, lens = tables.long(), lens.long()
    rows = torch.arange(tables.shape[0], device=tables.device)

    def s(x, v):
        pt = x.shape[2]
        page = tables[rows, lens // pt]
        x[:, page, lens % pt] = v[:, rows, lens].to(x.dtype)  # (L, B, ...)
        return x

    return tree_map(s, pool, view)


def cache_to_pages(cache, page_tokens: int):
    """Split one request's contiguous prefill cache (leaves (L, 1, cap, ...),
    ``cap`` a page multiple) into page chunks (L, cap/pt, pt, ...)."""

    def f(x):
        L, B, cap = x.shape[:3]
        if B != 1:
            raise ValueError(f"cache_to_pages expects a single-request cache, got B={B}")
        if cap % page_tokens:
            raise ValueError(f"capacity {cap} is not a multiple of {page_tokens}")
        return x[:, 0].reshape(L, cap // page_tokens, page_tokens, *x.shape[3:])

    return tree_map(f, cache)


def write_pages(pool, page_ids: Sequence[int], chunks):
    """Insert page chunks (leaves (L, k, pt, ...)) into pool pages
    ``page_ids``, in place — the prefill->decode handoff's final scatter."""

    def w(x, c):
        ids = torch.as_tensor(list(page_ids), dtype=torch.long, device=x.device)
        x[:, ids] = c.to(x.dtype)
        return x

    return tree_map(w, pool, chunks)

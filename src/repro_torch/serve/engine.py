"""Serving engines: fixed-batch prefill+decode, and continuous batching.

The port of ``repro/serve/engine.py``.  ``ServingEngine`` is the
fixed-batch engine: requests are grouped into one batch; finished
sequences are masked to EOS (output and fed-back token) while the batch
keeps stepping.

``ContinuousBatchingEngine`` serves a request *stream*: a paged KV pool
(``serve/kvcache.py``) replaces the contiguous per-batch cache, each batch
lane holds one live request with its own page table and length, and
finished lanes are retired and refilled mid-decode.  ``serve/scheduler.py``
drives it over a request trace.  Prefill/decode disaggregation over device
carvings (the reference's ``submeshes``) waits for the multi-device layer.

Both engines take ``device`` (default: the card; they raise when there is
none) and cast the weights to ``cfg.dtype`` once at construction — the
reference casts them at every use, with the same numbers — keeping norm
scales in fp32 as the reference's ``rms_norm`` reads them.  The engines
synchronise the device where the reference called ``block_until_ready``,
so ``prefill_s``/``decode_s`` time finished work.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from repro_torch._device import DeviceLike, as_dtype, resolve_device, sync
from repro_torch.models.api import ModelAPI, get_model
from repro_torch.models.layers import tree_map
from repro_torch.serve.kvcache import (
    SCRATCH_PAGE,
    PageAllocator,
    cache_to_pages,
    gather_view,
    init_cache,
    init_paged_cache,
    scatter_token,
    write_pages,
)


@dataclass
class ServeStats:
    prefill_s: float = 0.0
    prefills: int = 0
    decode_steps: int = 0    # batch steps dispatched
    decode_tokens: int = 0   # tokens actually produced (live lanes per step)
    decode_s: float = 0.0

    @property
    def tokens_per_s(self) -> float:
        """Decode throughput in *tokens* (live lanes x steps), comparable
        across batch sizes — not batch steps."""
        return self.decode_tokens / self.decode_s if self.decode_s else 0.0

    @property
    def steps_per_s(self) -> float:
        return self.decode_steps / self.decode_s if self.decode_s else 0.0


def serving_params(api: ModelAPI, params: dict, device: torch.device) -> dict:
    """``params`` on ``device``, every weight in ``cfg.dtype`` and every
    norm scale (logical axis 'norm') in fp32."""
    dt = as_dtype(api.cfg.dtype)

    def prep(x, spec):
        keep = spec.axes[-1] == "norm"
        return x.to(device=device, dtype=torch.float32 if keep else dt)

    return tree_map(prep, params, api.schema)


def _serving_api(cfg) -> ModelAPI:
    api = get_model(cfg)
    if api.prefill is None:
        raise NotImplementedError(
            f"{cfg.name}: serving the {cfg.block_type!r} family is not ported yet "
            "(ROADMAP Queue 1, item 8)")
    return api


class ServingEngine:
    def __init__(self, cfg, params, batch: int, capacity: int,
                 device: DeviceLike = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.api = _serving_api(cfg)
        self.params = serving_params(self.api, params, self.device)
        self.batch = batch
        self.capacity = capacity
        self.stats = ServeStats()
        self.reset()

    def reset(self) -> None:
        """Fresh KV state: every batch decodes against its own cache, never
        a predecessor's leftover entries."""
        self._cache = init_cache(self.api, self.batch, self.capacity, self.device)
        self._len = 0

    def _ids(self, tokens: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(tokens, np.int64), device=self.device)

    def prefill(self, prompts: np.ndarray) -> torch.Tensor:
        """prompts: (batch, prompt_len) int32 -> last-position logits."""
        t0 = time.perf_counter()
        B, P = prompts.shape
        if B != self.batch:
            raise ValueError(f"got {B} prompts for a batch of {self.batch}")
        last_logits, self._cache = self.api.prefill(self.params, self._ids(prompts),
                                                    self.capacity)
        self._len = P
        sync(self.device)
        self.stats.prefill_s += time.perf_counter() - t0
        self.stats.prefills += 1
        return last_logits

    def generate(self, prompts: np.ndarray, max_new_tokens: int,
                 eos_id: Optional[int] = None) -> np.ndarray:
        self.reset()
        logits = self.prefill(prompts)
        out: List[np.ndarray] = []
        tok = torch.argmax(logits, dim=-1).cpu().numpy().astype(np.int32)
        done = np.zeros((self.batch,), bool)
        t0 = time.perf_counter()
        for i in range(max_new_tokens):
            cur = tok.copy()
            if eos_id is not None:
                # finished rows emit EOS, not the garbage their lane keeps
                # argmax-ing, and keep feeding it back (frozen)
                cur[done] = eos_id
                done |= cur == eos_id
            out.append(cur)
            if done.all() or i + 1 == max_new_tokens:
                # the last emitted token needs no further decode: logits
                # would be discarded, so neither compute nor count the step
                break
            live = int((~done).sum()) if eos_id is not None else self.batch
            logits, self._cache = self.api.decode_step(
                self.params, self._ids(cur[:, None]), self._cache, self._len
            )
            self._len += 1
            tok = torch.argmax(logits, dim=-1).cpu().numpy().astype(np.int32)
            self.stats.decode_steps += 1
            self.stats.decode_tokens += live
        sync(self.device)
        self.stats.decode_s += time.perf_counter() - t0
        return np.stack(out, axis=1)


# ---------------------------------------------------------------------------
# Continuous batching over the paged pool
# ---------------------------------------------------------------------------


class ContinuousBatchingEngine:
    """Request-stream serving: paged KV, per-lane lengths, lane reuse.

    ``lanes`` batch slots decode together in one step; each live lane holds
    one request, its page-table row and its own length (the ``(B,)``
    ``cache_len`` path of ``decode_step``).  Dead lanes keep stepping — the
    batch shape is fixed — with an all-scratch table row, so their writes
    land in the reserved scratch page and their logits are discarded.  On
    ``admit`` a request is prefilled (exact prompt length, page-multiple
    cache capacity), its cache is split into pages and written into the
    pool, and the prefill's last-position argmax becomes its first
    generated token; ``step`` advances every live lane one token;
    ``retire`` frees the lane and returns its pages.
    """

    def __init__(self, cfg, params, *, lanes: int, n_pages: int,
                 page_tokens: int = 16, lane_capacity: int = 128,
                 debug_checks: bool = False, device: DeviceLike = None):
        if cfg.block_type not in ("attn_mlp", "moe"):
            raise ValueError(
                f"paged serving needs a KV-cache family, got {cfg.block_type}"
            )
        self.device = resolve_device(device)
        self.cfg = cfg
        self.api = _serving_api(cfg)
        self.lanes = lanes
        self.page_tokens = page_tokens
        self.max_pages = -(-lane_capacity // page_tokens)
        self.lane_capacity = self.max_pages * page_tokens
        self.alloc = PageAllocator(n_pages, page_tokens)
        # page-accounting invariants re-checked after every mutating op
        # (admit/step/retire/reset) — cheap O(pages) sets, off by default,
        # on in tests
        self.debug_checks = debug_checks
        self.params = serving_params(self.api, params, self.device)
        self.pool = init_paged_cache(self.api, n_pages, page_tokens, self.device)
        self.tables = np.full((lanes, self.max_pages), SCRATCH_PAGE, np.int64)
        self.lens = np.zeros((lanes,), np.int64)
        self.lane_tok = np.zeros((lanes,), np.int64)
        self.lane_req: List[Optional[object]] = [None] * lanes
        self.stats = ServeStats()

    def reset(self) -> None:
        """Fresh serving state (pool, tables, allocator, stats)."""
        n_pages = self.alloc.n_pages
        self.alloc = PageAllocator(n_pages, self.page_tokens)
        self.pool = init_paged_cache(self.api, n_pages, self.page_tokens, self.device)
        self.tables[:] = SCRATCH_PAGE
        self.lens[:] = 0
        self.lane_tok[:] = 0
        self.lane_req = [None] * self.lanes
        self.stats = ServeStats()
        self._debug_check()

    def _debug_check(self) -> None:
        if self.debug_checks:
            self.alloc.check_invariants()

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device)

    # -- capacity ----------------------------------------------------------

    def live_count(self) -> int:
        return sum(1 for r in self.lane_req if r is not None)

    def has_free_lane(self) -> bool:
        return any(r is None for r in self.lane_req)

    def can_fit(self, req, check: bool = False) -> bool:
        """Whether ``req`` can *ever* run here (lane capacity + pool size);
        ``check=True`` raises — an oversize request is a config error, not
        a transient full-pool condition."""
        need = self.alloc.pages_for(req.total_tokens)
        ok = (req.total_tokens <= self.lane_capacity
              and need <= self.alloc.n_pages - 1)
        if check and not ok:
            raise ValueError(
                f"request {req.rid!r} needs {req.total_tokens} tokens "
                f"({need} pages); engine lanes hold {self.lane_capacity} "
                f"tokens over a {self.alloc.n_pages - 1}-page pool"
            )
        return ok

    # -- scheduler-facing ops ----------------------------------------------

    def admit(self, req) -> bool:
        """Prefill ``req`` into a free lane.  False when the page pool
        can't hold it right now (caller keeps it queued)."""
        lane = next(
            (i for i, r in enumerate(self.lane_req) if r is None), None
        )
        if lane is None:
            return False
        pages = self.alloc.alloc(req.rid, req.total_tokens)
        if pages is None:
            return False
        t0 = time.perf_counter()
        P = req.prompt_len
        n_pf = self.alloc.pages_for(P)
        logits, cache = self.api.prefill(
            self.params, self._to_device(req.prompt[None, :].astype(np.int64)),
            n_pf * self.page_tokens,
        )
        first = int(torch.argmax(logits[0]))  # waits for the prefill
        write_pages(self.pool, pages[:n_pf], cache_to_pages(cache, self.page_tokens))
        sync(self.device)
        self.stats.prefill_s += time.perf_counter() - t0
        self.stats.prefills += 1
        row = np.full((self.max_pages,), SCRATCH_PAGE, np.int64)
        row[: len(pages)] = pages
        self.tables[lane] = row
        self.lens[lane] = P
        self.lane_tok[lane] = first
        self.lane_req[lane] = req
        req.tokens.append(first)
        self._debug_check()
        return True

    def step(self) -> List[object]:
        """One decode tick over every live lane; returns newly finished
        requests (their lanes already retired)."""
        live = [i for i, r in enumerate(self.lane_req) if r is not None]
        if not live:
            return []
        t0 = time.perf_counter()
        tables = self._to_device(self.tables)
        lens = self._to_device(self.lens)
        view = gather_view(self.pool, tables)
        logits, view = self.api.decode_step(
            self.params, self._to_device(self.lane_tok[:, None]), view, lens)
        scatter_token(self.pool, view, tables, lens)
        nxt = torch.argmax(logits, dim=-1).cpu().numpy()
        sync(self.device)
        self.stats.decode_s += time.perf_counter() - t0
        self.stats.decode_steps += 1
        finished: List[object] = []
        for lane in live:
            req = self.lane_req[lane]
            self.lens[lane] += 1
            tok = int(nxt[lane])
            req.tokens.append(tok)
            self.lane_tok[lane] = tok
            self.stats.decode_tokens += 1
            if req.decoding_done():
                finished.append(req)
                self._retire_lane(lane)
        self._debug_check()
        return finished

    def retire(self, req) -> None:
        """Free ``req``'s lane and pages (instant-finish path: a request
        whose prefill already satisfied it)."""
        for lane, r in enumerate(self.lane_req):
            if r is req:
                self._retire_lane(lane)
                return
        raise KeyError(f"request {req.rid!r} holds no lane")

    def _retire_lane(self, lane: int) -> None:
        req = self.lane_req[lane]
        self.alloc.free(req.rid)
        self.tables[lane] = SCRATCH_PAGE
        self.lens[lane] = 0
        self.lane_tok[lane] = 0
        self.lane_req[lane] = None
        self._debug_check()

"""Serving engines: fixed-batch prefill+decode, and continuous batching.

The port of ``repro/serve/engine.py``.  ``ServingEngine`` is the
fixed-batch engine: requests are grouped into one batch; finished
sequences are masked to EOS (output and fed-back token) while the batch
keeps stepping.  It serves every family: ``attn_mlp`` and ``moe`` through
their fused prefill (pixtral's without patches, as in the reference),
``rwkv6``, ``mamba2`` and the encoder-decoder family (which have none) by
feeding the prompt through ``decode_step`` one token at a time, as the
reference does.  An encoder-decoder model so decodes against the cache's
encoder memory as ``init_cache`` made it: all zeros, as in the reference.

With ``mesh`` (a ``DeviceMesh``) and ``rules`` (default: the decode
cell's, ``sharding_rules(cfg, mesh, decode shape)``) it serves SPMD, every
rank of the mesh making the same calls: the weights and the cache are
DTensors placed by the rules (``kvcache.init_cache(..., mesh, rules)``),
decode runs through the sharded decode step
(``train.step.jit_decode_step``; split-KV where the rules split the
cache's sequence), a MoE routing each step's tokens as one group over the
whole batch as the reference's engine does, and the fused prefill through
``train.step.jit_prefill``, which keeps each rank's share of the cache it
builds, so the cache stays where the rules place it (the reference's
prefill replaces its placed cache with an unplaced one).  Every rank
gathers the logits and picks the same tokens.

``ContinuousBatchingEngine`` serves a request *stream*: a paged KV pool
(``serve/kvcache.py``) replaces the contiguous per-batch cache, each batch
lane holds one live request with its own page table and length, and
finished lanes are retired and refilled mid-decode.  ``serve/scheduler.py``
drives it over a request trace.  Like the reference's, it accepts an
encoder-decoder config (``block_type`` ``attn_mlp``) and fails at the first
``admit``, since that family has no ``prefill``.  With ``submeshes``
(``launch.mesh.split_mesh_for_serving``) it disaggregates: prefill runs on
the prefill slice, decode on the decode slice; the weights are placed on
both, the page pool lives on the decode slice, and at each admit the
prefilled pages are handed off to the decode slice before they are
written into the pool.  On one card (the paper's same-device mode) both
slices are that card, each on a stream of its own, and the weights are
one copy.  Over rank slices (``split_mesh_for_serving(..., ranks=)``, one
card per rank) every rank runs the same scheduler: each prefill rank holds
the weights and runs the prefill, replicated (as the reference replicates
the weights over its prefill carving); each decode rank holds the weights
and the page pool and decodes, replicated; the handoff is a
point-to-point transfer of the pages and the first token from the prefill
slice's first rank to each decode rank (and of the token to every other
rank), each decode tick's tokens reach every rank in one broadcast from
the decode slice's first rank, and ``agreed_now`` hands the scheduler that
rank's clock once a tick, so every rank admits the same requests in the
same order.

Both engines take ``device`` (default: the card; they raise when there is
none) and cast the weights to ``cfg.dtype`` once at construction — the
reference casts them at every use, with the same numbers — keeping the
leaves the reference reads in fp32 (norm scales, biases, the recurrent
families' decay parameters, the MoE router) in fp32 (``layers.keeps_fp32``).  Weights drawn by ``ModelAPI.init(..., dtype=
cfg.dtype)`` are already in that form, and the cast leaves them as they
are.  The engines
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
from repro_torch.models.layers import keeps_fp32, tree_leaves, tree_map, zeros
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
    """``params`` on ``device``, every weight matrix in ``cfg.dtype`` and
    the ``keeps_fp32`` leaves (norm scales, biases, decay parameters, the
    MoE router) in fp32.  A leaf already so placed and typed is returned as
    it is (no copy)."""
    dt = as_dtype(api.cfg.dtype)

    def prep(x, spec):
        return x.to(device=device, dtype=torch.float32 if keeps_fp32(spec) else dt)

    return tree_map(prep, params, api.schema)


class ServingEngine:
    def __init__(self, cfg, params, batch: int, capacity: int,
                 device: DeviceLike = None, mesh=None, rules=None):
        self.cfg = cfg
        self.api = get_model(cfg)
        self.batch = batch
        self.capacity = capacity
        self.mesh = mesh
        self.rules = rules
        if mesh is None:
            self.device = resolve_device(device)
            self.params = serving_params(self.api, params, self.device)
        else:
            from repro_torch.configs.base import ShapeConfig
            from repro_torch.dist.sharding import device_put, sharding_rules
            from repro_torch.launch.mesh import rank_device
            from repro_torch.train.step import jit_decode_step, jit_prefill

            self.device = rank_device()
            if device is not None and resolve_device(device).type != self.device.type:
                raise ValueError(f"device {device} is not the mesh's ({self.device.type})")
            shape = ShapeConfig("serve", capacity, batch, "decode")
            self.rules = rules = rules or sharding_rules(cfg, mesh, shape)
            # a MoE routes a step's tokens as one group over the whole batch,
            # as the reference's engine does (it steps outside any sharding
            # context): the rules' act_tokens count the cell's cache
            # positions, not a step's tokens, so the steps' rules give it no
            # axis, while the batch stays split as the rules split it
            step_rules = dict(rules, act_tokens=())
            self._decode_fn, p_sh, self._decode_sh = jit_decode_step(self.api, mesh, shape,
                                                                     step_rules)
            if self.api.prefill is not None:
                self._prefill_fn = jit_prefill(self.api, mesh, shape, step_rules)[0]
            self.params = device_put(serving_params(self.api, params, self.device), p_sh)
        self.stats = ServeStats()
        self.reset()

    def reset(self) -> None:
        """Fresh KV state: every batch decodes against its own cache, never
        a predecessor's leftover entries."""
        self._cache = init_cache(self.api, self.batch, self.capacity, self.device,
                                 self.mesh, self.rules)
        self._len = 0

    def _step(self, tokens: torch.Tensor) -> torch.Tensor:
        """One decode step of the whole batch at ``self._len``: the
        (batch, V) logits, gathered on every rank where the engine has a
        mesh."""
        if self.mesh is None:
            logits, self._cache = self.api.decode_step(self.params, tokens, self._cache,
                                                       self._len)
            return logits
        from repro_torch.dist.sharding import device_put

        batch = device_put({"token": tokens, "cache_len": self._len, "cache": self._cache},
                           self._decode_sh)
        logits, self._cache = self._decode_fn(self.params, batch)
        return logits.full_tensor()

    def _ids(self, tokens: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(tokens, np.int64), device=self.device)

    def prefill(self, prompts: np.ndarray) -> torch.Tensor:
        """prompts: (batch, prompt_len) int32 -> last-position logits.  A
        family with a fused prefill runs it; the others feed the prompt
        through ``decode_step`` one token at a time (the cache-building
        path shared with decode)."""
        t0 = time.perf_counter()
        B, P = prompts.shape
        if B != self.batch:
            raise ValueError(f"got {B} prompts for a batch of {self.batch}")
        if self.api.prefill is not None:
            if self.mesh is None:
                last_logits, self._cache = self.api.prefill(self.params, self._ids(prompts),
                                                            self.capacity)
            else:
                last_logits, self._cache = self._prefill_fn(self.params, self._ids(prompts))
                last_logits = last_logits.full_tensor()
            self._len = P
        else:
            ids = self._ids(prompts)
            for i in range(P):
                last_logits = self._step(ids[:, i:i + 1])
                self._len += 1
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
            logits = self._step(self._ids(cur[:, None]))
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
                 submeshes=None, debug_checks: bool = False, device: DeviceLike = None):
        if cfg.block_type not in ("attn_mlp", "moe"):
            raise ValueError(
                f"paged serving needs a KV-cache family, got {cfg.block_type}"
            )
        self.submeshes = submeshes
        # over rank slices: the prefill and decode slices' ranks, and whether
        # this rank prefills / decodes (a single slice, or one process, does both)
        self._ranks = None
        self.on_prefill = self.on_decode = True
        if submeshes is None:
            self.device = self.prefill_device = resolve_device(device)
        elif submeshes.prefill_mesh.ranks is not None:
            from repro_torch.launch.mesh import rank_device

            pf, dc = submeshes.prefill_mesh, submeshes.decode_mesh
            self._ranks = (pf.ranks, dc.ranks)
            self.on_prefill, self.on_decode = pf.member, dc.member
            self.device = self.prefill_device = rank_device()
            if device is not None and resolve_device(device) != self.device:
                raise ValueError(f"device {device} is not this rank's {self.device}")
        else:
            self.prefill_device = submeshes.prefill_mesh.device
            self.device = submeshes.decode_mesh.device  # the pool's
            if device is not None and resolve_device(device) != self.device:
                raise ValueError(f"device {device} is not the decode slice's {self.device}")
        self.cfg = cfg
        self.api = get_model(cfg)
        self.lanes = lanes
        self.page_tokens = page_tokens
        self.max_pages = -(-lane_capacity // page_tokens)
        self.lane_capacity = self.max_pages * page_tokens
        self.alloc = PageAllocator(n_pages, page_tokens)
        # page-accounting invariants re-checked after every mutating op
        # (admit/step/retire/reset) — cheap O(pages) sets, off by default,
        # on in tests
        self.debug_checks = debug_checks
        # decode's weights, and prefill's (one copy where both are one device;
        # over rank slices each rank holds only its own slice's)
        self.params = (serving_params(self.api, params, self.device)
                       if self.on_decode else None)
        self.params_prefill = (
            None if not self.on_prefill
            else self.params if self.on_decode and self.prefill_device == self.device
            else serving_params(self.api, params, self.prefill_device))
        self.prefill_stream = self.decode_stream = None  # the current stream
        if submeshes is not None and self._ranks is None and self.device.type == "cuda":
            self.prefill_stream = (submeshes.prefill_mesh.stream
                                   or torch.cuda.Stream(device=self.prefill_device))
            self.decode_stream = (submeshes.decode_mesh.stream
                                  or torch.cuda.Stream(device=self.device))
        self.handoff_s: List[float] = []  # each admit's handoff (disaggregated)
        self.pool = None  # on the decode slice only
        if self.on_decode:
            with torch.cuda.stream(self.decode_stream):
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
        if self.on_decode:
            with torch.cuda.stream(self.decode_stream):
                self.pool = init_paged_cache(self.api, n_pages, self.page_tokens, self.device)
        self.handoff_s = []
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
        chunks = first = None
        if self.on_prefill:
            with torch.cuda.stream(self.prefill_stream):
                logits, cache = self.api.prefill(
                    self.params_prefill,
                    torch.as_tensor(req.prompt[None, :].astype(np.int64),
                                    device=self.prefill_device),
                    n_pf * self.page_tokens,
                )
                chunks = cache_to_pages(cache, self.page_tokens)
                first = int(torch.argmax(logits[0]))  # waits for the prefill
        if self.submeshes is None:
            write_pages(self.pool, pages[:n_pf], chunks)
        elif self._ranks is not None:
            first = self._handoff_ranks(pages[:n_pf], chunks, first)
        else:
            self._handoff(pages[:n_pf], chunks)
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

    def _handoff(self, pages, chunks) -> None:
        """The disaggregation handoff: the prefilled pages move to the decode
        slice's device, ordered after the prefill on the decode stream,
        and are written into the pool there; timed to the decode stream's
        end (``handoff_s``)."""
        t0 = time.perf_counter()
        with torch.cuda.stream(self.decode_stream):
            if self.decode_stream is not None:
                self.decode_stream.wait_stream(self.prefill_stream)
            moved = tree_map(lambda x: x.to(self.device, non_blocking=True), chunks)
            if self.decode_stream is not None:  # prefill-stream blocks read here
                for x in tree_leaves(moved):
                    x.record_stream(self.decode_stream)
            write_pages(self.pool, pages, moved)
        if self.decode_stream is not None:
            self.decode_stream.synchronize()
        self.handoff_s.append(time.perf_counter() - t0)

    def _handoff_ranks(self, pages, chunks, first: Optional[int]) -> int:
        """The handoff over rank slices: the prefill slice's first rank
        sends the prefilled pages and the first token to each decode rank
        (and the token alone to every rank outside both slices), point to
        point; each decode rank writes the pages into its pool.  Returns
        the first token, on every rank; timed on each rank to its own end
        (``handoff_s``)."""
        import torch.distributed as dist

        t0 = time.perf_counter()
        (prefill_ranks, decode_ranks), me = self._ranks, dist.get_rank()
        src = prefill_ranks[0]
        tok = torch.tensor([first or 0], dtype=torch.int64, device=self.device)
        if me == src:
            for dst in range(dist.get_world_size()):
                if dst in prefill_ranks:
                    continue
                if dst in decode_ranks:
                    for x in tree_leaves(chunks):
                        dist.send(x.contiguous(), dst)
                dist.send(tok, dst)
        elif me not in prefill_ranks:
            if self.on_decode:
                chunks = cache_to_pages(zeros(self.api.cache_schema(
                    1, len(pages) * self.page_tokens), self.device), self.page_tokens)
                for x in tree_leaves(chunks):
                    dist.recv(x, src)
            dist.recv(tok, src)
            first = int(tok)
        if self.on_decode:
            write_pages(self.pool, pages, chunks)
            sync(self.device)
        self.handoff_s.append(time.perf_counter() - t0)
        return first

    def agreed_now(self, now: float) -> float:
        """The scheduler's clock, agreed once a tick: over rank slices the
        decode slice's first rank's (one broadcast), so every rank moves the
        same arrivals into its queue; else ``now`` as it is."""
        if self._ranks is None:
            return now
        import torch.distributed as dist

        t = torch.tensor([now], dtype=torch.float64, device=self.device)
        dist.broadcast(t, src=self._ranks[1][0])
        return float(t)

    def step(self) -> List[object]:
        """One decode tick over every live lane; returns newly finished
        requests (their lanes already retired).  Over rank slices the
        decode slice's first rank broadcasts the tokens to every rank."""
        live = [i for i, r in enumerate(self.lane_req) if r is not None]
        if not live:
            return []
        t0 = time.perf_counter()
        nxt = None
        if self.on_decode:
            with torch.cuda.stream(self.decode_stream):
                tables = self._to_device(self.tables)
                lens = self._to_device(self.lens)
                view = gather_view(self.pool, tables)
                logits, view = self.api.decode_step(
                    self.params, self._to_device(self.lane_tok[:, None]), view, lens)
                scatter_token(self.pool, view, tables, lens)
                nxt = torch.argmax(logits, dim=-1).cpu()  # waits for the decode
        if self._ranks is not None:
            import torch.distributed as dist

            t = (nxt.to(self.device) if nxt is not None
                 else torch.zeros(self.lanes, dtype=torch.int64, device=self.device))
            dist.broadcast(t, src=self._ranks[1][0])
            nxt = t.cpu()
        nxt = nxt.numpy()
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

"""Multi-chain graph reduction (paper §4.2, Fig 7).

The port of ``repro/core/graph_reduce.py`` (numpy only, the reference's
arithmetic in its order).

A branch/join region (``CostedBlock``) is reduced to a single transition
edge: for every (branching-scale g, joining-scale h) pair we plan each branch
with its entry pinned to g and exit resharded to h, find the critical
branch, and decide per non-critical branch whether it runs *in parallel* on
disjoint devices (doesn't extend the block) or *sequentially* (reuses the
critical branch's devices) — parallel only when it neither increases total
time nor overshoots the amplification limit, per the paper.

Two implementations of the same reduction:

``block_transition`` / ``block_transition_table``
    The original per-(g, h) formulation: one pure-Python entry-pinned search
    per branch per (g, h) cell — O(S²) searches per branch.  Consumed by
    ``planner.search_linear_reference`` (the differential-test oracle).

``block_transition_matrix``
    Vectorized: each branch is planned *once* by the matrix DP with every
    entry scale pinned (the E axis of ``planner._search_vec``), the exit
    reshard is folded in as an S×S min over final scales, and the
    critical/parallel decisions run as stable-argsort + masked updates over
    the whole (g_in, g_out) grid at once.  Produces the block's S×S time /
    gpu-sec matrices plus per-branch paths — enough to also emit genuine
    branch-parallel *placements* (``block_placements``): the critical branch
    on devices [0, peak), parallel branches stacked onto disjoint device
    ranges above it (the block's GapWindow of idle devices), sequential
    branches reusing the critical range.

Both paths produce bit-identical (time, gpu_sec) tables; the differential
suite (tests/test_planner_diff.py) pins this.
"""
from __future__ import annotations

import weakref
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np

from repro_torch.core.costmodel import Hardware, comm_matrix
from repro_torch.core.profiler import CostedBlock, CostedLayer

INF = float("inf")


@dataclass(frozen=True)
class BranchPlan:
    time: float
    gpu_sec: float
    peak_gpus: int
    parallel: bool  # runs concurrently with the critical branch?


@dataclass(frozen=True)
class BlockTransition:
    time: float
    gpu_sec: float
    branches: Tuple[BranchPlan, ...]
    critical: int = 0  # index of the critical (longest) branch


def _plan_branch(
    branch: Sequence,
    scales: Sequence[int],
    amp_limit: float,
    hw: Hardware,
    entry_scale: int,
    exit_scale: int,
    entry_act_bytes: float,
) -> Tuple[float, float, int]:
    """Best (time, gpu_sec, peak_gpus) through one branch with pinned
    entry/exit scales (exit reshard included).  Reference path."""
    from repro_torch.core.costmodel import comm_time
    from repro_torch.core.planner import _backtrace, _layer_cost, search_linear_reference

    res = search_linear_reference(
        branch, scales, amp_limit, hw, entry_scale=entry_scale,
        entry_act_bytes=entry_act_bytes,
    )
    L = len(res.layers)
    best = (INF, 0.0, entry_scale)
    for g in scales:
        t = res.S[L - 1][g] + comm_time(res.layers[-1].act_bytes, g, exit_scale, hw)
        if t < best[0]:
            best = (t, g, g)
    t_best, g_final, _ = best
    gs = _backtrace(res, g_final)
    gpu_sec = 0.0
    for i, (layer, g) in enumerate(zip(res.layers, gs)):
        h = gs[i - 1] if i > 0 else entry_scale
        gpu_sec += (res.trans[i](h, g) + _layer_cost(layer, g)) * g
    gpu_sec += comm_time(res.layers[-1].act_bytes, g_final, exit_scale, hw) * g_final
    return t_best, gpu_sec, max(gs)


def _single_gpu_time(els) -> float:
    t = 0.0
    for el in els:
        if isinstance(el, CostedLayer):
            t += el.comp1
        else:
            for br in el.branches:
                t += _single_gpu_time(br)
    return t


def block_transition(
    block: CostedBlock,
    g_in: int,
    g_out: int,
    scales: Sequence[int],
    amp_limit: float,
    hw: Hardware,
    entry_act_bytes: float,
) -> BlockTransition:
    plans = [
        _plan_branch(br, scales, amp_limit, hw, g_in, g_out, entry_act_bytes)
        for br in block.branches
    ]
    order = sorted(range(len(plans)), key=lambda i: -plans[i][0])
    crit = order[0]
    total_time = plans[crit][0]
    comp1 = max(_single_gpu_time([block]), 1e-30)
    gpu_sec = plans[crit][1]
    decided: List[BranchPlan] = [None] * len(plans)  # type: ignore
    decided[crit] = BranchPlan(*plans[crit][:3], parallel=False)
    for i in order[1:]:
        t_i, gs_i, peak_i = plans[i]
        # parallel = needs disjoint devices: extra gpu-sec but no extra time;
        # allowed iff amp stays under the limit and it doesn't extend the block
        amp_if_parallel = (gpu_sec + gs_i) / comp1
        run_parallel = (t_i <= total_time) and (amp_if_parallel <= amp_limit)
        if run_parallel:
            gpu_sec += gs_i
        else:
            total_time += t_i
            gpu_sec += gs_i
        decided[i] = BranchPlan(t_i, gs_i, peak_i, parallel=run_parallel)
    return BlockTransition(
        time=total_time, gpu_sec=gpu_sec, branches=tuple(decided), critical=crit
    )


def block_transition_table(
    block: CostedBlock,
    scales: Sequence[int],
    amp_limit: float,
    hw: Hardware,
    entry_act_bytes: float,
) -> Dict[Tuple[int, int], Tuple[float, float]]:
    """(g_in, g_out) -> (time, gpu_sec). Memoized per (block, params)."""
    key = (id(block), tuple(scales), amp_limit, hw, entry_act_bytes)
    cached = _TABLE_CACHE.get(key)
    if cached is not None:
        return cached
    table = {}
    for g in scales:
        for h in scales:
            bt = block_transition(block, g, h, scales, amp_limit, hw, entry_act_bytes)
            table[(g, h)] = (bt.time, bt.gpu_sec)
    _cache_put(_TABLE_CACHE, key, block, table)
    return table


_TABLE_CACHE: Dict = {}


def _cache_put(cache: Dict, key, block, value) -> None:
    """Memoize keyed by id(block): evict on the block's GC so a recycled id
    can't alias a stale entry, and so long-lived replanning processes don't
    grow the cache without bound."""
    cache[key] = value
    weakref.finalize(block, cache.pop, key, None)


# ---------------------------------------------------------------------------
# Vectorized reduction: whole (g_in, g_out) grid in one matrix DP per branch
# ---------------------------------------------------------------------------


@dataclass
class BlockMatrix:
    """Vectorized block reduction over the full (g_in, g_out) grid.

    All arrays are indexed [g_in, g_out] (scale indices); the branch axis
    where present is leading.  ``branch_paths[b]`` is (L_b, S, S): the
    backtraced per-layer scale index of branch b's top-level chain for every
    grid cell.
    """

    time: np.ndarray             # (S, S) block transition time
    gpu_sec: np.ndarray          # (S, S) block gpu-seconds
    branch_times: np.ndarray     # (nb, S, S)
    branch_gsecs: np.ndarray     # (nb, S, S)
    branch_peaks: np.ndarray     # (nb, S, S) int peak devices
    branch_parallel: np.ndarray  # (nb, S, S) bool
    critical: np.ndarray         # (S, S) int critical branch index
    branch_paths: List[np.ndarray]
    branch_layers: List[list]    # per branch: its top-level CostedLayers


def _branch_matrix(branch, scales, amp_limit, hw, entry_act_bytes):
    """One branch, every (entry, exit) pair at once: (time, gpu_sec, peak,
    paths) arrays of shape (S, S) / (L, S, S)."""
    from repro_torch.core.planner import _backtrace_grid, _search_vec

    res = _search_vec(
        branch, scales, amp_limit, hw, entry="all", entry_act_bytes=entry_act_bytes
    )
    n = len(scales)
    L = len(res.layers)
    scales_f = np.asarray(scales, dtype=np.float64)
    c_exit = comm_matrix(res.layers[-1].act_bytes, scales, scales, hw)  # (g, h)
    tot = res.S[:, -1, :, None] + c_exit[None, :, :]                    # (e, g, h)
    g_final = np.argmin(tot, axis=1)                                    # (e, h)
    t_best = np.take_along_axis(tot, g_final[:, None, :], axis=1)[:, 0, :]
    paths = _backtrace_grid(res.P, g_final)                             # (L, e, h)

    erange = np.arange(n)[:, None]
    hrange = np.arange(n)[None, :]
    gpu_sec = np.zeros((n, n))
    for i in range(L):
        gi = paths[i]
        if i == 0:
            tr = res.edge_mats[0][erange, gi]
        else:
            tr = res.edge_mats[i][paths[i - 1], gi]
        gpu_sec += (tr + res.lc[i][gi]) * scales_f[gi]
    gfin = paths[-1]
    gpu_sec += c_exit[gfin, hrange] * scales_f[gfin]
    peak = np.asarray(scales)[paths].max(axis=0)
    return t_best, gpu_sec, peak, paths, res.layers


def block_transition_matrix(
    block: CostedBlock,
    scales: Sequence[int],
    amp_limit: float,
    hw: Hardware,
    entry_act_bytes: float,
) -> BlockMatrix:
    """Vectorized ``block_transition_table``: the full S×S grid at once,
    bit-identical to the reference per-cell reduction.  Memoized."""
    key = (id(block), tuple(scales), amp_limit, hw, entry_act_bytes)
    cached = _MATRIX_CACHE.get(key)
    if cached is not None:
        return cached
    nb = len(block.branches)
    n = len(scales)
    times = np.empty((nb, n, n))
    gsecs = np.empty((nb, n, n))
    peaks = np.empty((nb, n, n), dtype=np.int64)
    paths: List[np.ndarray] = []
    blayers: List[list] = []
    for b, br in enumerate(block.branches):
        t, gs, pk, pth, lyrs = _branch_matrix(br, scales, amp_limit, hw, entry_act_bytes)
        times[b], gsecs[b], peaks[b] = t, gs, pk
        paths.append(pth)
        blayers.append(lyrs)

    # Critical branch + parallel/sequential decisions, every cell at once.
    # Stable argsort on -time == the reference's `sorted(key=-time)`.
    order = np.argsort(-times, axis=0, kind="stable")
    crit = order[0]
    total = np.take_along_axis(times, crit[None], axis=0)[0]
    gpu_sec = np.take_along_axis(gsecs, crit[None], axis=0)[0]
    comp1 = max(_single_gpu_time([block]), 1e-30)
    par = np.zeros((nb, n, n), dtype=bool)
    for r in range(1, nb):
        idx = order[r]
        t_i = np.take_along_axis(times, idx[None], axis=0)[0]
        gs_i = np.take_along_axis(gsecs, idx[None], axis=0)[0]
        run_par = (t_i <= total) & ((gpu_sec + gs_i) / comp1 <= amp_limit)
        np.put_along_axis(par, idx[None], run_par[None], axis=0)
        gpu_sec = gpu_sec + gs_i
        total = np.where(run_par, total, total + t_i)

    bm = BlockMatrix(
        time=total, gpu_sec=gpu_sec, branch_times=times, branch_gsecs=gsecs,
        branch_peaks=peaks, branch_parallel=par, critical=crit,
        branch_paths=paths, branch_layers=blayers,
    )
    _cache_put(_MATRIX_CACHE, key, block, bm)
    return bm


_MATRIX_CACHE: Dict = {}


def block_placements(
    block: CostedBlock,
    g_in_idx: int,
    g_out_idx: int,
    scales: Sequence[int],
    amp_limit: float,
    hw: Hardware,
    entry_act_bytes: float,
    num_gpus: int,
    layer_index: int = -1,
) -> tuple:
    """Per-branch device-range assignment for the chosen (g_in, g_out) cell.

    The critical branch runs on devices [0, peak).  Branches decided
    *parallel* by the reduction stack onto disjoint ranges above it — the
    idle devices of the block's GapWindow — for as long as they fit inside
    the ``num_gpus`` machine; a parallel-decided branch that no longer fits
    is demoted to time-multiplexing the critical range (the DP's amp
    accounting admits more concurrency than the device count can host).
    ``BranchPlacement.parallel`` therefore reports *placed-on-disjoint-
    devices*; the reduction's raw decision stays in
    ``BlockMatrix.branch_parallel``.  Paths cover each branch's top-level
    chain (nested blocks stay folded into their edge).  ``layer_index`` tags
    each placement with the plan layer whose ``comm_in`` folds this block,
    so the multiplexer can exclude branch device windows per-stage instead
    of for the whole iteration.
    """
    from repro_torch.core.plan import BranchPlacement

    bm = block_transition_matrix(block, scales, amp_limit, hw, entry_act_bytes)
    nb = len(block.branches)
    crit = int(bm.critical[g_in_idx, g_out_idx])
    offset = int(bm.branch_peaks[crit, g_in_idx, g_out_idx])
    out = []
    for b in range(nb):
        peak = int(bm.branch_peaks[b, g_in_idx, g_out_idx])
        parallel = bool(bm.branch_parallel[b, g_in_idx, g_out_idx])
        path = tuple(
            int(scales[int(bm.branch_paths[b][i][g_in_idx, g_out_idx])])
            for i in range(bm.branch_paths[b].shape[0])
        )
        demoted = False
        if b == crit:
            start, end = 0, peak
        elif parallel and offset + peak <= num_gpus:
            start, end = offset, offset + peak
            offset += peak
        else:
            # decided parallel but the gap window is full: demote to
            # time-multiplexing the critical range, and flag it — the block
            # transition time consumed by the DP assumed this branch was free
            demoted = parallel
            parallel = False
            start, end = 0, peak
        out.append(
            BranchPlacement(
                block=block.name, branch=b, critical=(b == crit),
                parallel=parallel,
                time=float(bm.branch_times[b, g_in_idx, g_out_idx]),
                gpus=peak, device_start=start, device_end=end, scales=path,
                demoted=demoted, layer_index=layer_index,
            )
        )
    return tuple(out)

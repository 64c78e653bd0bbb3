"""Burst-parallel training planner — the paper's Algorithm 1.

The port of ``repro/core/planner.py``: numpy only, its arithmetic in the
reference's order, so both packages give bit-identical plans
(``tests/test_torch_planner.py``).

Dynamic program over (layer, device-count) with the user-given GPU-sec
amplification limit:

    S[i][g] = shortest time to complete L_1..L_i with L_i at scale g
    T[i][g] = time spent on L_i while minimizing S[i][g]
    Amp(i,g) = T[i][g] · g / comp(i,1)

Search space is powers of two (paper §7.4).

Two engines implement the same DP:

``search_linear_reference``
    The original pure-Python dict-of-dict formulation.  It is kept verbatim
    as the *oracle* for the differential test harness
    (tests/test_planner_diff.py) and as the baseline for the recorded
    search-time trajectory (BENCH_planner.json).

``search_linear`` (default, vectorized)
    Matrix formulation over numpy arrays.  Per edge i the transition costs
    form an S×S matrix Tr_i with Tr_i[h, g] = tr((i-1, g_h) → (i, g_g));
    the DP step is a min-plus product of the state row S[i-1, :] with Tr_i
    under the amplification mask — implemented as a short scan over the ≤
    log2(G)+1 source scales with vectorized updates over all (entry,
    destination) cells at once, preserving the reference's exact greedy
    tie-breaking (and therefore its bit pattern).  Branch/join blocks reduce
    to S×S matrices via ``graph_reduce.block_transition_matrix``, which also
    plans *all* pinned entry scales in one matrix DP (the E axis below)
    instead of one search per (g_in, g_out) pair — the source of the
    planner's order-of-magnitude search-time win at 1024+ devices.

DAG support beyond linear chains: ``ParallelBlock``s (arbitrarily nested)
are folded into transition edges with per-branch device placements
(``graph_reduce.block_placements``), and ``EncDecGraph`` two-chain DAGs are
planned by ``plan_encdec`` — encoder and decoder chains joined by a
resharding cross-edge, with the decoder's entry scale pinned to every
candidate encoder exit scale in a single matrix DP.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.costmodel import Hardware, comm_matrix, comm_time
from repro_torch.core.plan import BurstPlan, LayerPlan
from repro_torch.core.profiler import (
    CostedBlock,
    CostedLayer,
    plan_scales,
    powers_of_two,
)

INF = float("inf")


@dataclass
class _ChainResult:
    """Reference-engine DP tables for one chain: indexed [layer][g]."""

    S: List[Dict[int, float]]
    T: List[Dict[int, float]]
    P: List[Dict[int, Optional[int]]]  # backpointer: chosen predecessor scale
    layers: List[CostedLayer]
    trans: List  # trans[i](h, g) -> transition time from layer i-1@h to i@g


def _layer_cost(layer: CostedLayer, g: int) -> float:
    return layer.comp[g] + layer.sync[g]


# ---------------------------------------------------------------------------
# Reference engine: the original pure-Python DP (differential-test oracle)
# ---------------------------------------------------------------------------


def search_linear_reference(
    chain: Sequence,
    scales: Sequence[int],
    amp_limit: float,
    hw: Hardware,
    entry_scale: Optional[int] = None,
    entry_act_bytes: float = 0.0,
) -> _ChainResult:
    """Paper Algorithm 1 over a chain of CostedLayer/CostedBlock elements.

    ``entry_scale`` fixes the scale feeding the first layer (used by the
    graph reduction when planning a branch whose branching layer is pinned).
    """
    from repro_torch.core.graph_reduce import block_transition_table  # lazy: avoids cycle

    # Collapse the chain into layers + per-edge transition functions.
    layers: List[CostedLayer] = []
    trans: List = []
    pending_blocks: List[CostedBlock] = []
    prev_layer: Optional[CostedLayer] = None
    for el in chain:
        if isinstance(el, CostedBlock):
            pending_blocks.append(el)
            continue
        blocks = tuple(pending_blocks)
        pending_blocks = []
        if prev_layer is None:
            if entry_scale is None:
                trans.append(lambda h, g: 0.0)
            else:
                eb = entry_act_bytes

                def entry_tr(h, g, eb=eb):
                    return comm_time(eb, h, g, hw)

                trans.append(entry_tr)
        else:
            pb = prev_layer.act_bytes
            if blocks:
                tables = [
                    block_transition_table(b, scales, amp_limit, hw, pb) for b in blocks
                ]

                def tr(h, g, tables=tables):
                    t = 0.0
                    cur = h
                    for tab in tables:
                        t += tab[(cur, g)][0]
                        cur = g
                    return t

                trans.append(tr)
            else:

                def tr(h, g, pb=pb):
                    return comm_time(pb, h, g, hw)

                trans.append(tr)
        layers.append(el)
        prev_layer = el
    if pending_blocks:
        raise ValueError("chain must not end with a ParallelBlock")

    L = len(layers)
    S: List[Dict[int, float]] = [dict() for _ in range(L)]
    T: List[Dict[int, float]] = [dict() for _ in range(L)]
    P: List[Dict[int, Optional[int]]] = [dict() for _ in range(L)]

    def amp(i: int, g: int) -> float:
        return T[i][g] * g / max(layers[i].comp1, 1e-30)

    for i in range(L):
        for g in scales:
            if i == 0:
                src_scales = [entry_scale] if entry_scale is not None else [g]
                best_s, best_t, best_h = INF, INF, None
                for h in src_scales:
                    c = trans[0](h, g)
                    if c < best_s:
                        best_s, best_t, best_h = c, c, h
            else:
                best_amp, best_s, best_t, best_h = INF, INF, INF, None
                for h in scales:
                    a_prev = amp(i - 1, h)
                    if a_prev <= max(best_amp, amp_limit) and (
                        S[i - 1][h] + trans[i](h, g) <= best_s
                    ):
                        best_s = S[i - 1][h] + trans[i](h, g)
                        best_t = trans[i](h, g)
                        best_amp = min(best_amp, a_prev)
                        best_h = h
            S[i][g] = best_s + _layer_cost(layers[i], g)
            T[i][g] = best_t + _layer_cost(layers[i], g)
            P[i][g] = best_h

    return _ChainResult(S=S, T=T, P=P, layers=layers, trans=trans)


def _backtrace(res: _ChainResult, final_g: int) -> List[int]:
    gs = [final_g]
    for i in range(len(res.layers) - 1, 0, -1):
        gs.append(res.P[i][gs[-1]])
    gs.reverse()
    return gs


# ---------------------------------------------------------------------------
# Vectorized engine: matrix DP over numpy transition matrices
# ---------------------------------------------------------------------------


@dataclass
class _VecResult:
    """Vectorized DP tables.

    Arrays are indexed [entry, layer, scale]: the entry axis has size 1 for
    an unpinned chain, or len(scales) when *every* entry scale is planned at
    once (``entry="all"``, used by the block reduction).
    """

    S: np.ndarray               # (E, L, n) shortest completion time
    T: np.ndarray               # (E, L, n) time on layer i along chosen path
    P: np.ndarray               # (E, L, n) predecessor scale index; -1 = none
    layers: List[CostedLayer]
    edge_mats: List[np.ndarray]  # [0]: (E, n) entry costs; [i>0]: (n, n)
    edge_blocks: List[tuple]     # CostedBlocks folded into edge i ([] for 0)
    lc: np.ndarray               # (L, n) per-layer comp+sync
    scales: Tuple[int, ...]


def _collapse_chain(chain: Sequence):
    """Split a chain into layers + per-edge metadata, mirroring the reference
    collapse exactly (blocks before the first layer are dropped; a trailing
    block is an error)."""
    layers: List[CostedLayer] = []
    edge_blocks: List[tuple] = []
    act_in: List[Optional[float]] = []
    pending: List[CostedBlock] = []
    prev: Optional[CostedLayer] = None
    for el in chain:
        if isinstance(el, CostedBlock):
            pending.append(el)
            continue
        blocks = tuple(pending)
        pending = []
        if prev is None:
            edge_blocks.append(())
            act_in.append(None)
        else:
            edge_blocks.append(blocks)
            act_in.append(prev.act_bytes)
        layers.append(el)
        prev = el
    if pending:
        raise ValueError("chain must not end with a ParallelBlock")
    return layers, edge_blocks, act_in


def _edge_matrices(
    layers, edge_blocks, act_in, scales, amp_limit, hw, entry, entry_act_bytes
) -> List[np.ndarray]:
    """Materialize every edge's transition costs as matrices: (E, n) for the
    entry edge, (n, n) [src, dst] for interior edges.  Blocks on an edge
    contribute their reduced S×S time matrix (first block h→g, subsequent
    blocks g→g on the diagonal, as in the reference closure)."""
    from repro_torch.core.graph_reduce import block_transition_matrix  # lazy: cycle

    n = len(scales)
    mats: List[np.ndarray] = []
    if entry is None:
        mats.append(np.zeros((1, n)))
    elif entry == "all":
        mats.append(comm_matrix(entry_act_bytes, scales, scales, hw))
    else:
        mats.append(comm_matrix(entry_act_bytes, [entry], scales, hw))
    for i in range(1, len(layers)):
        blocks = edge_blocks[i]
        if blocks:
            bm = block_transition_matrix(blocks[0], scales, amp_limit, hw, act_in[i])
            tr = bm.time.copy()
            for b in blocks[1:]:
                bm2 = block_transition_matrix(b, scales, amp_limit, hw, act_in[i])
                tr = tr + np.diagonal(bm2.time)[None, :]
        else:
            tr = comm_matrix(act_in[i], scales, scales, hw)
        mats.append(tr)
    return mats


def _search_vec(
    chain: Sequence,
    scales: Sequence[int],
    amp_limit: float,
    hw: Hardware,
    entry=None,
    entry_act_bytes: float = 0.0,
) -> _VecResult:
    """Vectorized Algorithm 1.  ``entry`` is None (free), an int scale
    (pinned, one DP row), or "all" (every entry scale pinned at once — one
    DP row per entry, the block reduction's batched mode)."""
    layers, edge_blocks, act_in = _collapse_chain(list(chain))
    scales = tuple(scales)
    n = len(scales)
    scales_f = np.asarray(scales, dtype=np.float64)
    mats = _edge_matrices(
        layers, edge_blocks, act_in, scales, amp_limit, hw, entry, entry_act_bytes
    )
    E = mats[0].shape[0]
    L = len(layers)
    lc = np.empty((L, n))
    for i, l in enumerate(layers):
        comp = np.array([l.comp[g] for g in scales])
        sync = np.array([l.sync[g] for g in scales])
        lc[i] = comp + sync
    comp1 = np.array([max(l.comp1, 1e-30) for l in layers])

    S = np.empty((E, L, n))
    T = np.empty((E, L, n))
    P = np.full((E, L, n), -1, dtype=np.int64)
    S[:, 0, :] = mats[0] + lc[0]
    T[:, 0, :] = mats[0] + lc[0]
    if entry == "all":
        P[:, 0, :] = np.arange(n)[:, None]
    elif entry is not None and entry in scales:
        P[:, 0, :] = scales.index(entry)
    # an entry scale outside the search space (elastic shrink) keeps -1:
    # the comm row above already prices it, and backtrace stops at layer 1

    for i in range(1, L):
        prev_amp = T[:, i - 1, :] * scales_f[None, :] / comp1[i - 1]
        tr = mats[i]
        best_amp = np.full((E, n), INF)
        best_s = np.full((E, n), INF)
        best_t = np.full((E, n), INF)
        best_h = np.full((E, n), -1, dtype=np.int64)
        # Short scan over source scales with vectorized updates over every
        # (entry, destination) cell — replicates the reference's greedy
        # `a_prev <= max(bestAmp, AmpLimit) and cand <= bestS` selection
        # elementwise, so chosen predecessors (and bits) are identical.
        for hi in range(n):
            a_prev = prev_amp[:, hi][:, None]                      # (E, 1)
            cand = S[:, i - 1, hi][:, None] + tr[hi][None, :]      # (E, n)
            ok = (a_prev <= np.maximum(best_amp, amp_limit)) & (cand <= best_s)
            best_s = np.where(ok, cand, best_s)
            best_t = np.where(ok, np.broadcast_to(tr[hi], cand.shape), best_t)
            best_amp = np.where(ok, np.minimum(best_amp, a_prev), best_amp)
            best_h = np.where(ok, hi, best_h)
        S[:, i, :] = best_s + lc[i]
        T[:, i, :] = best_t + lc[i]
        P[:, i, :] = best_h

    return _VecResult(
        S=S, T=T, P=P, layers=layers, edge_mats=mats, edge_blocks=edge_blocks,
        lc=lc, scales=scales,
    )


def search_linear(
    chain: Sequence,
    scales: Sequence[int],
    amp_limit: float,
    hw: Hardware,
    entry_scale: Optional[int] = None,
    entry_act_bytes: float = 0.0,
) -> _VecResult:
    """Vectorized drop-in for ``search_linear_reference`` (same signature)."""
    return _search_vec(
        chain, scales, amp_limit, hw,
        entry=entry_scale, entry_act_bytes=entry_act_bytes,
    )


def _backtrace_idx(res: _VecResult, e_idx: int, g_idx: int) -> List[int]:
    idxs = [g_idx]
    for i in range(len(res.layers) - 1, 0, -1):
        idxs.append(int(res.P[e_idx, i, idxs[-1]]))
    idxs.reverse()
    return idxs


def _backtrace_grid(P: np.ndarray, g_final: np.ndarray) -> np.ndarray:
    """Vectorized backtrace for every (entry, exit) cell at once.

    P: (E, L, n) backpointers; g_final: (E, H) chosen final scale indices.
    Returns (L, E, H) per-layer scale indices along each cell's path."""
    E, L, _ = P.shape
    out = np.empty((L,) + g_final.shape, dtype=np.int64)
    out[L - 1] = g_final
    er = np.arange(E)[:, None]
    for i in range(L - 1, 0, -1):
        out[i - 1] = P[er, i, out[i]]
    return out


# ---------------------------------------------------------------------------
# Plan construction
# ---------------------------------------------------------------------------


def plan(
    graph,
    num_gpus: int,
    amp_limit: float = 2.0,
    hw: Optional[Hardware] = None,
    engine: str = "vectorized",
) -> BurstPlan:
    """Plan a LayerGraph / EncDecGraph (models/graph.py) or pre-costed chain.

    ``engine="vectorized"`` (default) runs the matrix DP; ``"reference"``
    runs the original pure-Python DP — both produce bit-identical plans
    (tests/test_planner_diff.py pins this).
    """
    from repro_torch.core.profiler import profile_graph
    from repro_torch.models.graph import EncDecGraph, LayerNode, ParallelBlock

    if engine not in ("vectorized", "reference"):
        raise ValueError(f"unknown planner engine: {engine!r}")
    hw = hw or Hardware()
    if isinstance(graph, EncDecGraph):
        return plan_encdec(graph, num_gpus, amp_limit, hw, engine=engine)
    if graph and isinstance(graph[0], (LayerNode, ParallelBlock)):
        chain = profile_graph(graph, num_gpus, hw)
    else:
        chain = list(graph)
    scales = plan_scales(num_gpus)
    first = next((l for l in chain if isinstance(l, CostedLayer)), None)
    if first is not None:
        # a pre-costed chain may carry tables for the pow2-only scale set;
        # never index a scale its tables don't cover
        scales = [s for s in scales if s in first.comp]
    if engine == "reference":
        return _plan_reference(chain, num_gpus, scales, amp_limit, hw)
    return _plan_vectorized(chain, num_gpus, scales, amp_limit, hw)


def _plan_reference(chain, num_gpus, scales, amp_limit, hw) -> BurstPlan:
    res = search_linear_reference(chain, scales, amp_limit, hw)
    L = len(res.layers)

    def amp(i, g):
        return res.T[i][g] * g / max(res.layers[i].comp1, 1e-30)

    feasible = [g for g in scales if amp(L - 1, g) <= amp_limit]
    pool = feasible if feasible else scales
    final_g = min(pool, key=lambda g: res.S[L - 1][g])
    gs = _backtrace(res, final_g)

    layer_plans = []
    for i, (layer, g) in enumerate(zip(res.layers, gs)):
        h = gs[i - 1] if i > 0 else (g if res.P[0][g] is None else res.P[0][g])
        comm_in = res.trans[i](h, g)
        layer_plans.append(
            LayerPlan(
                index=i,
                name=layer.name,
                gpus=g,
                time=comm_in + _layer_cost(layer, g),
                comp=layer.comp[g],
                sync=layer.sync[g],
                comm_in=comm_in,
                amp=amp(i, g),
                kind=layer.kind,
            )
        )
    # count branch layers folded into transition edges too, so amplification
    # and speedup stay meaningful on DAG graphs
    from repro_torch.core.graph_reduce import _single_gpu_time

    single = _single_gpu_time(chain)
    return BurstPlan(
        layers=tuple(layer_plans),
        num_gpus=num_gpus,
        amp_limit=amp_limit,
        single_gpu_time=single,
    )


def _plan_vectorized(chain, num_gpus, scales, amp_limit, hw) -> BurstPlan:
    from repro_torch.core.graph_reduce import block_placements

    res = _search_vec(chain, scales, amp_limit, hw)
    L = len(res.layers)
    n = len(scales)
    scales_f = np.asarray(scales, dtype=np.float64)

    amp_last = res.T[0, -1, :] * scales_f / max(res.layers[-1].comp1, 1e-30)
    feas = np.nonzero(amp_last <= amp_limit)[0]
    pool = feas if feas.size else np.arange(n)
    final_idx = int(pool[int(np.argmin(res.S[0, -1, pool]))])
    idxs = _backtrace_idx(res, 0, final_idx)

    layer_plans = []
    details: Dict[str, object] = {}
    for i, (layer, gi) in enumerate(zip(res.layers, idxs)):
        g = scales[gi]
        if i > 0:
            comm_in = float(res.edge_mats[i][idxs[i - 1], gi])
        else:
            comm_in = float(res.edge_mats[0][0, gi])
        amp_i = float(res.T[0, i, gi]) * g / max(layer.comp1, 1e-30)
        layer_plans.append(
            LayerPlan(
                index=i,
                name=layer.name,
                gpus=g,
                time=comm_in + _layer_cost(layer, g),
                comp=layer.comp[g],
                sync=layer.sync[g],
                comm_in=comm_in,
                amp=amp_i,
                kind=layer.kind,
            )
        )
        if i > 0 and res.edge_blocks[i]:
            cur = idxs[i - 1]
            for b in res.edge_blocks[i]:
                # the block folds into layer i's comm_in: its branch devices
                # are busy only during the stage containing layer i
                details[b.name] = block_placements(
                    b, cur, gi, scales, amp_limit, hw,
                    res.layers[i - 1].act_bytes, num_gpus, layer_index=i,
                )
                cur = gi
    from repro_torch.core.graph_reduce import _single_gpu_time

    single = _single_gpu_time(chain)  # includes branch layers inside blocks
    return BurstPlan(
        layers=tuple(layer_plans),
        num_gpus=num_gpus,
        amp_limit=amp_limit,
        single_gpu_time=single,
        block_details=details,
    )


# ---------------------------------------------------------------------------
# Encoder-decoder two-chain DAG planning (resharding join on the cross-edge)
# ---------------------------------------------------------------------------


def plan_encdec(
    graph,
    num_gpus: int,
    amp_limit: float = 2.0,
    hw: Optional[Hardware] = None,
    engine: str = "vectorized",
) -> BurstPlan:
    """Plan an EncDecGraph as a two-chain DAG.

    The encoder chain runs first; the decoder chain's cross-attention then
    consumes the encoder output memory, paying a resharding join of
    ``cross_act_bytes`` from the encoder's exit scale to the decoder's entry
    scale.  The vectorized engine plans the decoder once with *every* entry
    scale pinned (matrix DP E axis) and jointly minimizes
    S_enc[e] + S_dec[e][g] over (encoder exit e, decoder exit g).
    """
    from repro_torch.core.profiler import profile_graph

    if engine not in ("vectorized", "reference"):
        raise ValueError(f"unknown planner engine: {engine!r}")
    hw = hw or Hardware()
    scales = plan_scales(num_gpus)
    enc_chain = profile_graph(list(graph.encoder), num_gpus, hw)
    dec_chain = profile_graph(list(graph.decoder), num_gpus, hw)
    if engine == "reference":
        return _plan_encdec_reference(
            graph, enc_chain, dec_chain, num_gpus, scales, amp_limit, hw
        )

    n = len(scales)
    scales_f = np.asarray(scales, dtype=np.float64)
    enc = _search_vec(enc_chain, scales, amp_limit, hw)
    dec = _search_vec(
        dec_chain, scales, amp_limit, hw,
        entry="all", entry_act_bytes=graph.cross_act_bytes,
    )
    amp_enc = enc.T[0, -1, :] * scales_f / max(enc.layers[-1].comp1, 1e-30)
    amp_dec = dec.T[:, -1, :] * scales_f[None, :] / max(dec.layers[-1].comp1, 1e-30)
    total = enc.S[0, -1, :][:, None] + dec.S[:, -1, :]          # (e, g)
    feas = (amp_enc[:, None] <= amp_limit) & (amp_dec <= amp_limit)
    if not feas.any():
        feas = np.ones_like(feas)
    e_idx, gd_idx = np.unravel_index(
        int(np.argmin(np.where(feas, total, INF))), total.shape
    )
    e_idx, gd_idx = int(e_idx), int(gd_idx)

    enc_idxs = _backtrace_idx(enc, 0, e_idx)
    dec_idxs = _backtrace_idx(dec, e_idx, gd_idx)

    from repro_torch.core.graph_reduce import _single_gpu_time, block_placements

    layer_plans: List[LayerPlan] = []
    details: Dict[str, object] = {}

    def _emit(res, row, idxs, base, amp_limit_=amp_limit):
        for i, (layer, gi) in enumerate(zip(res.layers, idxs)):
            g = scales[gi]
            if i > 0:
                comm_in = float(res.edge_mats[i][idxs[i - 1], gi])
            else:
                comm_in = float(res.edge_mats[0][row, gi])
            layer_plans.append(
                LayerPlan(
                    index=base + i, name=layer.name, gpus=g,
                    time=comm_in + _layer_cost(layer, g),
                    comp=layer.comp[g], sync=layer.sync[g], comm_in=comm_in,
                    amp=float(res.T[row, i, gi]) * g / max(layer.comp1, 1e-30),
                    kind=layer.kind,
                )
            )
            if i > 0 and res.edge_blocks[i]:
                cur = idxs[i - 1]
                for b in res.edge_blocks[i]:
                    details[b.name] = block_placements(
                        b, cur, gi, scales, amp_limit_, hw,
                        res.layers[i - 1].act_bytes, num_gpus,
                        layer_index=base + i,
                    )
                    cur = gi

    _emit(enc, 0, enc_idxs, 0)
    base = len(enc.layers)
    _emit(dec, e_idx, dec_idxs, base)  # edge 0 row e_idx = resharding join
    single = _single_gpu_time(enc_chain) + _single_gpu_time(dec_chain)
    details |= {
        "encdec_join": {
            "encoder_layers": base,
            "encoder_exit_gpus": scales[e_idx],
            "decoder_entry_gpus": scales[dec_idxs[0]],
            "reshard_time": float(dec.edge_mats[0][e_idx, dec_idxs[0]]),
            "cross_act_bytes": graph.cross_act_bytes,
        }
    }
    return BurstPlan(
        layers=tuple(layer_plans),
        num_gpus=num_gpus,
        amp_limit=amp_limit,
        single_gpu_time=single,
        block_details=details,
    )


def _plan_encdec_reference(
    graph, enc_chain, dec_chain, num_gpus, scales, amp_limit, hw
) -> BurstPlan:
    """Pure-Python oracle for plan_encdec: one entry-pinned reference search
    per candidate encoder exit scale; same joint objective and tie-breaks."""
    enc = search_linear_reference(enc_chain, scales, amp_limit, hw)
    Le = len(enc.layers)
    dec_by_entry = {
        e: search_linear_reference(
            dec_chain, scales, amp_limit, hw,
            entry_scale=e, entry_act_bytes=graph.cross_act_bytes,
        )
        for e in scales
    }
    Ld = len(dec_by_entry[scales[0]].layers)

    def enc_amp(i, g):
        return enc.T[i][g] * g / max(enc.layers[i].comp1, 1e-30)

    def dec_amp(res, i, g):
        return res.T[i][g] * g / max(res.layers[i].comp1, 1e-30)

    pairs = [
        (e, g)
        for e in scales
        for g in scales
        if enc_amp(Le - 1, e) <= amp_limit
        and dec_amp(dec_by_entry[e], Ld - 1, g) <= amp_limit
    ]
    if not pairs:
        pairs = [(e, g) for e in scales for g in scales]
    best_e, best_g, best_total = None, None, INF
    for e, g in pairs:  # e-major, ascending: same tie-break as np.argmin
        t = enc.S[Le - 1][e] + dec_by_entry[e].S[Ld - 1][g]
        if t < best_total:
            best_e, best_g, best_total = e, g, t
    dec = dec_by_entry[best_e]
    enc_gs = _backtrace(enc, best_e)
    dec_gs = _backtrace(dec, best_g)

    layer_plans: List[LayerPlan] = []
    for i, (layer, g) in enumerate(zip(enc.layers, enc_gs)):
        h = enc_gs[i - 1] if i > 0 else g
        comm_in = enc.trans[i](h, g)
        layer_plans.append(
            LayerPlan(
                index=i, name=layer.name, gpus=g,
                time=comm_in + _layer_cost(layer, g),
                comp=layer.comp[g], sync=layer.sync[g], comm_in=comm_in,
                amp=enc_amp(i, g), kind=layer.kind,
            )
        )
    for j, (layer, g) in enumerate(zip(dec.layers, dec_gs)):
        h = dec_gs[j - 1] if j > 0 else best_e
        comm_in = dec.trans[j](h, g)
        layer_plans.append(
            LayerPlan(
                index=Le + j, name=layer.name, gpus=g,
                time=comm_in + _layer_cost(layer, g),
                comp=layer.comp[g], sync=layer.sync[g], comm_in=comm_in,
                amp=dec_amp(dec, j, g), kind=layer.kind,
            )
        )
    from repro_torch.core.graph_reduce import _single_gpu_time

    single = _single_gpu_time(enc_chain) + _single_gpu_time(dec_chain)
    details = {
        "encdec_join": {
            "encoder_layers": Le,
            "encoder_exit_gpus": best_e,
            "decoder_entry_gpus": dec_gs[0],
            "reshard_time": dec.trans[0](best_e, dec_gs[0]),
            "cross_act_bytes": graph.cross_act_bytes,
        }
    }
    return BurstPlan(
        layers=tuple(layer_plans),
        num_gpus=num_gpus,
        amp_limit=amp_limit,
        single_gpu_time=single,
        block_details=details,
    )


# ---------------------------------------------------------------------------
# Data-parallel baseline
# ---------------------------------------------------------------------------


def plan_data_parallel(graph, num_gpus: int, hw: Optional[Hardware] = None) -> BurstPlan:
    """The paper's 'DP' baseline: every layer at full scale."""
    return _dp_plan(graph, num_gpus, hw)


def _dp_plan(graph, num_gpus: int, hw: Optional[Hardware]) -> BurstPlan:
    from repro_torch.core.profiler import profile_graph
    from repro_torch.models.graph import EncDecGraph, LayerNode, ParallelBlock

    hw = hw or Hardware()
    if isinstance(graph, EncDecGraph):
        # DP baseline runs both chains back-to-back at full scale
        graph = list(graph.encoder) + list(graph.decoder)
    if graph and isinstance(graph[0], (LayerNode, ParallelBlock)):
        chain = profile_graph(graph, num_gpus, hw)
    else:
        chain = list(graph)
    # flatten blocks: DP runs branches sequentially at full scale
    flat: List[CostedLayer] = []

    def _flat(els):
        for el in els:
            if isinstance(el, CostedLayer):
                flat.append(el)
            else:
                for br in el.branches:
                    _flat(br)

    _flat(chain)
    g = num_gpus
    plans = [
        LayerPlan(
            index=i, name=l.name, gpus=g, time=_layer_cost(l, g), comp=l.comp[g],
            sync=l.sync[g], comm_in=0.0, amp=_layer_cost(l, g) * g / max(l.comp1, 1e-30),
            kind=l.kind,
        )
        for i, l in enumerate(flat)
    ]
    return BurstPlan(
        layers=tuple(plans),
        num_gpus=g,
        amp_limit=INF,
        single_gpu_time=sum(l.comp1 for l in flat),
    )

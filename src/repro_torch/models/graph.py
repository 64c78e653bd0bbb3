"""Layer-graph representation consumed by the burst-parallel planner.

The port of ``repro/models/graph.py``, built on the port's own
``configs`` (field for field the reference's).

A graph is a *chain* of elements; an element is either a ``LayerNode`` or a
``ParallelBlock`` whose branches are themselves chains (possibly nested) —
exactly the branch/join structure the paper's graph-reduction algorithm
(Fig 7) handles.

Each node carries analytical cost descriptors; ``core/profiler.py`` turns
them into the paper's ``comp(i, g)`` tables through the hardware model.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Union

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.configs.vgg16 import ConvSpec, VGGConfig


@dataclass(frozen=True)
class LayerNode:
    name: str
    flops: float            # fwd FLOPs for the full global batch
    param_bytes: float      # parameter bytes (gradient-sync payload)
    act_out_bytes: float    # output activation bytes (resharding payload)
    parallel_units: int     # max useful sample-dimension split
    seq_flops: float = 0.0  # inherently sequential FLOPs (scan steps etc.)
    bwd_mult: float = 2.0   # bwd = bwd_mult × fwd flops
    kind: str = "generic"
    sync_groups: int = 1    # params sharded over this many groups (TP/EP):
                            # grad sync runs per group over g/sync_groups
                            # replicas with 1/sync_groups of the bytes


@dataclass(frozen=True)
class ParallelBlock:
    name: str
    branches: tuple  # tuple of chains; each chain is a tuple of elements


@dataclass(frozen=True)
class EncDecGraph:
    """Two-chain DAG: encoder chain + decoder chain joined by a cross-edge.

    The decoder's cross-attention consumes the encoder's output memory, so
    the planner (core/planner.plan_encdec) plans the two chains jointly: the
    encoder's exit scale becomes the decoder's pinned entry scale and the
    cross-edge pays a resharding join of ``cross_act_bytes``.
    """

    name: str
    encoder: tuple  # LayerGraph chain
    decoder: tuple  # LayerGraph chain
    cross_act_bytes: float


GraphElem = Union[LayerNode, ParallelBlock]
LayerGraph = List[GraphElem]  # a chain


def flatten_nodes(graph) -> list:
    out = []
    for el in graph:
        if isinstance(el, LayerNode):
            out.append(el)
        else:
            for br in el.branches:
                out.extend(flatten_nodes(list(br)))
    return out


def total_fwd_flops(graph) -> float:
    return sum(n.flops + n.seq_flops for n in flatten_nodes(graph))


# ---------------------------------------------------------------------------
# Builders — LM architectures
# ---------------------------------------------------------------------------

_BYTES = 2  # activations in bf16


def build_lm_graph(cfg: ModelConfig, shape: ShapeConfig, tp: int = 16) -> LayerGraph:
    """Per-layer chain for the assigned LM architectures. Costs are for one
    iteration at the global batch of `shape` (train) or one decode step.
    `tp` = model-axis width: params are TP/EP-sharded over it, so gradient
    sync spans only g/tp replicas with 1/tp of the bytes (dist/sharding.py
    layout)."""
    B = shape.global_batch
    S = shape.seq_len if shape.kind != "decode" else 1
    S_kv = shape.seq_len
    D, Hh, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.d_head
    T = B * S  # tokens per iteration
    act = T * D * _BYTES
    g: LayerGraph = []

    g.append(
        LayerNode(
            "embed",
            flops=2.0 * T * D,  # gather ~ bytes-bound; count copy flops
            param_bytes=cfg.padded_vocab * D * 4,
            act_out_bytes=act,
            parallel_units=T,
            kind="embed",
            sync_groups=tp,
        )
    )

    def attn_node(i: int) -> LayerNode:
        proj = 2.0 * T * D * (cfg.attn_dim + 2 * cfg.kv_dim) + 2.0 * T * cfg.attn_dim * D
        window = min(cfg.sliding_window or S_kv, S_kv)
        if shape.kind == "decode":
            score = 2.0 * B * Hh * hd * window * 2  # qk + pv
        else:
            score = 2.0 * B * Hh * hd * S * min(window, S)  # causal ≈ /2 applied below
            score = score  # keep full-window upper bound; masks don't save on MXU
        pb = (D * (cfg.attn_dim + 2 * cfg.kv_dim) + cfg.attn_dim * D) * 4
        return LayerNode(
            f"attn_{i}", flops=proj + score, param_bytes=pb, act_out_bytes=act,
            parallel_units=T, kind="attention", sync_groups=tp,
        )

    def ffn_node(i: int) -> LayerNode:
        if cfg.is_moe:
            fl = 6.0 * T * D * cfg.moe_d_ff * cfg.experts_per_tok
            pb = cfg.num_experts * 3 * D * cfg.moe_d_ff * 4
            return LayerNode(
                f"moe_{i}", flops=fl, param_bytes=pb, act_out_bytes=act,
                parallel_units=T, kind="moe", sync_groups=tp,
            )
        fl = 6.0 * T * D * cfg.d_ff
        return LayerNode(
            f"mlp_{i}", flops=fl, param_bytes=3 * D * cfg.d_ff * 4,
            act_out_bytes=act, parallel_units=T, kind="mlp", sync_groups=tp,
        )

    def mamba_node(i: int) -> LayerNode:
        din, N, Hm = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_heads
        proj = 2.0 * T * D * (2 * din + 2 * N + Hm) + 2.0 * T * din * D
        chunk = 128
        ssd = 2.0 * B * max(S // chunk, 1) * chunk * chunk * (Hm + 2 * N)  # intra-chunk
        seq = 2.0 * B * max(S // chunk, 1) * Hm * cfg.ssm_head_dim * N  # inter-chunk scan
        pb = (D * (2 * din + 2 * N + Hm) + din * D) * 4
        return LayerNode(
            f"mamba_{i}", flops=proj + ssd, seq_flops=seq, param_bytes=pb,
            act_out_bytes=act, parallel_units=B * max(S // chunk, 1), kind="ssm",
            sync_groups=tp,
        )

    def rwkv_node(i: int) -> LayerNode:
        chunk = 64
        proj = 2.0 * T * D * (5 * D)
        wkv = 2.0 * B * max(S // chunk, 1) * chunk * chunk * D
        seq = 2.0 * B * max(S // chunk, 1) * D * hd
        cmix = 6.0 * T * D * cfg.d_ff
        return LayerNode(
            f"rwkv_{i}", flops=proj + wkv + cmix, seq_flops=seq,
            param_bytes=(6 * D * D + 2 * D * cfg.d_ff) * 4,
            act_out_bytes=act, parallel_units=B * max(S // chunk, 1), kind="ssm",
            sync_groups=tp,
        )

    for i in range(cfg.num_layers):
        if cfg.block_type == "mamba2":
            g.append(mamba_node(i))
            if cfg.attn_every and i % cfg.attn_every == 0:
                g.append(attn_node(i))
                g.append(ffn_node(i))
        elif cfg.block_type == "rwkv6":
            g.append(rwkv_node(i))
        else:
            g.append(attn_node(i))
            g.append(ffn_node(i))

    g.append(
        LayerNode(
            "lm_head",
            flops=2.0 * T * D * cfg.padded_vocab,
            param_bytes=cfg.padded_vocab * D * 4,
            act_out_bytes=T * cfg.padded_vocab * _BYTES,
            parallel_units=T,
            kind="head",
            sync_groups=tp,
        )
    )
    return g


# ---------------------------------------------------------------------------
# Builders — encoder-decoder two-chain DAG (seamless-m4t class, encdec.py)
# ---------------------------------------------------------------------------


def build_encdec_graph(cfg: ModelConfig, shape: ShapeConfig, tp: int = 16) -> EncDecGraph:
    """Two-chain DAG for an encoder-decoder LM (models/encdec.py shapes):
    encoder over ``seq_len`` frames, decoder over ``seq_len // 4`` tokens
    (encdec.DEC_RATIO), cross-attention joining them.  The cross-edge payload
    is the encoder output memory each decoder device must hold."""
    dec_ratio = 4  # the reference's encdec.DEC_RATIO
    B = shape.global_batch
    S_enc = shape.seq_len
    S_dec = max(S_enc // dec_ratio, 1)
    D, Hh, hd = cfg.d_model, cfg.num_heads, cfg.d_head
    T_e, T_d = B * S_enc, B * S_dec
    act_e = T_e * D * _BYTES
    act_d = T_d * D * _BYTES

    enc: List[LayerNode] = [
        LayerNode(
            "frontend_proj", flops=2.0 * T_e * D * D, param_bytes=D * D * 4,
            act_out_bytes=act_e, parallel_units=T_e, kind="embed", sync_groups=tp,
        )
    ]
    attn_pb = (D * (cfg.attn_dim + 2 * cfg.kv_dim) + cfg.attn_dim * D) * 4
    for i in range(cfg.num_encoder_layers):
        proj = 2.0 * T_e * D * (cfg.attn_dim + 2 * cfg.kv_dim) + 2.0 * T_e * cfg.attn_dim * D
        score = 2.0 * B * Hh * hd * S_enc * S_enc  # bidirectional
        enc.append(
            LayerNode(
                f"enc_attn_{i}", flops=proj + score, param_bytes=attn_pb,
                act_out_bytes=act_e, parallel_units=T_e, kind="attention",
                sync_groups=tp,
            )
        )
        enc.append(
            LayerNode(
                f"enc_mlp_{i}", flops=6.0 * T_e * D * cfg.d_ff,
                param_bytes=3 * D * cfg.d_ff * 4, act_out_bytes=act_e,
                parallel_units=T_e, kind="mlp", sync_groups=tp,
            )
        )

    dec: List[LayerNode] = [
        LayerNode(
            "embed", flops=2.0 * T_d * D, param_bytes=cfg.padded_vocab * D * 4,
            act_out_bytes=act_d, parallel_units=T_d, kind="embed", sync_groups=tp,
        )
    ]
    for i in range(cfg.num_layers):
        proj = 2.0 * T_d * D * (cfg.attn_dim + 2 * cfg.kv_dim) + 2.0 * T_d * cfg.attn_dim * D
        score = 2.0 * B * Hh * hd * S_dec * S_dec
        dec.append(
            LayerNode(
                f"dec_self_attn_{i}", flops=proj + score, param_bytes=attn_pb,
                act_out_bytes=act_d, parallel_units=T_d, kind="attention",
                sync_groups=tp,
            )
        )
        # cross-attention: q from T_d decoder tokens, k/v projected from the
        # T_e-frame encoder memory, scores over S_dec × S_enc
        x_proj = (
            2.0 * T_d * D * cfg.attn_dim
            + 2.0 * T_e * D * 2 * cfg.kv_dim
            + 2.0 * T_d * cfg.attn_dim * D
        )
        x_score = 2.0 * B * Hh * hd * S_dec * S_enc * 2  # qk + pv
        dec.append(
            LayerNode(
                f"dec_cross_attn_{i}", flops=x_proj + x_score, param_bytes=attn_pb,
                act_out_bytes=act_d, parallel_units=T_d, kind="attention",
                sync_groups=tp,
            )
        )
        dec.append(
            LayerNode(
                f"dec_mlp_{i}", flops=6.0 * T_d * D * cfg.d_ff,
                param_bytes=3 * D * cfg.d_ff * 4, act_out_bytes=act_d,
                parallel_units=T_d, kind="mlp", sync_groups=tp,
            )
        )
    dec.append(
        LayerNode(
            "lm_head", flops=2.0 * T_d * D * cfg.padded_vocab,
            param_bytes=cfg.padded_vocab * D * 4,
            act_out_bytes=T_d * cfg.padded_vocab * _BYTES,
            parallel_units=T_d, kind="head", sync_groups=tp,
        )
    )
    return EncDecGraph(
        name=cfg.name, encoder=tuple(enc), decoder=tuple(dec),
        cross_act_bytes=float(act_e),
    )


# ---------------------------------------------------------------------------
# Builders — paper's CNNs (VGG-16 + a synthetic Inception-style graph)
# ---------------------------------------------------------------------------


def build_vgg_graph(vcfg: VGGConfig, global_batch: int) -> LayerGraph:
    g: LayerGraph = []
    for spec in vcfg.layers:
        if isinstance(spec, ConvSpec):
            hw = spec.spatial * spec.spatial
            fl = 2.0 * global_batch * hw * spec.kernel ** 2 * spec.in_ch * spec.out_ch
            pb = spec.kernel ** 2 * spec.in_ch * spec.out_ch * 4
            ab = global_batch * hw * spec.out_ch * _BYTES
            g.append(
                LayerNode(spec.name, flops=fl, param_bytes=pb, act_out_bytes=ab,
                          parallel_units=global_batch, kind="conv")
            )
        else:
            fl = 2.0 * global_batch * spec.in_dim * spec.out_dim
            g.append(
                LayerNode(spec.name, flops=fl, param_bytes=spec.in_dim * spec.out_dim * 4,
                          act_out_bytes=global_batch * spec.out_dim * _BYTES,
                          parallel_units=global_batch, kind="dense")
            )
    return g


def build_wrn_graph(global_batch: int, image_size: int = 400) -> LayerGraph:
    """WideResNet-101-2 (paper Table 1: 105 layers, 3×400×400, intense conv).
    Bottleneck stages [3, 4, 23, 3], width factor 2."""
    g: LayerGraph = []
    hw = image_size // 2

    def conv(name, cin, cout, k, sp):
        fl = 2.0 * global_batch * sp * sp * k * k * cin * cout
        g.append(
            LayerNode(name, flops=fl, param_bytes=k * k * cin * cout * 4,
                      act_out_bytes=global_batch * sp * sp * cout * _BYTES,
                      parallel_units=global_batch, kind="conv")
        )

    conv("stem", 3, 64, 7, hw)
    hw //= 2
    cin = 64
    for si, (blocks, planes) in enumerate(zip((3, 4, 23, 3), (128, 256, 512, 1024))):
        cout = planes * 4 // 2  # expansion 4, post-width normalization
        for b in range(blocks):
            conv(f"s{si}b{b}_1x1a", cin, planes, 1, hw)
            conv(f"s{si}b{b}_3x3", planes, planes, 3, hw)
            conv(f"s{si}b{b}_1x1b", planes, cout, 1, hw)
            cin = cout
        hw = max(hw // 2, 7)
    g.append(LayerNode("fc", flops=2.0 * global_batch * cin * 1000,
                       param_bytes=cin * 1000 * 4,
                       act_out_bytes=global_batch * 1000 * _BYTES,
                       parallel_units=global_batch, kind="dense"))
    return g


def build_inception_like_graph(global_batch: int, n_blocks: int = 9) -> LayerGraph:
    """Synthetic multi-branch graph (Inception-v3 shape class): exercises the
    paper's graph-reduction algorithm. Each block: 4 parallel branches of
    1–3 convs joined by concat."""
    g: LayerGraph = []
    ch, hw = 32, 149
    g.append(LayerNode("stem", flops=2.0 * global_batch * hw * hw * 9 * 3 * ch,
                       param_bytes=9 * 3 * ch * 4,
                       act_out_bytes=global_batch * hw * hw * ch * _BYTES,
                       parallel_units=global_batch, kind="conv"))
    for b in range(n_blocks):
        hwb = max(8, hw // (1 + b // 3))
        chb = ch * (1 + b // 3)
        branches = []
        for j, depth in enumerate((1, 2, 3, 1)):
            chain = tuple(
                LayerNode(
                    f"b{b}_br{j}_conv{k}",
                    flops=2.0 * global_batch * hwb * hwb * (1 if k == 0 else 9) * chb * chb // 4,
                    param_bytes=(1 if k == 0 else 9) * chb * chb // 4 * 4,
                    act_out_bytes=global_batch * hwb * hwb * chb // 4 * _BYTES,
                    parallel_units=global_batch,
                    kind="conv",
                )
                for k in range(depth)
            )
            branches.append(chain)
        g.append(ParallelBlock(f"block{b}", tuple(branches)))
    g.append(LayerNode("classifier", flops=2.0 * global_batch * 2048 * 1000,
                       param_bytes=2048 * 1000 * 4,
                       act_out_bytes=global_batch * 1000 * _BYTES,
                       parallel_units=global_batch, kind="dense"))
    return g

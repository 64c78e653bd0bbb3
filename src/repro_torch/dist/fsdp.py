"""FSDP parameter gathering, activation constraints and the collectives of
explicit local compute.

The port of ``repro/dist/fsdp.py``.  The models call the reference's
hooks at the reference's sites:

  - ``gather(tree, schema)`` / ``gather_leaf(x, axes)``: a parameter is a
    DTensor placed by the rules; at its use site it is redistributed to
    its TP-only layout (data and pod axes stripped, ``_tp_only_rules``: an
    all-gather of the FSDP shards) and handed to the model as this rank's
    plain local tensor, with ``Partial`` gradient placements on the axes
    the batch is split over.  Autograd then reduce-scatters the gradient
    back onto the parameter's shards: ZeRO-3, since every family calls
    the hook inside its per-layer remat function, so the recompute gathers
    again.
  - ``constrain(x, axes)``: local compute already holds this rank's
    shard and needs no layout hint, so this is the identity.
  - ``group_count(axis)``: the number of shards the active rules give a
    logical axis (1 outside any context), for group-local capacity math.

Port-only, for the global reductions local compute must make itself:
``batch_sum`` (a sum over the ranks the batch is split over, whose
backward is the identity: each rank's gradient is its own share), and
the tensor-parallel crossings over the ``model`` axis, with
``model_max``, ``model_size`` and ``model_rank``, the
split-KV decode's ``kv_seq_axes``, ``kv_seq_offset`` and ``reduce_over``,
and sequence parallelism's ``sp_enter``, ``sp_exit``, ``sp_slice``,
``token_sum`` and ``input_split``.

Tensor parallelism over ``model`` (the dense and MoE decoder blocks,
rwkv6, Mamba-2 and zamba2's shared block, pixtral's vision projection, the
encoder-decoder blocks)
keeps every activation in one of two states:

  - replicated: the same on every ``model`` rank, with the same gradient
    on every rank (the residual stream, norms of it, routing);
  - local: this rank's shard (its heads, channels or experts), or this
    rank's partial sum.

The crossings between them:

  - replicated -> local (a column-parallel input, or a slice to this
    rank's heads or experts): ``tp_copy`` (identity forward, gradient
    summed over ``model``);
  - local partial sum -> replicated (a row-parallel product): ``tp_sum``
    (all-reduce forward, identity backward);
  - local shard -> replicated: ``tp_gather(x, dim)`` (all-gather along
    ``dim`` forward, this rank's slice of the replicated gradient
    backward).

A parameter the rules keep whole over ``model`` gets ``Replicate``
gradient placements there (``gather_leaf``), so it may feed replicated
compute only; where a rank reads a slice of it (rwkv6's ``ln_x`` scale
and decay, Mamba-2's ``B``/``C``), that use enters through ``tp_copy``
first.  A norm over a split width takes its statistic as
``tp_copy(tp_sum(local sum))`` (``layers.rms_norm``'s ``width``): each
rank's gradient of the statistic reaches every rank.

The encoder-decoder blocks (seamless) run the dense family's rule in the
encoder, the decoder and the cross-attention.  The cross-attention's K/V
project the replicated encoder output onto this rank's KV heads, and that
output enters through ``tp_copy``: each rank's heads' gradient reaches
every rank's encoder.

Split-KV decoding.  A decode cell whose rules give ``act_kv_seq`` live
mesh axes holds each cache leaf with that axis (the KV caches of the dense,
MoE and zamba2 blocks, seamless's self-attention and encoder memory) split
along its sequence over ``kv_seq_axes(leaf)``, in the rules' order with the
first axis major (as ``pspec`` and ``placements`` lay out a dim split over
a tuple of axes).  A rank holds positions ``[off, off + S_loc)``, with
``off`` this rank's index along the axes times ``S_loc``
(``kv_seq_offset``).  The axes are the leaf's own: where the divisibility
guard keeps one leaf whole (a capacity not divisible by the split) it
decodes whole on every rank, with no merge, while another leaf of the same
cache (seamless's encoder memory) splits.  Each rank attends over its
slice, masking by global position, and returns its partial output with
the row's log-sum-exp (``models.attention.decode_attention_partial``); the
partials merge as ``m = max(lse)``, ``w = exp(lse - m)``, ``out =
sum(o w) / sum(w)`` over the leaf's axes (``reduce_over``), in fp32
(``merge_partials``; the two sums travel in one all-reduce).  A rank whose
whole slice is masked has its ``lse`` near the finite ``NEG_INF`` and so a
weight of exactly 0.  Where
'model' carries the sequence while the query heads are split over it, a
rank gathers ``q`` over 'model' (``tp_gather(q, 2)``), attends with every
query head over its slice, merges, and keeps its own heads' rows for the
row-parallel out-projection.  The new token's K/V are written by the rank
whose slice holds position ``n`` only (``models.attention.cache_write``:
a clamped index and ``torch.where``, no read on the host).  Decoding runs
under ``torch.no_grad()``, so the helpers need no backward.  A prefill
into a split cache (``train.step.jit_prefill``, the serving engine's)
runs ``transformer.prefill`` on the rank's rows and heads, which fills the
whole sequence, then keeps the rank's slice of it (a local narrow, no
collective); the production prefill cells run ``jit_forward``, which
builds no cache.

Kept whole over ``model``.  A parameter the rules split on ``model``
along a logical axis that no block computes on locally (one outside
``TP_AXES``: a norm scale, ``embed``, ``head_dim``, ...) is gathered whole at
its use like an FSDP shard (``_tp_only_rules`` strips ``model`` there), and
its ``Replicate`` gradient goes back onto its shards.  KV heads split while
the query heads stay whole: each rank takes the query heads of its own KV
groups, a slice of the whole ``wq`` and ``wo`` read through ``tp_copy``, and
the out-projection is row-parallel (``models/transformer.py``).  A Mamba-2
``d_inner`` split over whole heads (``ssm_inner`` split, ``heads`` whole)
gathers the channels after the causal conv and runs the scan over every head
(``models/mamba2.py``).

Sequence parallelism (the Megatron form of the reference's "SP for
norms/residual").  Where the placement of a step's input splits its
sequence over ``model`` (``act_seq`` on a live ``model``, the divisibility
guard keeping the split), the residual stream of that input is local: a
rank holds positions ``[r S/m, (r + 1) S/m)``, ``r = model_rank()``, ``m =
model_size()``, and the embeddings' output, the norms in front of every
block and the residual adds run on that slice.  The step wrappers record
which inputs split, and whether the decoder's residual stream does
(``"residual"``: the tokens, after pixtral's patches), by the same guard
(``context(..., layout=)``, read by ``input_split``); the models read it at
their entry and pass it down as ``seq``.  A block needs the whole
sequence, so it is gathered at the block's entry and scattered at its exit:

  - entry into a tensor-parallel block: ``sp_enter`` (all-gather along the
    sequence forward, reduce-scatter backward), in place of ``tp_copy``;
  - exit from a row-parallel product: ``sp_exit`` (reduce-scatter along the
    sequence forward, all-gather backward), in place of ``tp_sum``;
  - a block the rules keep whole over ``model`` (qwen2's and minicpm's
    attention, the MoE's routing and dispatch, Mamba-2 over whole heads,
    rwkv6's token shifts) computes on every rank alike: it enters through
    ``tp_gather(x, 1)`` (gather forward, slice backward) and leaves through
    ``sp_slice`` (this rank's slice forward, all-gather backward).

Between ``sp_enter`` and ``sp_exit`` each rank's compute is its share, so a
parameter the rules keep whole that it reads (a K/V projection over whole
KV heads, Mamba-2's ``B``/``C``) enters through ``tp_copy``, as does a
whole parameter read by the sequence-local compute (the norm scales):
their gradients sum over ``model``.  Token ids gather whole before the
vocab-parallel lookup, which leaves by ``sp_exit``.  The loss
sums over every rank that holds a share of the tokens (``token_sum``).  The
kernels see the gathered sequence at this rank's heads, the shapes of the
tensor-parallel step.  An input the guard keeps whole (a decode step's one
token, a length not divisible by ``m``) runs as without sequence
parallelism.

Each cache leaf decodes by its own placement: ``kv_seq_axes(leaf)`` reads
the live axes of the leaf's ``act_kv_seq`` dim from the step's layout, so a
leaf the guard keeps whole decodes whole on every rank while another leaf
of the same cache splits.

Every hook is the identity outside a ``context(mesh, rules)`` block, so
single-device code runs the same model code unsharded, and every
collective over axes of size 1 is skipped.
"""
from __future__ import annotations

import math
from contextlib import contextmanager
from typing import Any, Optional, Tuple

import torch

from repro_torch.dist.sharding import DP_AXES, axis_names, mesh_axis_sizes, placements, pspec

# The logical parameter axes tensor parallelism over 'model' splits: the
# blocks compute on such a leaf's local shard.  A leaf split on 'model'
# along any other axis is gathered whole at its use.
TP_AXES = ("heads", "kv_heads", "mlp", "vocab", "embed_out", "ssm_inner", "expert", "moe_mlp")

# Stack of (mesh, rules) — LIFO so contexts nest — and of the steps' layouts.
_CTX: list = []
_LAYOUT: list = []


@contextmanager
def context(mesh, rules, layout: Optional[dict] = None):
    """Activate (mesh, rules) for the hooks.  ``layout`` is what the
    placement of a step's inputs says (``train.step``): ``{"seq": the
    names of the inputs whose sequence splits over 'model', "kv_seq":
    {cache leaf: the live mesh axes its sequence splits over}}``."""
    _CTX.append((mesh, rules))
    _LAYOUT.append(layout)
    try:
        yield
    finally:
        _CTX.pop()
        _LAYOUT.pop()


def active() -> Optional[tuple]:
    return _CTX[-1] if _CTX else None


def group_count(axis: str) -> int:
    """Shard count of a logical axis under the active rules (1 if inactive)."""
    ctx = active()
    if ctx is None:
        return 1
    mesh, rules = ctx
    sizes = mesh_axis_sizes(mesh)
    return int(math.prod(sizes.get(a, 1) for a in rules.get(axis, ()))) or 1


def _tp_only_rules(rules) -> dict:
    """The rule set with DP/FSDP axes stripped, and 'model' on the logical
    axes outside ``TP_AXES`` (what a gathered weight keeps)."""
    dp = set(DP_AXES)
    return {
        k: tuple(a for a in v if a not in dp and (a != "model" or k in TP_AXES))
        for k, v in rules.items()
        if isinstance(v, (tuple, list))
    }


def _live(axes) -> Tuple[str, ...]:
    """The axes among ``axes`` of size > 1 on the active mesh."""
    mesh, _ = active()
    sizes = mesh_axis_sizes(mesh)
    return tuple(a for a in axes if sizes.get(a, 1) > 1)


def batch_axes() -> Tuple[str, ...]:
    """The mesh axes (of size > 1) the batch is split over: the active
    rules' ``act_batch``; () outside a context."""
    if active() is None:
        return ()
    return _live(active()[1].get("act_batch", ()))


def batch_shards() -> int:
    """How many ranks split the batch (1 outside a context)."""
    if active() is None:
        return 1
    sizes = mesh_axis_sizes(active()[0])
    return int(math.prod(sizes[a] for a in batch_axes()))


def model_size() -> int:
    """The ``model`` axis size (1 outside a context)."""
    if active() is None:
        return 1
    return mesh_axis_sizes(active()[0]).get("model", 1)


def model_rank() -> int:
    """This rank's coordinate on the ``model`` axis (0 outside a context)."""
    if model_size() == 1:
        return 0
    return active()[0].get_local_rank("model")


def _groups(axes):
    mesh = active()[0]
    return [mesh.get_group(a) for a in axes]


def _all_reduce(x: torch.Tensor, axes, op=None) -> torch.Tensor:
    import torch.distributed as dist

    y = x.clone()
    for g in _groups(axes):
        dist.all_reduce(y, op=op or dist.ReduceOp.SUM, group=g)
    return y


class _SumIdentityGrad(torch.autograd.Function):
    """Forward: the sum over ``axes``; backward: the identity."""

    @staticmethod
    def forward(ctx, x, axes):
        return _all_reduce(x, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _IdentitySumGrad(torch.autograd.Function):
    """Forward: the identity; backward: the gradient summed over ``axes``."""

    @staticmethod
    def forward(ctx, x, axes):
        ctx.axes = axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.axes), None


def batch_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the ranks the batch is split over: every rank
    holds the global value, and its gradient flows back to this rank's own
    share only.  The identity outside a context or on one shard."""
    axes = batch_axes()
    return _SumIdentityGrad.apply(x, axes) if axes else x


def tp_copy(x: torch.Tensor) -> torch.Tensor:
    """Enter a tensor-parallel region: identity, gradient summed over ``model``."""
    return _IdentitySumGrad.apply(x, ("model",)) if model_size() > 1 else x


def tp_sum(x: torch.Tensor) -> torch.Tensor:
    """Leave a tensor-parallel region: sum over ``model``, gradient as is."""
    return _SumIdentityGrad.apply(x, ("model",)) if model_size() > 1 else x


class _GatherSliceGrad(torch.autograd.Function):
    """Forward: the all-gather over 'model' along ``dim``; backward: this
    rank's slice of the (replicated) gradient."""

    @staticmethod
    def forward(ctx, x, dim):
        import torch.distributed as dist

        ctx.dim, ctx.n = dim, x.shape[dim]
        y = x.movedim(dim, 0).contiguous()
        out = y.new_empty((model_size() * y.shape[0],) + tuple(y.shape[1:]))
        dist.all_gather_into_tensor(out, y, group=_groups(("model",))[0])
        return out.movedim(0, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, model_rank() * ctx.n, ctx.n).contiguous(), None


def tp_gather(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Leave a tensor-parallel region from a shard: the ranks' shards
    concatenated along ``dim`` (in ``model`` order), gradient sliced back."""
    return _GatherSliceGrad.apply(x, dim % x.dim()) if model_size() > 1 else x


def _gather_along(x: torch.Tensor, dim: int, axes=("model",)) -> torch.Tensor:
    """The all-gather of ``x`` along ``dim`` over ``axes`` (the first axis
    major), no autograd."""
    import torch.distributed as dist

    for g in reversed(_groups(axes)):  # the innermost axis first
        y = x.movedim(dim, 0).contiguous()
        out = y.new_empty((g.size() * y.shape[0],) + tuple(y.shape[1:]))
        dist.all_gather_into_tensor(out, y, group=g)
        x = out.movedim(0, dim)
    return x


def _scatter_along(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The reduce-scatter of ``x`` along ``dim`` over 'model': this rank's
    slice of the sum, no autograd."""
    import torch.distributed as dist

    y = x.movedim(dim, 0).contiguous()
    out = y.new_empty((y.shape[0] // model_size(),) + tuple(y.shape[1:]))
    dist.reduce_scatter_tensor(out, y, group=_groups(("model",))[0])
    return out.movedim(0, dim)


def _slice(x: torch.Tensor, dim: int) -> torch.Tensor:
    n = x.shape[dim] // model_size()
    return x.narrow(dim, model_rank() * n, n).contiguous()


class _GatherScatterGrad(torch.autograd.Function):
    """Forward: the all-gather over 'model' along ``dim``; backward: the
    reduce-scatter of the (partial) gradient."""

    @staticmethod
    def forward(ctx, x, dim):
        ctx.dim = dim
        return _gather_along(x, dim)

    @staticmethod
    def backward(ctx, g):
        return _scatter_along(g, ctx.dim), None


class _ScatterGatherGrad(torch.autograd.Function):
    """Forward: the reduce-scatter over 'model' along ``dim``; backward: the
    all-gather of the gradient."""

    @staticmethod
    def forward(ctx, x, dim):
        ctx.dim = dim
        return _scatter_along(x, dim)

    @staticmethod
    def backward(ctx, g):
        return _gather_along(g, ctx.dim), None


class _SliceGatherGrad(torch.autograd.Function):
    """Forward: this rank's slice along ``dim``; backward: the all-gather of
    the gradient over 'model'."""

    @staticmethod
    def forward(ctx, x, dim):
        ctx.dim = dim
        return _slice(x, dim)

    @staticmethod
    def backward(ctx, g):
        return _gather_along(g, ctx.dim), None


def sp_enter(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """Enter a tensor-parallel region from a sequence slice: the ranks'
    slices gathered along ``dim``, each rank's share of the gradient
    reduce-scattered back (the sequence-parallel ``tp_copy``)."""
    return _GatherScatterGrad.apply(x, dim % x.dim()) if model_size() > 1 else x


def sp_exit(x: torch.Tensor) -> torch.Tensor:
    """Leave a tensor-parallel region onto a sequence slice: this rank's
    slice of the ranks' partial sums (a reduce-scatter along dim 1), the
    gradient gathered back (the sequence-parallel ``tp_sum``)."""
    return _ScatterGatherGrad.apply(x, 1) if model_size() > 1 else x


def sp_slice(x: torch.Tensor) -> torch.Tensor:
    """Leave a region every rank computed alike onto a sequence slice: this
    rank's slice along dim 1, the gradient gathered back over 'model'."""
    return _SliceGatherGrad.apply(x, 1) if model_size() > 1 else x


def input_split(name: str) -> bool:
    """Whether the step's input ``name`` (``tokens``, ``labels``,
    ``frames``, ``patch_embeds``, ``token``) holds this rank's slice of its
    sequence over 'model' (its placement, recorded by the step); for
    ``"residual"``, whether the decoder's residual stream does (the tokens,
    after pixtral's patches, split by the same guard)."""
    layout = _LAYOUT[-1] if _LAYOUT else None
    return layout is not None and name in layout.get("seq", ())


def token_sum(x: torch.Tensor, seq: bool) -> torch.Tensor:
    """``x`` summed over every rank holding a share of the tokens: the batch
    axes, and 'model' where the sequence is split over it (``seq``); the
    gradient flows back to this rank's own share."""
    axes = batch_axes() + (("model",) if seq and model_size() > 1 else ())
    return _SumIdentityGrad.apply(x, axes) if axes else x


def batch_index() -> int:
    """This rank's index among the ranks the batch is split over."""
    return _index(batch_axes())


def batch_gather(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """The ranks' batch shards of ``x`` (no gradient) gathered along ``dim``
    over the batch axes, in the batch's order."""
    axes = batch_axes()
    return _gather_along(x.detach(), dim, axes) if axes else x


def reduce_over(x: torch.Tensor, axes, op: str = "sum") -> torch.Tensor:
    """The elementwise sum (``op="max"``: the max) of ``x`` over the mesh
    axes ``axes``, no gradient; ``x`` itself for no axes."""
    import torch.distributed as dist

    x = x.detach()
    if not axes:
        return x
    return _all_reduce(x, axes, dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM)


def model_max(x: torch.Tensor) -> torch.Tensor:
    """The elementwise max over ``model`` (no gradient)."""
    return reduce_over(x, ("model",) if model_size() > 1 else (), "max")


def kv_seq_axes(leaf: str) -> Tuple[str, ...]:
    """The mesh axes (of size > 1) the decode cache leaf ``leaf`` is split
    over along its sequence: its placement's, as the step's layout records
    it; () outside a step."""
    layout = _LAYOUT[-1] if _LAYOUT else None
    return tuple((layout or {}).get("kv_seq", {}).get(leaf, ()))


def _index(axes) -> int:
    """This rank's index along the mesh axes ``axes`` (the first axis
    major); 0 for no axes."""
    index = 0
    for a in axes:
        mesh = active()[0]
        index = index * mesh_axis_sizes(mesh)[a] + mesh.get_local_rank(a)
    return index


def kv_seq_offset(local_len: int, axes: Tuple[str, ...]) -> int:
    """The global position of this rank's first cache entry, for a slice of
    ``local_len`` positions split over ``axes``: its index along them (the
    first axis major) times ``local_len``; 0 for no axes."""
    return _index(axes) * local_len


def gather_leaf(x, axes: Tuple[str, ...]):
    """All-gather an FSDP-sharded leaf at its use site (identity unsharded).

    Inside a context ``x`` must be a DTensor.  It is redistributed to its
    TP-only layout (on a mesh whose axes are all of size 1 that is its own
    layout, and nothing is copied) and returned as this rank's local
    tensor, whose gradient is ``Partial`` on the axes the batch is split
    over."""
    ctx = active()
    if ctx is None:
        return x
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    if not isinstance(x, DTensor):
        raise TypeError(f"inside a sharding context a parameter must be a DTensor, got a "
                        f"{type(x).__name__} of shape {tuple(x.shape)} (axes {axes})")
    mesh, rules = ctx
    target = placements(pspec(axes, x.shape, _tp_only_rules(rules), mesh), mesh)
    live_batch = set(batch_axes())
    grad = [p if isinstance(p, Shard) else Partial() if name in live_batch else Replicate()
            for name, p in zip(axis_names(mesh), target)]
    return x.redistribute(mesh, target).to_local(grad_placements=grad)


def gather(params: Any, schema: Any) -> Any:
    """``gather_leaf`` over a param subtree, axes taken from its schema."""
    if active() is None:
        return params
    from repro_torch.models.layers import tree_map  # models import this module

    return tree_map(lambda x, s: gather_leaf(x, s.axes), params, schema)


def constrain(x, axes: Tuple[Optional[str], ...]):
    """The reference's sharding constraint: the identity, since local
    compute already holds this rank's batch/token shard."""
    return x

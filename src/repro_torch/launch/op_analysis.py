"""Operation analysis of one step: FLOPs, bytes written, collective traffic
and peak memory, counted as the step runs.

The counterpart of ``repro/launch/hlo_analysis.py``.  The reference parses
the compiled HLO text; the port compiles nothing, so it counts the
operators the step dispatches, one call under ``torch.utils.flop_counter``
and a dispatch mode of its own:

  - FLOPs from ``FlopCounterMode``: the matrix products, convolutions and
    library attention it knows, plus the port's kernels, whose registered
    operators carry their own formulas (``kernels/flash_attention.py``,
    ``ssd_scan.py``, ``wkv6.py``: the counts of ``PERF.md``'s bound column);
  - bytes written: the output bytes of every operator that is not a view
    or an alias of its input (an in-place operator writes its output, so it
    counts), the local shard of a DTensor;
  - collective operand bytes per kind, the reference's kinds:
    ``all-gather``, ``all-reduce``, ``reduce-scatter``, ``all-to-all`` and
    ``collective-permute`` (send/recv and broadcast), from both the
    functional collectives (``_c10d_functional.*``, DTensor's
    redistribution) and the in-place ``c10d.*_`` operators
    ``torch.distributed`` issues (``dist/fsdp.py``);
  - the peak of live device memory: the bytes of every storage off the
    CPU alive at once, the arguments' included, each as the block PyTorch's
    CUDA caching allocator gives it (``_LargePool``: rounded up to 512
    bytes; a request over 1 MiB takes the smallest free block that fits,
    or a new segment, and holds the whole block where splitting it would
    leave 1 MiB or less), so the peak compares with
    ``torch.cuda.max_memory_allocated`` of a step that starts with no free
    cached segment (the arguments count at their sizes: their blocks were
    made before the step).  The functional collectives' results hold no
    memory of their own: an
    ``AsyncCollectiveTensor`` counts as the tensor it wraps, and the
    outputs of ``_wrap_tensor_autograd`` and ``wait_tensor`` (on real
    tensors that wrapper and the input itself; on fake ones fresh tensors)
    count as their input, which lives as long as they do;
  - ``diag``: operator, collective and kernel-operator counts.

Shapes are those each rank holds, so every number is per device and per
call.  Eager execution runs every layer, so the reference's trip-count
multiplier for scanned layers has nothing to do here: each layer's
operators are dispatched, and counted, once per execution (a rematerialised
layer's forward twice).  The same counters run on fake tensors (the
dry-run, ``launch/dryrun.py``) and on real ones (``chip_smoke.py`` phase
13b), so the two counts compare operator for operator.
"""
from __future__ import annotations

import bisect
import weakref
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List

import torch
from torch.distributed._functional_collectives import AsyncCollectiveTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

BLOCK = 512  # the CUDA caching allocator's rounding of every block
MIB = 1 << 20  # requests up to this size take the small pool's exact blocks

# collective operators -> (the reference's kind, index of the operand argument)
_COLLECTIVES = {
    "all_gather_into_tensor": ("all-gather", 0),
    "all_gather_into_tensor_coalesced": ("all-gather", 0),
    "allgather_": ("all-gather", 1),
    "allgather_coalesced_": ("all-gather", 1),
    "allgather_into_tensor_coalesced_": ("all-gather", 1),
    "_allgather_base_": ("all-gather", 1),
    "all_reduce": ("all-reduce", 0),
    "all_reduce_coalesced": ("all-reduce", 0),
    "allreduce_": ("all-reduce", 0),
    "allreduce_coalesced_": ("all-reduce", 0),
    "reduce_scatter_tensor": ("reduce-scatter", 0),
    "reduce_scatter_tensor_coalesced": ("reduce-scatter", 0),
    "reduce_scatter_": ("reduce-scatter", 1),
    "_reduce_scatter_base_": ("reduce-scatter", 1),
    "reduce_scatter_tensor_coalesced_": ("reduce-scatter", 1),
    "all_to_all_single": ("all-to-all", 0),
    "alltoall_": ("all-to-all", 1),
    "alltoall_base_": ("all-to-all", 1),
    "send": ("collective-permute", 0),
    "recv_": ("collective-permute", 0),
    "broadcast": ("collective-permute", 0),
    "broadcast_": ("collective-permute", 0),
}
_COLLECTIVE_NAMESPACES = ("c10d", "_c10d_functional", "c10d_functional")
# functional-collective operators whose output is its input's memory
_WRAPS_INPUT = ("_wrap_tensor_autograd", "wait_tensor")


@dataclass
class OpCosts:
    """What one call dispatched, per device."""

    flops: int = 0
    flops_by_op: Dict[str, int] = field(default_factory=dict)
    bytes_written: int = 0
    collectives: Dict[str, int] = field(default_factory=lambda: defaultdict(int))
    peak_bytes: int = 0
    argument_bytes: List[int] = field(default_factory=list)  # each argument's, exact
    output_bytes: int = 0  # the result's storages off the CPU that no argument holds
    diag: Dict[str, int] = field(default_factory=lambda: defaultdict(int))
    out: Any = None  # the call's result

    @property
    def collective_bytes(self) -> int:
        return int(sum(self.collectives.values()))


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard (what this rank holds), the tensor an
    ``AsyncCollectiveTensor`` wraps, else ``t``."""
    if isinstance(t, AsyncCollectiveTensor):
        return t.elem
    inner = getattr(t, "_local_tensor", None)
    return inner if isinstance(inner, torch.Tensor) else t


def _tensors(tree) -> List[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    return []


def _nbytes(t: torch.Tensor) -> int:
    t = _local(t)
    return t.numel() * t.element_size()


class _LargePool:
    """The CUDA caching allocator's large pool (requests over 1 MiB) on one
    stream, as it hands out and takes back blocks: the smallest free block
    that fits, else a new segment (20 MiB below 10 MiB, else the request
    rounded up to 2 MiB); the rest split off as a free block only where it
    exceeds 1 MiB, else held whole; a freed block merged with its free
    neighbours in its segment.  Blocks are ``(segment, offset)``."""

    def __init__(self):
        self.free: List[tuple] = []  # sorted (size, segment, offset)
        self.blocks: List[Dict[int, list]] = []  # per segment: offset -> [size, in use]

    def malloc(self, n: int) -> tuple:
        """-> (segment, offset, the block's bytes) for a request of ``n``
        bytes (a multiple of ``BLOCK``, over 1 MiB)."""
        i = bisect.bisect_left(self.free, (n, -1, -1))
        if i < len(self.free):
            size, seg, off = self.free.pop(i)
        else:
            size = 20 * MIB if n < 10 * MIB else -(-n // (2 * MIB)) * (2 * MIB)
            seg, off = len(self.blocks), 0
            self.blocks.append({})
        if size - n > MIB:
            self.blocks[seg][off + n] = [size - n, False]
            bisect.insort(self.free, (size - n, seg, off + n))
            size = n
        self.blocks[seg][off] = [size, True]
        return seg, off, size

    def release(self, seg: int, off: int) -> None:
        blocks = self.blocks[seg]
        size = blocks[off][0]
        nxt = blocks.get(off + size)
        if nxt is not None and not nxt[1]:
            self.free.remove((nxt[0], seg, off + size))
            del blocks[off + size]
            size += nxt[0]
        prev = next((o for o, b in blocks.items() if o + b[0] == off and not b[1]), None)
        if prev is not None:
            self.free.remove((blocks[prev][0], seg, prev))
            del blocks[off]
            size += blocks[prev][0]
            off = prev
        blocks[off] = [size, False]
        bisect.insort(self.free, (size, seg, off))


def _writes(func, i: int) -> bool:
    """Whether output ``i`` of ``func`` is written by it: a fresh output,
    or one that aliases an input and is written (in place, ``out=``);
    not a view or another alias."""
    returns = func._schema.returns
    alias = returns[min(i, len(returns) - 1)].alias_info if returns else None
    return alias is None or alias.is_write


class _Counter(TorchDispatchMode):
    """Bytes written, collectives, live storages and their peak."""

    def __init__(self, costs: OpCosts):
        super().__init__()
        self.costs = costs
        self.live: Dict[int, int] = {}  # storage key -> rounded bytes
        self.refs: Dict[int, weakref.ref] = {}
        self.alias: Dict[int, int] = {}  # storage key -> the key whose memory it is
        self.pool = _LargePool()
        self.held: Dict[int, tuple] = {}  # storage key -> its large-pool block
        self.current = 0

    def track(self, t: torch.Tensor, pooled: bool = True) -> None:
        """Count ``t``'s storage as live; ``pooled``: a block the step asks
        the allocator for (an argument's block was made before the step, by
        a history the counter does not see, so it counts at its size)."""
        t = _local(t)
        if t.device.type == "cpu":  # host memory (a step counter), not the device's
            return
        st = t.untyped_storage()
        key = self.alias.get(st._cdata, st._cdata)
        if key in self.live:
            return
        n = -(-st.nbytes() // BLOCK) * BLOCK
        if pooled and n > MIB:
            seg, off, n = self.pool.malloc(n)
            self.held[key] = (seg, off)
        self.live[key] = n
        self.refs[key] = weakref.ref(st, lambda _, k=key: self._free(k))
        self.current += n
        self.costs.peak_bytes = max(self.costs.peak_bytes, self.current)

    def _free(self, key: int) -> None:
        self.current -= self.live.pop(key, 0)
        self.refs.pop(key, None)
        if key in self.held:
            self.pool.release(*self.held.pop(key))

    def same_memory(self, out: torch.Tensor, inp: torch.Tensor) -> None:
        """``out``'s storage is ``inp``'s memory: views of it count as
        ``inp``, which lives while it does."""
        so, si = _local(out).untyped_storage(), _local(inp).untyped_storage()
        if so._cdata != si._cdata:
            self.alias[so._cdata] = self.alias.get(si._cdata, si._cdata)
            weakref.finalize(so, lambda key, _inp: self.alias.pop(key, None), so._cdata, inp)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        costs = self.costs
        costs.diag["n_ops"] += 1
        ns, name = func.namespace, func._schema.name.split("::")[-1]
        if ns in _COLLECTIVE_NAMESPACES and name in _WRAPS_INPUT:
            self.same_memory(out, args[0])
            return out
        if ns == "repro_torch":
            costs.diag["n_kernel_ops"] += 1
        if ns in _COLLECTIVE_NAMESPACES and name in _COLLECTIVES:
            kind, arg = _COLLECTIVES[name]
            operand = args[arg] if len(args) > arg else None
            costs.collectives[kind] += sum(_nbytes(t) for t in _tensors(operand))
            costs.diag["n_collective_ops"] += 1
        outs = out if isinstance(out, (tuple, list)) else (out,)
        for i, t in enumerate(outs):
            if isinstance(t, torch.Tensor):
                if _writes(func, i):
                    costs.bytes_written += _nbytes(t)
                self.track(t)
        return out

    def close(self) -> None:
        self.refs.clear()  # later frees are no longer this call's


def analyze_step(fn: Callable, *args) -> OpCosts:
    """Run ``fn(*args)`` once under the counters and return its costs;
    ``OpCosts.out`` is the call's result.  The storages of ``args`` count
    as live from the start; ``argument_bytes`` are the bytes each argument
    holds (a DTensor's local shard, host scalars included) and
    ``output_bytes`` those of the result's device storages that are not an
    argument's (an update in place writes into its argument)."""
    costs = OpCosts(argument_bytes=[sum(_nbytes(t) for t in _tensors(a)) for a in args])
    counter = _Counter(costs)
    for t in _tensors(args):
        counter.track(t, pooled=False)
    held = {_local(t).untyped_storage()._cdata for t in _tensors(args)}
    flop_counter = FlopCounterMode(display=False)
    try:
        with flop_counter, counter:
            costs.out = fn(*args)
    finally:
        counter.close()
    costs.output_bytes = sum(
        _nbytes(t) for t in _tensors(costs.out)
        if _local(t).device.type != "cpu" and _local(t).untyped_storage()._cdata not in held)
    costs.flops = int(flop_counter.get_total_flops())
    costs.flops_by_op = {str(op): int(n) for op, n in
                         flop_counter.get_flop_counts().get("Global", {}).items()}
    costs.collectives = dict(costs.collectives)
    costs.diag = dict(costs.diag)
    return costs

"""The bf16 WKV-6 kernels' share of their roofline over the traced steps:
the sum of each call's least time (the larger of its FLOPs over the bf16
peak and its bytes over the memory bandwidth, ``bench/counts.py``, at the
cell's shapes) over the device time of every kernel of those calls, in
percent.  Calls are counted from the trace: one ``wkv6_chunk_out_kernel``
a forward, one ``wkv6_chunk_walk_kernel`` a backward."""
from bench.counts import least_seconds, wkv6_bytes, wkv6_chunk_flops


def read(run):
    t = run.trace
    if t is None:
        return None
    spent = sum(s for n, s in t.ops if "wkv6_" in n)
    fwd = sum(1 for n, _ in t.ops if "wkv6_chunk_out_kernel" in n)
    bwd = sum(1 for n, _ in t.ops if "wkv6_chunk_walk_kernel" in n)
    if spent <= 0 or fwd + bwd == 0:
        return None
    m, tr = run.cell.config["model"], run.cell.traffic
    shape = (tr["batch"], tr["seq"], m["num_heads"], m["d_head"])
    b_fwd, b_bwd = wkv6_bytes(*shape)
    least = (fwd * least_seconds(wkv6_chunk_flops(*shape), b_fwd)
             + bwd * least_seconds(wkv6_chunk_flops(*shape, backward=True), b_bwd))
    return 100.0 * least / spent

"""The bf16 flash attention kernels' share of their roofline over the
traced steps: the sum of each call's least time (the larger of its FLOPs,
over the causal pairs, over the bf16 peak and its bytes over the memory
bandwidth, ``bench/counts.py``, at the cell's shapes) over the device time
of ``flash_fwd_sm90`` and the two backward kernels, in percent.  Calls are
counted from the trace: one ``flash_fwd_sm90`` a forward, one
``flash_bwd_dq_sm90`` a backward."""
from bench.counts import flash_bytes, flash_flops, least_seconds


def read(run):
    t = run.trace
    if t is None:
        return None
    spent = sum(s for n, s in t.ops if "flash_fwd" in n or "flash_bwd" in n)
    fwd = sum(1 for n, _ in t.ops if "flash_fwd_sm90" in n)
    bwd = sum(1 for n, _ in t.ops if "flash_bwd_dq_sm90" in n)
    if spent <= 0 or fwd + bwd == 0:
        return None
    m, tr = run.cell.config["model"], run.cell.traffic
    B, S = tr["batch"], tr["seq"]
    H, KV, d, win = m["num_heads"], m["num_kv_heads"], m["d_head"], m.get("sliding_window", 0)
    b_fwd, b_bwd = flash_bytes(B, S, S, H, KV, d)
    least = (fwd * least_seconds(flash_flops(B, S, S, H, d, True, win), b_fwd)
             + bwd * least_seconds(flash_flops(B, S, S, H, d, True, win, backward=True), b_bwd))
    return 100.0 * least / spent

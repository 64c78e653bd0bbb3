"""Model FLOPs of one forward pass of the RWKV-6 language model (the
configuration's ``model`` block) over ``batch`` x ``seq`` tokens: its matrix
products (the r, k, v, g and output projections, the decay LoRA, the
channel mix and the head, 2 a multiply-add) and the WKV-6 read-out
``r_t . S`` (2 N^2 a token and head), as the plain reference's exact form
computes them.  Remat recompute is not counted.  A training step is three
times this."""


def forward_flops(m: dict, batch: int, seq: int) -> int:
    T = batch * seq
    D, F, L = m["d_model"], m["d_ff"], m["num_layers"]
    H, N, V = m["num_heads"], m["d_head"], m["padded_vocab"]
    decay_rank = 64
    per_layer = 4 * D * H * N + H * N * D + 2 * D * decay_rank + 2 * D * F + D * D
    return 2 * T * (L * per_layer + D * V) + L * 2 * T * H * N * N

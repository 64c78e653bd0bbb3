"""Model FLOPs of one forward pass of the Qwen2 decoder (the
configuration's ``model`` block) over ``batch`` x ``seq`` tokens: its matrix
products (q, k, v, o, the SwiGLU MLP and the tied head over the padded
vocabulary, 2 a multiply-add) and the attention's score and value products
over the causal pairs, each pair once, as the plain reference's exact form
computes them.  Remat recompute is not counted.  A training step is three
times this."""
from bench.counts import attention_pairs


def forward_flops(m: dict, batch: int, seq: int) -> int:
    T = batch * seq
    D, F, L = m["d_model"], m["d_ff"], m["num_layers"]
    H, KV, hd, V = m["num_heads"], m["num_kv_heads"], m["d_head"], m["padded_vocab"]
    per_layer = 2 * D * H * hd + 2 * D * KV * hd + 3 * D * F
    attn = 4 * batch * H * hd * attention_pairs(seq, seq, True, m.get("sliding_window", 0))
    return 2 * T * (L * per_layer + D * V) + L * attn

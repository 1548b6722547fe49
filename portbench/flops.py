"""Model FLOPs of one training step, counted from a configuration's shapes.

6 x the matmul parameters each position passes through x the positions
(forward, and the backward's two products), plus the causal half of
attention's score and value products (2 B H D T^2 forward, x 3). The
blocks see every position, the conditioning prefix too; the unembedding
sees the token positions; the prefix projection sees the prefix frames
and needs no gradient of its input (x 4). The embedding lookup is no matmul, and recomputation under rematerialisation is not counted.
"""

from __future__ import annotations

H100_BF16_PEAK = 989e12      # dense bf16 FLOP/s of one H100 SXM


def train_step_flops(m: dict, batch: int, seq: int) -> float:
    d, L = m["d_model"], m["num_layers"]
    H, KV, D = m["num_heads"], m["num_kv_heads"], m["head_dim"]
    F = m.get("frontend_len", 0)
    T = seq + F
    attn = d * H * D + 2 * d * KV * D + H * D * d
    ffn = 3 * d * m["d_ff"]
    flops = 6 * batch * T * L * (attn + ffn)
    flops += 6 * batch * seq * d * m["vocab_size"]
    flops += 4 * batch * F * m.get("frontend_dim", 0) * d
    flops += 6 * batch * L * H * D * T * T
    return float(flops)

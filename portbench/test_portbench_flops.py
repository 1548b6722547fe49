"""The model-FLOPs count against FlopCounterMode on the reference's own
forward and backward, at a small size."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.flops import train_step_flops
from portbench.reference import model as ref

DENSE = {"num_layers": 2, "d_model": 32, "num_heads": 4, "num_kv_heads": 2,
         "head_dim": 8, "d_ff": 48, "vocab_size": 40, "act": "gelu",
         "frontend_dim": 12, "frontend_len": 3, "norm_eps": 1e-6,
         "rope_theta": 10000.0}
MHA = {**DENSE, "num_kv_heads": 4, "frontend_dim": 0, "frontend_len": 0}
DEEP = {**DENSE, "num_layers": 3, "num_heads": 2, "num_kv_heads": 1,
        "head_dim": 16, "frontend_len": 5}


def _params(m):
    g = torch.Generator().manual_seed(0)
    d, L, H, KV, D = (m[k] for k in ("d_model", "num_layers", "num_heads",
                                     "num_kv_heads", "head_dim"))
    shapes = {"embed": (m["vocab_size"], d), "head": (d, m["vocab_size"]),
              "final_norm/scale": (d,), "blocks/b0_attn/wq": (L, d, H * D),
              "blocks/b0_attn/wk": (L, d, KV * D),
              "blocks/b0_attn/wv": (L, d, KV * D),
              "blocks/b0_attn/wo": (L, H * D, d),
              "blocks/b0_attn/norm1/scale": (L, d),
              "blocks/b0_attn/norm2/scale": (L, d)}
    if m.get("frontend_len"):
        shapes["frontend_proj"] = (m["frontend_dim"], d)
    f = m["d_ff"]
    shapes.update({"blocks/b0_attn/mlp/wg": (L, d, f),
                   "blocks/b0_attn/mlp/wu": (L, d, f),
                   "blocks/b0_attn/mlp/wd": (L, f, d)})
    return {k: torch.randn(s, generator=g) * 0.2 for k, s in shapes.items()}


@pytest.mark.parametrize("m", [DENSE, MHA, DEEP],
                         ids=["dense", "mha", "deep"])
def test_count_matches_the_counter(m):
    B, S = 3, 7
    g = torch.Generator().manual_seed(1)
    ids = torch.randint(0, m["vocab_size"], (B, S + 1), generator=g)
    batch = {"tokens": ids[:, :-1], "labels": ids[:, 1:]}
    F = m.get("frontend_len", 0)
    if F:
        batch["frontend_embeds"] = torch.randn(B, F, m["frontend_dim"],
                                               generator=g)
    p = _params(m)
    counter = FlopCounterMode(display=False)
    with counter:
        ref.loss_and_grads(p, m, batch, rows=B)
    counted = counter.get_total_flops()
    T = S + F
    # the reference scores every (query, key) pair and masks half of them
    masked = 6 * B * m["num_layers"] * m["num_heads"] * m["head_dim"] * T * T
    assert counted == train_step_flops(m, B, S) + masked


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.randn(4096, generator=torch.Generator().manual_seed(3))
    y = ref.round_tf32(x)
    assert not (y.view(torch.int32) & 0x1FFF).any()
    assert ((y - x).abs() <= x.abs() * 2.0 ** -11).all()
    assert (y != x).any()
    half = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -11])
    assert ref.round_tf32(half).tolist() == [1.0, 1.0 + 4 * 2.0 ** -11]

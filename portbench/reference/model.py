"""Decoder LM in plain float32 PyTorch: forward, loss and gradients.

The blocks are pre-norm: RMSNorm, causal softmax attention (grouped KV
heads, optional RMSNorm of each query and key head, rotary positions on
split halves), then RMSNorm and a gated MLP. An optional prefix of
conditioning frames is projected to the model width and put before the
tokens; the loss is the mean next-token nll of the token positions.

``precision="tf32"`` is the control: every matmul operand is rounded to
TF32 (10 explicit mantissa bits, to nearest, ties to even), as the
card's TF32 tensor cores take float32 operands, and the products are
accumulated in float32 (the gradient passes straight through the
rounding); everything else stays float32. The rounding is done on the
bits, so the control reads the same on the CPU.

Parameters are a flat dict of float32 tensors keyed as the checkpoint
keys them under ``params/``: ``embed``, ``head``, ``frontend_proj``,
``final_norm/scale`` and ``blocks/b0_attn/<leaf>`` stacked over layers.
The batch is processed in blocks of rows, so that float32 logits of long
sequences fit.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

BLOCK = "blocks/b0_attn/"


def exact_matmuls() -> None:
    """float32 matmuls in float32 (no TF32 on the card)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def round_tf32(x):
    """float32 ``x`` with its mantissa rounded to TF32's 10 bits."""
    b = x.contiguous().view(torch.int32)
    b = (b + 0xFFF + ((b >> 13) & 1)) & ~0x1FFF
    return b.view(torch.float32)


class _RoundTf32(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return round_tf32(x)

    @staticmethod
    def backward(ctx, g):
        return g


def _op(x, precision: str):
    return _RoundTf32.apply(x) if precision == "tf32" else x


def _mm(a, b, precision: str):
    return _op(a, precision) @ _op(b, precision)


def _rmsnorm(x, scale, eps: float):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def _act(name: str):
    if name == "gelu":
        return lambda t: F.gelu(t, approximate="tanh")
    if name == "silu":
        return F.silu
    raise ValueError(name)


def _rope(x, theta: float):
    """x (n, T, H, D): rotary positions 0..T-1 on the two halves of D."""
    T, D = x.shape[1], x.shape[-1]
    half = D // 2
    freqs = 1.0 / theta ** (torch.arange(half, dtype=torch.float64,
                                         device=x.device) / half)
    ang = torch.arange(T, dtype=torch.float64, device=x.device)[:, None] \
        * freqs
    cos = torch.cos(ang).float()[None, :, None, :]
    sin = torch.sin(ang).float()[None, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attention(p, l: int, h, m: dict, precision: str):
    n, T, _ = h.shape
    H, KV, D = m["num_heads"], m["num_kv_heads"], m["head_dim"]
    q = _mm(h, p[BLOCK + "wq"][l], precision).reshape(n, T, H, D)
    k = _mm(h, p[BLOCK + "wk"][l], precision).reshape(n, T, KV, D)
    v = _mm(h, p[BLOCK + "wv"][l], precision).reshape(n, T, KV, D)
    if m.get("qk_norm"):
        q = _rmsnorm(q, p[BLOCK + "q_norm/scale"][l], m["norm_eps"])
        k = _rmsnorm(k, p[BLOCK + "k_norm/scale"][l], m["norm_eps"])
    q = _rope(q, m["rope_theta"])
    k = _rope(k, m["rope_theta"])
    if KV != H:
        k = k.repeat_interleave(H // KV, dim=2)
        v = v.repeat_interleave(H // KV, dim=2)
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))        # (n, H, T, D)
    logits = _mm(q, k.transpose(-1, -2), precision) / math.sqrt(D)
    causal = torch.ones(T, T, dtype=torch.bool, device=h.device).tril()
    w = torch.softmax(logits.masked_fill(~causal, float("-inf")), dim=-1)
    out = _mm(w, v, precision).transpose(1, 2).reshape(n, T, H * D)
    return _mm(out, p[BLOCK + "wo"][l], precision)


def _mlp(p, l: int, h, m: dict, precision: str):
    a = _act(m["act"])
    g = _mm(h, p[BLOCK + "mlp/wg"][l], precision)
    u = _mm(h, p[BLOCK + "mlp/wu"][l], precision)
    return _mm(a(g) * u, p[BLOCK + "mlp/wd"][l], precision)


def _forward_rows(p, m: dict, tokens, labels, frontend, precision: str):
    """One block of rows -> its summed nll."""
    x = p["embed"][tokens.long()]
    if frontend is not None:
        x = torch.cat([_mm(frontend, p["frontend_proj"], precision), x], 1)
    for l in range(m["num_layers"]):
        x = x + _attention(p, l, _rmsnorm(x, p[BLOCK + "norm1/scale"][l],
                                          m["norm_eps"]), m, precision)
        x = x + _mlp(p, l, _rmsnorm(x, p[BLOCK + "norm2/scale"][l],
                                    m["norm_eps"]), m, precision)
    S = labels.shape[1]
    h = _rmsnorm(x[:, -S:], p["final_norm/scale"], m["norm_eps"])
    logits = _mm(h, p["head"], precision)
    nll = torch.logsumexp(logits, -1) \
        - logits.gather(-1, labels.long()[..., None])[..., 0]
    return nll.sum()


def loss_and_grads(params: dict, m: dict, batch: dict, *, rows: int,
                   precision: str = "fp32"):
    """(loss, {key: float32 grad}) of float32 ``params`` on ``batch``
    (tokens, labels, optional frontend_embeds), ``rows`` sequences at a
    time."""
    tokens, labels = batch["tokens"], batch["labels"]
    frontend = batch.get("frontend_embeds")
    B, S = labels.shape
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    loss = torch.zeros((), dtype=torch.float32, device=tokens.device)
    for a in range(0, B, rows):
        sl = slice(a, min(a + rows, B))
        fr = None if frontend is None else frontend[sl].float()
        part = _forward_rows(leaves, m, tokens[sl], labels[sl], fr,
                             precision) / (B * S)
        part.backward()
        loss += part.detach()
    grads = {k: (v.grad if v.grad is not None else torch.zeros_like(v))
             for k, v in leaves.items()}
    return loss, grads

"""Functional layers over plain dict trees of tensors (the JAX package's
parameter layout, key for key).

Counterpart of ``repro/models/layers.py`` for the blocks this package runs:
RMSNorm, rotary embeddings, GQA attention (qk-norm, qkv-bias, logit softcap,
sliding window, KV cache), the gated MLP, and the RG-LRU block, whose
recurrence on the sequence path is the ``kernels.rglru`` scan and in decode
one step ``a * h + bx``. Matmuls run in ``cfg.dtype`` with float32 softmax,
normalisation and recurrence, as in the reference. Attention is written out
(einsum + float32 softmax), not a fused attention call, so that its numbers
follow the reference's.

Decode caches are updated IN PLACE: a block given a cache writes the new
key/value (or recurrent state) into it, advances its ``pos``, and returns
the same dict — the reference returns new arrays instead.

Not here yet: MoE, mLSTM and sLSTM blocks (ROADMAP queue A, "MoE, mLSTM,
sLSTM and frontend blocks").
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..kernels.rglru import rglru_scan
from .config import ModelConfig

BLOCKS_SLICE = "ROADMAP queue A4 (MoE, mLSTM, sLSTM and frontend blocks)"

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def dense_init(gen, shape, scale: float | None = None, *,
               device="cpu") -> torch.Tensor:
    """N(0, 1) * scale in float32; scale defaults to 1/sqrt(shape[0]) (the
    fan-in of the unstacked leaf). On the meta device only the shape."""
    scale = scale if scale is not None else 1.0 / math.sqrt(shape[0])
    out = torch.empty(shape, dtype=torch.float32, device=device)
    if out.device.type == "meta":
        return out
    return out.normal_(generator=gen).mul_(scale)


def act_fn(name: str):
    # jax.nn.gelu defaults to the tanh approximation
    return {"silu": F.silu,
            "gelu": lambda x: F.gelu(x, approximate="tanh")}[name]


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------

def rmsnorm_init(cfg: ModelConfig, dim: int | None = None, *, device="cpu"):
    return {"scale": torch.ones((dim or cfg.d_model,), dtype=torch.float32,
                                device=device)}


def rmsnorm(params, x, eps: float = 1e-6):
    dt = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * params["scale"]).to(dt)


# ---------------------------------------------------------------------------
# Rotary position embedding
# ---------------------------------------------------------------------------

def rope(x, positions, theta: float):
    """x: (..., S, H, D); positions: (..., S). Half-split halves.

    The frequencies and the cos/sin of the float32 angles are evaluated in
    float64 and rounded to float32: the correctly rounded values, which the
    reference's float32 functions give to within an ulp, whatever this
    device's float32 kernels for them do with angles of up to S radians."""
    d = x.shape[-1]
    half = d // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    freqs = (1.0 / (theta ** exps.double())).float()
    angles = positions[..., :, None].float() * freqs        # (..., S, half)
    cos = torch.cos(angles.double()).float()[..., None, :]
    sin = torch.sin(angles.double()).float()[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (GQA + variants), with optional KV cache
# ---------------------------------------------------------------------------

def attention_init(gen, cfg: ModelConfig, *, device="cpu"):
    d, qd, kvd = cfg.d_model, cfg.q_dim, cfg.kv_dim
    p = {
        "wq": dense_init(gen, (d, qd), device=device),
        "wk": dense_init(gen, (d, kvd), device=device),
        "wv": dense_init(gen, (d, kvd), device=device),
        "wo": dense_init(gen, (qd, d), device=device),
        "norm1": rmsnorm_init(cfg, device=device),
        "norm2": rmsnorm_init(cfg, device=device),
    }
    if cfg.qkv_bias:
        for name, n in (("bq", qd), ("bk", kvd), ("bv", kvd)):
            p[name] = torch.zeros((n,), dtype=torch.float32, device=device)
    if cfg.qk_norm:
        p["q_norm"] = rmsnorm_init(cfg, cfg.head_dim, device=device)
        p["k_norm"] = rmsnorm_init(cfg, cfg.head_dim, device=device)
    return p


def _softcap(logits, cap: float):
    if cap > 0:
        logits = cap * torch.tanh(logits / cap)
    return logits


def attention_scores(q, k, v, mask, cfg: ModelConfig):
    """q: (B,Sq,H,D), k/v: (B,Skv,KV,D), mask (B|1,Sq,Skv) -> (B,Sq,H,D)
    in v's dtype. q and k meet in their promoted dtype, as jnp.einsum's do
    (gemma decode: a float32 query against the bf16 cache)."""
    B, Sq, H, D = q.shape
    KV = k.shape[2]
    G = H // KV
    ct = torch.promote_types(q.dtype, k.dtype)
    q = q.reshape(B, Sq, KV, G, D).to(ct)
    logits = torch.einsum("bqkgd,bskd->bkgqs", q, k.to(ct)).float()
    logits = logits / math.sqrt(D)
    logits = _softcap(logits, cfg.attn_softcap)
    logits = torch.where(mask[:, None, None, :, :], logits,
                         torch.tensor(-1e30, dtype=logits.dtype,
                                      device=logits.device))
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", w.to(v.dtype), v)
    return out.reshape(B, Sq, H, D)


def causal_mask(Sq: int, Skv: int, q_offset: int, window: int = 0,
                device="cpu"):
    """(1, Sq, Skv) bool; window > 0 limits lookback (local attention)."""
    qpos = q_offset + torch.arange(Sq, device=device)[:, None]
    kpos = torch.arange(Skv, device=device)[None, :]
    m = kpos <= qpos
    if window > 0:
        m &= kpos > qpos - window
    return m[None, :, :]


ATTN_CHUNK = 1024  # query-chunk size for memory-bounded attention


def chunked_attention(q, k, v, cfg: ModelConfig, window: int,
                      chunk: int = ATTN_CHUNK):
    """Causal attention with O(S·chunk) live logits: query chunks in turn."""
    B, S, H, D = q.shape
    if S <= chunk:
        return attention_scores(q, k, v,
                                causal_mask(S, S, 0, window, q.device), cfg)
    pad = (-S) % chunk
    if pad:
        q = F.pad(q, (0, 0, 0, 0, 0, pad))
    outs = [attention_scores(q[:, off:off + chunk], k, v,
                             causal_mask(chunk, S, off, window, q.device), cfg)
            for off in range(0, S + pad, chunk)]
    return torch.cat(outs, dim=1)[:, :S]


def attention_apply(params, x, cfg: ModelConfig, *, positions, local: bool,
                    cache=None):
    """Pre-norm attention block with residual -> (x, cache). cache:
    dict(k, v, pos) or None; given one, S == 1 (decode)."""
    h = rmsnorm(params["norm1"], x, cfg.norm_eps)
    B, S, _ = h.shape
    q = h @ params["wq"].to(h.dtype)
    k = h @ params["wk"].to(h.dtype)
    v = h @ params["wv"].to(h.dtype)
    if cfg.qkv_bias:
        q = q + params["bq"].to(h.dtype)
        k = k + params["bk"].to(h.dtype)
        v = v + params["bv"].to(h.dtype)
    q = q.reshape(B, S, cfg.num_heads, cfg.head_dim)
    k = k.reshape(B, S, cfg.num_kv_heads, cfg.head_dim)
    v = v.reshape(B, S, cfg.num_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = rmsnorm(params["q_norm"], q, cfg.norm_eps)
        k = rmsnorm(params["k_norm"], k, cfg.norm_eps)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    window = cfg.sliding_window if local else 0
    if cache is None:
        out = chunked_attention(q, k, v, cfg, window)
    else:
        # decode: write into the ring (window > 0) or linear buffer, attend
        # over it. Slot positions are analytic: ring slot s holds position
        # cur - ((cur - s) mod W), linear slot s holds position s.
        ck, cv, pos = cache["k"], cache["v"], cache["pos"]
        W = ck.shape[1]
        slot = pos % W if window > 0 else torch.clamp(pos, max=W - 1)
        slot = slot.reshape(1).long()
        ck.index_copy_(1, slot, k.to(ck.dtype))
        cv.index_copy_(1, slot, v.to(cv.dtype))
        slots = torch.arange(W, dtype=torch.int32, device=x.device)[None, :]
        cur = positions[:, :1]                                 # (B, 1)
        if window > 0:
            kpos = cur - torch.remainder(cur - slots, W)       # floor mod
        else:
            kpos = slots.expand(cur.shape[0], W)
        valid = (kpos >= 0) & (kpos <= cur)
        if window > 0:
            valid &= kpos > cur - window
        out = attention_scores(q, ck, cv, valid[:, None, :], cfg)
        pos.add_(1)
    # a bf16 cache under a float32 residual stream (gemma) promotes here
    out = out.reshape(B, S, cfg.q_dim).to(x.dtype) @ params["wo"].to(x.dtype)
    return x + out, cache


def attention_cache_init(cfg: ModelConfig, batch: int, max_len: int,
                         local: bool, *, device="cpu"):
    """k/v zeros of (batch, W, kv heads, head dim) in ``cfg.dtype``, W the
    window for local blocks (at most ``max_len``), else ``max_len``; an
    int32 scalar ``pos``."""
    W = min(cfg.sliding_window, max_len) if (local and cfg.sliding_window) \
        else max_len
    shape = (batch, W, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype_of(cfg), device=device),
            "v": torch.zeros(shape, dtype=dtype_of(cfg), device=device),
            "pos": torch.zeros((), dtype=torch.int32, device=device)}


# ---------------------------------------------------------------------------
# Gated MLP
# ---------------------------------------------------------------------------

def mlp_init(gen, cfg: ModelConfig, *, device="cpu"):
    d, f = cfg.d_model, cfg.d_ff
    return {"wg": dense_init(gen, (d, f), device=device),
            "wu": dense_init(gen, (d, f), device=device),
            "wd": dense_init(gen, (f, d), device=device)}


def mlp_apply(params, x, cfg: ModelConfig):
    a = act_fn(cfg.act)
    h = a(x @ params["wg"].to(x.dtype)) * (x @ params["wu"].to(x.dtype))
    return h @ params["wd"].to(x.dtype)


# ---------------------------------------------------------------------------
# Transformer block = attention + MLP
# ---------------------------------------------------------------------------

def transformer_block_init(gen, cfg: ModelConfig, *, device="cpu"):
    if cfg.is_moe:
        raise NotImplementedError(f"MoE blocks are not ported yet: "
                                  f"{BLOCKS_SLICE}")
    p = attention_init(gen, cfg, device=device)
    p["mlp"] = mlp_init(gen, cfg, device=device)
    return p


def transformer_block_apply(params, x, cfg: ModelConfig, *, positions,
                            local: bool, cache=None):
    if cfg.is_moe:
        raise NotImplementedError(f"MoE blocks are not ported yet: "
                                  f"{BLOCKS_SLICE}")
    x, new_cache = attention_apply(params, x, cfg, positions=positions,
                                   local=local, cache=cache)
    h = rmsnorm(params["norm2"], x, cfg.norm_eps)
    y = mlp_apply(params["mlp"], h, cfg)
    return x + y, new_cache, torch.zeros((), dtype=torch.float32,
                                         device=x.device)


# ---------------------------------------------------------------------------
# RG-LRU block (RecurrentGemma) — gated linear recurrence + gated MLP
# ---------------------------------------------------------------------------

def rglru_init(gen, cfg: ModelConfig, *, device="cpu"):
    d, r = cfg.d_model, cfg.lru_dim
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "wx": dense_init(gen, (d, r), device=device),
        "wgate": dense_init(gen, (d, r), device=device),
        "wout": dense_init(gen, (r, d), device=device),
        "a_param": torch.full((r,), 4.0, **f32),
        "w_input_gate": dense_init(gen, (d, r), 0.02, device=device),
        "b_input_gate": torch.zeros((r,), **f32),
        "w_a_gate": dense_init(gen, (d, r), 0.02, device=device),
        "b_a_gate": torch.zeros((r,), **f32),
        "norm1": rmsnorm_init(cfg, device=device),
        "norm2": rmsnorm_init(cfg, device=device),
        "mlp": mlp_init(gen, cfg, device=device),
    }


def _rglru_coeffs(params, u):
    """u: (..., d_model) normalised input -> (a, bx) float32 of lru_dim."""
    c = 8.0
    ig = torch.sigmoid((u @ params["w_input_gate"].to(u.dtype)).float()
                       + params["b_input_gate"])
    ag = torch.sigmoid((u @ params["w_a_gate"].to(u.dtype)).float()
                       + params["b_a_gate"])
    log_a = -c * ag * F.softplus(params["a_param"])
    a = torch.exp(log_a)
    x = (u @ params["wx"].to(u.dtype)).float()
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-8))
    return a, beta * ig * x


def rglru_apply(params, x, cfg: ModelConfig, *, positions=None, local=False,
                cache=None):
    """Sequence path: the recurrence runs as the ``rglru_scan`` kernel.
    Decode (cache dict(h)): one step from the cached state, written back."""
    h = rmsnorm(params["norm1"], x, cfg.norm_eps)
    a, bx = _rglru_coeffs(params, h)                  # (B,S,r) float32
    if cache is None:
        hh = rglru_scan(a, bx)
    else:
        hh = a * cache["h"] + bx                      # (B,1,r) float32
        cache["h"].copy_(hh)
    gate = F.silu(h @ params["wgate"].to(h.dtype))
    y = (hh.to(x.dtype) * gate) @ params["wout"].to(x.dtype)
    x = x + y
    h2 = rmsnorm(params["norm2"], x, cfg.norm_eps)
    x = x + mlp_apply(params["mlp"], h2, cfg)
    return x, cache


def rglru_cache_init(cfg: ModelConfig, batch: int, *, device="cpu"):
    return {"h": torch.zeros((batch, 1, cfg.lru_dim), dtype=torch.float32,
                             device=device)}

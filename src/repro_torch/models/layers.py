"""Functional layers over plain dict trees of tensors (the JAX package's
parameter layout, key for key).

Counterpart of ``repro/models/layers.py``, every block of it: RMSNorm,
rotary embeddings, GQA attention (qk-norm, qkv-bias, logit softcap, sliding
window, KV cache), the gated MLP, the capacity-based top-k MoE, the RG-LRU
block, whose recurrence on the sequence path is the ``kernels.rglru`` scan
and in decode one step ``a * h + bx``, and the xLSTM blocks (mLSTM: matrix
memory, quadratic or chunkwise on a sequence; sLSTM: scalar memory, a loop
over time). Matmuls run in ``cfg.dtype`` with float32 softmax,
normalisation and recurrence, as in the reference. Attention is written out
(einsum + float32 softmax), not a fused attention call, so that its numbers
follow the reference's.

Decode caches are updated IN PLACE: a block given a cache writes the new
key/value (or recurrent state) into it, advances its ``pos``, and returns
the same dict — the reference returns new arrays instead. Under a mesh the
cache leaves are DTensors laid out by ``launch.specs.serve_cache_layouts``
and every write lands in a rank's own blocks (``_kv_step`` at the cache's
placements, ``sharding.dtensor.write_``); where the K/V timeline is split
over a mesh dim, each rank attends over its own slots and the partial
softmaxes are merged by a log-sum-exp combine over that dim
(``_combined_scores``).

Under a mesh the params and activations are DTensors and the projections,
norms and MLPs follow DTensor's sharding propagation (PyTorch 2.11 and
2.13 alike). The rest runs on each rank's local blocks under ``local_map``
(``sharding.dtensor.on_local``), where a release lacks a strategy or the
work is independent per batch row, head or channel: the attention core
per (batch row, query head) or, where the query heads do not divide the
``model`` axis, per (batch row, query row) (``_attention_local``: each
``model`` rank its share, the KV heads its query heads read), the mLSTM
core (``_mlstm_block``: each ``model`` rank its heads, or its columns of
a head's value dim where more ranks than heads share the axis), the sLSTM
loop over time (``_slstm_local``: each ``model`` rank its d/tp channels
of the gates and the state, h gathered over ``model`` at each step), the
MoE router, dispatch, experts and combine (each rank's own tokens, their
slots counted over the whole batch, its own experts over its share of the
slots; ``moe_apply``),
``log_sigmoid`` (``pointwise``) and the RG-LRU scan (``kernels.rglru``).
Rope's angles join as a replicated DTensor (``like``). A block's output
joins the residual stream at the stream's layout (``_residual``: a
projection's pending sum reduced, forward and backward, as Megatron's
all-reduce).
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..kernels.rglru import rglru_scan
from ..sharding.dtensor import (axis_group, gather_last, group_blocks,
                                is_dtensor, keep_dims, like, mapped,
                                model_axis, on_local, placed, pointwise,
                                replicate, summed_over, write_)
from .config import ModelConfig

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
    freqs = like((1.0 / (theta ** exps.double())).float(), positions)
    angles = positions[..., :, None].float() * freqs        # (..., S, half)
    cos = like(torch.cos(angles.double()).float()[..., None, :], x)
    sin = like(torch.sin(angles.double()).float()[..., None, :], x)
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


def _masked_logits(q, k, mask, cfg: ModelConfig):
    """q: (B,Sq,H,D), k: (B,Skv,KV,D), mask (B|1,Sq,Skv) -> float32 logits
    (B,KV,H/KV,Sq,Skv), softcapped, -1e30 where masked. q and k meet in
    their promoted dtype, as jnp.einsum's do (gemma decode: a float32 query
    against the bf16 cache)."""
    B, Sq, H, D = q.shape
    KV = k.shape[2]
    ct = torch.promote_types(q.dtype, k.dtype)
    q = q.reshape(B, Sq, KV, H // KV, D).to(ct)
    logits = torch.einsum("bqkgd,bskd->bkgqs", q, k.to(ct)).float()
    logits = logits / math.sqrt(D)
    logits = _softcap(logits, cfg.attn_softcap)
    return torch.where(mask[:, None, None, :, :], logits,
                       torch.tensor(-1e30, dtype=logits.dtype,
                                    device=logits.device))


def attention_scores(q, k, v, mask, cfg: ModelConfig):
    """q: (B,Sq,H,D), k/v: (B,Skv,KV,D), mask (B|1,Sq,Skv) -> (B,Sq,H,D)
    in v's dtype."""
    w = torch.softmax(_masked_logits(q, k, mask, cfg), dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", w.to(v.dtype), v)
    return out.reshape(q.shape)


def _combined_scores(q, k, v, mask, cfg: ModelConfig, group):
    """``attention_scores`` over a timeline split across the ranks of
    ``group``, each holding its slots of k/v and their mask: the local
    logits' max is all-reduced (MAX), then the sums of the rescaled
    ``exp`` and of the rescaled outputs (SUM, one call), and the output is
    their quotient — the log-sum-exp combine of flash decoding. Masked
    slots (-1e30) weigh exp(-1e30 - max) = 0 on every rank, as in the
    softmax. Float32 throughout, cast to v's dtype at the end."""
    logits = _masked_logits(q, k, mask, cfg)             # (B,KV,G,Sq,Sl)
    top = logits.amax(dim=-1, keepdim=True)
    dist.all_reduce(top, op=dist.ReduceOp.MAX, group=group)
    e = torch.exp(logits - top)
    num = torch.einsum("bkgqs,bskd->bkgqd", e, v.float())
    parts = torch.cat([num, e.sum(dim=-1, keepdim=True)], dim=-1)
    dist.all_reduce(parts, group=group)
    out = parts[..., :-1] / parts[..., -1:]              # (B,KV,G,Sq,D)
    return out.permute(0, 3, 1, 2, 4).reshape(q.shape).to(v.dtype)


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
                      chunk: int = ATTN_CHUNK, offset: int = 0):
    """Causal attention with O(Sq·chunk) live logits: query chunks in turn.
    q holds the Sq query rows from position ``offset`` on, k/v the whole
    sequence from position 0 (``offset`` 0 and Sq = Skv: every row)."""
    Sq, Skv = q.shape[1], k.shape[1]
    if Sq <= chunk:
        return attention_scores(
            q, k, v, causal_mask(Sq, Skv, offset, window, q.device), cfg)
    pad = (-Sq) % chunk
    if pad:
        q = F.pad(q, (0, 0, 0, 0, 0, pad))
    outs = [attention_scores(q[:, off:off + chunk], k, v,
                             causal_mask(chunk, Skv, offset + off, window,
                                         q.device), cfg)
            for off in range(0, Sq + pad, chunk)]
    return torch.cat(outs, dim=1)[:, :Sq]


def split_heads(t, heads: int):
    """(B, S, heads·hd) -> (B, S, heads, hd). Under a mesh, a split of the
    last dim that does not fall on whole heads (qwen2.5's 2 heads over 4
    ranks) is made whole first: DTensor cannot view it as heads."""
    if is_dtensor(t):
        ways = 1
        for i, p in enumerate(t.placements):
            if p.is_shard() and p.dim % t.ndim == t.ndim - 1:
                ways *= t.device_mesh.size(i)
        if heads % ways:
            t = t.redistribute(t.device_mesh, keep_dims(t, (0, 1)))
    return t.reshape(*t.shape[:-1], heads, t.shape[-1] // heads)


def merge_heads(t):
    """(B, S, heads, hd) -> (B, S, heads·hd), the inverse of
    ``split_heads``. Under a mesh, where a backward will run, the merge
    runs on local blocks, so its backward views the grad into heads at the
    heads' own layout: DTensor may hand the merged grad back split over
    more ranks than there are heads (4 over a model axis of 16), which it
    cannot view as heads."""
    if not is_dtensor(t) or not torch.is_grad_enabled():
        return t.reshape(*t.shape[:-2], -1)
    lay = keep_dims(t, (0, 1, 2))
    return on_local(lambda u: u.reshape(*u.shape[:-2], -1), (t,), (lay,),
                    mapped(lay, {0: 0, 1: 1, 2: 2}))


def _residual(x, y):
    """``x + y``, a block's output ``y`` first taken to the residual
    stream's layout under a mesh (a projection's pending sum reduced, rows
    gathered), so the residual and its grad keep that layout (Megatron's
    all-reduce). DTensor would otherwise reduce-scatter the sum over d,
    and the matmuls after it, or their backward, meet a residual (or grad)
    split over d, which they multiply with a whole weight where that is
    the smaller operand."""
    if is_dtensor(y):
        # under local_map the grad of y is taken to that layout too (a
        # pending sum reduced); a bare redistribute would leave it pending
        lay = tuple(x.placements)
        y = on_local(lambda t: t, (y,), (lay,), lay)
    return x + y


def _by_rows(h, cfg: ModelConfig) -> bool:
    """Whether attention under a mesh splits its query ROWS over ``model``
    (the query heads do not divide it: recurrentgemma's 10 over 16), not
    its heads."""
    ax = model_axis(h)
    return ax is not None and cfg.num_heads % ax[1] != 0


def _linear(t, w, b=None):
    return t @ w if b is None else t @ w + b


def _rows_linear(t, w, b, lay):
    """``_linear`` on each rank's rows: ``t`` at ``lay`` (its leading dims
    split, its last whole), ``w`` and ``b`` made whole. Their grads are
    pending sums over ``lay``'s splits."""
    ts = (t, w) if b is None else (t, w, b)
    n = len(ts) - 1
    return on_local(_linear, ts, (lay,) + (replicate(w),) * n, lay,
                    (lay,) + (summed_over(lay),) * n)


def _attention_local(q, k, v, cfg: ModelConfig, window: int):
    """``chunked_attention`` of q (B,S,H,D) over k/v (B,S,KV,D). Under a
    mesh each ``model`` rank computes its share on local blocks, the batch
    split as q's:

    - the query heads divide the model axis: each rank keeps its H/tp
      query heads (``wq``'s column split leaves them so) and the KV heads
      they read, query head h reading KV head h // (H/KV). K/V split on
      whole heads alike are taken as they lie; otherwise they are made
      whole over ``model`` and each rank slices its KV heads (Megatron's
      KV replication; H/tp must divide H/KV or be a multiple of it). Their
      grads are pending sums over the ranks that share a KV head;
    - otherwise (``_by_rows``) q arrives split over its sequence, and each
      rank attends its S/tp query rows, the causal and sliding-window
      masks at their global positions, against whole K/V.

    The output takes q's layout. A layout that cannot be taken raises."""
    ax = model_axis(q)
    if ax is None:
        if is_dtensor(q):
            raise NotImplementedError("attention on a mesh without a "
                                      "'model' axis")
        return chunked_attention(q, k, v, cfg, window)
    from torch.distributed.tensor import Partial, Replicate, Shard
    i, tp, r = ax
    S, H, KV = q.shape[1], q.shape[2], k.shape[2]
    rows = keep_dims(q, (0,))                   # the batch's split, if any
    whole = placed(rows, i, Replicate())
    kv_grad = placed(rows, i, Partial())
    if H % tp == 0:
        Hl, G = H // tp, H // KV
        lay = placed(rows, i, Shard(2))
        if keep_dims(k, (0, 2)) == lay == keep_dims(v, (0, 2)):
            return on_local(lambda *ts: chunked_attention(*ts, cfg, window),
                            (q, k, v), (lay,) * 3, lay)
        if Hl % G and G % Hl:
            raise NotImplementedError(
                f"{H} query heads over {tp} ranks read KV heads of two "
                f"groups of {G}")
        lo, n = r * Hl // G, max(Hl // G, 1)

        def fn(q, k, v):
            return chunked_attention(q, k[:, :, lo:lo + n],
                                     v[:, :, lo:lo + n], cfg, window)
    else:
        if S % tp:
            raise NotImplementedError(
                f"{H} query heads do not split over {tp} ranks, nor "
                f"{S} query rows")
        lay = placed(rows, i, Shard(1))
        off = r * S // tp

        def fn(q, k, v):
            return chunked_attention(q, k, v, cfg, window, offset=off)
    return on_local(fn, (q, k, v), (lay, whole, whole), lay,
                    (lay, kv_grad, kv_grad))


def attention_apply(params, x, cfg: ModelConfig, *, positions, local: bool,
                    cache=None):
    """Pre-norm attention block with residual -> (x, cache). cache:
    dict(k, v, pos) or None; given one, S == 1 (decode).

    Under a mesh, without a cache, the residual stream's sequence is made
    whole over ``model`` first (Megatron's sequence-parallel gather; a
    no-op without ``seq_parallel``) and the projections split as their
    weights do, the query heads over ``model``; where those do not divide
    it (``_by_rows``) each rank projects its own S/tp rows instead, the
    weights whole, attends them (``_attention_local``) and projects them
    out. The block's output meets the residual stream at its layout
    (``_residual``)."""
    h = rmsnorm(params["norm1"], x, cfg.norm_eps)
    by_rows = cache is None and _by_rows(h, cfg)
    lay = None
    if by_rows:
        from torch.distributed.tensor import Shard
        lay = placed(keep_dims(h, (0,)), model_axis(h)[0], Shard(1))
    elif cache is None and is_dtensor(h):
        h = h.redistribute(h.device_mesh, keep_dims(h, (0,)))

    def proj(w, b):
        w = params[w].to(h.dtype)
        b = params[b].to(h.dtype) if cfg.qkv_bias else None
        return _rows_linear(h, w, b, lay) if by_rows else _linear(h, w, b)

    q, k, v = proj("wq", "bq"), proj("wk", "bk"), proj("wv", "bv")
    q = split_heads(q, cfg.num_heads)
    k = split_heads(k, cfg.num_kv_heads)
    v = split_heads(v, cfg.num_kv_heads)
    if cfg.qk_norm:
        q = rmsnorm(params["q_norm"], q, cfg.norm_eps)
        k = rmsnorm(params["k_norm"], k, cfg.norm_eps)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    window = cfg.sliding_window if local else 0
    if cache is None:
        out = _attention_local(q, k, v, cfg, window)
    else:
        out = _attend_cached(q, k, v, positions, cache, cfg, window)
    # a bf16 cache under a float32 residual stream (gemma) promotes here
    out = merge_heads(out).to(x.dtype)
    wo = params["wo"].to(x.dtype)
    out = _rows_linear(out, wo, None, lay) if by_rows else out @ wo
    return _residual(x, out), cache


def _kv_step(q, k, v, positions, ck, cv, pos, cfg: ModelConfig, window: int,
             timeline=None):
    """Decode on plain tensors: write the new k/v (B,1,KV,D) into the ring
    (window > 0) or linear buffer ck/cv (B,W,KV,D) in place, advance
    ``pos``, attend over the buffer -> (B,1,H,D). Slot positions are
    analytic: ring slot s holds position cur - ((cur - s) mod W), linear
    slot s holds position s.

    ``timeline`` = (process group, this rank's index r, ranks n): ck/cv
    hold slots [r·Wl, (r+1)·Wl) of a W = n·Wl timeline. The slot written
    comes from the replicated ``pos``; a rank that does not own it writes
    its own slot's values back (no branch on a device value). Each rank
    masks its slots by their absolute positions and the ranks' partial
    results are combined (``_combined_scores``)."""
    group, r, n = timeline or (None, 0, 1)
    Wl = ck.shape[1]
    W, lo = Wl * n, r * Wl
    slot = pos % W if window > 0 else torch.clamp(pos, max=W - 1)
    if timeline is not None:
        own = (slot >= lo) & (slot < lo + Wl)
        slot = (slot - lo).clamp(0, Wl - 1)
    slot = slot.reshape(1).long()
    if timeline is not None:
        k = torch.where(own, k.to(ck.dtype), ck.index_select(1, slot))
        v = torch.where(own, v.to(cv.dtype), cv.index_select(1, slot))
    ck.index_copy_(1, slot, k.to(ck.dtype))
    cv.index_copy_(1, slot, v.to(cv.dtype))
    slots = lo + torch.arange(Wl, dtype=torch.int32, device=q.device)[None]
    cur = positions[:, :1]                                     # (B, 1)
    if window > 0:
        kpos = cur - torch.remainder(cur - slots, W)           # floor mod
    else:
        kpos = slots.expand(cur.shape[0], Wl)
    valid = (kpos >= 0) & (kpos <= cur)
    if window > 0:
        valid &= kpos > cur - window
    if timeline is None:
        out = attention_scores(q, ck, cv, valid[:, None, :], cfg)
    else:
        out = _combined_scores(q, ck, cv, valid[:, None, :], cfg, group)
    pos.add_(1)
    return out


def _attend_cached(q, k, v, positions, cache, cfg: ModelConfig,
                   window: int):
    """``_kv_step`` on the block's cache. Under a mesh it runs on local
    blocks with the cache at its OWN placements (``on_local`` would
    otherwise write into a redistributed copy): q, k, v split over batch
    and heads as the cache splits its batch and KV heads, else whole;
    where the cache splits its slot dim W over a mesh dim, the timeline
    split over that dim's group."""
    ck, cv, pos = cache["k"], cache["v"], cache["pos"]
    if not is_dtensor(ck):
        return _kv_step(q, k, v, positions, ck, cv, pos, cfg, window)
    own = tuple(ck.placements)
    if any(p.is_shard() and p.dim == 3 for p in own):
        raise NotImplementedError(f"a decode cache split over head_dim "
                                  f"{own}")
    split = [i for i, p in enumerate(own) if p.is_shard() and p.dim == 1]
    timeline = None
    if split:
        if len(split) > 1:
            raise NotImplementedError(f"a K/V timeline split over two mesh "
                                      f"dims {own}")
        mesh, i = ck.device_mesh, split[0]
        timeline = (mesh.get_group(i), mesh.get_coordinate()[i],
                    mesh.size(i))
    heads = mapped(own, {0: 0, 2: 2}, q.shape)
    return on_local(
        lambda *ts: _kv_step(*ts, cfg, window, timeline),
        (q, k, v, like(positions, q), ck, cv, pos),
        (heads, heads, heads, mapped(own, {0: 0}), own, own,
         tuple(pos.placements)), heads)


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
# Mixture of Experts (top-k, capacity-based dropping)
# ---------------------------------------------------------------------------

def moe_init(gen, cfg: ModelConfig, *, device="cpu"):
    d, f, E = cfg.d_model, cfg.moe_d_ff, cfg.num_experts
    return {"router": dense_init(gen, (d, E), 0.02, device=device),
            "wg": dense_init(gen, (E, d, f), device=device),
            "wu": dense_init(gen, (E, d, f), device=device),
            "wd": dense_init(gen, (E, f, d), device=device)}


def moe_capacity(T: int, cfg: ModelConfig, capacity_factor: float) -> int:
    """Expert slots C = max(ceil(T·k/E·cf), min(T, 4k)): the floor keeps
    tiny (decode) batches from dropping."""
    k = cfg.experts_per_token
    return max(int(math.ceil(T * k / cfg.num_experts * capacity_factor)),
               min(T, 4 * k))


def moe_route(probs, cfg: ModelConfig, capacity: int, before=None):
    """Top-k routing of (T, E) float32 router probabilities -> (gates,
    idx, pos, keep), each (T·k,) in token-major order: the normalised gate,
    the expert, the slot in that expert (a running count over the tokens,
    drops clamped to ``capacity - 1``) and whether the slot is within
    capacity. ``before`` (E,) counts each expert's assignments among the
    tokens ahead of these (the earlier shards of a batch split over the
    data axes); their slots come first, so that a shard's slots are the
    whole batch's."""
    gates, idx = torch.topk(probs, cfg.experts_per_token, dim=-1)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    e_flat = idx.reshape(-1)
    onehot = F.one_hot(e_flat, cfg.num_experts)              # (T*k, E)
    pos = onehot.cumsum(0).gather(1, e_flat[:, None])[:, 0] - 1
    if before is not None:
        pos = pos + before[e_flat]
    keep = pos < capacity
    return gates.reshape(-1), e_flat, pos.clamp_max(capacity - 1), keep


def moe_apply(params, x, cfg: ModelConfig,
              capacity_factor: float | None = None):
    """x: (B,S,d) -> ((B,S,d), aux loss): GShard-style dropping MoE. Tokens
    are dispatched into an (E, C, d) buffer, the experts run as batched
    GEMMs over it, and each token sums its k gated expert outputs. The
    Switch load-balance loss is E · Σ_e f_e · p_e.

    Under a mesh the experts are parallel (EP) and each token stays on its
    data shard (``_Split``). A rank routes the tokens of its shard of the
    batch (their sequence made whole within its ``model`` group); the
    shards' per-expert counts are gathered over the data axes and the
    earlier shards' go first (``moe_route``'s ``before``), so the slots
    are the whole batch's. Each rank fills its experts' (E/n, C', d)
    buffer at its tokens' slots (C' is C rounded up to a multiple of the
    data axes' size; the slots from C on stay empty), and a reduce-scatter
    over the data axes leaves it (E/n, C'/dp, d) — each slot has one
    filling shard. The expert stacks stay split over the mesh dims that
    split their expert dim (``model`` by the Partitioner's rule; a split
    of another dim, FSDP's over ``data``, is gathered). The outputs are
    gathered back along the slots; each rank combines its tokens' outputs
    from its experts, a pending sum over the splitting dims reduced to
    ``x``'s layout. The aux loss sums the probs and the top-1 picks over
    the data axes. Where nothing splits the experts (E does not divide the
    model axis) every rank runs them all over its share of the slots."""
    if capacity_factor is None:
        capacity_factor = cfg.moe_capacity_factor
    split = _Split(x, keep_dims(params["wg"], (0,)), cfg.num_experts) \
        if is_dtensor(x) else None
    return _moe(params, x, cfg, capacity_factor, split)


class _Split:
    """Where ``moe_apply``'s work lies. Each mesh dim has one role: a data
    axis over which ``x``'s batch is split (``rows``), a data axis that
    does not split it (``slots``: its ranks hold the same tokens), a dim
    that splits the expert stacks (``experts``), or none. The capacity
    slots split over every data axis. The placements of the MoE's tensors
    follow from the roles (``LAYOUTS``). Off a mesh (no ``x``) there is
    one shard holding every expert, and every layout is None."""

    # name: (rows, slots, experts) — "S0"/"S1" split along that dim, "P"
    # a pending sum, None a whole copy (the role-less dims always are)
    LAYOUTS = {"tok": ("S0", None, None),            # the shard's tokens
               "whole": (None, None, None),
               "summed": ("P", None, None),          # sums over the tokens
               "own": ("S0", None, "P"),             # from its experts
               "filled": ("P", None, "S0"),          # the dispatch buffer
               "mine": ("S1", "S1", "S0"),           # the rank's slots
               "stacks": (None, None, "S0"),
               "stack_grads": ("P", "P", "S0")}

    def __init__(self, x=None, stacks=None, num_experts: int = 0):
        self.mesh = None if x is None else x.device_mesh
        self.shard, self.first, self.ways = 0, 0, 1
        self.local = num_experts
        self.layouts = dict.fromkeys(self.LAYOUTS)
        if self.mesh is None:
            return
        from torch.distributed.tensor import Partial, Replicate, Shard
        mesh, names = self.mesh, self.mesh.mesh_dim_names or ()
        data = {i for i, n in enumerate(names) if n in ("pod", "data")}
        rows = {i for i, p in enumerate(x.placements)
                if p.is_shard() and p.dim % x.ndim == 0}
        experts = {i for i, p in enumerate(stacks) if p.is_shard()}
        if not rows <= data or experts & data:
            raise ValueError(
                f"moe_apply on a mesh of {names}: the batch splits over "
                f"the data axes only and the experts over none of them, "
                f"not x at {tuple(x.placements)} and the stacks at {stacks}")
        for i in sorted(rows):                    # the batch's split order
            self.shard = self.shard * mesh.size(i) + mesh.get_local_rank(i)
        for i in sorted(experts):
            self.first = self.first * mesh.size(i) + mesh.get_local_rank(i)
            self.local //= mesh.size(i)
        self.first *= self.local
        for i in data:
            self.ways *= mesh.size(i)
        role = [0 if i in rows else 1 if i in data else 2 if i in experts
                else None for i in range(mesh.ndim)]
        make = {"S0": lambda: Shard(0), "S1": lambda: Shard(1),
                "P": Partial, None: Replicate}
        self.layouts = {name: tuple(make[None if r is None else by_role[r]]()
                                    for r in role)
                        for name, by_role in self.LAYOUTS.items()}

    def to(self, t, placements):
        return t if self.mesh is None else t.redistribute(self.mesh,
                                                          placements)


def _moe(params, x, cfg: ModelConfig, capacity_factor: float,
         split: _Split | None = None):
    """``moe_apply`` in four stages on a rank's local blocks (``on_local``)
    — the router over its shard's tokens, their slots and the dispatch
    buffer, the experts over its slots, the combine — and, between them on
    a mesh, the collectives: the shards' counts gathered, the aux loss's
    sums reduced, the buffer reduce-scattered along the slots and the
    outputs gathered. Off a mesh the stages are plain calls, one shard
    with every expert, so a 1x1 mesh computes what the unsharded MoE
    does."""
    split = split or _Split(num_experts=cfg.num_experts)
    B, S, _ = x.shape
    E = cfg.num_experts
    T = B * S
    C = moe_capacity(T, cfg, capacity_factor)
    slots = -(-C // split.ways) * split.ways                 # C'
    lay = split.layouts
    tok, whole, summed, own = (lay[n] for n in ("tok", "whole", "summed",
                                                "own"))
    filled, mine, stacks = lay["filled"], lay["mine"], lay["stacks"]

    xs = split.to(x, tok)               # once: the router and the dispatch
    probs, counts, sums = on_local(
        lambda x, r: _moe_router(x, r, cfg), (xs, params["router"]),
        (tok, whole), (tok, tok, summed), (tok, summed))
    sums = split.to(sums, whole)
    aux = E * torch.sum((sums[0] / T) * (sums[1] / T))
    buf, g, e, pos, keep = on_local(
        lambda x, p, c: _moe_dispatch(x, p, c, cfg, C, slots, split),
        (xs, probs, counts), (tok, tok, whole),
        (filled, tok, tok, tok, tok), (own, tok, whole))
    h = on_local(
        lambda b, *ws: _moe_experts(b, *ws, cfg),
        (split.to(buf, mine), params["wg"], params["wu"], params["wd"]),
        (mine, stacks, stacks, stacks), mine,
        (mine, *(lay["stack_grads"],) * 3))
    y = on_local(
        lambda h, *r: _moe_combine(h, *r, split, cfg, S),
        (split.to(h, stacks), g, e, pos, keep),
        (stacks, tok, tok, tok, tok), own, (filled, own, tok, tok, tok))
    if split.mesh is None:
        return y, aux
    return split.to(y, x.placements), aux


def _moe_router(x, router, cfg: ModelConfig):
    """A shard's router -> (probs (T, E) float32, its assignments per
    expert (1, E), the aux loss's sums over its tokens (2, E): of the
    probs and of the top-1 picks)."""
    xt = x.reshape(-1, x.shape[-1])
    logits = (xt @ router.to(x.dtype)).float()
    probs = torch.softmax(logits, dim=-1)                    # (T, E)
    idx = torch.topk(probs, cfg.experts_per_token, dim=-1).indices
    experts = torch.arange(cfg.num_experts, device=x.device)
    counts = (idx.reshape(-1, 1) == experts).sum(0, keepdim=True)
    top1 = (idx[:, :1] == experts).sum(0).to(probs.dtype)
    return probs, counts, torch.stack([probs.sum(0), top1])


def _owned(e, keep, split: _Split, E: int):
    """The assignments to a rank's experts [first, first + local): their
    index in its stacks (clamped where it is another rank's) and whether
    each is kept there."""
    if split.local == E:
        return e, keep
    lo = split.first
    return ((e - lo).clamp(0, split.local - 1),
            keep & (e >= lo) & (e < lo + split.local))


def _moe_dispatch(x, probs, counts, cfg: ModelConfig, C: int, slots: int,
                  split: _Split):
    """A shard's routing, its slots after the ``counts`` (n, E) of the
    shards before it, and its rank's (local experts, slots, d) dispatch
    buffer: its kept tokens at their slots in the rank's experts, zeros
    elsewhere. -> (buffer, gates, experts, slots, kept), the last four
    (T·k,) token-major."""
    d, k = x.shape[-1], cfg.experts_per_token
    xt = x.reshape(-1, d)
    g, e, pos, keep = moe_route(probs, cfg, C, counts[:split.shard].sum(0)
                                if split.shard else None)
    el, kept = _owned(e, keep, split, cfg.num_experts)
    t_flat = torch.arange(xt.shape[0], device=x.device).repeat_interleave(k)
    contrib = xt[t_flat].masked_fill(~kept[:, None], 0)
    buf = xt.new_zeros((split.local, slots, d))
    return (buf.index_put((el, pos), contrib, accumulate=True), g, e, pos,
            keep)


def _moe_experts(buf, wg, wu, wd, cfg: ModelConfig):
    a = act_fn(cfg.act)
    h = a(torch.bmm(buf, wg.to(buf.dtype))) * torch.bmm(buf, wu.to(buf.dtype))
    return torch.bmm(h, wd.to(buf.dtype))


def _moe_combine(h, g, e, pos, keep, split: _Split, cfg: ModelConfig,
                 S: int):
    """Each token's gated outputs from the rank's experts ``h`` (local
    experts, C', d), summed over its k choices: the assignments are
    token-major, so the combine is a sum over k (no scatter-add:
    deterministic on the card)."""
    el, kept = _owned(e, keep, split, cfg.num_experts)
    y = h[el, pos] * g[:, None].to(h.dtype)
    y = y.masked_fill(~kept[:, None], 0)
    return y.reshape(-1, cfg.experts_per_token, h.shape[-1]).sum(1) \
        .reshape(-1, S, h.shape[-1])


# ---------------------------------------------------------------------------
# Transformer block = attention + (MLP | MoE)
# ---------------------------------------------------------------------------

def transformer_block_init(gen, cfg: ModelConfig, *, device="cpu"):
    p = attention_init(gen, cfg, device=device)
    if cfg.is_moe:
        p["moe"] = moe_init(gen, cfg, device=device)
    else:
        p["mlp"] = mlp_init(gen, cfg, device=device)
    return p


def transformer_block_apply(params, x, cfg: ModelConfig, *, positions,
                            local: bool, cache=None):
    x, new_cache = attention_apply(params, x, cfg, positions=positions,
                                   local=local, cache=cache)
    h = rmsnorm(params["norm2"], x, cfg.norm_eps)
    if cfg.is_moe:
        y, aux = moe_apply(params["moe"], h, cfg)
    else:
        y = mlp_apply(params["mlp"], h, cfg)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return _residual(x, y), new_cache, aux


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
    else:                                             # (B,1,r) float32
        # under a mesh at a's layout (the cache may split its size-1 dim)
        lay = a.placements if is_dtensor(a) else None
        hh = _state_step(lambda a, bx, h: (a * h + bx,) * 2, (a, bx),
                         (lay, lay), (cache["h"],), lay, lay)
    gate = F.silu(h @ params["wgate"].to(h.dtype))
    y = (hh.to(x.dtype) * gate) @ params["wout"].to(x.dtype)
    x = _residual(x, y)
    h2 = rmsnorm(params["norm2"], x, cfg.norm_eps)
    x = _residual(x, mlp_apply(params["mlp"], h2, cfg))
    return x, cache


def _state_step(fn, args, layouts, states, state_layout, out_layout):
    """Decode's recurrent step: ``fn(*args, *states) -> (out, *new
    states)``, each new state written back into its cache leaf in place
    (``write_``: at the leaf's own layout). Under a mesh ``fn`` runs on
    local blocks: ``args`` at ``layouts``, the states at ``state_layout``
    (the layout the step needs, which may gather a state that its cache
    leaf splits), ``out`` at ``out_layout``."""
    n = len(states)
    res = on_local(fn, (*args, *states), (*layouts, *[state_layout] * n),
                   (out_layout, *[state_layout] * n))
    for dst, val in zip(states, res[1:]):
        write_(dst, val)
    return res[0]


def rglru_cache_init(cfg: ModelConfig, batch: int, *, device="cpu"):
    return {"h": torch.zeros((batch, 1, cfg.lru_dim), dtype=torch.float32,
                             device=device)}


# ---------------------------------------------------------------------------
# mLSTM block (xLSTM) — matrix memory; quadratic or chunkwise on a sequence
# ---------------------------------------------------------------------------

NEG = -1e30   # log(0) stand-in of the chunkwise carry that survives arithmetic


def mlstm_init(gen, cfg: ModelConfig, *, device="cpu"):
    d = cfg.d_model
    up = int(cfg.proj_factor * d)
    hd = up // cfg.num_heads
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "w_up1": dense_init(gen, (d, up), device=device),
        "w_up2": dense_init(gen, (d, up), device=device),
        "w_down": dense_init(gen, (up, d), device=device),
        "wq": dense_init(gen, (up, up), device=device),
        "wk": dense_init(gen, (up, up), device=device),
        "wv": dense_init(gen, (up, up), device=device),
        "w_igate": dense_init(gen, (up, cfg.num_heads), 0.02, device=device),
        "b_igate": torch.zeros((cfg.num_heads,), **f32),
        "w_fgate": dense_init(gen, (up, cfg.num_heads), 0.02, device=device),
        "b_fgate": torch.full((cfg.num_heads,), 3.0, **f32),
        "norm1": rmsnorm_init(cfg, device=device),
        "out_norm": rmsnorm_init(cfg, hd, device=device),
    }


def _mlstm_qkv(params, h, cfg: ModelConfig, heads: bool = True):
    """h: (B,S,up) -> q, v (B,S,H,hd) in h's dtype; k (B,S,H,hd) float32;
    log input gate and log-sigmoid forget gate (B,S,H) float32; with
    ``heads=False`` q, k and v stay (B,S,up). The reference divides k by a
    numpy float64 scalar, which JAX does not treat as weak: k is promoted
    to float32 even for a bf16 model, and so here."""
    H = cfg.num_heads
    hd = h.shape[-1] // H
    q, k, v = (h @ params[w].to(h.dtype) for w in ("wq", "wk", "wv"))
    if heads:
        q, k, v = (split_heads(t, H) for t in (q, k, v))
    k = k.float() / math.sqrt(hd)
    logi = (h @ params["w_igate"].to(h.dtype)).float() + params["b_igate"]
    # log_sigmoid's backward has no DTensor strategy
    logf = pointwise(F.logsigmoid,
                     (h @ params["w_fgate"].to(h.dtype)).float()
                     + params["b_fgate"])
    return q, k, v, logi, logf


def _mlstm_intra(q, k, v, logi, logf):
    """Unnormalised in-chunk mLSTM pieces, for exact chunkwise merging ->
    (num (B,S,H,D), den (B,S,H), m (B,S,H), F (B,S,H)): num and den carry
    the stabiliser exp(-m), and F is the in-chunk cumulative log forget."""
    F_ = torch.cumsum(logf, dim=1)                            # (B,S,H)
    # log decay D[t,s] = F_t - F_s + i_s for s <= t
    dmat = F_[:, :, None, :] - F_[:, None, :, :] + logi[:, None, :, :]
    S = q.shape[1]
    later = torch.ones((S, S), dtype=torch.bool,
                       device=q.device).triu(1)[None, :, :, None]
    dmat = dmat.masked_fill(later, float("-inf"))             # (B,T,S,H)
    m = dmat.amax(dim=2)                                      # (B,T,H)
    dexp = torch.exp(dmat - m[:, :, None, :])
    scores = torch.einsum("bthd,bshd->btsh", q.float(), k.float())
    w = scores * dexp
    num = torch.einsum("btsh,bshd->bthd", w, v.float())
    return num, w.sum(dim=2), m, F_


def mlstm_sequence(q, k, v, logi, logf):
    """Stabilised quadratic-parallel mLSTM: q, k, v (B,S,H,D); logi, logf
    (B,S,H) -> (B,S,H,D) float32 (the xLSTM paper's parallel form)."""
    num, den, m, _ = _mlstm_intra(q, k, v, logi, logf)
    norm = torch.maximum(den.abs(), torch.exp(-m))
    return num / (norm[..., None] + 1e-6)


def _mlstm_chunked(q, k, v, logi, logf, chunk: int):
    """EXACT chunkwise mLSTM: quadratic within chunks of ``chunk`` tokens,
    a stabilised (C, N, M) carry across them (C = Σ_s k_s v_sᵀ
    exp(F_end − F_s + i_s − M), N likewise, M the running max exponent at
    the chunk boundary, starting from ``NEG``). S must be a multiple of
    ``chunk``, as the reference asserts."""
    B, S, H, D = q.shape
    if S % chunk:
        raise ValueError(f"sequence {S} is not a multiple of the mLSTM "
                         f"chunk {chunk}")
    C = torch.zeros((B, H, D, v.shape[-1]), dtype=torch.float32,
                    device=q.device)
    N = torch.zeros((B, H, D), dtype=torch.float32, device=q.device)
    M = torch.full((B, H), NEG, dtype=torch.float32, device=q.device)
    outs = []
    for a in range(0, S, chunk):
        qc, kc, vc = q[:, a:a + chunk], k[:, a:a + chunk], v[:, a:a + chunk]
        lic, lfc = logi[:, a:a + chunk], logf[:, a:a + chunk]
        num_i, den_i, m_i, F_ = _mlstm_intra(qc, kc, vc, lic, lfc)
        m_i = m_i.clamp_min(NEG)
        qf = qc.float()
        # per-position exponent of the carried state's contribution
        m_state = F_ + M[:, None, :]                          # (B,c,H)
        m_tot = torch.maximum(m_i, m_state)
        a_i = torch.exp(m_i - m_tot)
        a_s = torch.exp(m_state - m_tot)
        num = num_i * a_i[..., None] + \
            a_s[..., None] * torch.einsum("bchd,bhde->bche", qf, C)
        den = den_i * a_i + a_s * torch.einsum("bchd,bhd->bch", qf, N)
        outs.append(num / (torch.maximum(den.abs(), torch.exp(-m_tot))[
            ..., None] + 1e-6))
        # the state at the chunk's end, re-stabilised at M_new
        Ftot = F_[:, -1]                                      # (B,H)
        decay = Ftot[:, None, :] - F_ + lic                   # (B,c,H)
        M_new = torch.maximum(M + Ftot, decay.amax(dim=1))
        kc_f = kc.float() * torch.exp(decay - M_new[:, None, :])[..., None]
        scale_old = torch.exp(M + Ftot - M_new)
        C = C * scale_old[..., None, None] + \
            torch.einsum("bchd,bche->bhde", kc_f, vc.float())
        N = N * scale_old[..., None] + kc_f.sum(dim=1)
        M = M_new
    return torch.cat(outs, dim=1)


def mlstm_apply(params, x, cfg: ModelConfig, *, positions=None, local=False,
                cache=None, chunk: int = 256):
    """Sequence path: the quadratic form for S <= ``chunk``, else the
    chunkwise one (``_mlstm_block``). Decode (cache dict(C, N, M), S == 1):
    one recurrent step from the cached state, written back in place. Under
    a mesh, without a cache, the residual stream's sequence is made whole
    over ``model`` first (a no-op without ``seq_parallel``); the block's
    output meets the residual stream at its layout (``_residual``)."""
    h0 = rmsnorm(params["norm1"], x, cfg.norm_eps)
    if cache is None and is_dtensor(h0):
        h0 = h0.redistribute(h0.device_mesh, keep_dims(h0, (0,)))
    u1 = h0 @ params["w_up1"].to(x.dtype)
    u2 = F.silu(h0 @ params["w_up2"].to(x.dtype))
    if cache is None:
        if is_dtensor(u1):          # the projections' input, whole
            u1 = u1.redistribute(u1.device_mesh, keep_dims(u1, (0,)))
        out = _mlstm_block(params, u1, cfg, chunk)
    else:
        # per (batch row, head): under a mesh split as the cache splits them
        q, k, v, logi, logf = _mlstm_qkv(params, u1, cfg)
        states = (cache["C"], cache["N"], cache["M"])
        lay = keep_dims(states[0], (0, 1))
        qlay = mapped(lay, {0: 0, 1: 2}, q.shape)
        out = _state_step(_mlstm_step, (q, k, v, logi, logf),
                          (qlay,) * 5, states, lay, qlay)     # (B,1,H,D)
        out = merge_heads(rmsnorm(params["out_norm"], out, cfg.norm_eps))
    out = out.to(x.dtype) * u2
    return _residual(x, out @ params["w_down"].to(x.dtype)), cache


def _mlstm_block(params, u1, cfg: ModelConfig, chunk: int):
    """The mLSTM core and its ``out_norm`` over a sequence: u1 (B,S,up) ->
    (B,S,up) float32. Under a mesh u1 comes whole over ``model``, q, k and
    v come out split over ``model`` on their columns as ``wq``, ``wk`` and
    ``wv`` are, the gates whole, and each ``model`` rank computes its
    share on local blocks, the batch split as u1's:

    - the heads divide the model axis (H % tp == 0): each rank its H/tp
      heads, q, k and v as they lie;
    - the model axis is a multiple of the heads (xlstm-350m's 4 over 16):
      the g = tp/H ranks that share a head split its VALUE dim. Rank r
      holds head r // g's value columns (r % g)·D/g onward, as v lies; the
      head's q and k are gathered from the g ranks of its group (an
      all-to-all among them, ``group_blocks``). Each rank forms the
      chunk's scores, decay matrix, N and denominator of its head —
      replicated within the group — and its D/g columns of the numerator,
      of the carried C (D × D/g) and of the output; ``out_norm``'s mean of
      squares over the head's D sums the group's (B, S) partial sums (a
      gather over ``model`` of each rank's, ``gather_last``), and its
      weight is sliced to the rank's columns.

    The output leaves at q's layout, u1's column split, so that ``* u2``
    and ``@ w_down`` (split on its rows) need no collective. Any other
    split raises ``NotImplementedError``."""
    H = cfg.num_heads
    D = u1.shape[-1] // H
    eps = cfg.norm_eps
    lays = grads = None
    i, tp, r, g = None, 1, 0, 1
    if is_dtensor(u1):
        from torch.distributed.tensor import Partial, Replicate, Shard
        i, tp, r = model_axis(u1) or (None, 1, 0)
        if H % tp and tp % H:
            raise NotImplementedError(f"{H} mLSTM heads over {tp} ranks: "
                                      f"neither divides the other")
        g = max(tp // H, 1)
        rows = keep_dims(u1, (0,))         # the batch's split, if any
        cols = placed(rows, i, Shard(2))
        whole = placed(rows, i, Replicate())
        lays = (cols, cols, cols, whole, whole, replicate(u1))
        grads = (cols, cols, cols, placed(rows, i, Partial()),
                 placed(rows, i, Partial()), summed_over(cols))
    q, k, v, logi, logf = _mlstm_qkv(params, u1, cfg, heads=False)
    group = axis_group(u1, i) if g > 1 else None
    Hl = max(H // tp, 1)                   # heads a rank
    lo = r * Hl if g == 1 else r // g      # its first head
    Dv = D // g                            # its value columns of a head

    def fn(q, k, v, logi, logf, scale):
        B, S = q.shape[:2]
        q = group_blocks(q, group, tp, g, r).reshape(B, S, Hl, D)
        k = group_blocks(k, group, tp, g, r).reshape(B, S, Hl, D)
        v = v.reshape(B, S, Hl, Dv)
        li, lf = logi[..., lo:lo + Hl], logf[..., lo:lo + Hl]
        if S <= chunk:
            out = mlstm_sequence(q, k, v, li, lf)
        else:
            out = _mlstm_chunked(q, k, v, li, lf, chunk)
        if g == 1:
            out = rmsnorm({"scale": scale}, out, eps)
        else:
            part = gather_last(out.square().sum(-1), group, tp)  # (B,S,tp)
            var = part.reshape(B, S, H, g)[:, :, lo].sum(-1) / D
            c0 = (r % g) * Dv
            out = out * torch.rsqrt(var + eps)[..., None, None] * \
                scale[c0:c0 + Dv]
        return out.reshape(B, S, Hl * Dv)

    return on_local(fn, (q, k, v, logi, logf, params["out_norm"]["scale"]),
                    lays, lays[0] if lays else None, grads)


def _mlstm_step(q, k, v, logi, logf, C, N, M):
    """One recurrent step: q, k, v (B,1,H,D), logi, logf (B,1,H) from the
    state C (B,H,D,D), N (B,H,D), M (B,H) -> (out (B,1,H,D) float32, C,
    N, M new)."""
    lf, li = logf[:, 0], logi[:, 0]                           # (B,H)
    m_new = torch.maximum(lf + M, li)
    alpha = torch.exp(lf + M - m_new)[..., None]
    beta = torch.exp(li - m_new)[..., None]
    k1, v1, q1 = k[:, 0], v[:, 0], q[:, 0]                    # (B,H,D)
    C = C * alpha[..., None] + \
        beta[..., None] * k1[..., :, None] * v1[..., None, :]
    N = N * alpha + beta * k1
    qf = q1.float()
    num = torch.einsum("bhd,bhde->bhe", qf, C)
    den = torch.maximum(torch.einsum("bhd,bhd->bh", qf, N).abs(),
                        torch.exp(-m_new))
    return (num / (den[..., None] + 1e-6))[:, None], C, N, m_new


def mlstm_cache_init(cfg: ModelConfig, batch: int, *, device="cpu"):
    """C (B,H,hd,hd), N (B,H,hd) and M (B,H), float32 zeros — M starts at 0
    here, as in the reference, where the chunkwise carry starts at NEG."""
    up = int(cfg.proj_factor * cfg.d_model)
    hd = up // cfg.num_heads
    f32 = dict(dtype=torch.float32, device=device)
    return {"C": torch.zeros((batch, cfg.num_heads, hd, hd), **f32),
            "N": torch.zeros((batch, cfg.num_heads, hd), **f32),
            "M": torch.zeros((batch, cfg.num_heads), **f32)}


# ---------------------------------------------------------------------------
# sLSTM block (xLSTM) — scalar memory, a loop over time
# ---------------------------------------------------------------------------

SLSTM_GATES = ("i", "f", "z", "o")


def slstm_init(gen, cfg: ModelConfig, *, device="cpu"):
    d = cfg.d_model
    up = int(cfg.proj_factor * d)
    p = {"norm1": rmsnorm_init(cfg, device=device)}
    for g in SLSTM_GATES:
        p[f"w_{g}"] = dense_init(gen, (d, d), device=device)
    for g in SLSTM_GATES:
        p[f"r_{g}"] = dense_init(gen, (d, d), 0.02, device=device)
        p[f"b_{g}"] = torch.full((d,), 1.0 if g == "f" else 0.0,
                                 dtype=torch.float32, device=device)
    p["w_up"] = dense_init(gen, (d, up), device=device)
    p["w_down"] = dense_init(gen, (up, d), device=device)
    return p


def _slstm_step(r, carry, pre_x, one, gather=None):
    """One step: ``pre_x`` (B,4n) float32, the input's gate pre-activations
    with their biases; ``r`` (d,4n), the recurrent weights of the gates
    i, f, z, o side by side; carry (c, n, m, h) -> (new carry, h), of n
    channels (n = d, or a rank's d/tp, its h made whole by ``gather``
    before ``h @ r``). ``one`` is a float32 1 for the normaliser's floor:
    ``torch.maximum`` splits the gradient on a tie (n is exactly 1
    whenever the input gate sets m) as ``jnp.maximum`` does, where
    ``clamp`` would pass all of it to n."""
    c, n, m, h = carry
    h = h if gather is None else gather(h)
    it, ft, zt, ot = (pre_x + h @ r).chunk(4, dim=-1)
    zt = torch.tanh(zt)
    ot = torch.sigmoid(ot)
    logf = F.logsigmoid(ft)
    m_new = torch.maximum(logf + m, it)
    i_ = torch.exp(it - m_new)
    f_ = torch.exp(logf + m - m_new)
    c = f_ * c + i_ * zt
    n = f_ * n + i_
    h = ot * c / torch.maximum(n, one)
    return (c, n, m_new, h), h


def _slstm_scan(pre_x, r, gather=None):
    """The sLSTM recurrence over a whole sequence from a zero state:
    pre_x (B,S,4n) float32 -> h (B,S,n); each step's h made whole by
    ``gather`` (a rank's n = d/tp channels; every step, the first's zeros
    too) before ``h @ r``. On ``meta`` tensors (the dry run: shapes, no
    values) the S steps run as one step over all B·S rows — the same
    matmuls, forward and backward, and one gather of (B, S, d) for the S
    of (B, d), without S trips through the host (the recurrent input
    taken from ``pre_x`` so that its grad is formed, as every step but the
    first forms it)."""
    B, S, d4 = pre_x.shape
    if pre_x.device.type == "meta":
        one = torch.ones((), dtype=torch.float32, device="meta")
        state = pre_x[..., :d4 // 4] * 0
        return _slstm_step(r, (state,) * 4, pre_x, one, gather)[1]
    zero = torch.zeros((B, d4 // 4), dtype=torch.float32,
                       device=pre_x.device)
    one = torch.ones((), dtype=torch.float32, device=pre_x.device)
    carry = (zero, zero, zero, zero)
    hs = []
    # unbind, not pre_x[:, t]: the backward of S slices would add S
    # zero-filled (B,S,4d) grads; unbind's stacks them once
    for px in pre_x.unbind(1):
        carry, h = _slstm_step(r, carry, px, one, gather)
        hs.append(h)
    return torch.stack(hs, dim=1)


def slstm_apply(params, x, cfg: ModelConfig, *, positions=None, local=False,
                cache=None):
    """The recurrence runs in float32, with the gate weights and biases
    recast to float32 as in the reference (``w_up`` and ``w_down`` stay in
    the model's dtype). The input's share of the four gate pre-activations,
    ``h0 @ w_g + b_g``, is one float32 GEMM over all (B·S) tokens before
    the loop over time (the reference forms it step by step: the same
    math); each step adds ``h_{t-1} @ r_g``. Decode (cache dict(c, n, m,
    h), S == 1): one step, written back in place.

    Under a mesh each ``model`` rank computes its d/tp channels
    (``_slstm_local``); their h is made whole over ``model`` for ``w_up``
    (split on its columns), and the block's output meets the residual
    stream at its layout (``_residual``)."""
    h0 = rmsnorm(params["norm1"], x, cfg.norm_eps).float()
    out = _slstm_local(params, h0, cache).to(x.dtype)
    if is_dtensor(out):
        out = out.redistribute(out.device_mesh, keep_dims(out, (0,)))
    up = act_fn("gelu")(out @ params["w_up"].to(x.dtype))
    return _residual(x, up @ params["w_down"].to(x.dtype)), cache


def _slstm_local(params, h0, cache=None):
    """``slstm_apply``'s recurrence -> h (B,S,d) float32; under a mesh
    split over ``model`` on its channels. Each rank runs on local blocks,
    the batch split as h0's, its sequence and d made whole: its n = d/tp
    channels of the four gates — the (d, n) blocks of each ``w_g`` and
    ``r_g``, split on their columns as they lie, side by side (no cat of
    split weights), and its channels of each ``b_g`` — form its channels
    of i, f, z and o, and its channels of c, n and m. At each step it
    gathers h over ``model`` (``gather_last``: an all-gather, backward a
    reduce-scatter) for ``h @ r``, so the state never becomes whole. Off a
    mesh, on a model axis of one rank, or for a d that does not split over
    it, every channel is local and nothing is gathered.

    Decode: the cache (c, n, m, h) at its own layout (whole over
    ``model``, or split on d where it divides as ``lru_dim`` does): each
    rank reads its channels of c, n and m and the whole h, steps its
    channels, and writes them back (``write_``: gathered into a whole
    leaf)."""
    i, tp, r = model_axis(h0) or (None, 1, 0)
    d = h0.shape[-1]
    if d % tp:
        i, tp, r = None, 1, 0
    n = d // tp
    lo = r * n
    group = axis_group(h0, i)
    ws = [params[f"{k}_{g}"] for k in "wrb" for g in SLSTM_GATES]
    states = cache and tuple(cache[k] for k in ("c", "n", "m", "h"))
    lays = grads = outs = None
    if is_dtensor(h0):
        from torch.distributed.tensor import Partial, Shard
        rows = keep_dims(h0, (0,))
        own = placed(rows, i, Shard(2))               # its channels
        wlay = [placed(replicate(w), i, Shard(1)) for w in ws[:8]]
        lays = (rows, *wlay, *(replicate(b) for b in ws[8:]))
        grads = (placed(rows, i, Partial()),
                 *(tuple(Partial() if p.is_shard() else q
                         for p, q in zip(rows, lay)) for lay in wlay),
                 *(summed_over(own),) * 4)
        outs = own
        if cache is not None:
            whole = mapped(rows, {0: 0})              # (B, d)
            mine = placed(whole, i, Shard(1))
            lays = (*lays, mine, mine, mine, whole)
            outs = (own, mine, mine, mine, mine)

    def weights(w_i, w_f, w_z, w_o, r_i, r_f, r_z, r_o, *bs):
        w = torch.cat([t.float() for t in (w_i, w_f, w_z, w_o)], 1)
        rr = torch.cat([t.float() for t in (r_i, r_f, r_z, r_o)], 1)
        b = torch.cat([t.float()[lo:lo + n] for t in bs])
        return w, rr, b

    if cache is None:
        def fn(h0, *ws):
            w, rr, b = weights(*ws)
            return _slstm_scan(h0 @ w + b, rr,
                               lambda h: gather_last(h, group, tp))

        return on_local(fn, (h0, *ws), lays, outs, grads)

    def step(h0, *args):
        w, rr, b = weights(*args[:12])
        one = torch.ones((), dtype=torch.float32, device=h0.device)
        new, h = _slstm_step(rr, args[12:], (h0 @ w + b)[:, 0], one)
        return (h[:, None, :], *new)

    res = on_local(step, (h0, *ws, *states), lays, outs)
    for dst, val in zip(states, res[1:]):
        write_(dst, val)
    return res[0]


def slstm_cache_init(cfg: ModelConfig, batch: int, *, device="cpu"):
    return {k: torch.zeros((batch, cfg.d_model), dtype=torch.float32,
                           device=device) for k in ("c", "n", "m", "h")}

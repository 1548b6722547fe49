"""The port's recurrentgemma stack on the CPU against the JAX package: each
layer, the whole forward, and the loss with every gradient, on a narrow
config with the JAX package's params carried across; and the train-state
layout, narrow and full-size.

Tolerances: float32 — rtol 1e-4 on activations and logits, 1e-3 on grads
(both packages sum matmuls and scans in other orders); bfloat16 — the
largest difference within 2% of the largest value for one layer, 5% for
the logits after three layers and 6% for the grads (one bf16 ulp is
0.4-0.8%, bf16 rounds at other places in the two frameworks, and the logit
noise of about 2% passes into every grad through the softmax), and the loss
within 2%.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.core.serialization import path_str as jax_path_str
from repro.models import layers as JL, transformer as JT
from repro.models.config import ATTN_LOCAL, RGLRU
from repro.train.steps import (init_train_state as jax_init_state,
                               make_loss_fn as jax_loss_fn)
from repro_torch.configs import get_config
from repro_torch.core.serialization import (dtype_name, path_str,
                                            state_from_numpy,
                                            tree_leaves_with_path)
from repro_torch.models import layers as L, transformer as T
from repro_torch.train.steps import init_train_state, make_loss_fn

NARROW = dict(num_layers=3, block_pattern=(RGLRU, RGLRU, ATTN_LOCAL),
              d_model=128, num_heads=2, num_kv_heads=1, head_dim=64,
              d_ff=256, lru_dim=200, vocab_size=512, sliding_window=16)
B, S = 2, 63
DTYPES = ("float32", "bfloat16")
NP_DTYPE = {"float32": np.float32, "bfloat16": ml_dtypes.bfloat16}


def configs(dtype: str):
    return (jax_config("recurrentgemma-2b").replace(dtype=dtype, **NARROW),
            get_config("recurrentgemma-2b").replace(dtype=dtype, **NARROW))


@pytest.fixture(scope="module", params=DTYPES)
def setup(request):
    """(dtype, jax cfg, port cfg, jax params, port params): one set of
    values, made by the JAX package and carried across."""
    jc, pc = configs(request.param)
    params = jax.jit(lambda: jax_init_state(jax.random.key(0), jc))()[
        "params"]
    ported = state_from_numpy(jax.tree.map(np.asarray, params), device="cpu")
    return request.param, jc, pc, params, ported


def close(got, want, dtype, rtol=1e-4, atol=1e-5, bf16_tol=2e-2):
    got = np.asarray(got.detach().float().numpy() if isinstance(
        got, torch.Tensor) else got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)
    else:
        err = np.abs(got - want).max() / (np.abs(want).max() + 1e-12)
        assert err <= bf16_tol, err


def _x(dtype, seed=1, shape=(B, S, 128)):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return x.astype(NP_DTYPE[dtype])


def _both(x):
    return jnp.asarray(x), state_from_numpy(x, device="cpu")


def _group0(tree):
    if isinstance(tree, dict):
        return {k: _group0(v) for k, v in tree.items()}
    return tree[0]


def _positions():
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    return jnp.asarray(pos), torch.from_numpy(pos)


# ------------------------------------------------------------------ layers
def test_rmsnorm(setup):
    dtype, jc, _, _, _ = setup
    scale = np.random.default_rng(2).standard_normal(128).astype(np.float32)
    jx, tx = _both(_x(dtype))
    want = JL.rmsnorm({"scale": jnp.asarray(scale)}, jx, jc.norm_eps)
    got = L.rmsnorm({"scale": torch.from_numpy(scale)}, tx, jc.norm_eps)
    assert got.dtype == tx.dtype
    close(got, want, dtype)


def test_rope(setup):
    dtype, jc, _, _, _ = setup
    jq, tq = _both(_x(dtype, 3, (B, S, 2, 64)))
    jp, tp = _positions()
    close(L.rope(tq, tp, jc.rope_theta), JL.rope(jq, jp, jc.rope_theta),
          dtype)


@pytest.mark.parametrize("local", [True, False], ids=["window", "global"])
def test_attention_block(setup, local):
    """Window 16 < S = 63: the local mask cuts the lookback."""
    dtype, jc, pc, jparams, tparams = setup
    name = "b2_attn_local"
    jp = jax.tree.map(lambda x: x[0], jparams["blocks"][name])
    tp = _group0(tparams["blocks"][name])
    jx, tx = _both(_x(dtype, 4))
    jpos, tpos = _positions()
    want, _ = jax.jit(lambda p, x, pos: JL.attention_apply(
        p, x, jc, positions=pos, local=local))(jp, jx, jpos)
    got, _ = L.attention_apply(tp, tx, pc, positions=tpos, local=local)
    close(got, want, dtype)


def test_chunked_attention_matches_direct():
    """The query-chunk loop (S > chunk, S not a multiple of it) equals one
    direct pass, with a window."""
    _, pc = configs("float32")
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((1, 50, 2, 64), (1, 50, 1, 64), (1, 50, 1, 64)))
    direct = L.attention_scores(q, k, v, L.causal_mask(50, 50, 0, 16), pc)
    chunked = L.chunked_attention(q, k, v, pc, window=16, chunk=16)
    torch.testing.assert_close(chunked, direct, rtol=2e-5, atol=2e-5)


def test_mlp(setup):
    dtype, jc, pc, jparams, tparams = setup
    jp = jax.tree.map(lambda x: x[0], jparams["blocks"]["b2_attn_local"]["mlp"])
    tp = _group0(tparams["blocks"]["b2_attn_local"]["mlp"])
    jx, tx = _both(_x(dtype, 6))
    close(L.mlp_apply(tp, tx, pc), JL.mlp_apply(jp, jx, jc), dtype)


def test_rglru_block(setup):
    dtype, jc, pc, jparams, tparams = setup
    jp = jax.tree.map(lambda x: x[0], jparams["blocks"]["b0_rglru"])
    tp = _group0(tparams["blocks"]["b0_rglru"])
    jx, tx = _both(_x(dtype, 7))
    want, _ = jax.jit(lambda p, x: JL.rglru_apply(p, x, jc))(jp, jx)
    got, _ = L.rglru_apply(tp, tx, pc)
    close(got, want, dtype)


# ------------------------------------------------------------ whole model
def _tokens(seed=8):
    t = np.random.default_rng(seed).integers(0, NARROW["vocab_size"],
                                             (B, S + 1)).astype(np.int32)
    return {"tokens": t[:, :-1], "labels": t[:, 1:]}


def test_forward_logits(setup):
    dtype, jc, pc, jparams, tparams = setup
    tokens = _tokens()["tokens"]
    want, _ = jax.jit(lambda p, t: JT.forward(p, jc, t))(
        jparams, jnp.asarray(tokens))
    with torch.no_grad():
        got, aux = T.forward(tparams, pc, torch.from_numpy(tokens))
    assert got.dtype == torch.float32 and float(aux) == 0.0
    close(got, want, dtype, bf16_tol=5e-2)


def test_loss_and_every_grad(setup):
    dtype, jc, pc, jparams, tparams = setup
    batch = _tokens(9)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        jax_loss_fn(jc), has_aux=True))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    leaves = tree_leaves_with_path(tparams)
    live = [leaf.detach().requires_grad_(True) for _, leaf in leaves]
    tree = state_from_numpy({}, device="cpu")
    for (path, _), leaf in zip(leaves, live):
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    loss, extras = make_loss_fn(pc)(
        tree, {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, live)
    loss = float(loss.detach())
    if dtype == "float32":
        np.testing.assert_allclose(loss, float(jloss), rtol=1e-5)
    else:
        assert abs(loss - float(jloss)) <= 0.02 * abs(float(jloss))
    jflat = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    assert [jax_path_str(p) for p, _ in jflat] == \
        [path_str(p) for p, _ in leaves]
    for (path, jg), g, p in zip(jflat, grads, live):
        assert g.dtype == p.dtype, jax_path_str(path)
        close(g, jg, dtype, rtol=1e-3, atol=1e-6, bf16_tol=6e-2)


def test_gemma_embedding_scale_promotes_to_float32():
    """With ``attn_softcap`` (gemma2) the reference scales the bf16
    embedding by a numpy float32 scalar, which promotes the residual stream
    to float32; the port does the same."""
    jc = jax_config("gemma2-9b").scaled_down(vocab=64)
    pc = get_config("gemma2-9b").scaled_down(vocab=64)
    assert pc.attn_softcap and pc.dtype == "bfloat16"
    emb = _x("bfloat16", 10, (64, pc.d_model))
    tokens = np.arange(12, dtype=np.int32).reshape(2, 6)
    want = JT._embed({"embed": jnp.asarray(emb)}, jc, jnp.asarray(tokens))
    got = T._embed({"embed": state_from_numpy(emb, device="cpu")}, pc,
                   torch.from_numpy(tokens))
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_rglru_cache_branch_steps_the_state():
    """The RG-LRU cache branch returns the stepped ``{"h"}`` state."""
    _, pc = configs("float32")
    params = _group0(T.init_params(pc, device="cpu")["blocks"])["b0_rglru"]
    x = torch.zeros((2, 1, 128))
    y, cache = L.rglru_apply(params, x, pc, cache=L.rglru_cache_init(pc, 2))
    assert y.shape == x.shape and list(cache) == ["h"]
    assert cache["h"].shape == (2, 1, pc.lru_dim)
    assert cache["h"].dtype == torch.float32


def test_init_params_defaults_to_the_card():
    import inspect
    assert inspect.signature(T.init_params).parameters["device"].default \
        == "cuda"


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_init_params_builds_the_layout_where_asked(device):
    """On an explicit device the parameter tree has the JAX package's
    layout, every leaf on that device."""
    jc, pc = configs("float32")
    params = T.init_params(pc, device=device)
    want = [(k[len("params/"):], s, d) for k, s, d in _layout_of_jax(jc)
            if k.startswith("params/")]
    got = [(path_str(p), tuple(t.shape), dtype_name(t.dtype))
           for p, t in tree_leaves_with_path(params)]
    assert got == want
    assert {t.device.type for _, t in tree_leaves_with_path(params)} == \
        {device}


# ---------------------------------------------------------------- layout
def _layout_of_port(state) -> list:
    return [(path_str(p), tuple(t.shape), dtype_name(t.dtype))
            for p, t in tree_leaves_with_path(state)]


def _layout_of_jax(jcfg) -> list:
    shapes = jax.eval_shape(lambda: jax_init_state(jax.random.key(0), jcfg))
    flat, _ = jax.tree_util.tree_flatten_with_path(shapes)
    return [(jax_path_str(p), tuple(s.shape), str(s.dtype)) for p, s in flat]


@pytest.mark.parametrize("dtype", DTYPES)
def test_narrow_train_state_layout(dtype):
    jc, pc = configs(dtype)
    assert _layout_of_port(init_train_state(pc, device="cpu")) == \
        _layout_of_jax(jc)


def test_full_train_state_layout_on_meta():
    """Full-width, full-depth recurrentgemma-2b: 467 leaves,
    28,943,984,648 B, the JAX package's layout — laid out on the meta
    device, without allocating."""
    state = init_train_state(get_config("recurrentgemma-2b"), device="meta")
    got = _layout_of_port(state)
    assert got == _layout_of_jax(jax_config("recurrentgemma-2b"))
    assert len(got) == 467
    nbytes = sum(t.numel() * t.element_size()
                 for _, t in tree_leaves_with_path(state))
    assert nbytes == 28_943_984_648

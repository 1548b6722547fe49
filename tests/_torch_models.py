"""Shared checks of the ``test_torch_*`` model files: a reduced model of
either package run on one set of weights (made by the JAX package and
carried across with ``state_from_numpy``) and compared — the forward, the
loss with every gradient, ``decode_step`` step by step with every cache
leaf, the prefill, and decode against the teacher-forced forward.

Tolerances (those of ``tests/test_torch_model.py`` and
``tests/test_torch_serve.py``): float32 — rtol 1e-4, atol 1e-5 on logits
and cache leaves, 1e-3 on grads (both packages sum matmuls and scans in
other orders); bfloat16 — the largest difference within 5% of the largest
value for logits and cache leaves, 6% for grads, the loss within 2%;
decode against forward — max |diff| / max |logit| < 0.05, the reference's
own yardstick (``tests/test_models.py``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.core.serialization import path_str as jax_path_str
from repro.models import transformer as JT
from repro.train.steps import (init_train_state as jax_init_state,
                               make_loss_fn as jax_loss_fn,
                               make_prefill_step as jax_prefill_step)
from repro_torch.core.serialization import (path_str, state_from_numpy,
                                            state_to_numpy,
                                            tree_leaves_with_path)
from repro_torch.models import transformer as T
from repro_torch.train.steps import (init_train_state, make_loss_fn,
                                     make_prefill_step, make_serve_step)

F32 = dict(rtol=1e-4, atol=1e-5)
BF16_TOL = 5e-2
DECODE_VS_FORWARD = 0.05


def carried(jc, seed: int = 0):
    """(JAX params, port params): the JAX package's init, carried across."""
    params = jax.jit(lambda: jax_init_state(jax.random.key(seed), jc))()[
        "params"]
    return params, state_from_numpy(jax.tree.map(np.asarray, params),
                                    device="cpu")


def close(got, want, dtype, rtol=1e-4, atol=1e-5, bf16_tol=BF16_TOL):
    got = np.asarray(got.detach().float().numpy() if isinstance(
        got, torch.Tensor) else got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)
    else:
        err = np.abs(got - want).max() / (np.abs(want).max() + 1e-12)
        assert err <= bf16_tol, err


def group0(tree):
    if isinstance(tree, dict):
        return {k: group0(v) for k, v in tree.items()}
    return tree[0]


def tokens(cfg, shape, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def frontend(cfg, batch, seed=0):
    """Seeded ``frontend_embeds`` of the config, or None."""
    if not cfg.frontend:
        return None
    return np.random.default_rng(seed).standard_normal(
        (batch, cfg.frontend_len, cfg.frontend_dim)).astype(np.float32)


def flat(tree) -> list:
    """[(key path, numpy leaf)] in JAX order, for either package's tree."""
    leaves, _ = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(np.asarray, state_to_numpy(tree)))
    return [(jax.tree_util.keystr(p), x) for p, x in leaves]


def check_forward(jc, pc, jparams, params, dtype, B=2, S=31):
    tok = tokens(pc, (B, S), seed=8)
    fe = frontend(pc, B)
    want, jaux = jax.jit(lambda p, t, f: JT.forward(p, jc, t, f))(
        jparams, jnp.asarray(tok), None if fe is None else jnp.asarray(fe))
    with torch.no_grad():
        got, aux = T.forward(params, pc, torch.from_numpy(tok),
                             None if fe is None else torch.from_numpy(fe))
    assert got.dtype == torch.float32
    assert got.shape == (B, S + (pc.frontend_len if fe is not None else 0),
                         pc.vocab_size)
    close(got, want, dtype)
    tol = 1e-5 if dtype == "float32" else 2e-2
    assert abs(float(aux) - float(jaux)) <= tol * abs(float(jaux)) + 1e-6


def check_loss_and_grads(jc, pc, jparams, params, dtype, B=2, S=31):
    """The loss (aux included) and the gradient of every leaf."""
    t = tokens(pc, (B, S + 1), seed=9)
    batch = {"tokens": t[:, :-1], "labels": t[:, 1:]}
    fe = frontend(pc, B, seed=1)
    if fe is not None:
        batch["frontend_embeds"] = fe
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        jax_loss_fn(jc), has_aux=True))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    leaves = tree_leaves_with_path(params)
    live = [leaf.detach().requires_grad_(True) for _, leaf in leaves]
    tree: dict = {}
    for (path, _), leaf in zip(leaves, live):
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    loss, _ = make_loss_fn(pc)(
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


def check_init_cache(jc, pc, batch=3, max_len=40):
    """Key names, stacking over groups, shapes and dtypes; all zeros."""
    want = flat(JT.init_cache(jc, batch, max_len))
    got = flat(T.init_cache(pc, batch, max_len, device="cpu"))
    assert [k for k, _ in got] == [k for k, _ in want]
    for (k, g), (_, w) in zip(got, want):
        assert (g.dtype, g.shape) == (w.dtype, w.shape), k
        assert not g.any(), k
    return got


def check_decode_steps(jc, pc, jparams, params, dtype, B=2, steps=20):
    """``steps`` decode steps from the same caches: logits and every cache
    leaf after each step."""
    tok = tokens(pc, (B, steps))
    jcache = JT.init_cache(jc, B, steps)
    cache = T.init_cache(pc, B, steps, device="cpu")
    dec = jax.jit(lambda p, c, t, pos: JT.decode_step(p, jc, c, t, pos))
    for t in range(steps):
        pos = np.full((B, 1), t, np.int32)
        want, jcache = dec(jparams, jcache, jnp.asarray(tok[:, t:t + 1]),
                           jnp.asarray(pos))
        got, cache = T.decode_step(params, pc, cache,
                                   torch.from_numpy(tok[:, t:t + 1]),
                                   torch.from_numpy(pos))
        assert got.dtype == torch.float32 and \
            got.shape == (B, 1, pc.vocab_size)
        close(got.numpy(), want, dtype)
        g, w = flat(cache), flat(jcache)
        assert [k for k, _ in g] == [k for k, _ in w]
        for (k, gl), (_, wl) in zip(g, w):
            assert (gl.dtype, gl.shape) == (wl.dtype, wl.shape), k
            if k.endswith("['pos']"):
                np.testing.assert_array_equal(gl, wl)
            else:
                close(gl, wl, dtype)


def check_prefill(jc, pc, jparams, params, B=2, S=16):
    tok = tokens(pc, (B, S), seed=1)
    want = jax.jit(jax_prefill_step(jc))(jparams,
                                         {"tokens": jnp.asarray(tok)})
    got = make_prefill_step(pc)(params, {"tokens": torch.from_numpy(tok)})
    assert got.shape == (B, 1, pc.vocab_size) and got.dtype == torch.float32
    close(got.numpy(), want, "float32")


def decode_vs_forward(pc, B=2, steps=16) -> float:
    """Within the port: token-by-token decode with the cache against the
    teacher-forced forward, as max |diff| / max |logit|."""
    params = init_train_state(pc, seed=1, device="cpu")["params"]
    tok = torch.from_numpy(tokens(pc, (B, steps), seed=2))
    full, _ = T.forward(params, pc, tok)
    cache = T.init_cache(pc, B, max_len=steps, device="cpu")
    serve = make_serve_step(pc)
    outs = []
    for t in range(steps):
        pos = torch.full((B, 1), t, dtype=torch.int32)
        logits, cache = serve(params, cache, tok[:, t:t + 1], pos)
        outs.append(logits[:, 0])
    dec = torch.stack(outs, dim=1)
    return float((dec - full).abs().max()) / (float(full.abs().max()) + 1e-9)

"""The port's serving path on the CPU against the JAX package: decode caches
(tree, shapes, dtypes), ``decode_step`` logits and every cache leaf step by
step (a ring-buffer wrap included), ``make_prefill_step``, decode against
the teacher-forced forward within the port, and the model-swap zoo across
packages (a JAX-saved checkpoint swapped in, lightly updated in both, and
delta-saved to the same bytes).

Weights go across from the JAX package through ``state_from_numpy``.

Tolerances (those of ``tests/test_torch_model.py``): float32 — rtol 1e-4,
atol 1e-5 on logits and cache leaves (both packages sum matmuls in other
orders); bfloat16 — the largest difference within 5% of the largest value
for logits and cache leaves after at most three layers (one bf16 ulp is
0.4-0.8% and rounds at other places in the two frameworks); decode against
forward — max |diff| / max |logit| < 0.05, the reference's own yardstick
(``tests/test_models.py``). Positions, token ids and written bytes are
exact.
"""

import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.core import CheckpointManager as RefManager
from repro.models import transformer as JT
from repro.train.steps import (init_train_state as jax_init_state,
                               make_prefill_step as jax_prefill_step)
from repro_torch.configs import get_config
from repro_torch.core.serialization import state_from_numpy, state_to_numpy
from repro_torch.models import transformer as T
from repro_torch.train.steps import (generate, init_train_state,
                                     make_prefill_step, make_serve_step)

from _torch_port import dir_files, leaves_bytes

F32 = dict(rtol=1e-4, atol=1e-5)
BF16_TOL = 5e-2
DECODE_VS_FORWARD = 0.05

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ("recurrentgemma-2b", "qwen2.5-3b", "stablelm-3b", "gemma2-9b")
# recurrentgemma's three narrow layers (``tests/test_torch_model.py``) for
# bfloat16: its reduced config has 13 blocks, past the bf16 yardstick
NARROW = dict(num_layers=3, block_pattern=("rglru", "rglru", "attn_local"),
              d_model=128, num_heads=2, num_kv_heads=1, head_dim=64,
              d_ff=256, lru_dim=200, vocab_size=512)
WINDOW = 8            # local attention's ring buffer wraps within STEPS
B, STEPS = 2, 20


def _example(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ZOO = _example("torch_serve_swap")
REF_ZOO = _example("serve_swap")


def configs(arch: str, dtype: str):
    """(JAX config, port config): reduced (narrow for bf16 recurrentgemma),
    with an 8-token sliding window."""
    def make(get):
        cfg = get(arch)
        if arch == "recurrentgemma-2b" and dtype == "bfloat16":
            return cfg.replace(sliding_window=WINDOW, **NARROW)
        return cfg.scaled_down(layers=2, width_div=16, vocab=512).replace(
            dtype=dtype, sliding_window=WINDOW)
    return make(jax_config), make(get_config)


@functools.lru_cache(maxsize=None)
def models(arch: str, dtype: str):
    """(JAX config, port config, JAX params, port params): one set of
    values, made by the JAX package and carried across."""
    jc, pc = configs(arch, dtype)
    params = jax.jit(lambda: jax_init_state(jax.random.key(0), jc))()[
        "params"]
    return jc, pc, params, state_from_numpy(
        jax.tree.map(np.asarray, params), device="cpu")


def _tokens(cfg, shape, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def _flat(tree) -> list:
    """[(key path, numpy leaf)] in JAX order, for either package's tree."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(np.asarray, state_to_numpy(tree)))
    return [(jax.tree_util.keystr(p), x) for p, x in flat]


def _close(got, want, dtype):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, want, **F32)
    else:
        err = np.abs(got - want).max() / (np.abs(want).max() + 1e-12)
        assert err <= BF16_TOL, err


# ------------------------------------------------------------ caches
@pytest.mark.parametrize("arch", ARCHS)
def test_init_cache_matches_reference(arch):
    """Key names, stacking over groups, shapes and dtypes (bf16 k/v, f32
    RG-LRU state, int32 ``pos`` of shape (num_groups,)); all zeros."""
    jc = jax_config(arch).scaled_down(layers=2, width_div=16, vocab=512)
    pc = get_config(arch).scaled_down(layers=2, width_div=16, vocab=512)
    want = _flat(JT.init_cache(jc, 3, 40))
    got = _flat(T.init_cache(pc, 3, 40, device="cpu"))
    assert [k for k, _ in got] == [k for k, _ in want]
    for (k, g), (_, w) in zip(got, want):
        assert (g.dtype, g.shape) == (w.dtype, w.shape), k
        assert not g.any(), k
    assert any(k.endswith("['pos']") and x.shape == (pc.num_groups,)
               for k, x in got)


def test_init_cache_defaults_to_the_card():
    import inspect
    assert inspect.signature(T.init_cache).parameters["device"].default \
        == "cuda"


# ------------------------------------------------------------ decode
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_matches_reference(arch, dtype):
    """20 decode steps from the same caches: logits and every cache leaf
    after each step. With an 8-token window the local blocks' ring buffer
    wraps (recurrentgemma, gemma2); the global blocks fill a linear one."""
    jc, pc, jparams, params = models(arch, dtype)
    tokens = _tokens(pc, (B, STEPS))
    jcache = JT.init_cache(jc, B, STEPS)
    cache = T.init_cache(pc, B, STEPS, device="cpu")
    dec = jax.jit(lambda p, c, t, pos: JT.decode_step(p, jc, c, t, pos))
    for t in range(STEPS):
        pos = np.full((B, 1), t, np.int32)
        want, jcache = dec(jparams, jcache, jnp.asarray(tokens[:, t:t + 1]),
                           jnp.asarray(pos))
        got, cache = T.decode_step(params, pc, cache,
                                   torch.from_numpy(tokens[:, t:t + 1]),
                                   torch.from_numpy(pos))
        assert got.dtype == torch.float32 and got.shape == (B, 1,
                                                             pc.vocab_size)
        _close(got.numpy(), want, dtype)
        g, w = _flat(cache), _flat(jcache)
        assert [k for k, _ in g] == [k for k, _ in w]
        for (k, gl), (_, wl) in zip(g, w):
            assert (gl.dtype, gl.shape) == (wl.dtype, wl.shape), k
            if k.endswith("['pos']"):
                np.testing.assert_array_equal(gl, wl)
            else:
                _close(gl, wl, dtype)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_reference(arch):
    """``make_prefill_step``: the last position's logits only."""
    jc, pc, jparams, params = models(arch, "float32")
    tokens = _tokens(pc, (B, 16), seed=1)
    want = jax.jit(jax_prefill_step(jc))(jparams,
                                         {"tokens": jnp.asarray(tokens)})
    got = make_prefill_step(pc)(params, {"tokens": torch.from_numpy(tokens)})
    assert got.shape == (B, 1, pc.vocab_size) and got.dtype == torch.float32
    _close(got.numpy(), want, "float32")


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch):
    """Within the port, in bf16: token-by-token decode with the cache
    against the teacher-forced forward, past the ring buffer's wrap."""
    pc = get_config(arch).scaled_down(layers=13 if arch ==
                                      "recurrentgemma-2b" else 2,
                                      width_div=16, vocab=128).replace(
        sliding_window=WINDOW)
    params = init_train_state(pc, seed=1, device="cpu")["params"]
    tokens = torch.from_numpy(_tokens(pc, (B, STEPS), seed=2))
    full, _ = T.forward(params, pc, tokens)
    cache = T.init_cache(pc, B, max_len=STEPS, device="cpu")
    serve = make_serve_step(pc)
    outs = []
    for t in range(STEPS):
        pos = torch.full((B, 1), t, dtype=torch.int32)
        logits, cache = serve(params, cache, tokens[:, t:t + 1], pos)
        outs.append(logits[:, 0])
    dec = torch.stack(outs, dim=1)
    rel = float((dec - full).abs().max()) / (float(full.abs().max()) + 1e-9)
    assert rel < DECODE_VS_FORWARD, rel


def test_serve_step_updates_the_cache_in_place():
    """The port's decode writes into the stacked buffers it was given (the
    reference returns new arrays) and advances every block's ``pos``."""
    _, pc, _, params = models("gemma2-9b", "float32")
    cache = T.init_cache(pc, B, 4, device="cpu")
    ks = [t for _, t in _flat_tensors(cache)]
    _, out = make_serve_step(pc)(params, cache, torch.zeros((B, 1),
                                                            dtype=torch.int32),
                                 torch.zeros((B, 1), dtype=torch.int32))
    assert all(a is b for a, (_, b) in zip(ks, _flat_tensors(out)))
    assert all(int(c["pos"][0]) == 1 for c in cache.values())
    assert all(bool(c["k"][:, :, 0].any()) and not c["k"][:, :, 1:].any()
               for c in cache.values())


def _flat_tensors(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _flat_tensors(tree[k], f"{prefix}/{k}")]
    return [(prefix, tree)]


def test_generate_teacher_forces_then_decodes_greedily():
    """``steps.generate``: the prompt's last decode logits agree
    with the prefill's (the smoke's check on the card), and the generated
    tokens are the argmax chain."""
    pc = ZOO.zoo_config("qwen2.5-3b").replace(dtype="float32")
    params = init_train_state(pc, seed=ZOO.zoo_seed("qwen2.5-3b"),
                              device="cpu")["params"]
    prompt = torch.from_numpy(_tokens(pc, (3, 8), seed=3))
    rec = {}
    toks = generate(pc, params, prompt, steps=5, record=rec)
    assert toks.shape == (3, 5) and toks.dtype == torch.int32
    assert len(rec["step_s"]) == 8 + 5 - 1
    pre = make_prefill_step(pc)(params, {"tokens": prompt})
    torch.testing.assert_close(rec["prompt_logits"], pre, **F32)
    assert torch.equal(toks[:, :1], pre.argmax(-1).to(torch.int32))
    full, _ = T.forward(params, pc, torch.cat([prompt, toks[:, :-1]], 1))
    assert torch.equal(full[:, 7:].argmax(-1).to(torch.int32), toks)


# ------------------------------------------------------------ zoo
@pytest.mark.parametrize("arch", ZOO.ARCHS)
def test_zoo_round_trip_across_packages(tmp_path, arch):
    """The JAX package saves a zoo entry; the port swaps it in bit-exactly;
    the light update in both packages delta-saves the same written bytes,
    dirty chunks and chunk files; and the re-swapped model decodes to the
    reference's logits."""
    jc = jax_config(arch).scaled_down(layers=2, width_div=16, vocab=512)
    pc = ZOO.zoo_config(arch)
    jparams = jax.jit(lambda: jax_init_state(
        jax.random.key(ZOO.zoo_seed(arch) % 2**31), jc))()["params"]
    kw = dict(delta=True, keep=2, delta_chunk_bytes=ZOO.DELTA_CHUNK)
    for pkg in ("ref", "port"):
        with RefManager(str(tmp_path / pkg / arch), **kw) as mgr:
            mgr.save(0, {"params": jparams})
    jtmpl = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
                         jparams)
    tmpl = init_train_state(pc, device="meta")["params"]

    with RefManager(str(tmp_path / "ref" / arch), **kw) as mgr:
        rp = mgr.restore(state_template={"params": jtmpl})["params"]
        rp, rtouched = REF_ZOO._light_update(rp)
        rm = mgr.save(1, {"params": rp})
    with ZOO._manager(str(tmp_path / "port"), arch, "cpu") as mgr:
        pp = mgr.restore(state_template={"params": tmpl})["params"]
        assert leaves_bytes(pp) == leaves_bytes(jparams)
        pp, touched = ZOO._light_update(pp)
        m = mgr.save(1, {"params": pp})
    assert leaves_bytes(pp) == leaves_bytes(rp)
    assert touched == rtouched
    assert (m.written_bytes, m.chunks_dirty, m.chunks_total, m.total_bytes) \
        == (rm.written_bytes, rm.chunks_dirty, rm.chunks_total,
            rm.total_bytes)
    assert 0 < m.chunks_dirty < m.chunks_total
    files = {pkg: sorted(dir_files(str(tmp_path / pkg / arch /
                                       "chunkstore")).values())
             for pkg in ("ref", "port")}
    assert files["ref"] == files["port"] and files["port"]

    with ZOO._manager(str(tmp_path / "port"), arch, "cpu") as mgr:
        pp = mgr.restore(state_template={"params": tmpl})["params"]
    assert leaves_bytes(pp) == leaves_bytes(rp)
    tokens = _tokens(pc, (4, 8), seed=4)
    dec = jax.jit(lambda p, c, t, pos: JT.decode_step(p, jc, c, t, pos))
    jcache = JT.init_cache(jc, 4, 8)
    cache = T.init_cache(pc, 4, 8, device="cpu")
    for t in range(8):
        pos = np.full((4, 1), t, np.int32)
        want, jcache = dec(rp, jcache, jnp.asarray(tokens[:, t:t + 1]),
                           jnp.asarray(pos))
        got, cache = T.decode_step(pp, pc, cache,
                                   torch.from_numpy(tokens[:, t:t + 1]),
                                   torch.from_numpy(pos))
        _close(got.numpy(), want, "bfloat16")


def test_example_serves_the_zoo_on_the_cpu(tmp_path):
    """``examples/torch_serve_swap.main``: six round-robin swap-ins, then a
    delta update of each model that moves only its dirty chunks, and a
    re-swap."""
    out = ZOO.main(str(tmp_path), device="cpu")
    assert [s["arch"] for s in out["swaps"]] == ZOO.ARCHS * 3
    assert all(s["tokens"] == 4 * 12 and s["bytes"] > 0
               for s in out["swaps"])
    for u in out["updates"]:
        assert 0 < u["chunks_dirty"] < u["chunks_total"]
        assert u["touched"] <= u["written_bytes"] < u["total_bytes"]

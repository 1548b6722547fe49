"""The port's xLSTM blocks on the CPU against the JAX package: mLSTM in its
quadratic and chunkwise forms, the mLSTM and sLSTM blocks, the float32 ``k``
of the reference, and a reduced xlstm-350m (four heads) — forward, loss and
every grad, the decode caches step by step, prefill, decode against the
forward — plus a ``Trainer`` run checkpointed by either package and resumed
by the other, and the training CLI's default architecture.

Inputs are made from a seed with numpy; weights are the JAX package's,
carried across with ``state_from_numpy``; the JAX side is jitted.
Tolerances: float32 — rtol 1e-4 (atol 1e-5) on activations, logits and
cache leaves, 1e-3 on grads; bfloat16 — the largest difference within 2%
of the largest value for one layer (``tests/test_torch_model.py``), 5% for
logits and cache leaves after four layers and 6% for grads
(``tests/_torch_models.py``); the chunkwise mLSTM against the quadratic
form within 0.02, the reference's own tolerance (``tests/test_models.py``).
"""

import math
import os
import shutil

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from _torch_models import (DECODE_VS_FORWARD, carried, check_decode_steps,
                           check_forward, check_init_cache,
                           check_loss_and_grads, check_prefill, close,
                           decode_vs_forward, group0)
from _torch_port import (leaves_bytes, port_config, port_manager,
                         ref_config)
from repro.configs import get_config as jax_config
from repro.core import CheckpointManager as RefManager
from repro.data import DataConfig as JaxDataConfig
from repro.models import layers as JL
from repro.train.trainer import Trainer as JaxTrainer
from repro.train.trainer import TrainerConfig as JaxTrainerConfig
from repro_torch.configs import get_config
from repro_torch.data import DataConfig
from repro_torch.launch import train as launch_train
from repro_torch.models import layers as L, transformer as T
from repro_torch.train.steps import init_train_state, make_serve_step
from repro_torch.train.trainer import Trainer, TrainerConfig

ARCH = "xlstm-350m"
DTYPES = ("float32", "bfloat16")
NP_DTYPE = {"float32": np.float32, "bfloat16": ml_dtypes.bfloat16}
TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}
ONE_LAYER_BF16 = 2e-2


def configs(dtype: str = "float32"):
    """(JAX config, port config): xlstm-350m reduced to two groups of
    (mLSTM, sLSTM) and d_model 64, with its four heads (up-projection 128,
    mLSTM head dim 32: sqrt(32), like the full model's sqrt(512), is not a
    power of two)."""
    def make(get):
        return get(ARCH).scaled_down(layers=4, width_div=16, vocab=512) \
            .replace(num_heads=4, num_kv_heads=4, head_dim=16, dtype=dtype)
    return make(jax_config), make(get_config)


_MODELS: dict = {}


def models(dtype: str):
    """(JAX config, port config, JAX params, port params), made once."""
    if dtype not in _MODELS:
        jc, pc = configs(dtype)
        _MODELS[dtype] = (jc, pc) + carried(jc)
    return _MODELS[dtype]


def _gates(rng, shape):
    """Seeded (logi, logf) float32: log input gates and log-sigmoid
    forget gates near the reference's init (forget bias 3)."""
    logi = rng.standard_normal(shape).astype(np.float32)
    pre = (rng.standard_normal(shape) + 2).astype(np.float32)
    logf = -np.logaddexp(0.0, -pre.astype(np.float64)).astype(np.float32)
    return logi, logf


def _mlstm_inputs(dtype, B=2, S=64, H=2, D=32, seed=0):
    """q, v in ``dtype`` and k float32 (as ``_mlstm_qkv`` gives them), the
    gates float32, all numpy."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, S, H, D)).astype(np.float32)
               for _ in range(3))
    logi, logf = _gates(rng, (B, S, H))
    return (q.astype(NP_DTYPE[dtype]), k / np.float32(math.sqrt(D)),
            v.astype(NP_DTYPE[dtype]), logi, logf)


def _jax(*xs):
    return [jnp.asarray(x) for x in xs]


def _torch(*xs):
    return [torch.from_numpy(np.asarray(x).astype(np.float32)).to(
        torch.bfloat16) if x.dtype == ml_dtypes.bfloat16
        else torch.from_numpy(x) for x in xs]


# ------------------------------------------------------------ mLSTM
@pytest.mark.parametrize("dtype", DTYPES)
def test_mlstm_sequence_matches_reference(dtype):
    xs = _mlstm_inputs(dtype)
    want = jax.jit(JL.mlstm_sequence)(*_jax(*xs))
    got = L.mlstm_sequence(*_torch(*xs))
    assert got.dtype == torch.float32
    close(got, want, dtype, bf16_tol=ONE_LAYER_BF16)


@pytest.mark.parametrize("dtype", DTYPES)
def test_mlstm_chunked_matches_reference(dtype):
    """S = 64 in four chunks of 16: the (C, N, M) carry crosses three
    chunk boundaries."""
    xs = _mlstm_inputs(dtype, seed=1)
    want = jax.jit(lambda *a: JL._mlstm_chunked(*a, chunk=16))(*_jax(*xs))
    got = L._mlstm_chunked(*_torch(*xs), chunk=16)
    close(got, want, dtype, bf16_tol=ONE_LAYER_BF16)


def test_mlstm_chunked_matches_quadratic():
    """Within the port, the reference's test: the chunkwise form against
    the quadratic one (rtol and atol 0.02)."""
    rng = np.random.default_rng(0)
    B, S, H, D = 2, 64, 2, 16
    q, k, v = (torch.from_numpy(rng.standard_normal((B, S, H, D)).astype(
        np.float32)) for _ in range(3))
    logi, logf = (torch.from_numpy(x) for x in _gates(rng, (B, S, H)))
    full = L.mlstm_sequence(q, k, v, logi, logf)
    chunked = L._mlstm_chunked(q, k, v, logi, logf, chunk=16)
    torch.testing.assert_close(chunked, full, rtol=0.02, atol=0.02)


def test_mlstm_chunked_needs_whole_chunks():
    """S not a multiple of the chunk: the reference asserts, the port
    raises ValueError."""
    xs = _mlstm_inputs("float32", S=40)
    with pytest.raises(AssertionError, match="chunk-divisible"):
        JL._mlstm_chunked(*_jax(*xs), chunk=16)
    with pytest.raises(ValueError, match="multiple of the mLSTM chunk"):
        L._mlstm_chunked(*_torch(*xs), chunk=16)


def _x(dtype, shape, seed):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return x.astype(NP_DTYPE[dtype])


@pytest.mark.parametrize("S", [63, 512], ids=["quadratic", "chunked"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_mlstm_block_matches_reference(dtype, S):
    """The whole block: S = 63 takes the quadratic form, S = 512 the
    chunkwise one (two chunks of 256)."""
    jc, pc, jparams, params = models(dtype)
    jp = jax.tree.map(lambda x: x[0], jparams["blocks"]["b0_mlstm"])
    tp = group0(params["blocks"]["b0_mlstm"])
    x = _x(dtype, (1 if S > 256 else 2, S, pc.d_model), 3)
    want, _ = jax.jit(lambda p, x: JL.mlstm_apply(p, x, jc))(
        jp, jnp.asarray(x))
    got, cache = L.mlstm_apply(tp, _torch(x)[0], pc)
    assert cache is None and got.dtype == TORCH_DTYPE[dtype]
    close(got, want, dtype, bf16_tol=ONE_LAYER_BF16)


@pytest.mark.parametrize("dtype", DTYPES)
def test_slstm_block_matches_reference(dtype):
    jc, pc, jparams, params = models(dtype)
    jp = jax.tree.map(lambda x: x[0], jparams["blocks"]["b1_slstm"])
    tp = group0(params["blocks"]["b1_slstm"])
    x = _x(dtype, (2, 63, pc.d_model), 4)
    want, _ = jax.jit(lambda p, x: JL.slstm_apply(p, x, jc))(
        jp, jnp.asarray(x))
    got, _ = L.slstm_apply(tp, _torch(x)[0], pc)
    assert got.dtype == TORCH_DTYPE[dtype]
    close(got, want, dtype, bf16_tol=ONE_LAYER_BF16)


def test_mlstm_k_is_float32_for_a_bf16_model():
    """The reference divides the bf16 ``k`` by ``np.sqrt(hd)``, a numpy
    float64 scalar that JAX does not treat as weak, so ``k`` is float32;
    torch keeps ``bf16 / float`` in bf16, so the port casts first. The
    port's ``k`` is the reference's, not rounded to bf16 after the
    division."""
    jc, pc, jparams, params = models("bfloat16")
    jp = jax.tree.map(lambda x: x[0], jparams["blocks"]["b0_mlstm"])
    tp = group0(params["blocks"]["b0_mlstm"])
    h = _x("bfloat16", (2, 9, 2 * pc.d_model), 5)
    _, jk, *_ = JL._mlstm_qkv(jp, jnp.asarray(h), jc)
    _, k, *_ = L._mlstm_qkv(tp, _torch(h)[0], pc)
    assert jk.dtype == jnp.float32 and k.dtype == torch.float32
    assert (jnp.asarray(h) / np.sqrt(32)).dtype == jnp.float32
    close(k, jk, "float32", rtol=1e-2, atol=1e-2)
    # the division happened in float32: most values are not bf16 values
    assert float((k != k.bfloat16().float()).float().mean()) > 0.9


def test_cast_params_keeps_gate_biases_float32():
    """``b_igate``/``b_fgate`` (mLSTM) and ``b_{i,f,z,o}`` (sLSTM) stay
    float32 in a bf16 model, as the reference's ``cast_params`` keeps
    them; every weight is bf16."""
    _, pc = configs("bfloat16")
    params = init_train_state(pc, device="meta")["params"]["blocks"]
    keep = {"b_igate", "b_fgate", "b_i", "b_f", "b_z", "b_o", "scale"}
    for block in params.values():
        for name, leaf in block.items():
            if isinstance(leaf, dict):
                assert leaf["scale"].dtype == torch.float32
            else:
                want = torch.float32 if name in keep else torch.bfloat16
                assert leaf.dtype == want, name


# ------------------------------------------------------------ whole model
@pytest.mark.parametrize("dtype", DTYPES)
def test_forward_matches_reference(dtype):
    check_forward(*models(dtype), dtype)


def test_loss_and_every_grad_match_reference():
    """float32 only: in bf16 the small, cancelling gate-bias grads are
    noise in both packages (the reference's own bf16 grad of the sLSTM's
    ``b_i`` lies 15% of its largest value from its float32 grad of the same
    weights, the port's 3.7%), so a bf16 comparison would measure that
    noise."""
    check_loss_and_grads(*models("float32"), "float32")


# ------------------------------------------------------------ serving
def test_init_cache_matches_reference():
    """b{j}_mlstm/{C,N,M} and b{j}_slstm/{c,n,m,h}, float32 zeros stacked
    over the groups; M starts at 0, as in the reference (the chunkwise
    carry starts at NEG instead)."""
    jc, pc = configs()
    got = dict(check_init_cache(jc, pc))
    assert got["['b0_mlstm']['M']"].shape == (pc.num_groups, 3, 4)
    assert got["['b0_mlstm']['C']"].shape == (pc.num_groups, 3, 4, 32, 32)
    assert got["['b1_slstm']['h']"].shape == (pc.num_groups, 3, pc.d_model)
    assert L.NEG == -1e30


@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_step_matches_reference(dtype):
    """20 decode steps from the same caches: logits and every mLSTM and
    sLSTM cache leaf after each step."""
    check_decode_steps(*models(dtype), dtype)


def test_prefill_matches_reference():
    check_prefill(*models("float32"))


def test_decode_matches_forward():
    """The reference's own test at its reduced size (2 layers, width / 16,
    vocab 128), in bf16, within the port."""
    pc = get_config(ARCH).scaled_down(layers=2, width_div=16, vocab=128)
    assert decode_vs_forward(pc) < DECODE_VS_FORWARD


def test_decode_updates_the_caches_in_place():
    """The mLSTM and sLSTM caches are written into the stacked buffers the
    server passed (the reference returns new arrays)."""
    _, pc, _, params = models("float32")
    cache = T.init_cache(pc, 2, 4, device="cpu")
    before = {k: t for k, t in _leaves(cache)}
    _, out = make_serve_step(pc)(params, cache,
                                 torch.ones((2, 1), dtype=torch.int32),
                                 torch.zeros((2, 1), dtype=torch.int32))
    assert {k: t for k, t in _leaves(out)}.keys() == before.keys()
    assert all(t is before[k] for k, t in _leaves(out))
    assert all(bool(t.any()) for k, t in _leaves(out)
               if not k.endswith("/M"))


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _leaves(tree[k], f"{prefix}/{k}")]
    return [(prefix, tree)]


# ------------------------------------------------------------ training
DATA = dict(vocab_size=512, seq_len=32, global_batch=2, seed=0)


def _jax_trainer(d, steps):
    jc, _ = configs()
    return JaxTrainer(jc, JaxTrainerConfig(
        steps=steps, ckpt_every=2, ckpt_dir=str(d), async_ckpt=False,
        log_every=1, keep=None), engine_config=ref_config(),
        data_cfg=JaxDataConfig(**DATA))


def _port_trainer(d, steps):
    _, pc = configs()
    return Trainer(pc, TrainerConfig(
        steps=steps, ckpt_every=2, ckpt_dir=str(d), async_ckpt=False,
        log_every=1, keep=None), engine_config=port_config(),
        data_cfg=DataConfig(**DATA), device="cpu")


def _run(trainer, initial=None):
    try:
        return trainer.run(initial) if initial is not None else trainer.run()
    finally:
        trainer.close()


def _losses(out) -> dict:
    return {m["step"]: m["loss"] for m in out["metrics"]}


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_run_resumes_across_packages(tmp_path, writer):
    """Reduced xlstm-350m: one package trains 4 steps uninterrupted,
    checkpointing at 2 and 4; the other resumes its step 2. The step
    restores to the same bytes through either package (and through the
    port's Trainer), and the resumed losses at steps 2 and 3 are the
    uninterrupted run's (rtol 1e-4)."""
    full, resume = tmp_path / "full", tmp_path / "resume"
    make_writer, make_reader = ((_jax_trainer, _port_trainer)
                                if writer == "jax"
                                else (_port_trainer, _jax_trainer))
    straight = _run(make_writer(full, 4))
    assert sorted(_losses(straight)) == [0, 1, 2, 3]
    os.makedirs(resume)
    shutil.copytree(full / "step_00000002", resume / "step_00000002")

    with RefManager(str(resume), config=ref_config()) as m:
        by_jax = leaves_bytes(m.restore(step=2))
    with port_manager(resume) as m:
        assert leaves_bytes(m.restore(step=2)) == by_jax

    reader = make_reader(resume, 4)
    initial = None
    if writer == "jax":
        initial = reader.initial_state()
        assert initial[1] == 2
        assert leaves_bytes({"train": initial[0],
                             "data": reader.pipeline.state_dict()}) == by_jax
    out = _run(reader, initial)
    assert int(np.asarray(out["state"]["step"])) == 4
    resumed = _losses(out)
    assert sorted(resumed) == [2, 3]
    for s in (2, 3):
        np.testing.assert_allclose(resumed[s], _losses(straight)[s],
                                   rtol=1e-4)


def test_launch_train_defaults_to_xlstm(tmp_path):
    """The CLI's default architecture is the reference's, xlstm-350m, and
    its reduced default trains and checkpoints on the CPU."""
    assert launch_train.parser().parse_args([]).arch == ARCH
    out = tmp_path / "out.json"
    launch_train.main(["--device", "cpu", "--steps", "2", "--batch", "2",
                       "--seq-len", "16", "--ckpt-every", "2",
                       "--log-every", "1", "--buffered",
                       "--ckpt-dir", str(tmp_path / "ckpt"),
                       "--json-out", str(out)])
    with port_manager(tmp_path / "ckpt") as m:
        params = m.restore(step=2)["train"]["params"]["blocks"]
    assert sorted(params) == ["b0_mlstm", "b1_slstm"]

"""The port's training stack on the CPU against the JAX package: one AdamW
update, one train step, the synthetic batches, and a run checkpointed by
either package's ``Trainer`` resumed by the other's.

Tolerances (float32): moments and params after one update rtol 1e-5 and
atol 1e-6 of the leaf's largest value (the same elementwise formula, whose
moment sum may cancel); after a train step the loss rtol 1e-5 and the
grads' image in the moments rtol 1e-3 (matmul and scan sums in other
orders); losses of resumed steps rtol 1e-4. Restored leaves: bit-exact.
"""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import (leaves_bytes, port_config, port_manager,
                         ref_config, to_numpy)
from repro.configs import get_config as jax_config
from repro.core import CheckpointManager as RefManager
from repro.data import DataConfig as JaxDataConfig
from repro.data import SyntheticPipeline as JaxPipeline
from repro.optim import AdamWConfig as JaxAdamW
from repro.optim import apply_updates as jax_apply_updates
from repro.train.steps import (init_train_state as jax_init_state,
                               make_train_step as jax_train_step)
from repro.train.trainer import Trainer as JaxTrainer
from repro.train.trainer import TrainerConfig as JaxTrainerConfig
from repro_torch.configs import get_config
from repro_torch.core.serialization import state_from_numpy
from repro_torch.data import DataConfig, SyntheticPipeline
from repro_torch.launch import train as launch_train
from repro_torch.optim import AdamWConfig, apply_updates
from repro_torch.train.steps import init_train_state, make_train_step
from repro_torch.train.trainer import Trainer, TrainerConfig
from test_torch_model import NARROW


def configs():
    return (jax_config("recurrentgemma-2b").replace(dtype="float32",
                                                    **NARROW),
            get_config("recurrentgemma-2b").replace(dtype="float32",
                                                    **NARROW))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


# ---------------------------------------------------------------- AdamW
def test_apply_updates_matches_jax():
    """Clip active (global norm > 1), past warmup's start, bf16 and f32
    leaves; params and moments updated in place."""
    import ml_dtypes
    rng = np.random.default_rng(0)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)
    params = {"w": f32(33, 70).astype(ml_dtypes.bfloat16), "b": f32(70)}
    grads = {"w": (f32(33, 70) * 3).astype(ml_dtypes.bfloat16),
             "b": f32(70) * 3}
    opt = {"mu": {"w": f32(33, 70) * 1e-2, "b": f32(70) * 1e-2},
           "nu": {"w": np.abs(f32(33, 70)) * 1e-3,
                  "b": np.abs(f32(70)) * 1e-3},
           "count": np.asarray(4, np.int32)}
    cfg = dict(lr=1e-3, warmup_steps=10)
    jp, jopt, jm = jax_apply_updates(
        JaxAdamW(**cfg), jax.tree.map(jnp.asarray, params),
        jax.tree.map(jnp.asarray, grads), jax.tree.map(jnp.asarray, opt))
    tp, tg, topt = (state_from_numpy(t, device="cpu")
                    for t in (params, grads, opt))
    w_before = tp["w"]
    tm = apply_updates(AdamWConfig(**cfg), tp, tg, topt)
    assert tp["w"] is w_before and tp["w"].dtype == torch.bfloat16
    assert int(topt["count"]) == 5
    for k in ("grad_norm", "lr"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-6)
    assert float(tm["grad_norm"]) > 1.0
    got = jax.tree_util.tree_flatten_with_path(
        to_numpy({"params": tp, "opt": topt}))[0]
    want = jax.tree_util.tree_flatten_with_path(
        _np({"params": jp, "opt": jopt}))[0]
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        g, w = np.asarray(g, np.float32), np.asarray(w, np.float32)
        # atol: b1*mu + (1-b1)*g may cancel to a few ulps of its terms
        np.testing.assert_allclose(g, w, rtol=1e-5,
                                   atol=1e-6 * np.abs(w).max(),
                                   err_msg=str(path))


def test_train_step_matches_jax():
    """One fwd + bwd + AdamW step of the narrow float32 model, both packages
    from the same params and batch (warmup 1: the full learning rate)."""
    jc, pc = configs()
    state = jax.jit(lambda: jax_init_state(jax.random.key(1), jc))()
    tstate = state_from_numpy(_np(state), device="cpu")
    embed_before = tstate["params"]["embed"].clone()
    batch = JaxPipeline(JaxDataConfig(512, 32, 2, seed=3)).batch_at(0)
    opt = dict(warmup_steps=1)
    jstate, jm = jax.jit(jax_train_step(jc, JaxAdamW(**opt)))(
        state, {k: jnp.asarray(v) for k, v in batch.items()})
    tstate, tm = make_train_step(pc, AdamWConfig(**opt))(
        tstate, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-3)
    assert int(tstate["step"]) == 1 and int(tstate["opt"]["count"]) == 1
    # mu = 0.1 * clipped grad: every grad, through the moments
    got = to_numpy(tstate)
    for key in ("mu", "nu"):
        jl = jax.tree_util.tree_leaves(_np(jstate["opt"][key]))
        tl = jax.tree_util.tree_leaves(got["opt"][key])
        for a, b in zip(tl, jl):
            np.testing.assert_allclose(a, b, rtol=1e-3,
                                       atol=1e-3 * np.abs(b).max())
    # the update moved the params by lr-sized steps, as the reference's did
    delta = got["params"]["embed"] - embed_before.numpy()
    jdelta = np.asarray(jstate["params"]["embed"]) - \
        np.asarray(state["params"]["embed"])
    assert np.abs(delta).max() > 1e-4
    np.testing.assert_allclose(delta, jdelta, rtol=1e-2, atol=1e-6)


def test_microbatches_accumulate_the_full_batch_gradient():
    """Two microbatches of one batch give the one-batch loss and update
    (float32: the grads are summed in another order)."""
    _, pc = configs()
    batch = {k: torch.from_numpy(v) for k, v in
             SyntheticPipeline(DataConfig(512, 16, 4, seed=1)).batch_at(0)
             .items()}
    out = {}
    for mb in (1, 2):
        state = init_train_state(pc, seed=2, device="cpu")
        state, m = make_train_step(pc, AdamWConfig(warmup_steps=1),
                                   microbatches=mb)(state, batch)
        out[mb] = (float(m["loss"]), state["opt"]["mu"]["embed"])
    np.testing.assert_allclose(out[2][0], out[1][0], rtol=1e-5)
    torch.testing.assert_close(out[2][1], out[1][1], rtol=1e-3,
                               atol=1e-3 * float(out[1][1].abs().max()))


# ----------------------------------------------------------------- data
@pytest.mark.parametrize("host_index,host_count", [(0, 1), (1, 2)])
def test_batches_match_jax(host_index, host_count):
    for seed, step in ((0, 0), (5, 17)):
        want = JaxPipeline(JaxDataConfig(300, 64, 4, seed=seed),
                           host_index, host_count).batch_at(step)
        got = SyntheticPipeline(DataConfig(300, 64, 4, seed=seed),
                                host_index, host_count).batch_at(step)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


# -------------------------------------------------- cross-package resume
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


def _step2_only(src, dst):
    """A directory holding only the step-2 checkpoint of ``src``."""
    os.makedirs(dst)
    shutil.copytree(os.path.join(src, "step_00000002"),
                    os.path.join(dst, "step_00000002"))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_run_resumes_across_packages(tmp_path, writer):
    """One package trains 4 steps uninterrupted, checkpointing at 2 and 4;
    the other resumes its step 2: the step restores to the same bytes
    through either package (and through the port's Trainer), and the
    resumed losses at steps 2 and 3 are the uninterrupted run's."""
    full, resume = tmp_path / "full", tmp_path / "resume"
    make_writer, make_reader = ((_jax_trainer, _port_trainer)
                                if writer == "jax"
                                else (_port_trainer, _jax_trainer))
    straight = _run(make_writer(full, 4))
    assert sorted(_losses(straight)) == [0, 1, 2, 3]
    _step2_only(str(full), str(resume))

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


def test_unported_checkpointers_raise(tmp_path):
    _, pc = configs()
    for kw, slice_ in ((dict(multilevel_remote=str(tmp_path)), "A3"),
                       (dict(ckpt_writers=2, ckpt_every=1), "A2")):
        with pytest.raises(NotImplementedError, match=slice_):
            Trainer(pc, TrainerConfig(ckpt_dir=str(tmp_path), **kw),
                    device="cpu")


def test_launch_train_on_the_cpu(tmp_path, capsys):
    """``python -m repro_torch.launch.train --device cpu``: a reduced
    recurrentgemma trains and checkpoints, and a second run resumes."""
    def args(steps):
        return ["--device", "cpu", "--steps", str(steps), "--batch", "2",
                "--seq-len", "16", "--width-div", "32", "--vocab", "64",
                "--ckpt-every", "2", "--log-every", "1", "--buffered",
                "--ckpt-dir", str(tmp_path / "ckpt"),
                "--json-out", str(tmp_path / "out.json")]

    launch_train.main(args(2))
    assert os.path.isdir(tmp_path / "ckpt" / "step_00000002")
    launch_train.main(args(3))
    with open(tmp_path / "out.json") as f:
        assert [m["step"] for m in json.load(f)["metrics"]] == [2]
    assert "loss:" in capsys.readouterr().out

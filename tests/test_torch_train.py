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
from repro_torch.core import MultiWriterCheckpointer
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
    """``ckpt_writers > 1`` builds the multi-writer checkpointer (ported
    now); with a level-1 directory it is refused as in the reference (the
    two-level flusher wraps one manager)."""
    _, pc = configs()
    t = Trainer(pc, TrainerConfig(ckpt_dir=str(tmp_path), ckpt_writers=2,
                                  ckpt_every=1), device="cpu")
    assert isinstance(t.ckpt, MultiWriterCheckpointer)
    assert t.ckpt.num_ranks == 2 and t.ckpt.managers[1].device.type == "cpu"
    t.close()
    with pytest.raises(ValueError, match="mutually exclusive"):
        Trainer(pc, TrainerConfig(ckpt_dir=str(tmp_path), ckpt_writers=2,
                                  multilevel_remote=str(tmp_path / "l1")),
                device="cpu")


def _writers_trainer(pkg, d, steps, async_ckpt=False):
    jc, pc = configs()
    if pkg == "jax":
        return JaxTrainer(jc, JaxTrainerConfig(
            steps=steps, ckpt_every=2, ckpt_dir=str(d), async_ckpt=async_ckpt,
            log_every=1, keep=None, ckpt_writers=2),
            engine_config=ref_config(), data_cfg=JaxDataConfig(**DATA))
    return Trainer(pc, TrainerConfig(
        steps=steps, ckpt_every=2, ckpt_dir=str(d), async_ckpt=async_ckpt,
        log_every=1, keep=None, ckpt_writers=2),
        engine_config=port_config(), data_cfg=DataConfig(**DATA),
        device="cpu")


def test_multiwriter_trainer_resume_is_bit_exact(tmp_path):
    """``Trainer(ckpt_writers=2, async_ckpt=True)`` steps in place right
    after the snapshot barrier; a fresh single-writer Trainer resumes its
    step 2 and matches the uninterrupted run bit for bit (losses and
    params)."""
    t1 = _writers_trainer("port", tmp_path / "mw", 4, async_ckpt=True)
    saved = {}
    save = t1.ckpt.save

    def recording_save(step, state):
        saved[step] = leaves_bytes(state)
        return save(step, state)

    t1.ckpt.save = recording_save
    straight = _run(t1)
    assert sorted(saved) == [2, 4]
    resume = tmp_path / "resume"
    _step2_only(str(tmp_path / "mw"), str(resume))
    t2 = _port_trainer(resume, 4)
    initial = t2.initial_state()
    assert initial[1] == 2
    assert leaves_bytes({"train": initial[0],
                         "data": t2.pipeline.state_dict()}) == saved[2]
    assert initial[0]["step"].dtype is torch.int32
    out = _run(t2, initial)
    assert _losses(out) == {s: _losses(straight)[s] for s in (2, 3)}
    assert leaves_bytes(out["state"]) == leaves_bytes(straight["state"])


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_multiwriter_run_resumes_across_packages(tmp_path, writer):
    """Either package's ``Trainer(ckpt_writers=2)`` checkpoint of step 2
    resumes in the other's (a 2-writer Trainer too): the same restored
    bytes, and the resumed losses of the uninterrupted run."""
    full, resume = tmp_path / "full", tmp_path / "resume"
    reader = "port" if writer == "jax" else "jax"
    straight = _run(_writers_trainer(writer, full, 4))
    _step2_only(str(full), str(resume))
    with RefManager(str(resume), config=ref_config()) as m:
        by_jax = leaves_bytes(m.restore(step=2))
    with port_manager(resume) as m:
        assert leaves_bytes(m.restore(step=2)) == by_jax
    out = _run(_writers_trainer(reader, resume, 4))
    assert int(np.asarray(out["state"]["step"])) == 4
    resumed = _losses(out)
    assert sorted(resumed) == [2, 3]
    for s in (2, 3):
        np.testing.assert_allclose(resumed[s], _losses(straight)[s],
                                   rtol=1e-4)


def _multilevel_trainer(d, steps, level1):
    _, pc = configs()
    return Trainer(pc, TrainerConfig(
        steps=steps, ckpt_every=2, ckpt_dir=str(d), async_ckpt=False,
        log_every=1, keep=None, multilevel_remote=str(level1)),
        engine_config=port_config(), data_cfg=DataConfig(**DATA),
        device="cpu")


def test_multilevel_trainer_resumes_after_node_loss(tmp_path):
    """Run 1 checkpoints step 2 at level 0 and flushes it to level 1; level
    0 is lost; run 2 resumes step 2 through the prefetcher bit-exactly onto
    the trainer's device (promoting it to level 0) and trains on. The
    resumed state is what the reference Trainer restores from the same
    level-1 directory."""
    l0, l1 = tmp_path / "l0", tmp_path / "l1"
    t1 = _multilevel_trainer(l0, 3, l1)
    saved = {}
    save = t1.ckpt.save

    def recording_save(step, state):
        saved[step] = leaves_bytes(state)      # the save is synchronous
        return save(step, state)

    t1.ckpt.save = recording_save
    straight = _run(t1)
    assert list(saved) == [2]
    assert os.path.isdir(l1 / "step_00000002")
    shutil.rmtree(l0)
    os.makedirs(l0)

    jc, _ = configs()
    ref = JaxTrainer(jc, JaxTrainerConfig(
        steps=2, ckpt_every=2, ckpt_dir=str(tmp_path / "ref0"),
        async_ckpt=False, log_every=1, keep=None,
        multilevel_remote=str(l1)), engine_config=ref_config(),
        data_cfg=JaxDataConfig(**DATA))
    by_ref = _run(ref)             # restores step 2 and trains no step
    assert leaves_bytes({"train": by_ref["state"],
                         "data": ref.pipeline.state_dict()}) == saved[2]

    t2 = _multilevel_trainer(l0, 4, l1)
    initial = t2.initial_state()
    assert initial[1] == 2
    assert leaves_bytes({"train": initial[0],
                         "data": t2.pipeline.state_dict()}) == saved[2]
    assert t2.restore_attr["restore_seconds"] > 0
    assert os.path.isdir(l0 / "step_00000002")          # promoted
    out = _run(t2, initial)
    assert sorted(_losses(out)) == [2, 3]
    np.testing.assert_allclose(_losses(out)[2], _losses(straight)[2],
                               rtol=1e-4)


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


def test_launch_train_with_a_remote_dir_on_the_cpu(tmp_path):
    """``--remote-dir``: the step flushed to level 1 survives the loss of
    ``--ckpt-dir``, and the second run resumes from it (the promoted step
    holds level 1's bytes)."""
    ckpt, remote = tmp_path / "ckpt", tmp_path / "l1"

    def args(steps):
        return ["--device", "cpu", "--steps", str(steps), "--batch", "2",
                "--seq-len", "16", "--width-div", "32", "--vocab", "64",
                "--ckpt-every", "2", "--log-every", "1", "--buffered",
                "--ckpt-dir", str(ckpt), "--remote-dir", str(remote),
                "--json-out", str(tmp_path / "out.json")]

    launch_train.main(args(2))
    assert os.path.isdir(remote / "step_00000002")
    shutil.rmtree(ckpt)
    launch_train.main(args(3))
    with open(tmp_path / "out.json") as f:
        assert [m["step"] for m in json.load(f)["metrics"]] == [2]
    with port_manager(remote) as a, port_manager(ckpt) as b:
        assert leaves_bytes(a.restore(step=2)) == \
            leaves_bytes(b.restore(step=2))


def test_global_norm_adds_the_leaf_sums_in_leaf_order(tmp_path):
    """``global_norm`` adds each leaf's float32 sum of squares in leaf
    order, as the reference's ``global_norm`` does, and on a 1x1 mesh,
    whatever splits its DTensor leaves, the same bits: summed per split
    pattern first, the clip scale of a 1x1-mesh step differed from the
    unsharded one's by an ulp (these seeded leaves tell the two orders
    apart), which bf16 steps amplified into different losses."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.optim import global_norm
    rng = np.random.default_rng(1)
    leaves = [torch.from_numpy((rng.standard_normal(n) * scale).astype(
        np.float32)) for n, scale in ((300, 1.0), (50, 30.0), (700, 0.3),
                                      (20, 100.0))]
    total = torch.zeros(())
    for t in leaves:
        total = total + t.square().sum()
    plain = global_norm({f"l{i}": t for i, t in enumerate(leaves)})
    assert torch.equal(plain, torch.sqrt(total))
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    try:
        mesh = make_host_mesh(1, 1, device="cpu")
        tree = {f"l{i}": DTensor.from_local(
            t, mesh, (Replicate(), Shard(0) if i % 2 == 0 else Replicate()),
            run_check=False) for i, t in enumerate(leaves)}
        assert torch.equal(global_norm(tree), plain)
    finally:
        dist.destroy_process_group()

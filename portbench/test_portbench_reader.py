"""The reference's checkpoint reader against a checkpoint the port writes
on the CPU: digests equal to the saved state's, CRC faults caught."""

import os

import pytest
import torch

from portbench.reference import ckpt_reader
from portbench.weights import leaves


@pytest.fixture
def saved(tmp_path):
    from repro_torch.core import CheckpointManager
    g = torch.Generator().manual_seed(5)
    state = {"train": {"params": {"w": torch.randn(64, 33, generator=g)
                                  .to(torch.bfloat16),
                                  "s": torch.randn(7, generator=g)},
                       "step": torch.tensor(9, dtype=torch.int32)},
             "data": {"data_step": 9}}
    mgr = CheckpointManager(str(tmp_path), async_save=True, device="cpu")
    mgr.save(9, state)
    mgr.wait()
    mgr.close()
    return tmp_path, state


def test_digests_equal_the_state(saved):
    root, state = saved
    assert ckpt_reader.committed_steps(str(root)) == [9]
    files = ckpt_reader.step_digests(str(root), 9)
    want = {"train/" + k: ckpt_reader.digest(v)
            for k, v in leaves(state["train"]).items()}
    assert set(files) == set(want)
    for k in want:
        assert torch.equal(files[k], want[k]), k


def test_a_flipped_byte_is_caught(saved):
    root, _ = saved
    path = os.path.join(root, "step_00000009", "data", "checkpoint.bin")
    with open(path, "r+b") as f:
        f.seek(10)
        b = f.read(1)
        f.seek(10)
        f.write(bytes([b[0] ^ 1]))
    with pytest.raises(ValueError):
        ckpt_reader.read_step(str(root), 9)


def test_digest_sees_one_word():
    t = torch.arange(1000, dtype=torch.float32)
    u = t.clone()
    u[500] += 1
    assert not torch.equal(ckpt_reader.digest(t), ckpt_reader.digest(u))
    v = t.clone()
    v[[3, 4]] = v[[4, 3]]                  # a swap keeps the plain sum
    assert not torch.equal(ckpt_reader.digest(t), ckpt_reader.digest(v))

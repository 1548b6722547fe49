"""CheckpointManager of the port beyond the round trips: integrity checks,
retention, delta garbage collection, and the carried-over layers staying
what they were in the JAX package."""

import filecmp
import os

import numpy as np
import pytest
import torch

from repro_torch.core import (CheckpointManager, ChecksumError,
                              EngineConfig, ManifestError, delta)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cfg():
    return EngineConfig(backend="posix", direct=False)


def _state(seed: int):
    g = torch.Generator().manual_seed(seed)
    return {"w": torch.randn((64, 256), generator=g),
            "b": torch.randn(256, generator=g).to(torch.bfloat16),
            "step": torch.tensor(seed, dtype=torch.int32)}


def _same(a, b):
    return all(torch.equal(a[k].reshape(-1).view(torch.uint8),
                           b[k].reshape(-1).view(torch.uint8)) for k in a)


def test_device_defaults_to_cuda(tmp_path):
    mgr = CheckpointManager(str(tmp_path), config=_cfg())
    assert mgr.device == torch.device("cuda")
    mgr.close()


def test_crc_detects_a_flipped_data_byte(tmp_path):
    with CheckpointManager(str(tmp_path), config=_cfg(), device="cpu") as m:
        m.save(1, _state(1))
    data = os.path.join(tmp_path, "step_00000001", "data")
    path = os.path.join(data, sorted(os.listdir(data))[0])
    with open(path, "r+b") as f:
        f.seek(100)
        byte = f.read(1)
        f.seek(100)
        f.write(bytes([byte[0] ^ 0xFF]))
    with CheckpointManager(str(tmp_path), config=_cfg(), device="cpu") as m:
        with pytest.raises(ChecksumError):
            m.restore(step=1)


def test_retention_and_corrupt_manifest_fallback(tmp_path):
    with CheckpointManager(str(tmp_path), config=_cfg(), device="cpu",
                           keep=2) as m:
        for step in (1, 2, 3):
            m.save(step, _state(step))
        assert m.all_steps() == [2, 3]
    with open(os.path.join(tmp_path, "step_00000003", "manifest.json"),
              "wb") as f:
        f.write(b"{truncated")
    with CheckpointManager(str(tmp_path), config=_cfg(), device="cpu") as m:
        assert _same(m.restore(), _state(2))           # newest readable
        with pytest.raises(ManifestError):
            m.restore(step=3)


def test_delta_gc_keeps_referenced_chunks(tmp_path):
    kw = dict(config=_cfg(), device="cpu", delta=True, keep=1,
              delta_chunk_bytes=4096)
    with CheckpointManager(str(tmp_path), **kw) as m:
        m.delta_gc_grace_s = 0.0
        s = _state(5)
        m.save(1, s)
        s["w"][0] += 1
        m.save(2, s)                  # references most of step 1's pack
        assert m.all_steps() == [2]
        assert m.last_gc_stats.deleted == 0
        assert _same(m.restore(step=2), s)
        t = _state(6)                 # nothing left in common
        m.save(3, t)
        assert m.last_gc_stats.deleted == 2
        assert _same(m.restore(step=3), t)


def test_a_dtype_without_a_numpy_name_is_refused(tmp_path):
    with CheckpointManager(str(tmp_path), config=_cfg(), device="cpu") as m:
        with pytest.raises(TypeError, match="numpy"):
            m.save(1, {"x": torch.zeros(4, dtype=torch.complex32)})
        assert m.all_steps() == []


# the layers carried from repro.core, and the linter from repro.analysis
# (named relative to core), without a change (their copies must not drift;
# edited carries — faults, resharding, remote, engines/aggregated — are
# held by behaviour)
CARRIED = ["trace.py", "buffers.py", "uring.py", "manifest.py",
           "io_engine.py", "aggregation.py", "engines/base.py",
           "engines/__init__.py",
           "engines/datastates.py", "engines/snapshot.py",
           "engines/torchsave.py", "engines/remote.py", "tiered.py",
           "multilevel.py", "../analysis/crlint.py"]


@pytest.mark.parametrize("name", CARRIED)
def test_carried_layer_is_the_reference_copy(name):
    ref = os.path.join(ROOT, "src", "repro", "core", name)
    port = os.path.join(ROOT, "src", "repro_torch", "core", name)
    assert filecmp.cmp(ref, port, shallow=False)


def _engine_items(save_item):
    """Small objects that coalesce into one write, one object over
    ``chunk_bytes`` (streamed in chunks), and a blob."""
    rng = np.random.default_rng(7)
    items = [save_item(f"s{i}", a, "float32", a.shape) for i, a in
             enumerate(rng.standard_normal(n).astype(np.float32)
                       for n in (3, 1000, 4096, 17))]
    big = rng.integers(0, 256, 5 * 65536 + 123, dtype=np.uint8)
    return items + [save_item("big", big, "uint8", big.shape),
                    save_item("blob", b"lean" * 33, is_blob=True)]


def _engine_crcs(manifest) -> dict:
    out = {k: b.crc32 for k, b in manifest.blobs.items()}
    for k, rec in manifest.tensors.items():
        out.update({f"{k}@{sh.offset}": sh.crc32 for sh in rec.shards})
    return out


@pytest.mark.parametrize("backend", ["posix", "threadpool"])
def test_aggregated_engine_matches_the_reference(tmp_path, backend):
    """The port's aggregated engine (its staging spanned) against the
    reference's: with checksums on, the same files byte for byte and the
    same CRCs, and each engine reads the other's files back exactly,
    verifying the CRCs as the extents land."""
    from repro.core import engines as ref_eng
    from repro_torch.core import engines as port_eng
    pkgs = {"ref": ref_eng, "port": port_eng}
    kw = dict(backend=backend, direct=False, checksum=True,
              chunk_bytes=64 << 10, coalesce_bytes=256 << 10)
    saved = {}
    for name, pkg in pkgs.items():
        eng = pkg.ENGINES["aggregated"](pkg.EngineConfig(**kw))
        items = _engine_items(pkg.SaveItem)
        saved[name] = eng.save(str(tmp_path / name), items, step=1)
    ref_m, port_m = saved["ref"], saved["port"]
    assert _engine_crcs(port_m) == _engine_crcs(ref_m)
    assert None not in _engine_crcs(port_m).values()
    files = sorted(os.listdir(tmp_path / "ref" / "data"))
    assert files == sorted(os.listdir(tmp_path / "port" / "data"))
    for f in files:
        assert filecmp.cmp(tmp_path / "ref" / "data" / f,
                           tmp_path / "port" / "data" / f, shallow=False)
    want = {it.key: bytes(memoryview(it.data).cast("B"))
            for it in _engine_items(port_eng.SaveItem)}
    for reader, writer in (("port", "ref"), ("ref", "port")):
        pkg, m = pkgs[reader], saved[writer]
        reqs = [pkg.ReadReq(k, b.path, b.offset, b.nbytes)
                for k, b in m.blobs.items()]
        crcs = {k: b.crc32 for k, b in m.blobs.items()}
        for k, rec in m.tensors.items():
            (sh,) = rec.shards
            reqs.append(pkg.ReadReq(k, sh.path, sh.offset, sh.nbytes))
            crcs[k] = sh.crc32
        eng = pkg.ENGINES["aggregated"](pkg.EngineConfig(**kw))
        stream = eng.begin_restore(str(tmp_path / writer), reqs, crcs=crcs)
        got = {r.key: stream.get(r.key).tobytes() for r in reqs}
        stream.end_restore()
        assert got == want, (reader, writer)

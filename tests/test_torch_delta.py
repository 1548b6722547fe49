"""Delta (fp128) chains across packages, and the mutable-tensor barrier.

A delta chain started by one package and continued by the other must dirty
exactly the chunks the JAX package alone would: the digest index matches on
digest kind and exact digests, so any byte drift between the packages would
show up as extra dirty chunks and written bytes. The port's ``device`` and
``qdevice`` jobs run the kernels' plain versions on these CPU tensors —
the same plan a CUDA run takes.
"""

import copy

import numpy as np
import pytest
import torch

from repro_torch.core import quant_codec

from _torch_port import (QUANT, dir_files, leaves_bytes, np_state,
                         port_manager, ref_manager, to_jax, to_port)

CHUNK = 4096        # small grid so the small test tensors span many chunks


def _chain(seed: int) -> list[dict]:
    """Three states: a base, then two sparse in-place-style changes."""
    s0 = np_state(seed)
    s1 = copy.deepcopy(s0)
    s1["params"]["w"][3] += 1
    s1["opt"]["mu"]["w"][5, :40] += 1e-3
    s1["step"] = np.asarray(8, np.int32)
    s2 = copy.deepcopy(s1)
    s2["params"]["emb"][100:110] -= 1
    s2["opt"]["nu"]["w"][30] *= 2
    s2["step"] = np.asarray(9, np.int32)
    return [s0, s1, s2]


def _save(pkg: str, path, step: int, tree, quantize: bool):
    kw = dict(delta=True, delta_chunk_bytes=CHUNK, keep=None,
              quantize_prefixes=QUANT if quantize else (),
              quantize_min_bytes=1024)
    make = ref_manager if pkg == "ref" else port_manager
    conv = to_jax if pkg == "ref" else to_port
    with make(path, **kw) as mgr:
        m = mgr.save(step, conv(tree))
    return m.chunks_total, m.chunks_dirty, m.written_bytes


def _restore(pkg: str, path, step: int):
    make = ref_manager if pkg == "ref" else port_manager
    with make(path) as mgr:
        return leaves_bytes(mgr.restore(step=step))


@pytest.mark.parametrize("quantize", [False, True], ids=["plain", "quant"])
@pytest.mark.parametrize("starter", ["ref", "port"])
def test_delta_chain_continues_across_packages(tmp_path, starter, quantize):
    states = _chain(1)
    alone = [_save("ref", tmp_path / "alone", i, s, quantize)
             for i, s in enumerate(states)]
    other = "port" if starter == "ref" else "ref"
    order = [starter, other, starter]
    mixed = [_save(pkg, tmp_path / "mixed", i, s, quantize)
             for i, (pkg, s) in enumerate(zip(order, states))]
    assert mixed == alone                 # chunks and written bytes per step
    assert 0 < alone[1][1] < alone[1][0] and 0 < alone[2][1] < alone[2][0]
    want = _restore("ref", tmp_path / "alone", 2)
    assert _restore("port", tmp_path / "mixed", 2) == want
    assert _restore("ref", tmp_path / "mixed", 2) == want
    assert _restore("port", tmp_path / "mixed", 1) == \
        _restore("ref", tmp_path / "alone", 1)


def test_delta_chunk_store_bytes_match_reference(tmp_path):
    """Same chain, same packed chunk files (pack names aside)."""
    states = _chain(2)
    for pkg in ("ref", "port"):
        for i, s in enumerate(states[:2]):
            _save(pkg, tmp_path / pkg, i, s, True)
    files = {pkg: sorted(v for k, v in dir_files(
        str(tmp_path / pkg / "chunkstore")).items())
        for pkg in ("ref", "port")}
    assert files["ref"] == files["port"]


@pytest.mark.parametrize("dtype", [torch.int64, torch.bool, torch.float64])
def test_any_dtype_is_fingerprinted_where_it_lives(monkeypatch, dtype):
    """8-byte and bool tensors take the ``device`` job (the kernel on the
    card, its plain version here), never the host pass, and their digests
    are the JAX package's host-twin digests of the same bytes."""
    from repro.kernels.fingerprint import fingerprint_chunks_host as ref_fp
    from repro_torch.core import delta as dm
    from repro_torch.core.pipeline import build_save_puts
    from repro_torch.kernels import fingerprint as fpk

    def no_host_pass(*_):
        raise AssertionError("tensor put took the host fingerprint pass")

    monkeypatch.setattr(fpk, "fingerprint_chunks_host", no_host_pass)
    g = torch.Generator().manual_seed(5)
    t = {torch.int64: lambda: torch.randint(-2**40, 2**40, (3001,),
                                            generator=g),
         torch.bool: lambda: torch.rand(9001, generator=g) > 0.5,
         torch.float64: lambda: torch.randn(3001, generator=g,
                                            dtype=torch.float64)}[dtype]()
    puts, _ = build_save_puts({"x": t}, b"lean")
    plan = dm.plan_delta(puts, dm.DeltaIndex(), chunk_bytes=CHUNK,
                         device_fingerprint=True)
    raw = t.view(torch.uint8).numpy()
    want = fpk.digests_hex(ref_fp(raw, CHUNK))
    assert [h for _ck, h in plan.shards[0].refs] == want
    # the digest table plus the (all dirty) chunks: a device job's ledger
    assert plan.d2h_bytes == 16 * len(want) + raw.nbytes
    got = b"".join(bytes(p.resolve()) for p in plan.puts if not p.spec.is_blob)
    assert got == raw.tobytes()


def test_qdevice_header_is_the_pack_header():
    """Trap 6: the delta planner's header for a quantized put is
    byte-identical to ``pack``'s (orig_nbytes = n_elems * 4)."""
    x = torch.randn(3 * 512 + 5)
    assert quant_codec.pack(x)[:quant_codec.HEADER.size].tobytes() == \
        quant_codec.header(x.numel())
    assert quant_codec.HEADER.unpack(quant_codec.header(1000))[1] == 4000


@pytest.mark.parametrize("delta", [False, True], ids=["full", "delta"])
def test_async_save_snapshot_survives_in_place_mutation(tmp_path, delta):
    """Trap 4: torch tensors are mutated in place after an async save;
    ``wait_snapshotted()`` is the barrier after which the saved bytes are
    the pre-mutation ones."""
    tree = np_state(4)
    state = to_port(tree)
    kw = dict(async_save=True, quantize_prefixes=QUANT,
              quantize_min_bytes=1024, delta=delta, delta_chunk_bytes=CHUNK)
    with port_manager(tmp_path, **kw) as mgr:
        before = leaves_bytes(state)
        mgr.save(1, state)
        mgr.wait_snapshotted()
        for t in (state["params"]["w"], state["opt"]["mu"]["w"],
                  state["step"]):
            t.add_(1)                         # optimizer.step() in place
        mgr.wait()
    with port_manager(tmp_path, **kw) as mgr:
        restored = mgr.restore(step=1)
    got = leaves_bytes(restored)
    assert got["['params']['w']"] == before["['params']['w']"]
    assert got["['step']"] == before["['step']"]
    assert got["['params']['w']"] != leaves_bytes(state)["['params']['w']"]
    # quantized: the decode of the pre-mutation values
    with port_manager(tmp_path / "sync", quantize_prefixes=QUANT,
                      quantize_min_bytes=1024) as mgr:
        mgr.save(1, to_port(tree))
        want = leaves_bytes(mgr.restore(step=1))
    assert got["['opt']['mu']['w']"] == want["['opt']['mu']['w']"]

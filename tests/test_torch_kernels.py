"""The port's plain kernel versions against the JAX package's oracles.

Every comparison is byte-exact — q, scales, dequantized bits and digests —
because the fp128 delta index content-addresses exactly these bytes. The
JAX side runs its Pallas kernels in interpret mode (as tests/test_kernels.py
does) and its jnp / numpy oracles; the port's wrappers take their plain
PyTorch versions for these CPU tensors. The CUDA kernels themselves are held
against the same plain versions on the card (tests/test_torch_cuda.py and
chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant_codec as ref_codec
from repro.kernels import fingerprint as ref_fp
from repro.kernels import quantize as ref_q
from repro.kernels import ref as ref_oracle
from repro_torch.core import quant_codec
from repro_torch.kernels import fingerprint as fpk
from repro_torch.kernels import quantize as qk
from repro_torch.kernels.quantize import LANE_COLS


def _rows(seed: int, rows: int) -> np.ndarray:
    """Random rows at mixed magnitudes plus the edge rows: all zeros, exact
    .5 quotients at scale 1.0 (absmax 127), their negation, and a row of
    1e30 (beyond float16's range after decode: an inf, in both packages)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, LANE_COLS)).astype(np.float32)
    x *= rng.uniform(1e-4, 1e3, (rows, 1)).astype(np.float32)
    x[1] = 0.0
    x[2] = (np.arange(LANE_COLS) % 9 - 4.5).astype(np.float32)
    x[2, 0] = 127.0
    x[3] = -x[2]
    x[4] = 1e30
    return x


def _bytes(t) -> bytes:
    return np.ascontiguousarray(np.asarray(t)).tobytes()


@pytest.mark.parametrize("rows", [8, 24])
def test_quantize_plain_matches_jax_bytes(rows):
    x = _rows(rows, rows)
    q, s = qk.quantize_blocks(torch.from_numpy(x))
    qr, sr = ref_oracle.quantize_blocks_ref(jnp.asarray(x))
    qp, sp = ref_q.quantize_blocks(jnp.asarray(x), interpret=True)
    assert _bytes(q) == _bytes(qr) == _bytes(qp)
    assert _bytes(s) == _bytes(sr) == _bytes(sp)
    assert float(s[1]) == 1.0 and not q[1].any()
    # -3.5 -2.5 -1.5 -0.5 0.5 1.5 2.5 3.5 -4.5: round half to even
    assert q[2, 1:10].tolist() == [-4, -2, -2, 0, 0, 2, 2, 4, -4]


def test_quantize_zero_extension_equals_padded_input():
    x = _rows(3, 16).reshape(-1)[:7 * LANE_COLS + 33]
    padded = np.zeros((16, LANE_COLS), np.float32)
    padded.reshape(-1)[:x.size] = x
    q, s = qk.quantize_blocks(torch.from_numpy(x.copy()), 16)
    qr, sr = ref_oracle.quantize_blocks_ref(jnp.asarray(padded))
    assert _bytes(q) == _bytes(qr) and _bytes(s) == _bytes(sr)


@pytest.mark.parametrize("out_dtype", ["float32", "float16", "bfloat16"])
def test_dequantize_plain_matches_codec_decode(out_dtype):
    """The restore decode of the JAX package: f32 oracle, then a host cast."""
    x = _rows(5, 16)
    q, s = ref_oracle.quantize_blocks_ref(jnp.asarray(x))
    want = np.asarray(ref_oracle.dequantize_blocks_ref(
        q, s, out_dtype=jnp.float32)).astype(jnp.dtype(out_dtype))
    qt, st = torch.tensor(np.asarray(q)), torch.tensor(np.asarray(s))
    got = qk.dequantize_blocks(qt, st, getattr(torch, out_dtype))
    assert got.view(torch.uint8).numpy().tobytes() == want.tobytes()
    if out_dtype == "float32":
        kernel = ref_q.dequantize_blocks(q, s, out_dtype=jnp.float32,
                                         interpret=True)
        assert _bytes(got) == _bytes(kernel)
    tail = qk.dequantize_blocks(qt, st, getattr(torch, out_dtype), n=1000)
    assert tail.view(torch.uint8).numpy().tobytes() == \
        want.reshape(-1)[:1000].tobytes()


def _source(kind: str, nbytes: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 256, nbytes, dtype=np.int64).astype(np.uint8)
    return {"u8": raw, "i8": raw.view(np.int8),
            "bf16": raw[:nbytes // 2 * 2].view(ml_bf16()),
            "f32": raw[:nbytes // 4 * 4].view(np.float32)}[kind]


def ml_bf16():
    import ml_dtypes
    return ml_dtypes.bfloat16


@pytest.mark.parametrize("kind", ["u8", "i8", "bf16", "f32"])
@pytest.mark.parametrize("nbytes,chunk", [(3 * 4096 + 6, 4096),
                                          (4000, 4096),
                                          (2 * 4000 + 2, 4000)])
def test_fingerprint_plain_matches_jax(kind, nbytes, chunk):
    """1-, 2- and 4-byte lane sources, ragged last chunks, a bf16 lane count
    that is odd (the last lane half filled)."""
    arr = _source(kind, nbytes, nbytes)
    from repro_torch.core.serialization import state_from_numpy
    t = state_from_numpy({"x": arr}, device="cpu")["x"]
    got = fpk.digest_table(fpk.fingerprint_chunks(t, chunk))
    host = ref_fp.fingerprint_chunks_host(arr.view(np.uint8), chunk)
    lanes, lens = ref_fp._fp_prep_jit(jnp.asarray(arr), chunk)
    pallas = np.asarray(ref_fp.fingerprint_chunks(lanes, lens,
                                                  interpret=True))
    oracle = np.asarray(ref_fp._fp_device_jit(jnp.asarray(arr), chunk))
    assert got.dtype == np.uint32
    assert np.array_equal(got, host)
    assert np.array_equal(got, pallas)
    assert np.array_equal(got, oracle)


@pytest.mark.parametrize("nbytes,chunk", [(10_000, 4096), (5000, 1001),
                                          (1, 4096), (0, 64)])
def test_fingerprint_host_twin_is_the_reference(nbytes, chunk):
    arr = _source("u8", nbytes, 11)
    assert np.array_equal(fpk.fingerprint_chunks_host(arr, chunk),
                          ref_fp.fingerprint_chunks_host(arr, chunk))
    assert fpk.digest_bytes(arr.tobytes()) == ref_fp.digest_bytes(
        arr.tobytes())


def test_quantize_fingerprint_blocks_plain_matches_pallas():
    x = _rows(9, 32)
    chunk = 16 * LANE_COLS                       # 16 q rows per chunk
    q, s, d = fpk.quantize_fingerprint_blocks(torch.from_numpy(x), chunk)
    qp, sp, dp = ref_fp.quantize_fingerprint_blocks(jnp.asarray(x), chunk,
                                                    interpret=True)
    qr, sr, dr = ref_oracle.quantize_fingerprint_blocks_ref(jnp.asarray(x),
                                                            chunk)
    assert _bytes(q) == _bytes(qp) == _bytes(qr)
    assert _bytes(s) == _bytes(sp) == _bytes(sr)
    assert np.array_equal(fpk.digest_table(d), np.asarray(dp))
    assert np.array_equal(fpk.digest_table(d), np.asarray(dr))


@pytest.mark.parametrize("n,chunk", [(5 * LANE_COLS * 8 + 100, 8192),
                                     (3000, 4000), (LANE_COLS * 16, 8192)])
def test_quant_fingerprint_matches_jax(n, chunk):
    """The delta planner's qdevice dispatch: q, scales and the digests of
    the packed qs stream (q rows, then the scales region)."""
    x = np.random.default_rng(n).standard_normal(n).astype(np.float32)
    rows = quant_codec.packed_rows(n)
    padded = np.zeros((rows, LANE_COLS), np.float32)
    padded.reshape(-1)[:n] = x
    q, s, d = fpk.quant_fingerprint(torch.from_numpy(x), rows, chunk)
    qr, sr, dr = ref_fp.quant_fingerprint(jnp.asarray(padded), chunk)
    assert _bytes(q) == _bytes(qr) and _bytes(s) == _bytes(sr)
    assert np.array_equal(d, dr)


@pytest.mark.parametrize("dtype,n", [(np.float32, 5000), (np.float32, 4096),
                                     (np.float16, 777)])
def test_pack_bytes_match_reference(dtype, n):
    x = (np.random.default_rng(n).standard_normal(n) * 3).astype(dtype)
    packed = quant_codec.pack(torch.from_numpy(x))
    want = ref_codec.pack(x)
    assert packed.tobytes() == want
    assert packed.nbytes == quant_codec.packed_nbytes(n)
    assert quant_codec.header(n) == want[:quant_codec.HEADER.size]
    # decode: the port's bytes equal the JAX package's host decode
    got = quant_codec.unpack(np.frombuffer(want, np.uint8), dtype.__name__)
    ref = ref_codec.unpack(np.frombuffer(want, np.uint8), np.dtype(dtype))
    assert got.numpy().tobytes() == ref.tobytes()


def test_wrappers_refuse_tensors_off_cpu_and_cuda():
    meta = torch.empty((8, LANE_COLS), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        qk.quantize_blocks(meta)
    with pytest.raises(ValueError, match="CUDA"):
        fpk.fingerprint_chunks(meta, 4096)

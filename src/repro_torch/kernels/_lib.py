"""Build and bind the hand-written CUDA kernels (``csrc/*.cu``).

The sources are compiled with ``nvcc`` for Hopper (``sm_90a``) into one
shared library with a plain C interface, at first use, and bound with
``ctypes``: each C entry point launches on the stream it is given and
returns ``cudaGetLastError()``. The library is named by a hash of the
sources, so an edited kernel is rebuilt and a stale one never loaded.

Nothing here runs at import time — the CPU test suite imports every module
of the package on machines without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("quantize.cu", "fingerprint.cu")
# <checkout>/build (listed in .gitignore): src/repro_torch/kernels -> root
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

# launches per kernel wrapper; each wrapper adds one where it launches
LAUNCHES = {"quantize_blocks": 0, "dequantize_blocks": 0,
            "fingerprint_chunks": 0, "quantize_fingerprint_blocks": 0}

_P, _I64, _I32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_SIGNATURES = {
    "rt_quantize_blocks": (_P, _I64, _I64, _P, _P, _P),
    "rt_dequantize_blocks": (_P, _P, _I64, _I32, _P, _P),
    "rt_fingerprint_chunks": (_P, _I64, _I64, _P, _P),
    "rt_quant_fingerprint_blocks": (_P, _I64, _I64, _I64, _P, _P, _P, _P),
}

_lib = None
_lock = threading.Lock()
build_seconds = None      # wall time of this process's build (None: cached)
build_log = ""            # nvcc's output of that build (ptxas -v report)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin/nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sorted(p.name for p in CSRC.iterdir()):
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"libreprotorch_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless this exact source set is already built."""
    global build_seconds, build_log
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp),
           *(str(CSRC / s) for s in SOURCES)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    build_seconds = time.perf_counter() - t0
    build_log = proc.stdout + proc.stderr
    os.replace(tmp, out)
    return out


def lib():
    """The loaded library (built on first call)."""
    global _lib
    if _lib is None:
        with _lock:
            if _lib is None:
                handle = ctypes.CDLL(str(build()))
                for name, argtypes in _SIGNATURES.items():
                    fn = getattr(handle, name)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
                _lib = handle
    return _lib


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")


def stream_of(t) -> int:
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream

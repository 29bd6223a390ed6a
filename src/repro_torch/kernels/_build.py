"""Build the CUDA kernels with ``nvcc``, bind them with ``ctypes``, and check
what a launcher is handed.

One ``nvcc`` command compiles every ``csrc/*.cu`` file into one shared
library with a plain ``extern "C"`` interface (no PyTorch headers, so a build
takes seconds). The library lands in ``<checkout>/build/repro_torch/<hash>/``
where the hash covers the sources and the flags, so an edited source
rebuilds and an unchanged one loads the library already built. Nothing runs
at import time: :func:`load` builds on the first launch.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
LIB_NAME = "libonpair_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I = ctypes.c_void_p, ctypes.c_int
#: argument types of each extern "C" launcher (pointers and the stream as
#: c_void_p, so ctypes never truncates them to 32 bits)
SIGNATURES = {
    # tokens, n_tokens, mat16, lens, out, out_len, B, T, W, stream
    "onpair_decode_compact": [_P] * 6 + [_I] * 3 + [_P],
    # data, lens, s_lo, s_hi, s_len, s_tok, p_lo, p_hi, p_len, p_bucket,
    # bucket_start, bucket_size, suf_lo, suf_hi, suf_len, suf_tok, tokens,
    # n_tokens, B, Lp, max_tokens, s_size, p_size, s_probe_max, p_probe_max,
    # max_bucket, stream
    "onpair_encode_batch": [_P] * 18 + [_I] * 8 + [_P],
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
#: what the last build did: library path, seconds, compiler output
build_info: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.access(os.path.join(home, "bin", "nvcc"), os.X_OK):
            return os.path.join(home, "bin", "nvcc")
    raise RuntimeError("repro_torch: nvcc not found (set CUDA_HOME or PATH); "
                       "the CUDA kernels are built from source at first use")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels (unless this exact build exists) and return the
    library's path. Raises RuntimeError with the compiler's output on failure."""
    out_dir = BUILD_ROOT / _digest()
    lib = out_dir / LIB_NAME
    if lib.exists():
        build_info.update(path=str(lib), seconds=0.0, log="(cached)")
        return lib
    nvcc = _nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        staged = Path(tmp) / LIB_NAME
        proc = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-shared", "-o", str(staged),
             *(str(src) for src in _sources())],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed:\n{proc.stdout}")
        os.replace(staged, lib)  # atomic: a concurrent build loads either copy
    build_info.update(path=str(lib), seconds=time.perf_counter() - t0,
                      log=proc.stdout)
    return lib


def load() -> ctypes.CDLL:
    """The kernel library, built and bound on first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.onpair_cuda_error_string.argtypes = [ctypes.c_int]
            lib.onpair_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def expect(name: str, t: torch.Tensor, dtype: torch.dtype, ndim: int,
           device: torch.device) -> None:
    """Raise unless a launcher argument has the dtype, rank, device and
    contiguous layout its kernel reads."""
    if t.dtype != dtype or t.dim() != ndim:
        raise ValueError(f"{name} must be {dtype} with {ndim} dims, "
                         f"got {t.dtype} with shape {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check(rc: int, kernel: str) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if rc != 0:
        msg = load().onpair_cuda_error_string(rc).decode()
        raise RuntimeError(f"{kernel}: CUDA launch failed with error {rc} ({msg})")

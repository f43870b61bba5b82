"""Build and load the package's CUDA kernels.

All ``csrc/*.cu`` files compile with ``nvcc`` into ONE shared library with a
plain C interface, loaded with ``ctypes``. No PyTorch header is included, so
the build takes seconds. The library lands in ``multimeditron_torch/build/``
under a name that carries a hash of the sources and flags: an edit rebuilds
it, an unchanged tree reuses it.

Each C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`check` turns a nonzero code into an
exception. A missing ``nvcc`` or a failed build raises.
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

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signature of every entry point: pointers and the stream as void*.
SIGNATURES = {
    # q, k, v, o, B, S, H, Dh, kv_len, scale, dtype, stream
    "mmt_encoder_attention": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _P),
    # q, k_pages, v_pages, k_ring, v_ring, page_table, pages_len, lengths,
    # partial (float32 scratch), o, B, H, Hkv, D, n_pages, P, pm, T,
    # layer_index, scale, n_splits, dtype, stream
    "mmt_ring_decode_attention": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                  _I, _I, _I, _I, _I, _I, _I, _I, _I, _F,
                                  _I, _I, _P),
    "mmt_ring_decode_split_keys": (),
    # k_pages, v_pages, k_ring, v_ring, page_table, pages_len, lengths,
    # L, B, Hkv, D, n_pages, P, pm, T, rows, dtype, stream
    "mmt_fold_ring_into_pages": (_P, _P, _P, _P, _P, _P, _P,
                                 _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P),
}
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_lock = threading.Lock()
_lib = None
build_seconds = None  # wall time of the last compile in this process, if any


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError(
        "nvcc not found (looked on PATH and under CUDA_HOME or "
        "/usr/local/cuda): the CUDA kernels cannot be built")


def library_path() -> Path:
    sources = sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libmmt_kernels_{h.hexdigest()[:16]}.so"


def _compile(out: Path) -> None:
    global build_seconds
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *(str(s) for s in sorted(CSRC.glob("*.cu")))]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
            f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    build_seconds = time.perf_counter() - t0


def library() -> ctypes.CDLL:
    """The compiled kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            out = library_path()
            if not out.exists():
                _compile(out)
            lib = ctypes.CDLL(str(out))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            lib.mmt_error_string.argtypes = [ctypes.c_int]
            lib.mmt_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(name: str, code: int) -> None:
    """Raise if a kernel entry point reported a CUDA error."""
    if code != 0:
        msg = library().mmt_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA error {code} ({msg}) at launch")


def stream_handle(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream

"""Build and load the package's CUDA kernels.

All ``csrc/*.cu`` files compile with ``nvcc`` into ONE shared library with a
plain C interface, loaded with ``ctypes``: one ``nvcc`` process per source,
all started together, then one link. No PyTorch header is included, so the
build takes seconds. The library lands in ``multimeditron_torch/build/``
under a name that carries a hash of the sources and flags: an edit rebuilds
it, an unchanged tree reuses it.

Each C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`check` turns a nonzero code into an
exception. A missing ``nvcc`` or a failed build raises. Every source is
compiled with ``-Xptxas -v``; :func:`ptxas_report` reads each kernel's
registers and spills from the last compile's output.

The library links against the CUDA runtime only. The TMA tensor maps of the
wgmma kernels are encoded with libcuda's ``cuTensorMapEncodeTiled``,
which ``csrc/hopper.cuh`` looks up at run time through the runtime's
``cudaGetDriverEntryPoint[ByVersion]``, so no ``-lcuda`` is needed.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
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
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signature of every entry point: pointers and the stream as void*.
SIGNATURES = {
    # q, k, v, o, B, S, H, Dh, kv_len, scale, dtype, stream
    "mmt_encoder_attention": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _P),
    # q, k_pages, v_pages, k_ring, v_ring, page_table, pages_len, lengths,
    # work (float32 scratch), counters (int32 zeros), o, L, B, H, Hkv, D,
    # n_pages, P, pm, T, layer_index, scale, max_splits, window, dtype, stream
    "mmt_ring_decode_attention": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                  _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F,
                                  _I, _I, _I, _P),
    "mmt_ring_decode_split_keys": (),
    # q, k_pages, v_pages, page_table, lengths, work (float32 scratch),
    # counters (int32 zeros), o, B, H, Hkv, D, n_pages, P, pm, scale,
    # max_splits, dtype, stream
    "mmt_paged_attention": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F,
                            _I, _I, _P),
    # q, k_pages, v_pages, k_ring, v_ring, page_table, pages_len, lengths,
    # partial (float32 scratch), o, B, H, Hkv, S, D, n_pages, P, pm, T,
    # layer_index, scale, n_splits, dtype, stream
    "mmt_ring_verify_attention": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                  _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F,
                                  _I, _I, _P),
    "mmt_ring_verify_split_keys": (),
    "mmt_ring_verify_max_rows": (),
    # k_pages, v_pages, k_ring, v_ring, page_table, pages_len, lengths,
    # L, B, Hkv, D, n_pages, P, pm, T, rows, dtype, stream
    "mmt_fold_ring_into_pages": (_P, _P, _P, _P, _P, _P, _P,
                                 _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    # q, k, v, kv_mask (or NULL), o, lse, B, H, Hkv, Sq, Skv, D, causal,
    # offset, scale, dtype, stream
    "mmt_flash_fwd": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _I, _P),
    # q, k, v, dout, lse, di, kv_mask (or NULL), dq, then as the forward
    "mmt_flash_bwd_dq": (_P, _P, _P, _P, _P, _P, _P, _P,
                         _I, _I, _I, _I, _I, _I, _I, _I, _F, _I, _P),
    # q, k, v, dout, lse, di, kv_mask (or NULL), dk, dv, then as the forward
    "mmt_flash_bwd_dkv": (_P, _P, _P, _P, _P, _P, _P, _P, _P,
                          _I, _I, _I, _I, _I, _I, _I, _I, _F, _I, _P),
    # x, ln_w, ln_b, out, M, D, eps, inv_s, dtype, stream
    "mmt_int8_ln_quant": (_P, _P, _P, _P, _I, _I, _F, _F, _I, _P),
    # a, w, ws, bias, x_res, ln_w, ln_b, x_out, xq, M, K, D, s, inv_s, eps,
    # dtype, stream (K7e, and K7c with an int8 o)
    "mmt_int8_fc2_res_ln_quant": (_P, _P, _P, _P, _P, _P, _P, _P, _P,
                                  _I, _I, _I, _F, _F, _F, _I, _P),
    # a, w, ws, bias, out, M, K, N, s, inv_s, act, stream
    "mmt_int8_fc1_act_quant": (_P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _I, _P),
    # o, w, ws, bias, x_res, ln_w, ln_b, x_out, xq, M, K, D, s, inv_s_o, inv_s,
    # eps, dtype, stream
    "mmt_float_res_ln_quant": (_P, _P, _P, _P, _P, _P, _P, _P, _P,
                               _I, _I, _I, _F, _F, _F, _F, _I, _P),
    # xq, x_res, w1, w1_s, b1, w2, w2_s, b2, ln_w, ln_b, x_out, xq_out, M, D, F,
    # s2, inv_s3, s3, inv_s0n, eps, act, dtype, stream
    "mmt_int8_mlp_fused": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                           _I, _I, _I, _F, _F, _F, _F, _F, _I, _I, _P),
    # a, w, ws, bias, q8, k8, v, M, K, D, s0, inv_q, inv_k, stream
    "mmt_int8_qkv_project": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _F, _P),
    # a, w, ws, bias, q, k, v, M, K, D, s0, inv_q, inv_k, inv_v, out_code, stream
    "mmt_int8_qkv_split": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _F, _F, _I, _P),
    # q8, k8, v, o, B, S, H, dh, kv_len, a, shift, inv_s1, mode, out_code, stream
    "mmt_int8_attention": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _F, _I, _I, _P),
    # q8, k8, v8, o, B, S, H, dh, kv_len, qk_scale, pv_scale, out_code, stream
    "mmt_encoder_attention_int8": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _I, _P),
    # x, ids (int64), weights (float32), w_gate, w_up, w_down, counts, offsets,
    # perm (int32 scratch), h (bf16 scratch), ybuf (float32 scratch), stats
    # (int64, or NULL), y, N, D, F, E, k, stream
    "mmt_grouped_experts": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                            _I, _I, _I, _I, _I, _P),
    # x, w_q, w_s, out, work (float32 scratch or NULL), counters (int32 zeros
    # or NULL), M, K, N, tile_n, splits, chunks_per_split, dtype, stream
    "mmt_wo_matmul": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
}
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_lock = threading.Lock()
_lib = None
build_seconds = None  # wall time of the last compile in this process, if any
build_logs = {}  # source file name -> nvcc's output (ptxas -v) of the last compile


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
    nvcc, tag = _nvcc(), f"{out.stem}.{os.getpid()}"
    sources = sorted(CSRC.glob("*.cu"))
    objects = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in sources]
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    try:
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for src, obj in zip(sources, objects)]
        logs = [p.communicate()[0] for p in procs]
        build_logs.clear()
        build_logs.update((src.name, log) for src, log in zip(sources, logs))
        failed = [(src.name, p.returncode, log)
                  for src, p, log in zip(sources, procs, logs) if p.returncode]
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(
                f"{name} ({code}):\n{log}" for name, code, log in failed))
        link = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objects)]
        proc = subprocess.run(link, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{' '.join(link)}\n"
                               f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    finally:
        tmp.unlink(missing_ok=True)
        for obj in objects:
            obj.unlink(missing_ok=True)
    build_seconds = time.perf_counter() - t0


def ptxas_log(source: str) -> str:
    """nvcc's output (``-Xptxas -v``) for ``csrc/<source>``: the last
    compile's, or, when this process reused a built library, that of a
    compile of the one source (seconds)."""
    if source not in build_logs:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        obj = BUILD_DIR / f"ptxas_report.{os.getpid()}.o"
        try:
            proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj), str(CSRC / source)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        finally:
            obj.unlink(missing_ok=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source} ({proc.returncode}):\n{proc.stdout}")
        build_logs[source] = proc.stdout
    return build_logs[source]


def ptxas_report(source: str) -> dict:
    """The ``-Xptxas -v`` report for ``csrc/<source>`` (:func:`ptxas_log`):
    each kernel (entry, registers, spill stores and loads in bytes) and
    every warning line (e.g. C7512, spilled registers)."""
    kernels, warnings = [], []
    for line in ptxas_log(source).splitlines():
        entry = re.search(r"Compiling entry function '([^']+)'", line)
        used = re.search(r"Used (\d+) registers", line)
        spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if entry:
            kernels.append(dict(entry=entry.group(1), registers=None, spill_stores=None,
                                spill_loads=None))
        elif used and kernels:
            kernels[-1]["registers"] = int(used.group(1))
        elif spills and kernels:
            kernels[-1]["spill_stores"] = int(spills.group(1))
            kernels[-1]["spill_loads"] = int(spills.group(2))
        elif "warning" in line:
            warnings.append(line.strip())
    return dict(kernels=kernels, warnings=warnings)


def library() -> ctypes.CDLL:
    """The compiled kernel library, built on first use."""
    global _lib
    if _lib is not None:
        return _lib
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


# Scratch of the kernels that finish a reduction inside their launch (K9's
# split-K sum, K4 / K8's split merge): int32 counters that the kernels leave
# zero, and float32 workspace, one buffer of each per (device, stream), grown
# on demand. Launches on one stream run in order, so the kernels share them.
# A launch captured into a CUDA graph gets buffers of its own instead: they
# are allocated in the graph's pool and live as long as the graph, and no
# eager launch, on any stream, shares them while it replays.
_counters: dict = {}
_workspace: dict = {}


def zeroed_counters(device: torch.device, stream: int, n: int) -> torch.Tensor:
    """At least ``n`` int32 zeros on ``device`` for ``stream``'s launches."""
    if torch.cuda.is_current_stream_capturing():
        return torch.zeros(n, dtype=torch.int32, device=device)
    buf = _counters.get((device.index, stream))
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _counters[(device.index, stream)] = buf
    return buf


def workspace(device: torch.device, stream: int, n: int) -> torch.Tensor:
    """At least ``n`` float32 values of scratch on ``device`` for ``stream``."""
    if torch.cuda.is_current_stream_capturing():
        return torch.empty(n, dtype=torch.float32, device=device)
    buf = _workspace.get((device.index, stream))
    if buf is None or buf.numel() < n:
        buf = torch.empty(n, dtype=torch.float32, device=device)
        _workspace[(device.index, stream)] = buf
    return buf


def stream_handle(device: torch.device) -> int:
    """The raw handle of ``device``'s current stream, by PyTorch's own
    getter (no ``Stream`` object is built: that costs microseconds a call)."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    return torch._C._cuda_getCurrentRawStream(index)

"""Time the hand-written kernels of several kernel source trees in one
process, on one card: the flash kernels K1, K2a and K2b in bf16 at the
training shape (B = 1, H = 32, Hkv = 8, S = 4096, D = 128, causal, keys from
3500 masked; K2a and K2b on K1's o and lse from the first tree), the W8A8 ViT
kernels (K7b, K7c, K7d, K7e, K7g and K7g's projection alone) at the
ViT-L/14 encode shape (256 images, M = 65,792 rows), the weight-only int8
matmul K9 in bf16 at the Llama-3.1-8B projection shapes (decode M = 8 with
the lm_head, verify M = 40 and the W8A16 prefill's M = 4,096), and the
paged decode attention K4 and K8 in bf16 at chip_smoke.py phase 3's cases
(K4's ragged case and phase 5's shape, K8's serving case and 4,096 tokens),
K4 at Mellum2-12B's decode shape (128 slots, 32 / 4 heads, D = 128) over
3,000 keys with and without its 1,024-key window and over the GRPO cell's
mix of lengths, and the grouped-expert kernel at Mellum2-12B's widths (D =
2,304, 64 experts of F = 896, top-8) for a 128-slot decode step and a
1,024-token prefill chunk. A tree without K4's window or without the
grouped-expert entry skips those cases.

    python3 kernel_ab.py [--only NAME[,NAME...]] [SOURCE_DIR ...]

Each SOURCE_DIR holds a copy of ``multimeditron_torch/csrc`` (default: that
directory alone); every tree is built into its own library. A tree older
than K7e's own entry point (``mmt_int8_fc2_res_ln_quant``) runs K7e through
the entry it had then, ``mmt_int8_res_ln_quant``, and a tree that still has
that entry runs K7c (int8 o) through it, as the wrappers did before K7c
moved to K7e's kernel. K7c, K7d, K7e and K7g also run at the serving shape
(8 images, M = 2,056). The trees run in turns, forward then backward (A, B,
B, A), each timed by its kernels' device time from torch.profiler and by
the replay of a CUDA graph of 20 calls (the device time a call, without
the host's), and every tree's outputs are compared with the first tree's:
equal, or the largest difference relative to the largest value. A tree
from before K9's in-launch split sum (an ``mmt_wo_matmul`` without
``tile_n``) or K4 / K8's in-launch merge (``partial`` scratch) runs them
through the entries it had, with the split plans of that time. ``--only``
keeps the kernels whose names start with one of the given prefixes (e.g.
``--only flash``).
"""

from __future__ import annotations

import ctypes
import pathlib
import sys

import numpy as np
import torch

import chip_smoke as cs
from multimeditron_torch import _build
from multimeditron_torch.ops import flash_attention as fl
from multimeditron_torch.ops import grouped_experts as ge
from multimeditron_torch.ops import paged_attention as paged
from multimeditron_torch.ops import vit_int8_fused as v8
from multimeditron_torch.ops import wo_matmul as wo


def flash_runs(gen) -> dict:
    """K1, K2a and K2b at the training shape, on the current library."""
    q, k, v, kv_mask = cs.flash_case(torch.bfloat16, gen, 1, 32, 8, 4096, 4096, 128,
                                     [(0, 3500, 4096)])
    scale = 128 ** -0.5
    o, lse = fl._fwd_kernel(q, k, v, kv_mask, True, scale, 0)
    do = torch.randn(o.shape, generator=gen, device="cuda", dtype=o.dtype)
    di = (o.float() * do.float()).sum(dim=-1)
    bwd = (q, k, v, kv_mask, lse, di, do, True, scale, 0)
    return {"flash K1": lambda: fl._fwd_kernel(q, k, v, kv_mask, True, scale, 0),
            "flash K2a": lambda: fl._dq_kernel(*bwd),
            "flash K2b": lambda: fl._dkv_kernel(*bwd)}


# entry points that a newer tree has and an older one reached under another name
OLDER_ENTRIES = {"mmt_int8_fc2_res_ln_quant": "mmt_int8_res_ln_quant"}
K7C_OLDER = "mmt_int8_res_ln_quant"  # K7c's (int8 o) own entry, in trees that have it
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# K9, K4 and K8 as they were before their in-launch split sum and merge
OLDER_SIGNATURES = {
    "mmt_wo_matmul": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    "mmt_ring_decode_attention": (_P,) * 10 + (_I,) * 9 + (_F, _I, _I, _P),
    "mmt_paged_attention": (_P,) * 7 + (_I,) * 7 + (_F, _I, _I, _P),
}
# K4 with the in-launch merge, before its window argument
NO_WINDOW_K4 = (_P,) * 11 + (_I,) * 10 + (_F, _I, _I, _P)


def load_tree(d: str):
    """Build and load the kernel tree in directory ``d``."""
    _build.CSRC, _build._lib = pathlib.Path(d).resolve(), None
    out = _build.library_path()
    if not out.exists():
        _build._compile(out)
    probe = ctypes.CDLL(str(out))
    missing = {n: o for n, o in OLDER_ENTRIES.items() if not hasattr(probe, n)}
    # entries newer than the tree (the grouped-expert kernel's)
    absent = [n for n in _build.SIGNATURES if n not in OLDER_ENTRIES and not hasattr(probe, n)]
    signatures = dict(_build.SIGNATURES)
    for name in list(missing) + absent:
        del _build.SIGNATURES[name]
    try:
        lib = _build.library()
    finally:
        _build.SIGNATURES.clear()
        _build.SIGNATURES.update(signatures)
    for name, older in missing.items():
        setattr(lib, name, getattr(lib, older))
    if hasattr(lib, K7C_OLDER):
        getattr(lib, K7C_OLDER).argtypes = _build.SIGNATURES["mmt_int8_fc2_res_ln_quant"]
    tree = pathlib.Path(d)
    lib.older_k9 = "tile_n" not in (tree / "wo_matmul.cu").read_text()
    lib.older_k4 = "counters" not in (tree / "ring_decode.cu").read_text()
    for name, argtypes in OLDER_SIGNATURES.items():
        if lib.older_k9 if name == "mmt_wo_matmul" else lib.older_k4:
            getattr(lib, name).argtypes = list(argtypes)
    lib.k4_window = "int window" in (tree / "ring_decode.cu").read_text()
    if not lib.older_k4 and not lib.k4_window:
        lib.mmt_ring_decode_attention.argtypes = list(NO_WINDOW_K4)
    lib.has_experts = hasattr(lib, "mmt_grouped_experts")
    return lib


def older_split_k(M, K, N, sm_count):
    """K9's split plan before the in-launch sum: two blocks an SM of 16- or
    64-row by 128-column tiles, at least 4 chunks of 64 K values a split."""
    chunks = K // 64
    blocks = -(-M // (16 if M <= 16 else 64)) * -(-N // 128)
    want = min(-(-2 * sm_count // blocks), max(1, chunks // 4))
    per = -(-chunks // max(1, want))
    return -(-chunks // per), per


def wo_matmul(x, w, ws):
    """K9 on the current tree, through the entry that tree has."""
    lib = _build.library()
    if not lib.older_k9:
        return wo.wo_matmul(x, w, ws)
    (M, K), N = x.shape, w.shape[0]
    splits, per = older_split_k(M, K, N, wo._sm_count(0))
    partial = torch.empty(splits, M, N, dtype=torch.float32, device="cuda")
    out = torch.empty(M, N, dtype=x.dtype, device="cuda")
    _build.check("wo_matmul", lib.mmt_wo_matmul(
        x.data_ptr(), w.data_ptr(), ws.data_ptr(), out.data_ptr(), partial.data_ptr(), M, K, N,
        splits, per, 1, _build.stream_handle(x.device)))
    return out


def ring_decode(q, kp, vp, kr, vr, table, plen, lens, layer, window=0):
    """K4 on the current tree, through the entry that tree has."""
    lib = _build.library()
    if not lib.older_k4 and lib.k4_window:
        return paged.ring_decode_attention(q, kp, vp, kr, vr, table, plen, lens, layer,
                                           window=window)
    if window:
        raise ValueError("this tree's K4 has no window")
    if not lib.older_k4:
        (B, H, D), (L, Hkv, n_pages, P, _), pm, T = q.shape, kp.shape, table.shape[1], kr.shape[3]
        work, counters, max_splits = paged._decode_scratch(lib, q, B, Hkv, H // Hkv, D,
                                                           pm * P + T)
        o = torch.empty_like(q)
        _build.check("ring_decode_attention", lib.mmt_ring_decode_attention(
            q.data_ptr(), kp.data_ptr(), vp.data_ptr(), kr.data_ptr(), vr.data_ptr(),
            table.data_ptr(), plen.data_ptr(), lens.data_ptr(), work.data_ptr(),
            counters.data_ptr(), o.data_ptr(), L, B, H, Hkv, D, n_pages, P, pm, T, layer,
            D ** -0.5, max_splits, 1, _build.stream_handle(q.device)))
        return o
    (B, H, D), (_, Hkv, n_pages, P, _), pm, T = q.shape, kp.shape, table.shape[1], kr.shape[3]
    n_splits = -(-(pm * P + T) // lib.mmt_ring_decode_split_keys())
    partial = torch.empty(B * Hkv * n_splits * (H // Hkv) * (D + 2), dtype=torch.float32,
                          device="cuda")
    o = torch.empty_like(q)
    _build.check("ring_decode_attention", lib.mmt_ring_decode_attention(
        q.data_ptr(), kp.data_ptr(), vp.data_ptr(), kr.data_ptr(), vr.data_ptr(),
        table.data_ptr(), plen.data_ptr(), lens.data_ptr(), partial.data_ptr(), o.data_ptr(),
        B, H, Hkv, D, n_pages, P, pm, T, layer, D ** -0.5, n_splits, 1,
        _build.stream_handle(q.device)))
    return o


def paged_decode(q, kp, vp, table, lens):
    """K8 on the current tree, through the entry that tree has."""
    lib = _build.library()
    if not lib.older_k4:
        return paged.paged_attention(q, kp, vp, table, lens)
    (B, H, D), (Hkv, n_pages, P, _), pm = q.shape, kp.shape, table.shape[1]
    n_splits = -(-(pm * P) // lib.mmt_ring_decode_split_keys())
    partial = torch.empty(B * Hkv * n_splits * (H // Hkv) * (D + 2), dtype=torch.float32,
                          device="cuda")
    o = torch.empty_like(q)
    _build.check("paged_attention", lib.mmt_paged_attention(
        q.data_ptr(), kp.data_ptr(), vp.data_ptr(), table.data_ptr(), lens.data_ptr(),
        partial.data_ptr(), o.data_ptr(), B, H, Hkv, D, n_pages, P, pm, D ** -0.5, n_splits, 1,
        _build.stream_handle(q.device)))
    return o


def decode_runs(gen) -> dict:
    """K4 (phase 3's ragged case, and phase 5's shape over 8 layers taken in
    turn) and K8 (the serving case and 4,096 tokens), bf16."""
    c = cs.paged_case(torch.bfloat16, gen)
    args = tuple(c[k] for k in ("q", "k_pages", "v_pages", "k_ring", "v_ring", "page_table",
                                "pages_len", "lengths"))
    B, H, Hkv, D, P, T, L, pm = 8, 32, 8, 128, 128, 8, 8, 5
    n_pages = 1 + B * pm

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda", dtype=torch.bfloat16)

    p5 = (randn(B, H, D), randn(L, Hkv, n_pages, P, D), randn(L, Hkv, n_pages, P, D),
          randn(L, B, Hkv, T, D), randn(L, B, Hkv, T, D),
          torch.from_numpy(np.random.default_rng(3).permutation(np.arange(1, n_pages))
                           .reshape(B, pm).astype(np.int32)).cuda(),
          torch.full((B,), 568, dtype=torch.int32, device="cuda"),
          torch.full((B,), 568 + T - 1, dtype=torch.int32, device="cuda"))
    layer = {"i": 0}

    def p5_run():
        layer["i"] = (layer["i"] + 1) % L
        return ring_decode(*p5, layer["i"])

    def p5_reset():  # every tree's compared output comes from the same layer
        layer["i"] = 0

    p5_run.reset = p5_reset

    serving = cs.k8_case(torch.bfloat16, gen, [513, 530, 0, 576, 541, 560, 527, 550], 5)
    long = cs.k8_case(torch.bfloat16, gen, [4096, 3585, 3900, 4000, 3700, 4095, 3800, 3990], 32)
    at3000 = cs.mellum_k4_case(gen, [3000] * 128)
    mix = cs.mellum_k4_case(gen, cs.grpo_long_lengths())
    out = {"ring_decode K4 ragged": lambda: ring_decode(*args, 1),
           "ring_decode K4 phase 5": p5_run,
           "paged K8 serving": lambda: paged_decode(*serving),
           "paged K8 4096": lambda: paged_decode(*long),
           "ring_decode K4 mellum 3000 keys": lambda: ring_decode(*at3000, 0),
           "ring_decode K4 mellum 3000 keys window 1024":
               lambda: ring_decode(*at3000, 0, window=1024),
           "ring_decode K4 mellum cell mix window 1024":
               lambda: ring_decode(*mix, 0, window=1024)}
    for name in ("ring_decode K4 mellum 3000 keys window 1024",
                 "ring_decode K4 mellum cell mix window 1024"):
        out[name].needs = "k4_window"
    return out


def expert_runs(gen) -> dict:
    """The grouped-expert kernel at Mellum2-12B's widths: a 128-slot decode
    step (1,024 assignments) and a 1,024-token prefill chunk, routed by a
    softmax top-8 of random router scores."""
    E, F_, D, k = 64, 896, 2304, 8
    w = [torch.randn(*shape, generator=gen, device="cuda").mul_(fan ** -0.5).bfloat16()
         for shape, fan in (((E, F_, D), D), ((E, F_, D), D), ((E, D, F_), F_))]
    out = {}
    for name, N in (("decode 128 slots", 128), ("prefill 1024 tokens", 1024)):
        x = torch.randn(N, D, generator=gen, device="cuda").bfloat16()
        scores = torch.softmax(torch.randn(N, E, generator=gen, device="cuda"), dim=-1)
        top, ids = torch.topk(scores, k, dim=-1)
        top = top / top.sum(dim=-1, keepdim=True)
        fn = (lambda x=x, ids=ids, top=top: ge.grouped_experts(x, ids, top, *w))
        fn.needs = "has_experts"
        out[f"grouped_experts {name}"] = fn
    return out


def graph_ms(fn, n: int = 20, reps: int = 5):
    """Device time a call from the replay of a CUDA graph of n calls."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    side.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (n * reps)


def oproj_ln_quant(*args):
    """K7c (int8 o) on the current tree: through ``mmt_int8_res_ln_quant``
    where the tree has it, else through the wrapper's entry."""
    lib = _build.library()
    if not hasattr(lib, K7C_OLDER):
        return v8.oproj_ln_quant(*args)
    entry = lib.mmt_int8_fc2_res_ln_quant
    lib.mmt_int8_fc2_res_ln_quant = getattr(lib, K7C_OLDER)
    try:
        return v8.oproj_ln_quant(*args)
    finally:
        lib.mmt_int8_fc2_res_ln_quant = entry


def int8_runs(B: int, tag: str = "") -> dict:
    """The K7 kernels at B images of the ViT-L/14 shape (K7b and K7g's
    projection alone at the encode shape only)."""
    c = cs.int8_case(torch.Generator(device="cuda").manual_seed(0), B)
    M, D = c["M"], c["D"]
    xq2d = c["xq"].view(M, D)
    s0, inv_q, inv_k = (v8.f32(x) for x in c["scales6"][:3])
    runs = {
        f"fc1_gelu_quant{tag}": lambda: v8.fc1_gelu_quant(c["o8"], c["w1"], c["w1_s"], c["bF"],
                                                          1.1, 0.04, "quick_gelu_approx"),
        f"fc2_res_ln_quant{tag}": lambda: v8.fc2_res_ln_quant(c["h8"], c["x"], c["w2"],
                                                              c["w2_s"], c["bD"], c["lnw"],
                                                              c["lnb"], 1.3, 0.025, 1e-5),
        f"qkv_attn_int8{tag}": lambda: v8.qkv_attn_int8(c["xq"], c["wqkv"], c["wqkv_s"],
                                                        c["qkv_b"], c["scales6"], 16, 257),
        f"oproj_ln_quant{tag}": lambda: oproj_ln_quant(c["o8"], c["x"], c["wo"], c["wo_s"],
                                                       c["bD"], c["lnw"], c["lnb"], 1.3, 0.025,
                                                       1e-5),
    }
    if not tag:
        runs.update({
            "qkv_project": lambda: v8._qkv_project(xq2d, c["wqkv"], c["wqkv_s"], c["qkv_b"], s0,
                                                   inv_q, inv_k),
            "qkv_int8": lambda: v8.qkv_int8(xq2d, c["wqkv"], c["wqkv_s"], c["qkv_b"], 1.3),
        })
    return runs


# runs also timed by CUDA-graph replay (their wrappers allocate from the
# caching allocator and launch, nothing else)
GRAPHED = ("wo_matmul", "ring_decode", "paged", "grouped_experts")


def main(dirs, only=()) -> int:
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    libs = {d: load_tree(d) for d in dirs}
    _build._lib = libs[dirs[0]]
    runs = flash_runs(torch.Generator(device="cuda").manual_seed(2))
    runs.update(int8_runs(256))
    runs.update(int8_runs(8, " B=8"))
    gen = torch.Generator(device="cuda").manual_seed(1)
    shapes = [(name, M, K, N) for M in (8, 40, 4096) for name, (K, N) in cs.LLAMA_8B_PROJ.items()]
    shapes.append(("lm_head", 8, *cs.LM_HEAD_8B))
    for name, M, K, N in shapes:
        x = torch.randn(M, K, generator=gen, device="cuda").to(torch.bfloat16)
        w = torch.randint(-127, 128, (N, K), generator=gen, device="cuda", dtype=torch.int8)
        ws = (0.5 + torch.rand(N, generator=gen, device="cuda")) * (0.5 / (73 * K ** 0.5))
        runs[f"wo_matmul {name} M={M}"] = lambda x=x, w=w, ws=ws: wo_matmul(x, w, ws)
    runs.update(decode_runs(gen))
    runs.update(expert_runs(gen))

    if only:
        runs = {name: fn for name, fn in runs.items() if name.startswith(only)}

    def compare(a, b):
        """"equal", or max |a - b| / max |b| over the outputs."""
        a, b = (a, b) if isinstance(a, tuple) else ((a,), (b,))
        if all(torch.equal(x, y) for x, y in zip(a, b)):
            return "equal"
        return max(((x.float() - y.float()).abs().max() / y.float().abs().max()).item()
                   for x, y in zip(a, b))

    first = None
    all_runs = runs
    for d in list(dirs) + list(reversed(dirs)):
        _build._lib = libs[d]
        runs = {name: fn for name, fn in all_runs.items()
                if getattr(libs[d], getattr(fn, "needs", ""), True)}
        times = {name: cs.device_ms(fn) for name, fn in runs.items()}
        times = {name: None if t is None else round(t, 4) for name, t in times.items()}
        graphs = {name: round(graph_ms(fn), 4) for name, fn in runs.items()
                  if name.startswith(GRAPHED)}
        for fn in runs.values():
            getattr(fn, "reset", lambda: None)()
        outs = {name: fn() for name, fn in runs.items()}
        first = first or outs
        same = {name: compare(outs[name], first[name]) if name in first else "first here"
                for name in runs}
        print(f"{d}: device ms {times}; graph-replay ms {graphs}; outputs against {dirs[0]}: "
              f"{same}", flush=True)
    return 0


if __name__ == "__main__":
    args = sys.argv[1:]
    only = ()
    if args[:1] == ["--only"]:
        only, args = tuple(args[1].split(",")), args[2:]
    sys.exit(main(args or [str(_build.CSRC)], only))

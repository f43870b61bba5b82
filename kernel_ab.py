"""Time the hand-written kernels of several kernel source trees in one
process, on one card: the flash kernels K1, K2a and K2b in bf16 at the
training shape (B = 1, H = 32, Hkv = 8, S = 4096, D = 128, causal, keys from
3500 masked; K2a and K2b on K1's o and lse from the first tree), the W8A8 ViT
kernels (K7b, K7c, K7d, K7e, K7g and K7g's projection alone) at the
ViT-L/14 encode shape (256 images, M = 65,792 rows) and the weight-only
int8 matmul K9 in bf16 at the Llama-3.1-8B decode shapes (M = 8) and the
W8A16 prefill's gate-up (M = 4,096).

    python3 kernel_ab.py [--only NAME[,NAME...]] [SOURCE_DIR ...]

Each SOURCE_DIR holds a copy of ``multimeditron_torch/csrc`` (default: that
directory alone); every tree is built into its own library. A tree older
than K7e's own entry point (``mmt_int8_fc2_res_ln_quant``) runs K7e through
the entry it had then, ``mmt_int8_res_ln_quant``, and a tree that still has
that entry runs K7c (int8 o) through it, as the wrappers did before K7c
moved to K7e's kernel. K7c, K7d, K7e and K7g also run at the serving shape
(8 images, M = 2,056). The trees run in turns, forward then backward (A, B,
B, A), each timed by its kernels' device time from torch.profiler, and every
tree's outputs are compared with the first tree's: equal, or the largest
difference relative to the largest value. ``--only`` keeps the kernels whose names start with one of the given
prefixes (e.g. ``--only flash``).
"""

from __future__ import annotations

import ctypes
import pathlib
import sys

import torch

import chip_smoke as cs
from multimeditron_torch import _build
from multimeditron_torch.ops import flash_attention as fl
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


def load_tree(d: str):
    """Build and load the kernel tree in directory ``d``."""
    _build.CSRC, _build._lib = pathlib.Path(d).resolve(), None
    out = _build.library_path()
    if not out.exists():
        _build._compile(out)
    missing = {n: o for n, o in OLDER_ENTRIES.items() if not hasattr(ctypes.CDLL(str(out)), n)}
    signatures = dict(_build.SIGNATURES)
    for name in missing:
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
    return lib


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
    shapes = [(name, 8, K, N) for name, (K, N) in cs.LLAMA_8B_PROJ.items()]
    shapes += [("lm_head", 8, *cs.LM_HEAD_8B), ("gateup", 4096, *cs.LLAMA_8B_PROJ["gateup"])]
    for name, M, K, N in shapes:
        x = torch.randn(M, K, generator=gen, device="cuda").to(torch.bfloat16)
        w = torch.randint(-127, 128, (N, K), generator=gen, device="cuda", dtype=torch.int8)
        ws = (0.5 + torch.rand(N, generator=gen, device="cuda")) * (0.5 / (73 * K ** 0.5))
        runs[f"wo_matmul {name} M={M}"] = lambda x=x, w=w, ws=ws: wo.wo_matmul(x, w, ws)

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
    for d in list(dirs) + list(reversed(dirs)):
        _build._lib = libs[d]
        times = {name: round(cs.device_ms(fn), 4) for name, fn in runs.items()}
        outs = {name: fn() for name, fn in runs.items()}
        first = first or outs
        same = {name: compare(outs[name], first[name]) for name in runs}
        print(f"{d}: device ms {times}; outputs against {dirs[0]}: {same}", flush=True)
    return 0


if __name__ == "__main__":
    args = sys.argv[1:]
    only = ()
    if args[:1] == ["--only"]:
        only, args = tuple(args[1].split(",")), args[2:]
    sys.exit(main(args or [str(_build.CSRC)], only))

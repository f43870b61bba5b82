"""Time the W8A8 ViT kernels (K7c, K7d, K7e, K7g) and the weight-only int8
matmul K9 of several kernel source trees in one process, on one card: K7 at
the ViT-L/14 encode shape (256 images, M = 65,792 rows), K9 in bf16 at the
Llama-3.1-8B decode shapes (M = 8) and the W8A16 prefill's gate-up
(M = 4,096).

    python3 kernel_ab.py [SOURCE_DIR ...]

Each SOURCE_DIR holds a copy of ``multimeditron_torch/csrc`` (default: that
directory alone); every tree is built into its own library. The trees run in
turns, forward then backward (A, B, B, A), each timed by its kernels' device
time from torch.profiler, and every tree's outputs are compared with the
first tree's.
"""

from __future__ import annotations

import pathlib
import sys

import torch

import chip_smoke as cs
from multimeditron_torch import _build
from multimeditron_torch.ops import vit_int8_fused as v8
from multimeditron_torch.ops import wo_matmul as wo


def main(dirs) -> int:
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    libs = {}
    for d in dirs:
        _build.CSRC, _build._lib = pathlib.Path(d).resolve(), None
        libs[d] = _build.library()
    c = cs.int8_case(torch.Generator(device="cuda").manual_seed(0), 256)
    runs = {
        "qkv_attn_int8": lambda: v8.qkv_attn_int8(c["xq"], c["wqkv"], c["wqkv_s"], c["qkv_b"],
                                                  c["scales6"], 16, 257),
        "oproj_ln_quant": lambda: v8.oproj_ln_quant(c["o8"], c["x"], c["wo"], c["wo_s"], c["bD"],
                                                    c["lnw"], c["lnb"], 1.3, 0.025, 1e-5),
        "fc1_gelu_quant": lambda: v8.fc1_gelu_quant(c["o8"], c["w1"], c["w1_s"], c["bF"], 1.1,
                                                    0.04, "quick_gelu_approx"),
        "fc2_res_ln_quant": lambda: v8.fc2_res_ln_quant(c["h8"], c["x"], c["w2"], c["w2_s"],
                                                        c["bD"], c["lnw"], c["lnb"], 1.3, 0.025,
                                                        1e-5),
    }
    gen = torch.Generator(device="cuda").manual_seed(1)
    shapes = [(name, 8, K, N) for name, (K, N) in cs.LLAMA_8B_PROJ.items()]
    shapes += [("lm_head", 8, *cs.LM_HEAD_8B), ("gateup", 4096, *cs.LLAMA_8B_PROJ["gateup"])]
    for name, M, K, N in shapes:
        x = torch.randn(M, K, generator=gen, device="cuda").to(torch.bfloat16)
        w = torch.randint(-127, 128, (N, K), generator=gen, device="cuda", dtype=torch.int8)
        ws = (0.5 + torch.rand(N, generator=gen, device="cuda")) * (0.5 / (73 * K ** 0.5))
        runs[f"wo_matmul {name} M={M}"] = lambda x=x, w=w, ws=ws: wo.wo_matmul(x, w, ws)

    def equal(a, b):
        a, b = (a, b) if isinstance(a, tuple) else ((a,), (b,))
        return all(torch.equal(x, y) for x, y in zip(a, b))

    first = None
    for d in list(dirs) + list(reversed(dirs)):
        _build._lib = libs[d]
        times = {name: round(cs.device_ms(fn), 4) for name, fn in runs.items()}
        outs = {name: fn() for name, fn in runs.items()}
        first = first or outs
        same = {name: equal(outs[name], first[name]) for name in runs}
        print(f"{d}: device ms {times}; outputs equal to {dirs[0]}: {same}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:] or [str(_build.CSRC)]))

"""Drive the PyTorch port (multimeditron_torch) once on one NVIDIA GPU.

Run from the repository root:

    python3 chip_smoke.py [--mellum-only]

(``--mellum-only``: phases 1, 2 and 14 alone).

Phases, each of which raises on failure (non-zero exit):

1. device: a CUDA device must be present; prints nvidia-smi's name and
   power limit;
2. build: compiles the CUDA kernels (csrc/*.cu) into multimeditron_torch/build/,
   and prints what ptxas reports for the QKV projection's, K7d's, K7e's,
   K9's and K4 / K8's kernels (registers, spills);
3. kernels: each kernel (K3 encoder attention and its gradient at the
   serving batch, and in bf16 at the encode batch of 256 images beside SDPA's
   device time; K4 ring decode attention (a ragged case and, in bf16, phase
   5's shape: 8 slots of 576 keys), K8 paged decode attention (the serving
   shape and a 4,096-token case), K6 ring verify attention, K5 ring fold
   (K4, K6 and K8 beside SDPA over K/V gathered beforehand, K5 beside one
   advanced-index assignment), K1 flash forward (the training shape, with its TFLOP/s and SDPA's
   device time, and its decode form: Sq = 1 over a masked 640-key cache),
   K2a/K2b flash backward on K1's own o and lse, with their TFLOP/s and SDPA's
   backward's device time) against its plain PyTorch twin on
   the card, at the main paths' shapes, in float32 and bfloat16; the W8A8 ViT
   kernels (K7a
   ln_quant, K7g qkv_attn_int8 in each consume path: int8 out, float out,
   static stabiliser without fuse_l, row max; K7g's QKV projection alone,
   bitwise against its twin; K7b qkv_int8 with bf16, float32 and int8
   outputs, K7c oproj_ln_quant with an int8 and a bf16 o, K7d fc1_gelu_quant,
   K7e fc2_res_ln_quant, K7f mlp_fused, also against the split pair (x''
   bitwise, the int8 row within the int8 tolerance: K7e's LayerNorm sums
   run in another order than K7f's), and K10
   encoder_attention_int8) at the ViT-L/14 serving shape (8 images,
   M = 2,056 rows) and encode shape (256 images, M = 65,792). Each with
   CUDA-event timings around the wrapper, its device time from
   torch.profiler (the kernels' own CUDA time per call), the least time the
   card could take (bytes over 3.35 TB/s or operations over the type's
   peak, the larger) and, where one
   PyTorch call computes the same function or a named part of it, that
   call's time;
4. serving end to end in float32: the serving engine on the card against the
   same engine and weights on the CPU: greedy tokens, speculative greedy
   (k = 2, 4) equal to plain greedy, speculative sampling (k = 2, 4) equal
   across k and devices, a forked group, a chunked long prompt and staggered
   admission; the same through kv_mode="slab" (greedy equal to paged greedy,
   sampled, speculative, chunked, submit_group's fallback, quantize_llm), and
   generate() greedy and sampled;
5. serving at full width: seeded random weights at Llama-3.1-8B widths plus
   the CLIP ViT-L/14 tower in bfloat16, 8 requests of 512 prompt tokens with
   one 224x224 uint8 image each and 64 new tokens, through submit() and
   run(), timed; then one more such round under torch.profiler that counts
   each kernel's launches (each decode step is a replay of the graph the
   warm-up round captured, so K4 and K9 are counted from the round's device
   records, the others on the host);
6. training end to end in float32: 3 optimizer steps of MultimodalTrainer in
   ALIGNMENT and in FULL (remat, grad_accum=2) on the card against the CPU
   (losses and updated parameters must agree); and ALIGNMENT with
   quantize_frozen_towers (the fused int8 tower; losses within 1e-3);
7. training at full width: the phase-5 model, ALIGNMENT (projector only,
   remat), one collated batch of 4 x 4096 tokens with 16 uint8 images,
   through MultimodalTrainer.train(): one warm-up step, then 3 timed steps;
   counts each kernel's launches in that run; then one more step under
   torch.profiler: its top device ops by name and the device's busy share;
8. speculative serving at full width: the phase-5 model with k = 4, greedy,
   8 slots: 3 requests of 512 tokens, a forked group of 4 over a 512-token
   prompt and a 1,000-token prompt that prefills in two chunks, each with
   one image and 64 new tokens, through submit(), submit_group() and run();
   counts each kernel's launches in that run;
9. int8 encode at full width (the JAX bench's encode leg): the phase-5
   model's CLIP ViT-L/14 tower quantised with quantize_params(fused=True)
   (calibrated on 16 uint8 images) and its projector with
   quantize_mlp_projector; 8 batches of 256 uint8 224x224 images through the
   uint8 wire normalisation, int8 tower + int8 projector against the bf16
   tower + projector on the same images: img/s of each, calibration time,
   cosine (fails below 0.99), each K7 kernel's launches, and K3's in the bf16
   run (24 a batch);
10. serving with the int8 tower: phase 5 again on the quantised model; the
   K7 kernels launch and K3 does not;
11. int8 LLM serving at full width (the JAX bench's 8B configuration): the
   phase-5 model with its bf16 tower, served with quantize_llm=True and
   w8a8_prefill=True, phase 5's run and phase 8's speculative run (k = 4):
   K9 launches 129 times a decode or verify step, W8A8 runs 4 x 32 products
   a prefill call and none in decode; the int8 decoder's logits against the
   bf16 model's on one probe prompt (W8A16, and W8A8 with the gate open);
   then phase 5's run in W8A16 (quantize_llm alone, docs/serving.md's
   configuration): K9 launches 129 times a prefill call and a decode step,
   no W8A8 product; TTFT, decode tok/s and the prefill's profile;
12. the other calibrations of the fused int8 tower at full width: the
   phase-5 tower smoothed and calibrated on 16 uint8 images as (L, 4)
   (calibrate_act_scales) and as (L, 7) (calibrate_vit_int8_fused cut to
   seven columns), each exported and loaded back through load_jax_params,
   8 batches of 256 images through ImageModality.encode (img/s, cosine
   against bf16, fails below 0.99) and phase 5's serving run: (L, 4)
   launches K7b and K3 and no K7g, (L, 7) K7g's row-max form and no K3.
   Then one batch each of the (L, 8) tower with int8_o=False and with
   fuse_l=False, and one of the ops without a caller composed (K7b with int8
   outputs, K10, K7c with a float o, K7f), each cosine >= 0.99;
13. the slab KV mode and generate() at full width: phase 5's model and
   requests through kv_mode="slab" (TTFT, decode tok/s, peak memory, the busy
   share of one decode chunk; K1 launches 32 times a live decode step, K3 24
   times a prefill call, K4, K5, K6 and K8 not at all), phase 8's
   speculative mix through slab mode (k = 4, greedy; the forked group becomes
   four requests), generate() on 8 right-padded 512-token prompts with one
   image each, 64 new tokens, greedy (K1 32 times a live step); then K8
   through its own entry point: the slab run's cache laid out in pages
   through a shuffled page table, one paged_attention call a layer, against
   K1 over the contiguous cache;
14. Mellum2-12B-A2.5B at full width (the GRPO cell's model): the
   grouped-expert kernel against its twin at a 128-slot decode step and a
   1,024-token prefill chunk (D 2,304, 64 experts of 896, top 8) and K4
   with the 1,024-key window against its twin over the cell's mix of
   lengths and over 3,000 keys (also with no window, which must be slower),
   each tolerance shown to miss a one-expert or one-tile error, with
   device time and bound; then the engine on the whole model (5 requests
   of 400-1,300 prompt tokens and a forked group of 4, one image each, 64
   new tokens): every decode step a graph replay, the expert kernel 28
   times a step and a prefill call's, K4 28 times a step, from the counted
   round's device records.

Phase 3 also holds K9 (the weight-only int8 matmul) against its twin at the
Llama-3.1-8B projection shapes (M = 8, 40 and 4,096, and the lm_head at
M = 8), float32 and bf16, each beside torch.matmul on a weight dequantised
beforehand (by events and on the device); its entry sums a bf16 decode
step's 129 calls and a W8A16 prefill layer's four products; phase 4 adds
the engine with quantize_llm, and with quantize_llm + w8a8_prefill on a
256-row prefill.

The last lines of standard output are JSON objects for the full-width runs,
nvidia-smi's name and power limit, a JSON object describing each kernel,
then {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import gc
import argparse
import json
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

from multimeditron_torch import _build
from multimeditron_torch.modalities.image_clip import ImageConfig
from multimeditron_torch.models.generation import generate
from multimeditron_torch.models.llama import LlamaConfig
from multimeditron_torch.models.multimodal import MultimodalConfig, MultimodalModel, TrainingMode
from multimeditron_torch.ops import encoder_attention as enc
from multimeditron_torch.ops import flash_attention as fl
from multimeditron_torch.ops import paged_attention as paged
from multimeditron_torch.ops import vit_int8_fused as v8
from multimeditron_torch.ops import wo_matmul as wo
from multimeditron_torch.convert import export_jax_params, load_jax_params
from multimeditron_torch.models.vit_quant import (
    calibrate_act_scales,
    embed_patches,
    finish,
    vit_params_tree,
)
from multimeditron_torch.models.projector import (
    mlp_projector_forward_int8,
    mlp_projector_tree,
    quantize_mlp_projector,
)
from multimeditron_torch.serve import prng
from multimeditron_torch.serve.engine import EngineConfig, ServingEngine
from multimeditron_torch.train.trainer import MetricsLogger, MultimodalTrainer, TrainerConfig

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}  # max-abs, outputs of order 1
# Gradients are not of order 1 (they scale with the loss and the sequence),
# so they are held relative to the largest value of the twin's gradient:
# max|kernel - twin| / max|twin| within the same bounds.
GRAD_TOL = TOL
LSE_TOL = 1e-3  # max-abs on the base-2 logsumexp (values of order 10)
# H100 SXM peaks (NVIDIA's data sheet; dense): device memory and the rate of
# each input type's arithmetic (bf16 and int8 on tensor cores, float32 on CUDA
# cores)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12, torch.int8: 1979e12}
KERNELS = {
    "encoder_attention": dict(
        module=enc, source="multimeditron_torch/csrc/encoder_attention.cu",
        replaces="multimeditron_tpu/ops/encoder_attention.py:31"),
    "ring_decode_attention": dict(
        module=paged, source="multimeditron_torch/csrc/ring_decode.cu",
        replaces="multimeditron_tpu/ops/paged_attention.py:401"),
    "paged_attention": dict(
        module=paged, source="multimeditron_torch/csrc/ring_decode.cu",
        replaces="multimeditron_tpu/ops/paged_attention.py:95"),
    "ring_verify_attention": dict(
        module=paged, source="multimeditron_torch/csrc/ring_verify.cu",
        replaces="multimeditron_tpu/ops/paged_attention.py:634"),
    "fold_ring_into_pages": dict(
        module=paged, source="multimeditron_torch/csrc/fold_ring.cu",
        replaces="multimeditron_tpu/ops/paged_attention.py:780"),
    "flash_attention_fwd": dict(
        module=fl, source="multimeditron_torch/csrc/flash_fwd.cu",
        replaces="multimeditron_tpu/ops/flash_attention.py:90"),
    # K1's decode form (Sq = 1, the slab engine and generate): its own entry,
    # the same kernel and launch counter
    "flash_attention_fwd_decode": dict(
        module=fl, source="multimeditron_torch/csrc/flash_fwd.cu",
        replaces="multimeditron_tpu/ops/flash_attention.py:90",
        counter="flash_attention_fwd"),
    "flash_attention_bwd_dq": dict(
        module=fl, source="multimeditron_torch/csrc/flash_bwd.cu",
        replaces="multimeditron_tpu/ops/flash_attention.py:287"),
    "flash_attention_bwd_dkv": dict(
        module=fl, source="multimeditron_torch/csrc/flash_bwd.cu",
        replaces="multimeditron_tpu/ops/flash_attention.py:368"),
    "ln_quant": dict(
        module=v8, source="multimeditron_torch/csrc/vit_int8_rowln.cu",
        replaces="multimeditron_tpu/ops/vit_int8_fused.py:105"),
    "qkv_attn_int8": dict(
        module=v8, source="multimeditron_torch/csrc/vit_int8_attention.cu",
        replaces="multimeditron_tpu/ops/vit_int8_fused.py:217"),
    "oproj_ln_quant": dict(
        module=v8, source="multimeditron_torch/csrc/vit_int8_fc2.cu",
        replaces="multimeditron_tpu/ops/vit_int8_fused.py:128"),
    "fc1_gelu_quant": dict(
        module=v8, source="multimeditron_torch/csrc/vit_int8_fc1.cu",
        replaces="multimeditron_tpu/ops/vit_int8_fused.py:145"),
    "fc2_res_ln_quant": dict(
        module=v8, source="multimeditron_torch/csrc/vit_int8_fc2.cu",
        replaces="multimeditron_tpu/ops/vit_int8_fused.py:166"),
    "wo_matmul": dict(
        module=wo, source="multimeditron_torch/csrc/wo_matmul.cu",
        replaces="multimeditron_tpu/ops/wo_matmul.py:31"),
    "qkv_int8": dict(
        module=v8, source="multimeditron_torch/csrc/vit_int8_gemm.cu",
        replaces="multimeditron_tpu/ops/vit_int8_fused.py:111"),
    # K7g's projection alone: the kernel that every K7g form launches first
    "qkv_project": dict(
        module=v8, source="multimeditron_torch/csrc/vit_int8_gemm.cu",
        replaces="multimeditron_tpu/ops/vit_int8_fused.py:217"),
    "qkv_attn_int8_rowmax": dict(
        module=v8, source="multimeditron_torch/csrc/vit_int8_attention.cu",
        replaces="multimeditron_tpu/ops/vit_int8_fused.py:446"),
    "qkv_attn_int8_static": dict(
        module=v8, source="multimeditron_torch/csrc/vit_int8_attention.cu",
        replaces="multimeditron_tpu/ops/vit_int8_fused.py:446"),
    "qkv_attn_int8_float_out": dict(
        module=v8, source="multimeditron_torch/csrc/vit_int8_attention.cu",
        replaces="multimeditron_tpu/ops/vit_int8_fused.py:369"),
    "oproj_ln_quant_float": dict(
        module=v8, source="multimeditron_torch/csrc/vit_int8_rowln.cu",
        replaces="multimeditron_tpu/ops/vit_int8_fused.py:134"),
    "mlp_fused": dict(
        module=v8, source="multimeditron_torch/csrc/vit_int8_rowln.cu",
        replaces="multimeditron_tpu/ops/vit_int8_fused.py:179"),
    "encoder_attention_int8": dict(
        module=enc, source="multimeditron_torch/csrc/encoder_attention_int8.cu",
        replaces="multimeditron_tpu/ops/encoder_attention.py:170"),
}
SERVING = ("encoder_attention", "ring_decode_attention", "fold_ring_into_pages")
SPEC_SERVING = ("encoder_attention", "ring_verify_attention", "fold_ring_into_pages")
TRAINING = ("flash_attention_fwd", "flash_attention_bwd_dq", "flash_attention_bwd_dkv")
INT8_TOWER = ("ln_quant", "qkv_project", "qkv_attn_int8", "oproj_ln_quant", "fc1_gelu_quant",
              "fc2_res_ln_quant")
# each image tower's kernels: ln_quant once a forward, the others once a layer;
# every other tower kernel must not launch
TOWERS = {
    "bf16": ((), ("encoder_attention",)),
    "L8": (("ln_quant",), INT8_TOWER[1:]),
    "L4": (("ln_quant",), ("qkv_int8", "encoder_attention", "oproj_ln_quant_float",
                           "fc1_gelu_quant", "fc2_res_ln_quant")),
    "L7": (("ln_quant",), ("qkv_project", "qkv_attn_int8_rowmax", "oproj_ln_quant_float",
                           "fc1_gelu_quant", "fc2_res_ln_quant")),
    "L8_float_out": (("ln_quant",), ("qkv_project", "qkv_attn_int8_float_out",
                                     "oproj_ln_quant_float", "fc1_gelu_quant",
                                     "fc2_res_ln_quant")),
    "L8_no_fuse_l": (("ln_quant",), ("qkv_project", "qkv_attn_int8_static",
                                     "oproj_ln_quant_float", "fc1_gelu_quant",
                                     "fc2_res_ln_quant")),
}
TOWER_KERNELS = ("encoder_attention", "ln_quant", "qkv_int8", "qkv_project", "qkv_attn_int8",
                 "qkv_attn_int8_rowmax", "qkv_attn_int8_static", "qkv_attn_int8_float_out",
                 "oproj_ln_quant", "oproj_ln_quant_float", "fc1_gelu_quant", "fc2_res_ln_quant",
                 "mlp_fused", "encoder_attention_int8")
DECODE = ("ring_decode_attention", "fold_ring_into_pages")
# the kernels a slab-mode engine may not launch
PAGED_KERNELS = ("paged_attention", "ring_decode_attention", "ring_verify_attention",
                 "fold_ring_into_pages")
# Llama-3.1-8B projections, (K, N), in a decode step's order; 4 K9 calls a
# layer and the lm_head make 129 a step
LLAMA_8B_PROJ = {"qkv": (4096, 6144), "o": (4096, 4096), "gateup": (4096, 28672),
                 "down": (14336, 4096)}
LM_HEAD_8B = (4096, 128256)
K9_PER_STEP = 4 * 32 + 1
W8A8_PER_PREFILL = 4 * 32


# sources whose kernels' registers and spills phase 2 prints (-Xptxas -v;
# K7d and K7e report 168 registers, the count at launch, under setmaxnreg)
PTXAS_REPORTED = ("vit_int8_gemm.cu", "vit_int8_fc1.cu", "vit_int8_fc2.cu", "wo_matmul.cu",
                  "ring_decode.cu")

T_START = time.perf_counter()


def log(msg: str) -> None:
    print(msg, flush=True)


def phase(msg: str) -> None:
    """A phase's heading, with the seconds since the script started."""
    log(f"{msg} (t = {time.perf_counter() - T_START:.0f} s)")


def counter(name: str) -> tuple:
    """(module launch dict, key) holding kernel ``name``'s launch count."""
    k = KERNELS[name]
    return k["module"].launches, k.get("counter", name)


def launch_counts(names=SERVING) -> dict:
    return {name: counter(name)[0][counter(name)[1]] for name in names}


def check_tower_launches(tower: str, counts: dict, forwards: int, layers: int = 24) -> None:
    """The kernels of ``tower`` ran at least once (ln_quant) or ``layers``
    times (the others) a forward, over ``forwards`` forwards; every other
    tower kernel not at all. Removes the absent kernels from ``counts``."""
    once, per_layer = TOWERS[tower]
    for name in TOWER_KERNELS:
        if name in once + per_layer:
            need = forwards * (1 if name in once else layers)
            if counts[name] < need:
                raise AssertionError(f"{tower} tower: {name} launched {counts[name]} times, "
                                     f"fewer than {need}: {counts}")
        elif counts.pop(name, 0):
            raise AssertionError(f"{tower} tower: {name} launched: {counts}")


def reset_launch_counts(names=tuple(KERNELS)) -> None:
    for name in names:
        launches, key = counter(name)
        launches[key] = 0
    wo.launches["w8a8_matmul"] = 0  # not a kernel: where W8A8 fired


def bound(dtype, bytes_moved: float, flops) -> dict:
    """The least time the card could take: each input byte read once and each
    output byte written once at the memory rate, or the operations at the
    peak of their inputs' type, whichever is longer. ``flops`` is a count in
    ``dtype`` or a {dtype: count} for work in several types."""
    ops = flops if isinstance(flops, dict) else {dtype: flops}
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = sum(n / PEAK_FLOPS[dt] for dt, n in ops.items()) * 1e3
    return dict(bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations")


def time_ms(fn, n: int = 20, warmup: int = 3) -> float:
    """Median device time of ``fn`` over ``n`` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, n: int = 10, tries: int = 3, label: str = ""):
    """Device time of ``fn`` per call: the CUDA time of every kernel that the
    calls launch, summed from a torch.profiler trace of ``n`` calls, over n.
    Kineto now and then returns a trace that holds no device event at all;
    such a trace is taken again, up to ``tries`` times, and after that the
    time is None ("not measured": the CUDA-event ``ms`` stands alone).
    With a ``label``, the count of device events in the trace is logged, so
    that a trace missing some of its events shows beside its time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(1, tries + 1):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        spans = [e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        us = sum(spans)
        if label:
            log(f"  {label}: {len(spans)} device events in {n} calls, "
                f"{us / 1e3 / n:.4f} ms a call on the device")
        if us > 0:
            return us / 1e3 / n
        log(f"  torch.profiler recorded no device time (trace {attempt} of {tries})")
    return None


def fmt_ms(t) -> str:
    return "not measured" if t is None else f"{t:.4f}"


def check_close(name: str, got: torch.Tensor, want: torch.Tensor, tol: float) -> float:
    torch.cuda.synchronize()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    err = (got.float() - want.float()).abs().max().item()
    log(f"  {name}: max_abs_err={err:.3e} (tol {tol:g})")
    if not err <= tol:
        raise AssertionError(f"{name}: max abs error {err} > {tol}")
    return err


def check_grad(name: str, got: torch.Tensor, want: torch.Tensor, tol: float) -> float:
    """max|got - want| / max|want|; returns the max-abs error."""
    torch.cuda.synchronize()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite kernel gradient")
    err = (got.float() - want.float()).abs().max().item()
    rel = err / max(want.float().abs().max().item(), 1e-30)
    log(f"  {name}: max_abs_err={err:.3e}, relative to max|twin| {rel:.3e} (tol {tol:g})")
    if not rel <= tol:
        raise AssertionError(f"{name}: relative gradient error {rel} > {tol}")
    return err


# ----------------------------------------------------------------------
# Phase 3: each kernel against its plain twin
# ----------------------------------------------------------------------
def k3_times(q, k, v, H: int, dtype) -> dict:
    """K3's times at one shape (every key valid): the kernel by events and on
    the device, the plain twin, SDPA on the same heads, and the bound."""
    B, S, D = q.shape
    Dh = D // H
    qh, kh, vh = (x.view(B, S, H, Dh).transpose(1, 2).contiguous() for x in (q, k, v))
    tag = f"K3 {str(dtype)[6:]} B={B}"
    return dict(ms=time_ms(lambda: enc.encoder_attention(q, k, v, H)),
                device_ms=device_ms(lambda: enc.encoder_attention(q, k, v, H), label=tag),
                plain_ms=time_ms(lambda: enc.encoder_attention_plain(q, k, v, H, Dh ** -0.5)),
                library_ms=time_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh)),
                library_device_ms=device_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh),
                                            label=f"SDPA beside {tag}"),
                # q, k, v read and o written; QK^T and PV over every pair
                **bound(dtype, 4 * q.numel() * q.element_size(), 4 * B * H * S * S * Dh))


def check_k3_masks(tag: str, q, k, v, H: int, dtype) -> float:
    """K3 against its twin with every key valid and with keys from 200 on
    masked (rows past kv_len are garbage by contract)."""
    scale = (q.shape[-1] // H) ** -0.5
    S = q.shape[1]
    err = check_close(f"{tag} S={S}", enc.encoder_attention(q, k, v, H),
                      enc.encoder_attention_plain(q, k, v, H, scale), TOL[dtype])
    kv_len = 200
    check_close(f"{tag} kv_len={kv_len}",
                enc.encoder_attention(q, k, v, H, kv_len=kv_len)[:, :kv_len],
                enc.encoder_attention_plain(q, k, v, H, scale, kv_len)[:, :kv_len],
                TOL[dtype])
    return err


def check_encoder_attention(dtype, gen) -> dict:
    """K3 at CLIP ViT-L/14's serving batch (8 images) with its gradient, and
    in bf16 at the encode batch (256 images)."""
    B, S, H, Dh = 8, 257, 16, 64
    q, k, v = (torch.randn(B, S, H * Dh, generator=gen, device="cuda", dtype=dtype)
               for _ in range(3))
    scale = Dh ** -0.5
    tag = f"K3 {str(dtype)[6:]}"
    err = check_k3_masks(tag, q, k, v, H, dtype)
    # the gradient: the kernel's autograd Function against the twin's vjp
    qkv = [x.requires_grad_() for x in (q, k, v)]
    do = torch.randn(B, S, H * Dh, generator=gen, device="cuda", dtype=dtype)
    out = enc.encoder_attention(*qkv, H)
    if out.grad_fn is None:
        raise AssertionError("K3: the kernel's output has no grad_fn")
    got = torch.autograd.grad(out, qkv, do)
    want = torch.autograd.grad(enc.encoder_attention_plain(*qkv, H, scale), qkv, do)
    for name, a, b in zip("qkv", got, want):
        check_grad(f"{tag} d{name}", a, b, GRAD_TOL[dtype])
    res = dict(max_abs_err=err, **k3_times(*(x.detach() for x in qkv), H, dtype))
    if dtype == torch.bfloat16:
        big = [torch.randn(256, S, H * Dh, generator=gen, device="cuda", dtype=dtype)
               for _ in range(3)]
        res["encode_shape"] = dict(max_abs_err=check_k3_masks(f"{tag} B=256", *big, H, dtype),
                                   **k3_times(*big, H, dtype))
        e = res["encode_shape"]
        log(f"  K3 bf16 B=256: kernel {e['ms']:.4f} ms (device {fmt_ms(e['device_ms'])}), "
            f"plain {e['plain_ms']:.4f}, SDPA {e['library_ms']:.4f} (device "
            f"{fmt_ms(e['library_device_ms'])}), bound {e['bound_ms']:.4f} ({e['bound_by']})")
        del big
        torch.cuda.empty_cache()
    return res


def paged_case(dtype, gen):
    """Llama-3.1-8B decode shapes: 8 slots, 32 heads over 8 kv heads, D=128,
    pages of 128, a 16-row ring, 2 layers; ragged page lengths with 0, page
    boundaries and a full page; 0..15 ring rows in use."""
    B, H, Hkv, D, P, T, L, pm = 8, 32, 8, 128, 128, 16, 2, 5
    n_pages = 1 + B * pm
    pages_len = torch.tensor([0, 1, 127, 128, 129, 256, 383, 512], dtype=torch.int32)
    gen_rows = torch.tensor([3, 0, 15, 7, 1, 12, 5, 9], dtype=torch.int32)
    rng = np.random.default_rng(0)
    ids = rng.permutation(np.arange(1, n_pages))
    table = np.zeros((B, pm), np.int32)
    for b in range(B):
        need = min(-(-(int(pages_len[b]) + T) // P), pm)
        table[b, :need] = ids[b * pm: b * pm + need]

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda", dtype=dtype)

    return dict(
        q=randn(B, H, D), k_pages=randn(L, Hkv, n_pages, P, D),
        v_pages=randn(L, Hkv, n_pages, P, D), k_ring=randn(L, B, Hkv, T, D),
        v_ring=randn(L, B, Hkv, T, D), page_table=torch.from_numpy(table).cuda(),
        pages_len=pages_len.cuda(), lengths=(pages_len + gen_rows).cuda())


def gathered_ring_sdpa(q, k_pages, v_pages, k_ring, v_ring, page_table, pages_len, lengths,
                       layer):
    """A partial library yardstick for K4 (q (B, H, D)) and K6 (q (B, H, S,
    D)): the layer's pages and ring gathered to contiguous K/V beforehand
    (not timed), then one SDPA call with the key mask (query row i of a
    verify block sees ring rows <= lengths - pages_len + i)."""
    S = q.shape[2] if q.dim() == 4 else 1
    B, H = q.shape[:2]
    D = q.shape[-1]
    _, Hkv, _, P, _ = k_pages.shape
    pm, T = page_table.shape[1], k_ring.shape[3]
    table = page_table.long()
    k = torch.cat([k_pages[layer][:, table].transpose(0, 1).reshape(B, Hkv, pm * P, D),
                   k_ring[layer]], dim=2)
    v = torch.cat([v_pages[layer][:, table].transpose(0, 1).reshape(B, Hkv, pm * P, D),
                   v_ring[layer]], dim=2)
    page_ok = torch.arange(pm * P, device="cuda")[None, None, :] < pages_len[:, None, None]
    ring_ok = (torch.arange(T, device="cuda")[None, None, :]
               <= (lengths - pages_len)[:, None, None] + torch.arange(S, device="cuda")[None, :, None])
    mask = torch.cat([page_ok.expand(B, S, pm * P), ring_ok], dim=2)[:, None]
    qs = q if q.dim() == 4 else q[:, :, None, :]
    return lambda: F.scaled_dot_product_attention(qs, k, v, attn_mask=mask, enable_gqa=True)


GATHERED_NOTE = ("partial: SDPA over K/V gathered from pages and ring to contiguous memory "
                 "beforehand (the gather is not timed)")


def ring_decode_phase5(gen) -> dict:
    """K4 at phase 5's shape (bf16): 8 slots of 568 page keys and 8 ring rows
    (576 keys, the decode chunk's last step), 32 heads over 8 kv heads, D =
    128, pages of 128, an 8-row ring; 8 layers of pool and ring, each call on
    the next layer, so that no call finds its pages in the L2 cache."""
    B, H, Hkv, D, P, T, L, pm = 8, 32, 8, 128, 128, 8, 8, 5
    n_pages = 1 + B * pm

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda", dtype=torch.bfloat16)

    q, kp, vp = randn(B, H, D), randn(L, Hkv, n_pages, P, D), randn(L, Hkv, n_pages, P, D)
    kr, vr = randn(L, B, Hkv, T, D), randn(L, B, Hkv, T, D)
    ids = np.random.default_rng(3).permutation(np.arange(1, n_pages)).reshape(B, pm)
    table = torch.from_numpy(ids.astype(np.int32)).cuda()
    plen = torch.full((B,), 568, dtype=torch.int32, device="cuda")
    lens = plen + T - 1
    tail = (table, plen, lens)
    err = check_close("K4 bf16 phase 5 shape", paged.ring_decode_attention(q, kp, vp, kr, vr, *tail, 3),
                      paged.ring_decode_attention_plain(q, kp, vp, kr, vr, *tail, 3),
                      TOL[torch.bfloat16])
    layer = {"i": 0}

    def cycled(fn):
        def run():
            layer["i"] = (layer["i"] + 1) % L
            return fn(q, kp, vp, kr, vr, *tail, layer["i"])
        return run

    keys = int((lens + 1).sum())
    return dict(max_abs_err=err,
                ms=time_ms(cycled(paged.ring_decode_attention)),
                device_ms=device_ms(cycled(paged.ring_decode_attention), n=16),
                plain_ms=time_ms(cycled(paged.ring_decode_attention_plain)),
                library_ms=time_ms(gathered_ring_sdpa(q, kp, vp, kr, vr, *tail, 3)),
                library_note=GATHERED_NOTE,
                **bound(torch.bfloat16, (2 * keys * Hkv * D + 2 * B * H * D) * 2,
                        4 * H * D * keys))


def check_ring_decode(dtype, gen) -> dict:
    """K4 in phase 3's ragged case (times and bound from this case) and, in
    bf16, at phase 5's shape."""
    c = paged_case(dtype, gen)
    args = (c["q"], c["k_pages"], c["v_pages"], c["k_ring"], c["v_ring"],
            c["page_table"], c["pages_len"], c["lengths"], 1)
    err = check_close(f"K4 {str(dtype)[6:]}", paged.ring_decode_attention(*args),
                      paged.ring_decode_attention_plain(*args), TOL[dtype])
    B, H, D = c["q"].shape
    Hkv = c["k_pages"].shape[1]
    keys = int((c["lengths"] + 1).sum())  # pages + ring rows through this step's
    res = dict(max_abs_err=err,
               ms=time_ms(lambda: paged.ring_decode_attention(*args)),
               device_ms=device_ms(lambda: paged.ring_decode_attention(*args)),
               plain_ms=time_ms(lambda: paged.ring_decode_attention_plain(*args)),
               library_ms=time_ms(gathered_ring_sdpa(*args)),
               library_note=GATHERED_NOTE,
               **bound(dtype, (2 * keys * Hkv * D + 2 * B * H * D) * c["q"].element_size(),
                       4 * H * D * keys))
    if dtype == torch.bfloat16:
        res["phase5_shape"] = p5 = ring_decode_phase5(gen)
        log(f"  K4 bf16 phase 5 shape: kernel {p5['ms']:.4f} ms (device {fmt_ms(p5['device_ms'])}), "
            f"plain {p5['plain_ms']:.4f}, SDPA {p5['library_ms']:.4f}, bound {p5['bound_ms']:.4f} "
            f"({p5['bound_by']})")
    return res


def k8_case(dtype, gen, lengths, pm):
    """Llama-3.1-8B decode shapes for K8: 32 heads over 8 kv heads, D = 128,
    pages of 128, one layer's pool; slot b's lengths[b] tokens in pages of a
    shuffled page table."""
    B, H, Hkv, D, P = len(lengths), 32, 8, 128, 128
    n_pages = 1 + B * pm
    ids = np.random.default_rng(2).permutation(np.arange(1, n_pages))
    table = np.zeros((B, pm), np.int32)
    for b, n in enumerate(lengths):
        used = -(-n // P)
        table[b, :used] = ids[b * pm: b * pm + used]

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda", dtype=dtype)

    return (randn(B, H, D), randn(Hkv, n_pages, P, D), randn(Hkv, n_pages, P, D),
            torch.from_numpy(table).cuda(), torch.tensor(lengths, dtype=torch.int32).cuda())


def gathered_sdpa(q, k_pages, v_pages, page_table, lengths):
    """A partial library yardstick for K8: K/V gathered to contiguous memory
    beforehand (not timed), then one SDPA call with the key mask."""
    B, H, D = q.shape
    Hkv, _, P, _ = k_pages.shape
    N = page_table.shape[1] * P
    table = page_table.long()
    k = k_pages[:, table].transpose(0, 1).reshape(B, Hkv, N, D)
    v = v_pages[:, table].transpose(0, 1).reshape(B, Hkv, N, D)
    mask = (torch.arange(N, device="cuda")[None, :] < lengths[:, None])[:, None, None, :]
    qs = q[:, :, None, :]
    return lambda: F.scaled_dot_product_attention(qs, k, v, attn_mask=mask, enable_gqa=True)


def check_paged_attention(dtype, gen) -> dict:
    """K8 at the serving shape (8 slots, lengths 513..576 and one empty
    slot, pages_max 5: times and bound from this case) and a long case (8
    slots of 3,585..4,096 tokens, pages_max 32: many key splits)."""
    t = str(dtype)[6:]
    long = k8_case(dtype, gen, [4096, 3585, 3900, 4000, 3700, 4095, 3800, 3990], 32)
    err_long = check_close(f"K8 {t} 4,096 tokens", paged.paged_attention(*long),
                           paged.paged_attention_plain(*long), TOL[dtype])
    c = k8_case(dtype, gen, [513, 530, 0, 576, 541, 560, 527, 550], 5)
    got = paged.paged_attention(*c)
    err = check_close(f"K8 {t} serving", got, paged.paged_attention_plain(*c), TOL[dtype])
    if got[2].any():
        raise AssertionError("K8: the slot of length 0 is not an exact zero row")
    q = c[0]
    B, H, D = q.shape
    Hkv = c[1].shape[0]
    keys = int(c[4].sum())  # the keys the slots' lengths cover
    return dict(max_abs_err=max(err, err_long),
                ms=time_ms(lambda: paged.paged_attention(*c)),
                device_ms=device_ms(lambda: paged.paged_attention(*c)),
                plain_ms=time_ms(lambda: paged.paged_attention_plain(*c)),
                library_ms=time_ms(gathered_sdpa(*c)),
                library_note="partial: SDPA over K/V gathered to contiguous memory "
                             "beforehand (the gather is not timed)",
                long_case=dict(ms=time_ms(lambda: paged.paged_attention(*long)),
                               device_ms=device_ms(lambda: paged.paged_attention(*long)),
                               plain_ms=time_ms(lambda: paged.paged_attention_plain(*long)),
                               library_ms=time_ms(gathered_sdpa(*long)),
                               **bound(dtype, (2 * int(long[4].sum()) * Hkv * D + 2 * B * H * D)
                                       * q.element_size(), 4 * H * D * int(long[4].sum()))),
                # the page rows the lengths cover (K and V), q read, o written
                **bound(dtype, (2 * keys * Hkv * D + 2 * B * H * D) * q.element_size(),
                        4 * H * D * keys))


def check_flash_decode(dtype, gen) -> dict:
    """K1's decode form, as the slab engine and generate() launch it: B = 8,
    H = 32, Hkv = 8, Sq = 1 over a 640-key cache, D = 128, non-causal, a key
    mask of each slot's length (513..576)."""
    B, H, Hkv, Skv, D = 8, 32, 8, 640, 128
    lengths = torch.tensor([513, 530, 520, 576, 541, 560, 527, 550], device="cuda")
    q = torch.randn(B, H, 1, D, generator=gen, device="cuda", dtype=dtype)
    k, v = (torch.randn(B, Hkv, Skv, D, generator=gen, device="cuda", dtype=dtype)
            for _ in range(2))
    kv_mask = (torch.arange(Skv, device="cuda")[None, :] < lengths[:, None]).to(torch.int32)
    fwd = (q, k, v, kv_mask, False, D ** -0.5, Skv - 1)
    o, _ = fl._fwd_kernel(*fwd)
    err = check_close(f"K1 decode {str(dtype)[6:]}", o,
                      fl.flash_attention_fwd_plain(*fwd[:-1])[0], TOL[dtype])
    allowed = (kv_mask != 0)[:, None, None, :]
    keys = int(lengths.sum())
    return dict(max_abs_err=err,
                ms=time_ms(lambda: fl._fwd_kernel(*fwd)),
                device_ms=device_ms(lambda: fl._fwd_kernel(*fwd)),
                plain_ms=time_ms(lambda: fl.flash_attention_fwd_plain(*fwd[:-1])),
                library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=allowed, enable_gqa=True)),
                # the valid keys' K and V rows, q, o and the mask; lse written
                **bound(dtype, (2 * keys * Hkv * D + 2 * B * H * D) * q.element_size()
                        + kv_mask.numel() * 4 + B * H * 4, 4 * H * D * keys))


def verify_case(dtype, gen, ring_rows):
    """Llama-3.1-8B verify shapes with k = 4: 8 slots, 32 heads over 8 kv
    heads, S = 5 block rows, D = 128, pages of 128, pages_max 5, the engine's
    16-row ring, 2 layers; page lengths spread over 512..576; the block's
    first ring row at ``ring_rows`` per slot (0 in the engine)."""
    B, H, Hkv, S, D, P, T, L, pm = 8, 32, 8, 5, 128, 128, 16, 2, 5
    n_pages = 1 + B * pm
    pages_len = torch.tensor([512, 520, 527, 535, 543, 551, 560, 576], dtype=torch.int32)
    table = np.random.default_rng(1).permutation(np.arange(1, n_pages)).reshape(B, pm)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda", dtype=dtype)

    return dict(
        q=randn(B, H, S, D), k_pages=randn(L, Hkv, n_pages, P, D),
        v_pages=randn(L, Hkv, n_pages, P, D), k_ring=randn(L, B, Hkv, T, D),
        v_ring=randn(L, B, Hkv, T, D),
        page_table=torch.from_numpy(table.astype(np.int32)).cuda(), pages_len=pages_len.cuda(),
        lengths=(pages_len + torch.tensor(ring_rows, dtype=torch.int32)).cuda())


def check_ring_verify(dtype, gen) -> dict:
    """K6 with the engine's g = 0 (times and bound from this case) and with
    g > 0."""
    t, errs = str(dtype)[6:], []
    for tag, ring_rows in (("g>0", [0, 1, 2, 3, 4, 5, 6, 11]), ("g=0", [0] * 8)):
        c = verify_case(dtype, gen, ring_rows)
        args = (c["q"], c["k_pages"], c["v_pages"], c["k_ring"], c["v_ring"],
                c["page_table"], c["pages_len"], c["lengths"], 1)
        errs.append(check_close(f"K6 {t} {tag}", paged.ring_verify_attention(*args),
                                paged.ring_verify_attention_plain(*args), TOL[dtype]))
    B, H, S, D = c["q"].shape
    Hkv = c["k_pages"].shape[1]
    keys = int((c["lengths"] + S).sum())  # keys each slot's block reads
    pairs = int((c["lengths"] + 1).sum()) * S + B * S * (S - 1) // 2  # row s sees s more
    return dict(max_abs_err=max(errs),
                ms=time_ms(lambda: paged.ring_verify_attention(*args)),
                device_ms=device_ms(lambda: paged.ring_verify_attention(*args)),
                plain_ms=time_ms(lambda: paged.ring_verify_attention_plain(*args)),
                library_ms=time_ms(gathered_ring_sdpa(*args)),
                library_note=GATHERED_NOTE,
                **bound(dtype, (2 * keys * Hkv * D + 2 * B * H * S * D) * c["q"].element_size(),
                        4 * H * D * pairs))


def check_fold(dtype, gen) -> dict:
    c = paged_case(dtype, gen)
    rows = c["k_ring"].shape[3]
    tail = (c["k_ring"], c["v_ring"], c["page_table"], c["pages_len"], rows, c["lengths"])
    kk, vk = c["k_pages"].clone(), c["v_pages"].clone()
    kp, vp = c["k_pages"].clone(), c["v_pages"].clone()
    paged.fold_ring_into_pages(kk, vk, *tail)
    paged.fold_ring_into_pages_plain(kp, vp, *tail)
    torch.cuda.synchronize()
    # a copy is exact: every page but the trash page 0 must agree bit for bit
    err = max((kk[:, :, 1:].float() - kp[:, :, 1:].float()).abs().max().item(),
              (vk[:, :, 1:].float() - vp[:, :, 1:].float()).abs().max().item())
    moved = not torch.equal(kk[:, :, 1:], c["k_pages"][:, :, 1:])
    log(f"  K5 {str(dtype)[6:]}: pages 1.. max_abs_err={err} (must be 0), rows moved={moved}")
    if not (err == 0.0 and moved):
        raise AssertionError("K5: fold kernel disagrees with its plain twin")
    L, _, Hkv, _, D = c["k_ring"].shape
    moved = int((c["lengths"] - c["pages_len"]).clamp(0, rows).sum())  # rows per layer
    # partial library yardstick: the twin's page and row indices computed
    # beforehand (not timed), then one advanced-index assignment each for K
    # and V
    P, pm = c["k_pages"].shape[3], c["page_table"].shape[1]
    pos = c["pages_len"][:, None].long() + torch.arange(rows, device="cuda")[None, :]
    pid = torch.gather(c["page_table"].long(), 1, torch.clamp(pos // P, max=pm - 1))
    pid, off = torch.where(pos < c["lengths"][:, None], pid, 0), pos % P
    k_src = c["k_ring"][:, :, :, :rows].transpose(1, 2)
    v_src = c["v_ring"][:, :, :, :rows].transpose(1, 2)

    def index_put():
        kp[:, :, pid, off] = k_src
        vp[:, :, pid, off] = v_src

    return dict(max_abs_err=err,
                ms=time_ms(lambda: paged.fold_ring_into_pages(kk, vk, *tail)),
                device_ms=device_ms(lambda: paged.fold_ring_into_pages(kk, vk, *tail)),
                plain_ms=time_ms(lambda: paged.fold_ring_into_pages_plain(kp, vp, *tail)),
                library_ms=time_ms(index_put),
                library_note="partial: one advanced-index assignment each for K and V, the "
                             "page and row indices computed beforehand (not timed)",
                # K and V ring rows read and written into their pages
                **bound(dtype, 2 * 2 * L * moved * Hkv * D * kk.element_size(), 0))


def flash_case(dtype, gen, B, H, Hkv, Sq, Skv, D, dead_keys=()):
    """q, k, v and an int32 kv mask with the key ranges in ``dead_keys`` off."""
    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda", dtype=dtype)

    kv_mask = torch.ones(B, Skv, dtype=torch.int32, device="cuda")
    for b, lo, hi in dead_keys:
        kv_mask[b, lo:hi] = 0
    return randn(B, H, Sq, D), randn(B, Hkv, Skv, D), randn(B, Hkv, Skv, D), kv_mask


def check_flash_case(tag, dtype, gen, B, H, Hkv, Sq, Skv, D, causal, dead_keys):
    """K1 against its twin, then K2a, K2b on K1's o and lse against the twins'
    gradients, on one case; returns the errors and the inputs the timings
    reuse."""
    q, k, v, kv_mask = flash_case(dtype, gen, B, H, Hkv, Sq, Skv, D, dead_keys)
    scale, offset = D ** -0.5, Skv - Sq
    o, lse = fl._fwd_kernel(q, k, v, kv_mask, causal, scale, offset)
    o_ref, lse_ref = fl.flash_attention_fwd_plain(q, k, v, kv_mask, causal, scale)
    err_o = check_close(f"K1 {tag} o", o, o_ref, TOL[dtype])
    check_close(f"K1 {tag} lse (base 2)", lse, lse_ref, LSE_TOL)
    empty = lse_ref == fl.MASK_VALUE
    if not torch.equal(lse == fl.MASK_VALUE, empty) or o[empty].any():
        raise AssertionError(f"K1 {tag}: rows with no valid key are not exact zeros")
    # K2a / K2b read K1's own o and lse, as in training, and so does their twin
    do = torch.randn(o.shape, generator=gen, device="cuda", dtype=dtype)
    di = (o.float() * do.float()).sum(dim=-1)
    bwd = (q, k, v, kv_mask, lse, di, do, causal, scale, offset)
    dq = fl._dq_kernel(*bwd)
    dk, dv = fl._dkv_kernel(*bwd)
    dq_ref, dk_ref, dv_ref = fl.flash_attention_bwd_plain(q, k, v, kv_mask, o, lse, do,
                                                          causal, scale)
    err_dq = check_grad(f"K2a {tag} dq", dq, dq_ref, GRAD_TOL[dtype])
    err_dkv = max(check_grad(f"K2b {tag} dk", dk, dk_ref, GRAD_TOL[dtype]),
                  check_grad(f"K2b {tag} dv", dv, dv_ref, GRAD_TOL[dtype]))
    dead = (kv_mask == 0)[:, None, :, None].expand_as(dk)
    if dk[dead].any() or dv[dead].any():
        raise AssertionError(f"K2b {tag}: masked keys got a nonzero gradient")
    return dict(err_o=err_o, err_dq=err_dq, err_dkv=err_dkv, q=q, k=k, v=v, kv_mask=kv_mask,
                o=o, lse=lse, do=do, bwd=bwd, causal=causal, scale=scale)


def check_flash(dtype, gen) -> dict:
    """K1/K2a/K2b at the full-width training shape with B=1 (the plain twin's
    float32 scores are 2.1 GB per batch row): H=32, Hkv=8, S=4096, D=128,
    causal, keys from 3500 on masked (right padding); then three small edge
    cases: left padding that leaves query rows with no valid key, a
    non-causal, ragged, D=64 GQA case with holes in the mask, and 17
    end-aligned query rows over 1,000 keys with a whole key tile masked."""
    t = str(dtype)[6:]
    c = check_flash_case(f"{t} S=4096", dtype, gen, 1, 32, 8, 4096, 4096, 128, True,
                         [(0, 3500, 4096)])
    check_flash_case(f"{t} empty rows", dtype, gen, 2, 4, 2, 300, 300, 128, True,
                     [(0, 0, 100), (1, 250, 300)])
    check_flash_case(f"{t} non-causal D=64", dtype, gen, 2, 8, 2, 333, 517, 64, False,
                     [(0, 3, 9), (1, 400, 517)])
    check_flash_case(f"{t} Sq=17 over 1000 keys", dtype, gen, 1, 8, 2, 17, 1000, 64, True,
                     [(0, 128, 256), (0, 864, 1000)])
    fwd = (c["q"], c["k"], c["v"], c["kv_mask"], c["causal"], c["scale"], 0)
    twin_bwd = (c["q"], c["k"], c["v"], c["kv_mask"], c["o"], c["lse"], c["do"], c["causal"],
                c["scale"])
    plain_bwd = time_ms(lambda: fl.flash_attention_bwd_plain(*twin_bwd), n=10)
    # the library yardstick: SDPA with the same causal + key mask, GQA folded
    q, k, v, kv_mask, do = c["q"], c["k"], c["v"], c["kv_mask"], c["do"]
    B, H, S, D = q.shape
    allowed = torch.ones(S, S, dtype=torch.bool, device="cuda").tril() & (kv_mask[:, None, None, :] != 0)
    sdpa = dict(attn_mask=allowed, scale=c["scale"], enable_gqa=True)
    lib_fwd = time_ms(lambda: F.scaled_dot_product_attention(q, k, v, **sdpa), n=10)
    lib_fwd_device = device_ms(lambda: F.scaled_dot_product_attention(q, k, v, **sdpa), n=5,
                               label=f"SDPA beside K1 {t}")
    qkv = [x.detach().requires_grad_() for x in (q, k, v)]
    out = F.scaled_dot_product_attention(*qkv, **sdpa)
    lib_bwd = time_ms(lambda: torch.autograd.grad(out, qkv, do, retain_graph=True), n=10)
    lib_bwd_device = device_ms(lambda: torch.autograd.grad(out, qkv, do, retain_graph=True),
                               n=5, label=f"SDPA backward beside K2 {t}")
    del out, qkv
    # (query, key) pairs the causal mask and the key mask leave: query i
    # sees the valid keys j <= i
    pairs = int(kv_mask.cumsum(dim=1).sum())
    elt, big, small = q.element_size(), q.numel(), k.numel()
    rows = B * H * S * 4 + kv_mask.numel() * 4  # lse (or di) and the mask, float32/int32
    fwd_ms = time_ms(lambda: fl._fwd_kernel(*fwd), n=10)
    fwd_device_ms = device_ms(lambda: fl._fwd_kernel(*fwd), n=5, label=f"K1 {t}")
    fwd_ops = 4 * H * D * pairs
    rate = fwd_ops / ((fwd_device_ms or fwd_ms) * 1e-3) / 1e12
    log(f"  K1 {t} S=4096: {rate:.1f} TFLOP/s on "
        f"{'the device time' if fwd_device_ms else 'the event time'}")
    # K2a recomputes s and dp and takes dq (6 H D FLOP a pair), K2b s, dp, dv
    # and dk (8 H D)
    bwd = {}
    for name, tag, fn, flop in (("flash_attention_bwd_dq", "K2a", fl._dq_kernel, 6),
                                ("flash_attention_bwd_dkv", "K2b", fl._dkv_kernel, 8)):
        ms = time_ms(lambda: fn(*c["bwd"]), n=10)
        dev = device_ms(lambda: fn(*c["bwd"]), n=5, label=f"{tag} {t}")
        ops = flop * H * D * pairs
        bwd[name] = dict(ms=ms, device_ms=dev, tflops=ops / ((dev or ms) * 1e-3) / 1e12, ops=ops)
        log(f"  {tag} {t} S=4096: {bwd[name]['tflops']:.1f} TFLOP/s on "
            f"{'the device time' if dev else 'the event time'}")
    dq, dkv = bwd["flash_attention_bwd_dq"], bwd["flash_attention_bwd_dkv"]
    log(f"  K2a + K2b {t} S=4096: {dq['ms'] + dkv['ms']:.4f} ms by events against SDPA's "
        f"backward {lib_bwd:.4f} (device: {fmt_ms(dq['device_ms'])} + "
        f"{fmt_ms(dkv['device_ms'])} against {fmt_ms(lib_bwd_device)})")
    return {
        "flash_attention_fwd": dict(
            max_abs_err=c["err_o"], ms=fwd_ms, device_ms=fwd_device_ms,
            plain_ms=time_ms(lambda: fl.flash_attention_fwd_plain(*fwd[:-1]), n=10),
            library_ms=lib_fwd, library_device_ms=lib_fwd_device, tflops=rate,
            **bound(dtype, (2 * big + 2 * small) * elt + rows, fwd_ops)),
        # the twin and SDPA's backward compute dq, dk and dv in one function:
        # their times stand beside each backward kernel
        "flash_attention_bwd_dq": dict(
            max_abs_err=c["err_dq"], ms=dq["ms"], device_ms=dq["device_ms"],
            plain_ms=plain_bwd, library_ms=lib_bwd, library_device_ms=lib_bwd_device,
            tflops=dq["tflops"],
            **bound(dtype, (3 * big + 2 * small) * elt + rows + B * H * S * 4, dq["ops"])),
        "flash_attention_bwd_dkv": dict(
            max_abs_err=c["err_dkv"], ms=dkv["ms"], device_ms=dkv["device_ms"],
            plain_ms=plain_bwd, library_ms=lib_bwd, library_device_ms=lib_bwd_device,
            tflops=dkv["tflops"],
            **bound(dtype, (2 * big + 4 * small) * elt + rows + B * H * S * 4, dkv["ops"])),
    }


def time_sampler(gen) -> dict:
    """One plain decode step's sampling at full width, (8, 128256) float32
    logits: the host key split and the threefry categorical, against the
    greedy argmax."""
    logits = torch.randn(8, 128256, generator=gen, device="cuda")
    key = prng.prng_key(0)

    def sample():
        _, sub = prng.split(key)
        return prng.categorical(sub, logits)

    return dict(threefry_ms=time_ms(sample), argmax_ms=time_ms(lambda: logits.argmax(dim=-1)))


# ----------------------------------------------------------------------
# Phase 3, K7: the W8A8 ViT kernels against their twins
# ----------------------------------------------------------------------
def check_int8(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """int8 outputs: equal on >= 99.5% of elements and never more than 1
    apart (the LayerNorm and softmax sums run in another order than the
    twin's); returns the max-abs error."""
    torch.cuda.synchronize()
    diff = (got.int() - want.int()).abs()
    err, equal = diff.max().item(), (diff == 0).float().mean().item()
    log(f"  {name}: max_abs_err={err} (tol 1), equal {equal:.6f} (tol 0.995)")
    if not (err <= 1 and equal >= 0.995):
        raise AssertionError(f"{name}: int8 output disagrees with the twin")
    return float(err)


def check_ulp(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """Residual outputs: within one ulp of their dtype at their magnitude."""
    torch.cuda.synchronize()
    w = want.float()
    ulp = torch.exp2(torch.floor(torch.log2(w.abs().clamp(min=1e-30)))) * torch.finfo(want.dtype).eps
    err = (got.float() - w).abs()
    log(f"  {name}: max_abs_err={err.max().item():.3e}, within one ulp: "
        f"{bool((err <= ulp).all())}")
    if not (torch.isfinite(got).all() and (err <= ulp).all()):
        raise AssertionError(f"{name}: residual output off by more than one ulp")
    return err.max().item()


def int8_case(gen, B: int) -> dict:
    """ViT-L/14 layer inputs for B images (S = 257, D = 1024, F = 4096, 16
    heads): int8 activations and weights ((N, K) layout), scales that put
    every quantised value in range, a bf16 residual stream."""
    S, D, FF, H = 257, 1024, 4096, 16
    M = B * S

    def i8(*shape):
        return torch.randint(-127, 128, shape, generator=gen, device="cuda", dtype=torch.int8)

    def unif(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand(*shape, generator=gen, device="cuda")

    def scale(n, k):
        return unif(0.5, 1.5, n) / (127 * 60 * k ** 0.5)

    sq = 2.5 / 127
    return dict(
        B=B, S=S, D=D, FF=FF, H=H, M=M,
        x=(2 * torch.randn(M, D, generator=gen, device="cuda")).to(torch.bfloat16),
        lnw=unif(0.5, 1.5, D), lnb=0.1 * torch.randn(D, generator=gen, device="cuda"),
        xq=i8(B, S, D), wqkv=i8(3, D, D), wqkv_s=scale(3 * D, D),
        qkv_b=0.1 * torch.randn(3 * D, generator=gen, device="cuda"),
        scales6=[1.0, 1 / sq, 1 / sq, 6.0, sq * sq * 64 ** -0.5, 127 / 0.6],
        o8=i8(M, D), wo=i8(D, D), wo_s=scale(D, D),
        o16=(0.5 * torch.randn(M, D, generator=gen, device="cuda")).to(torch.bfloat16),
        w1=i8(FF, D), w1_s=unif(0.5, 1.5, FF) / (127 * 40 * D ** 0.5),
        h8=i8(M, FF), w2=i8(D, FF), w2_s=scale(D, FF),
        bD=0.1 * torch.randn(D, generator=gen, device="cuda"),
        bF=0.2 * torch.randn(FF, generator=gen, device="cuda"))


def check_int8_kernels(gen, B: int) -> dict:
    """K7a/g/c/d/e, K7g's projection alone and the kernels off the (L, 8)
    path at B images against their twins; times, device times, bounds and
    partial library yardsticks."""
    c = int8_case(gen, B)
    M, D, FF, S, H = c["M"], c["D"], c["FF"], c["S"], c["H"]
    tag = f"B={B} M={M}"
    n_plain = 20 if B <= 8 else 3
    out = {}

    def record(name, err, run, plain, library, note, nbytes, ops):
        out[name] = dict(max_abs_err=err, ms=time_ms(run), device_ms=device_ms(run),
                         plain_ms=time_ms(plain, n=n_plain, warmup=1),
                         library_ms=time_ms(library), library_note=note,
                         **bound(torch.int8, nbytes, ops))

    # K7a
    inv = v8.f32_inv(0.03)
    run = lambda: v8.ln_quant(c["x"], c["lnw"], c["lnb"], 0.03, 1e-5)  # noqa: E731
    plain = lambda: v8.ln_quant_plain(c["x"], c["lnw"], c["lnb"], inv, 1e-5)  # noqa: E731
    record("ln_quant", check_int8(f"K7a {tag}", run(), plain()), run, plain,
           lambda: F.layer_norm(c["x"], (D,), c["lnw"].bfloat16(), c["lnb"].bfloat16()),
           "partial: F.layer_norm, no quantisation", 3 * M * D + 8 * D, 0)

    # K7g's projection alone: q8, k8 and v bitwise equal to the twin's
    xq2d, wqkv_t = c["xq"].view(M, D), c["wqkv"].reshape(3 * D, D).t()
    s0, inv_q, inv_k = (v8.f32(x) for x in c["scales6"][:3])
    p_args = (xq2d, c["wqkv"], c["wqkv_s"], c["qkv_b"], s0, inv_q, inv_k)
    run = lambda: v8._qkv_project(*p_args)  # noqa: E731
    plain = lambda: v8.qkv_project_plain(*p_args)  # noqa: E731
    for part, got, want in zip(("q8", "k8", "v"), run(), plain()):
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"K7g's projection {part} {tag} differs from its twin")
    log(f"  K7g's projection {tag}: q8, k8 and v bitwise equal to the twin's")
    record("qkv_project", 0.0, run, plain, lambda: torch._int_mm(xq2d, wqkv_t),
           "partial: torch._int_mm, the int8 product alone", M * D + 3 * D * D + 24 * D + 4 * M * D,
           2 * M * D * 3 * D)

    # K7g
    g_args = (c["xq"], c["wqkv"], c["wqkv_s"], c["qkv_b"], c["scales6"], H, S)
    run = lambda: v8.qkv_attn_int8(*g_args)  # noqa: E731
    plain = lambda: v8.qkv_attn_int8_plain(*g_args)  # noqa: E731
    err = check_int8(f"K7g {tag}", run(), plain())
    qh, kh, vh = (torch.randn(B, H, S, 64, generator=gen, device="cuda", dtype=torch.bfloat16)
                  for _ in range(3))
    record("qkv_attn_int8", err, run, plain,
           lambda: F.scaled_dot_product_attention(qh, kh, vh),
           "partial: SDPA on bf16 q/k/v, the attention alone", 2 * M * D + 3 * D * D + 24 * D,
           {torch.int8: 2 * M * D * 3 * D + 2 * B * H * S * S * 64,
            torch.bfloat16: 2 * B * H * S * S * 64})

    # K7c, K7e
    for name, a8, w, ws, K in (("oproj_ln_quant", c["o8"], c["wo"], c["wo_s"], D),
                               ("fc2_res_ln_quant", c["h8"], c["w2"], c["w2_s"], FF)):
        args = (a8, c["x"], w, ws, c["bD"], c["lnw"], c["lnb"], 1.3, 0.025, 1e-5)
        fn = getattr(v8, name)
        run = lambda fn=fn, args=args: fn(*args)  # noqa: E731
        plain = lambda args=args: v8.res_ln_quant_plain(  # noqa: E731
            *args[:8], v8.f32_inv(args[8]), args[9])
        (xo, xq), (xo_ref, xq_ref) = run(), plain()
        check_ulp(f"{name} x' {tag}", xo, xo_ref)
        err = check_int8(f"{name} xq {tag}", xq, xq_ref)
        wt = w.t()
        record(name, err, run, plain, lambda a8=a8, wt=wt: torch._int_mm(a8, wt),
               "partial: torch._int_mm, the int8 product alone",
               M * K + D * K + 2 * 2 * M * D + M * D + 16 * D, 2 * M * K * D)

    w1t = c["w1"].t()

    # K7b: float (the (L, 4) layer's bf16; float32) and int8 (static q/k/v
    # scales) outputs
    b_args = (xq2d, c["wqkv"], c["wqkv_s"], c["qkv_b"], 1.3)
    inv3 = [v8.f32_inv(x) for x in (0.02, 0.03, 0.025)]
    err = max(check_ulp(f"K7b bf16 {part} {tag}", got, want) for part, got, want in
              zip("qkv", v8.qkv_int8(*b_args), v8.qkv_int8_plain(*b_args, torch.bfloat16)))
    for part, got, want in zip("qkv", v8.qkv_int8(*b_args, out_dtype=torch.float32),
                               v8.qkv_int8_plain(*b_args, torch.float32)):
        check_ulp(f"K7b float32 {part} {tag}", got, want)
    for part, got, want in zip("qkv", v8.qkv_int8(*b_args, qkv_scales=(0.02, 0.03, 0.025)),
                               v8.qkv_int8_plain(*b_args, torch.int8, inv3)):
        check_int8(f"K7b int8 {part} {tag}", got, want)
    run = lambda: v8.qkv_int8(*b_args, out_dtype=torch.bfloat16)  # noqa: E731
    record("qkv_int8", err, run, lambda: v8.qkv_int8_plain(*b_args, torch.bfloat16),
           lambda: torch._int_mm(xq2d, wqkv_t), "partial: torch._int_mm, the int8 product alone",
           M * D + 3 * D * D + 3 * 2 * M * D + 24 * D, 2 * M * D * 3 * D)
    out["qkv_int8"]["int8_out_ms"] = time_ms(
        lambda: v8.qkv_int8(*b_args, qkv_scales=(0.02, 0.03, 0.025)))

    # K7g's other consume paths, bf16 out (the residual stream's dtype)
    for name, mode, kw in (("qkv_attn_int8_rowmax", "rowmax", dict(static_smax=False)),
                           ("qkv_attn_int8_static", "static", dict(fuse_l=False)),
                           ("qkv_attn_int8_float_out", "fused", {})):
        run = lambda kw=kw: v8.qkv_attn_int8(*g_args, out_dtype=torch.bfloat16, **kw)  # noqa: E731
        plain = lambda mode=mode: v8.qkv_attn_int8_plain(  # noqa: E731
            *g_args, mode=mode, out_dtype=torch.bfloat16)
        err = check_close(f"{name} {tag}", run(), plain(), TOL[torch.bfloat16])
        record(name, err, run, plain, lambda: F.scaled_dot_product_attention(qh, kh, vh),
               "partial: SDPA on bf16 q/k/v, the attention alone",
               M * D + 3 * D * D + 24 * D + 2 * M * D,
               {torch.int8: 2 * M * D * 3 * D + 2 * B * H * S * S * 64,
                torch.bfloat16: 2 * B * H * S * S * 64})

    # K7c with a bf16 o, quantised by 1 / s1 in the kernel
    s1 = 1.5 / 127
    args = (c["o16"], c["x"], c["wo"], c["wo_s"], c["bD"], c["lnw"], c["lnb"], s1, 0.025, 1e-5)
    run = lambda: v8.oproj_ln_quant(*args)  # noqa: E731

    def plain():
        o8 = torch.clamp(torch.round(c["o16"].float() * v8.f32_inv(s1)), -127, 127)
        return v8.res_ln_quant_plain(o8.to(torch.int8), *args[1:8], v8.f32_inv(0.025), 1e-5)

    (xo, xq), (xo_ref, xq_ref) = run(), plain()
    check_ulp(f"oproj_ln_quant_float x' {tag}", xo, xo_ref)
    err = check_int8(f"oproj_ln_quant_float xq {tag}", xq, xq_ref)
    wo_t = c["wo"].t()
    record("oproj_ln_quant_float", err, run, plain,
           lambda: torch._int_mm(c["o8"], wo_t), "partial: torch._int_mm, the int8 product alone",
           2 * M * D + D * D + 2 * 2 * M * D + M * D + 16 * D, 2 * M * D * D)

    # K7f, against its twin and the split pair K7d + K7e on the card (same bits)
    f_args = (c["o8"], c["x"], c["w1"], c["w1_s"], c["bF"], c["w2"], c["w2_s"], c["bD"],
              c["lnw"], c["lnb"])
    f_scal = (1.1, 0.04, 0.03, 1e-5)
    run = lambda: v8.mlp_fused(*f_args, *f_scal, "quick_gelu")  # noqa: E731
    plain = lambda: v8.mlp_fused_plain(  # noqa: E731
        *f_args, 1.1, v8.f32_inv(0.04), 0.04, v8.f32_inv(0.03), 1e-5, "quick_gelu")

    def split_pair():
        hq = v8.fc1_gelu_quant(c["o8"], c["w1"], c["w1_s"], c["bF"], 1.1, 0.04, "quick_gelu")
        return v8.fc2_res_ln_quant(hq, c["x"], c["w2"], c["w2_s"], c["bD"], c["lnw"], c["lnb"],
                                   0.04, 0.03, 1e-5)

    (xo, xq), (xo_ref, xq_ref), (xo_pair, xq_pair) = run(), plain(), split_pair()
    check_ulp(f"mlp_fused x'' {tag}", xo, xo_ref)
    err = check_int8(f"mlp_fused xq {tag}", xq, xq_ref)
    # x'' is the same arithmetic in both; K7e's LayerNorm sums run in
    # another order than K7f's, so xq is held to the int8 tolerance
    if not torch.equal(xo, xo_pair):
        raise AssertionError("K7f's x'' differs from the split pair K7d + K7e on the card")
    check_int8(f"mlp_fused xq against the split pair {tag}", xq, xq_pair)
    w2t = c["w2"].t()
    record("mlp_fused", err, run, plain,
           lambda: (torch._int_mm(c["o8"], w1t), torch._int_mm(c["h8"], w2t)),
           "partial: torch._int_mm, the two int8 products alone",
           M * D + 2 * FF * D + 2 * 2 * M * D + M * D + 8 * FF + 16 * D, 2 * 2 * M * D * FF)
    out["mlp_fused"]["split_pair_ms"] = time_ms(split_pair)
    out["mlp_fused"]["split_pair_device_ms"] = device_ms(split_pair)

    # K10 on int8 q, k, v, bf16 out
    q8, k8, v8_ = c["xq"], c["o8"].view(B, S, D), c["h8"][:, :D].contiguous().view(B, S, D)
    sq = 2.0 / 127
    qk, pv = sq * sq * 64 ** -0.5, 1.0 / 127 ** 2  # v = v8 / 127: outputs of order 1
    run = lambda: enc.encoder_attention_int8(q8, k8, v8_, H, qk, pv)  # noqa: E731
    plain = lambda: enc.encoder_attention_int8_plain(  # noqa: E731
        q8, k8, v8_, H, v8.f32(qk), v8.f32(pv), S, torch.bfloat16)
    err = check_close(f"K10 {tag}", run(), plain(), TOL[torch.bfloat16])
    record("encoder_attention_int8", err, run, plain,
           lambda: F.scaled_dot_product_attention(qh, kh, vh),
           "partial: SDPA on bf16 q/k/v of the same shape", 3 * M * D + 2 * M * D,
           2 * 2 * B * H * S * S * 64)

    # K7d
    args = (c["o8"], c["w1"], c["w1_s"], c["bF"], 1.1, 0.04, "quick_gelu_approx")
    run = lambda: v8.fc1_gelu_quant(*args)  # noqa: E731
    plain = lambda: v8.fc1_gelu_quant_plain(*args[:5], v8.f32_inv(0.04), args[6])  # noqa: E731
    record("fc1_gelu_quant", check_int8(f"K7d {tag}", run(), plain()), run, plain,
           lambda: torch._int_mm(c["o8"], w1t), "partial: torch._int_mm, the int8 product alone",
           M * D + FF * D + M * FF + 8 * FF, 2 * M * D * FF)
    for name, r in out.items():
        log(f"  {name} {tag}: kernel {r['ms']:.4f} ms (device {fmt_ms(r['device_ms'])}), plain "
            f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}), "
            f"library {r['library_ms']:.4f} ms ({r['library_note']})")
    return out


# ----------------------------------------------------------------------
# Phase 3, K9: the weight-only int8 matmul against its twin
# ----------------------------------------------------------------------
def check_wo_matmul(gen) -> dict:
    """K9 at the Llama-3.1-8B projection shapes: decode (M = 8), verify with
    k = 4 (M = 40) and W8A16 prefill (M = 4,096), and the lm_head at
    M = 8, float32 and bf16; weight scales that put outputs at std ~0.5.
    The library yardstick is torch.matmul on a weight dequantised ahead of
    time (the product alone). Returns K9's entry: the bf16 decode step's
    129 calls summed, each shape under "shapes"."""
    shapes = [(name, M, K, N) for M in (8, 40, 4096) for name, (K, N) in LLAMA_8B_PROJ.items()]
    shapes.append(("lm_head", 8, *LM_HEAD_8B))
    per = {}
    for dtype in (torch.float32, torch.bfloat16):
        t = str(dtype)[6:]
        for name, M, K, N in shapes:
            w = torch.randint(-127, 128, (N, K), generator=gen, device="cuda", dtype=torch.int8)
            ws = (0.5 + torch.rand(N, generator=gen, device="cuda")) * (0.5 / (73 * K ** 0.5))
            x = torch.randn(M, K, generator=gen, device="cuda").to(dtype)
            err = check_close(f"K9 {t} {name} M={M}", wo.wo_matmul(x, w, ws),
                              wo.wo_matmul_plain(x, w, ws), TOL[dtype])
            deq = (w.float() * ws[:, None]).to(dtype).t()
            n = 5 if M == 4096 else 20
            elt = x.element_size()
            per[f"{t} {name} M={M}"] = r = dict(
                max_abs_err=err, ms=time_ms(lambda: wo.wo_matmul(x, w, ws), n=n),
                device_ms=device_ms(lambda: wo.wo_matmul(x, w, ws), n=3 if M == 4096 else 10),
                plain_ms=time_ms(lambda: wo.wo_matmul_plain(x, w, ws), n=n, warmup=1),
                library_ms=time_ms(lambda: x @ deq, n=n),
                library_device_ms=device_ms(lambda: x @ deq, n=3 if M == 4096 else 10),
                # x and the int8 weight read, its scales read, the output written
                bytes=M * K * elt + N * K + 4 * N + M * N * elt, ops=2 * M * K * N,
                **bound(dtype, M * K * elt + N * K + 4 * N + M * N * elt, 2 * M * K * N))
            log(f"  K9 {t} {name} M={M}: kernel {r['ms']:.4f} ms (device {fmt_ms(r['device_ms'])}), "
                f"plain {r['plain_ms']:.4f}, library {r['library_ms']:.4f} (device "
                f"{fmt_ms(r['library_device_ms'])}), bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
            del w, x, deq
        torch.cuda.empty_cache()
    # a decode step: 32 layers of the four projections, then the lm_head
    step = [(32, per[f"bfloat16 {name} M=8"]) for name in LLAMA_8B_PROJ]
    step.append((1, per["bfloat16 lm_head M=8"]))

    def total(key):
        if any(r[key] is None for _, r in step):
            return None
        return sum(k * r[key] for k, r in step)

    out = dict(max_abs_err=max(r["max_abs_err"] for key, r in per.items()
                               if key.startswith("bfloat16")),
               ms=total("ms"), device_ms=total("device_ms"), plain_ms=total("plain_ms"),
               library_ms=total("library_ms"), library_device_ms=total("library_device_ms"),
               **bound(torch.bfloat16, total("bytes"), total("ops")),
               measured_as="a bf16 decode step at M = 8: 32 x (qkv, o, gate-up, down) + lm_head",
               shapes=per)
    log(f"  K9 decode step (129 calls, bf16, M = 8): kernel {out['ms']:.4f} ms (device "
        f"{fmt_ms(out['device_ms'])}), plain {out['plain_ms']:.4f}, library {out['library_ms']:.4f} "
        f"(device {fmt_ms(out['library_device_ms'])}), bound {out['bound_ms']:.4f} ms "
        f"({out['bound_by']})")
    # the W8A16 prefill's four projections at M = 4,096, one layer
    layer = {key: sum(per[f"bfloat16 {name} M=4096"][key] for name in LLAMA_8B_PROJ)
             for key in ("device_ms", "library_device_ms", "bound_ms")
             if all(per[f"bfloat16 {name} M=4096"][key] is not None for name in LLAMA_8B_PROJ)}
    out["prefill_layer"] = layer
    log(f"  K9 W8A16 prefill layer (qkv + o + gate-up + down, M = 4,096): {layer}")
    return out


# ----------------------------------------------------------------------
# Phases 4 and 5: the engine
# ----------------------------------------------------------------------
def make_request(rng, vocab: int, prompt_len: int, image_size: int = 0, patch: int = 1,
                 image_at: int = 8) -> dict:
    """A collated B=1 batch; with ``image_size`` one uint8 image whose
    (image_size/patch)^2 embeddings replace tokens from ``image_at`` on."""
    ids = rng.integers(2, vocab, (1, prompt_len)).astype(np.int32)
    batch = {"input_ids": ids, "attention_mask": np.ones_like(ids)}
    if image_size:
        n_emb = (image_size // patch) ** 2
        batch["mm_inputs"] = {"image": {
            "values": rng.integers(0, 256, (1, image_size, image_size, 3)).astype(np.uint8),
            "batch_idx": np.zeros((n_emb,), np.int32),
            "token_pos": np.arange(image_at, image_at + n_emb, dtype=np.int32),
        }}
    return batch


def small_f32_models():
    """The same seeded float32 model (head_dim 128, two layers, a ViT of
    head dim 64) on the CPU and on the card."""
    llm = LlamaConfig(vocab_size=1024, hidden_size=512, intermediate_size=1024,
                      num_layers=2, num_heads=4, num_kv_heads=2, head_dim=128,
                      dtype=torch.float32)
    img = ImageConfig(model_type="meditron_clip", hidden_size=512, clip_name="",
                      image_size=32, patch_size=8, vision_hidden_size=256,
                      vision_layers=2, vision_heads=4, vision_intermediate_size=512,
                      param_dtype="float32", wire_dtype="uint8")
    cfg = MultimodalConfig(llm=llm, modalities=[img], eos_token_idx=1)
    cpu_model = MultimodalModel(cfg, device="cpu")
    cpu_model.init_weights(torch.Generator().manual_seed(0))
    gpu_model = MultimodalModel(cfg, device="cuda")
    gpu_model.load_state_dict(cpu_model.state_dict())
    return cpu_model, gpu_model


def check_f32_card_vs_cpu() -> None:
    """The engine on the card against the CPU, same weights, float32: plain
    greedy; speculative greedy (k = 2, 4) equal to plain greedy; speculative
    sampling (k = 2, 4, temperature 0.7) equal across k and devices; a forked
    group (sampled), a 100-token prompt over buckets of 32/64 (chunked) and
    staggered admission; the int8 LLM; the same through kv_mode="slab"; and
    generate() on a right-padded batch with an image."""
    cpu_model, gpu_model = small_f32_models()
    base = dict(max_slots=4, max_seq_len=128, prefill_buckets=(32, 64), page_size=16,
                decode_chunk=8, do_sample=False, max_new_tokens=12)
    sampled = dict(do_sample=True, temperature=0.7, seed=3)
    rng = np.random.default_rng(1)
    batches = [make_request(rng, 1024, 30, image_size=32, patch=8, image_at=4),
               make_request(rng, 1024, 20), make_request(rng, 1024, 50)]
    long_prompt = make_request(rng, 1024, 100, image_size=32, patch=8, image_at=70)

    def both(name, generate, **kw):
        """Tokens on the card and on the CPU, which must agree; the card's
        kernel launches (and W8A8 products)."""
        reset_launch_counts()
        on_card = generate(ServingEngine(gpu_model, EngineConfig(**{**base, **kw})))
        counts = {**launch_counts(tuple(KERNELS)), "w8a8_matmul": wo.launches["w8a8_matmul"]}
        on_cpu = generate(ServingEngine(cpu_model, EngineConfig(**{**base, **kw})))
        log(f"  {name}: card {on_card}")
        if on_card != on_cpu:
            log(f"  {name}: cpu  {on_cpu}")
            raise AssertionError(f"f32 engine on the card disagrees with the CPU: {name}")
        return on_card, counts

    plain, counts = both("greedy", lambda e: e.generate(batches))
    log(f"  launches: {counts}")
    if not all(counts[n] for n in SERVING):
        raise AssertionError(f"a kernel was not launched by the f32 engine: {counts}")
    spec_sampled = []
    for k in (2, 4):
        spec, counts = both(f"speculative k={k} greedy", lambda e: e.generate(batches),
                            speculative_k=k)
        if spec != plain:
            raise AssertionError(f"speculative greedy (k={k}) differs from plain greedy")
        if not all(counts[n] for n in SPEC_SERVING) or counts["ring_decode_attention"]:
            raise AssertionError(f"speculative engine launches: {counts}")
        spec_sampled.append(both(f"speculative k={k} sampled", lambda e: e.generate(batches),
                                 speculative_k=k, **sampled)[0])
    if spec_sampled[0] != spec_sampled[1]:
        raise AssertionError("speculative sampling depends on k")
    both("forked group of 3, sampled",
         lambda e: e.generate([batches[0]] * 3, group_size=3), **sampled)
    both("chunked 100-token prompt", lambda e: e.generate([long_prompt] + batches[1:]))
    both("staggered admission", lambda e: e.generate(batches + batches), prefill_group_cap=1)

    # the int8 LLM: W8A16 through K9 everywhere ...
    q_plain, counts = both("quantize_llm greedy", lambda e: e.generate(batches), quantize_llm=True)
    if not counts["wo_matmul"] or counts["w8a8_matmul"]:
        raise AssertionError(f"quantize_llm engine launches: {counts}")
    q_spec, _ = both("quantize_llm speculative k=2", lambda e: e.generate(batches),
                     quantize_llm=True, speculative_k=2)
    if q_spec != q_plain:
        raise AssertionError("quantize_llm: speculative greedy (k=2) differs from plain greedy")
    # ... and W8A8 on a prefill of 256 padded rows (a 12-token prompt in the
    # 256 bucket: few valid rows, so few int8 codes near a rounding boundary
    # that the card's and the CPU's float32 sums could round apart)
    w8 = dict(quantize_llm=True, w8a8_prefill=True, prefill_buckets=(8, 256), max_seq_len=320)
    short = [make_request(rng, 1024, 12)]
    w8_plain, counts = both("quantize_llm + w8a8_prefill greedy (256-row prefill)",
                            lambda e: e.generate(short), **w8)
    if counts["w8a8_matmul"] != 4 * 2 or not counts["wo_matmul"]:
        raise AssertionError(f"W8A8 did not run the 256-row prefill's 8 products: {counts}")
    w8_spec, _ = both("quantize_llm + w8a8_prefill speculative k=2",
                      lambda e: e.generate(short), speculative_k=2, **w8)
    if w8_spec != w8_plain:
        raise AssertionError("w8a8_prefill: speculative greedy (k=2) differs from plain greedy")

    # the slab KV mode: decode attention is K1 at Sq = 1, no paged kernel runs
    slab = dict(kv_mode="slab")
    s_plain, counts = both("slab greedy", lambda e: e.generate(batches), **slab)
    if s_plain != plain:
        raise AssertionError("slab greedy differs from paged greedy on the card")
    if not counts["flash_attention_fwd"] or any(counts[n] for n in PAGED_KERNELS):
        raise AssertionError(f"slab engine launches: {counts}")
    both("slab sampled", lambda e: e.generate(batches), **slab, **sampled)
    s_sampled = []
    for k in (2, 4):
        spec, counts = both(f"slab speculative k={k} greedy", lambda e: e.generate(batches),
                            speculative_k=k, **slab)
        if spec != s_plain:
            raise AssertionError(f"slab speculative greedy (k={k}) differs from plain greedy")
        if any(counts[n] for n in PAGED_KERNELS):
            raise AssertionError(f"slab speculative engine launches: {counts}")
        s_sampled.append(both(f"slab speculative k={k} sampled", lambda e: e.generate(batches),
                              speculative_k=k, **slab, **sampled)[0])
    if s_sampled[0] != s_sampled[1]:
        raise AssertionError("slab speculative sampling depends on k")
    both("slab chunked 100-token prompt", lambda e: e.generate([long_prompt] + batches[1:]),
         **slab)
    group = both("slab submit_group of 3 (independent requests), sampled",
                 lambda e: e.generate([batches[0]] * 3, group_size=3), **slab, **sampled)[0]
    if len(group) != 3:
        raise AssertionError("slab submit_group did not queue three requests")
    _, counts = both("slab quantize_llm greedy", lambda e: e.generate(batches),
                     quantize_llm=True, **slab)
    if not counts["wo_matmul"]:
        raise AssertionError(f"slab quantize_llm engine launches: {counts}")

    # generate(): 3 right-padded prompts (30, 20 and 50 tokens), an image in
    # the first, greedy and sampled
    mask = (np.arange(50)[None, :] < np.asarray([30, 20, 50])[:, None]).astype(np.int32)
    gbatch = {"input_ids": rng.integers(2, 1024, (3, 50)).astype(np.int32) * mask,
              "attention_mask": mask, "mm_inputs": batches[0]["mm_inputs"]}
    for name, kw in (("greedy", dict(do_sample=False)),
                     ("sampled", dict(temperature=0.7, top_k=50, top_p=0.9,
                                      key=prng.prng_key(5)))):
        on_card = generate(gpu_model, gbatch, max_new_tokens=12, **kw).cpu()
        on_cpu = generate(cpu_model, gbatch, max_new_tokens=12, **kw)
        log(f"  generate {name}: card {on_card.tolist()}")
        if not torch.equal(on_card, on_cpu):
            log(f"  generate {name}: cpu  {on_cpu.tolist()}")
            raise AssertionError(f"generate on the card disagrees with the CPU: {name}")


def full_width_model() -> MultimodalModel:
    """Llama-3.1-8B widths + the default CLIP ViT-L/14 tower, bf16, seeded."""
    llm = LlamaConfig(
        vocab_size=128256, hidden_size=4096, intermediate_size=14336, num_layers=32,
        num_heads=32, num_kv_heads=8, rope_theta=500000.0,
        rope_scaling={"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
                      "high_freq_factor": 4.0, "original_max_position_embeddings": 8192},
        max_position_embeddings=131072, dtype=torch.bfloat16)
    img = ImageConfig(model_type="meditron_clip", hidden_size=4096, clip_name="",
                      param_dtype="bfloat16", wire_dtype="uint8")
    # eos 1 is never special for random weights; requests end on their budget
    model = MultimodalModel(MultimodalConfig(llm=llm, modalities=[img], eos_token_idx=1),
                            device="cuda")
    model.init_weights(torch.Generator(device="cuda").manual_seed(0))
    return model


INT8_LLM = dict(quantize_llm=True, w8a8_prefill=True)  # the JAX bench's 8B legs
W8A16 = dict(quantize_llm=True, w8a8_prefill=False)   # docs/serving.md's int8 decoder


def check_int8_llm_launches(counts: dict, steps: int, prefill_calls: int) -> None:
    """K9 runs every projection of a decode or verify step and the lm_head
    of every prefill call; W8A8 runs the 4 x 32 projections of every
    prefill call and nothing else."""
    if counts["wo_matmul"] < K9_PER_STEP * steps + prefill_calls:
        raise AssertionError(f"K9 launched fewer than {K9_PER_STEP} times a step: {counts}")
    if counts["w8a8_matmul"] != W8A8_PER_PREFILL * prefill_calls:
        raise AssertionError(f"W8A8 products are not {W8A8_PER_PREFILL} a prefill call "
                             f"and 0 in decode: {counts}")


def check_w8a16_launches(counts: dict, steps: int, prefill_calls: int) -> None:
    """W8A16 (quantize_llm without w8a8_prefill): K9 runs every projection
    and the lm_head of every prefill call and decode step; no W8A8 product."""
    if counts["wo_matmul"] < K9_PER_STEP * (steps + prefill_calls):
        raise AssertionError(f"K9 launched fewer than {K9_PER_STEP} times a step or prefill "
                             f"call: {counts}")
    if counts["w8a8_matmul"]:
        raise AssertionError(f"W8A8 products ran without w8a8_prefill: {counts}")


# device records of the kernels a CUDA graph's replays launch: K4 (the ring
# form of decode_kernel) and K9
GRAPH_KERNELS = {"ring_decode_attention": r"\bdecode_kernel<[^<>]*, true>",
                 "wo_matmul": r"\bwo_(wgmma|f32)_kernel\b"}


def device_records(fn, patterns: dict) -> dict:
    """One call of ``fn`` under torch.profiler: the number of device records
    of the kernels whose name matches each pattern, a graph's replays
    included (the wrappers count the launches made on the host)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    return {k: sum(1 for n in names if re.search(rx, n)) for k, rx in patterns.items()}


def check_requests(reqs, vocab: int, budget: int = 64) -> None:
    """Every request finished with 1..budget tokens inside the vocab."""
    for r in reqs:
        if r.finish_reason is None or not 1 <= len(r.tokens) <= budget:
            raise AssertionError(f"request {r.request_id}: {r.finish_reason}, "
                                 f"{len(r.tokens)} tokens")
        if not all(0 <= t < vocab for t in r.tokens):
            raise AssertionError(f"request {r.request_id}: token outside the vocab")


def latency(reqs) -> dict:
    """TTFT percentiles (submit -> first token) and decode tok/s (tokens
    after each request's first / (last finish - last first token))."""
    ttfts = sorted(r.ttft for r in reqs)
    first = max(r.first_token_time for r in reqs)
    last = max(r.finish_time for r in reqs)
    return dict(ttft_p50_ms=statistics.median(ttfts) * 1000,
                ttft_p95_ms=float(np.percentile(ttfts, 95)) * 1000,
                ttft_max_ms=ttfts[-1] * 1000,
                decode_tok_per_s=sum(len(r.tokens) - 1 for r in reqs) / (last - first),
                tokens=sum(len(r.tokens) for r in reqs))


def logit_fidelity(ref: torch.Tensor, got: torch.Tensor) -> dict:
    """Mean per-position cosine and top-1 agreement of (S, V) logits."""
    ref, got = ref.float(), got.float()
    return dict(cosine_mean=F.cosine_similarity(ref, got, dim=-1).mean().item(),
                top1_agreement=(ref.argmax(-1) == got.argmax(-1)).float().mean().item())


def run_full_width(model: MultimodalModel, tower: str = "bf16", int8_llm: bool = False,
                   w8a8_prefill: bool = True) -> dict:
    """Phase 5 (``tower`` "bf16", the float tower: K3); phase 10 ("L8", the
    fused int8 tower: K7, and no K3); phase 12 ("L4": K7b and K3, "L7":
    K7g's row-max form); with ``int8_llm`` phase 11: quantize_llm +
    w8a8_prefill (K9 in decode and the lm_head, W8A8 in prefill) and, with
    ``w8a8_prefill`` False, quantize_llm alone (W8A16: K9 in prefill too, 129
    launches a prefill call)."""
    llm_cfg = (INT8_LLM if w8a8_prefill else W8A16) if int8_llm else {}
    engine = ServingEngine(model, EngineConfig(
        max_slots=8, max_seq_len=640, prefill_buckets=(512,), page_size=128,
        decode_chunk=8, temperature=0.7, **llm_cfg))
    log(f"  engine: {engine.num_pages} pages, KV pool "
        f"{2 * engine.state['k'].numel() * engine.state['k'].element_size() / 1e9:.3f} GB")
    vocab, n_req = model.config.llm.vocab_size, 8
    rng = np.random.default_rng(0)

    def requests():
        return [make_request(rng, vocab, 512, image_size=224, patch=14) for _ in range(n_req)]

    # warm-up round (allocator, cuBLAS handles); not measured
    for b in requests():
        engine.submit(b, max_new_tokens=4)
    engine.run()

    # the timed round
    batches = requests()
    torch.cuda.reset_peak_memory_stats()
    steps = engine.n_decode_steps
    t0 = time.time()
    reqs = [engine.submit(b, max_new_tokens=64) for b in batches]
    engine.run()
    wall = time.time() - t0
    check_requests(reqs, vocab)
    timed = dict(**latency(reqs), wall_s=wall, timed_decode_steps=engine.n_decode_steps - steps)

    # the counted round, under torch.profiler: every decode step replays the
    # graph the warm-up round captured, so its K4 and K9 launches are device
    # records, which the wrappers' host counts miss
    reset_launch_counts()
    engine.n_prefill_calls = engine.n_decode_steps = engine.n_decode_chunks = 0
    engine.n_decode_graph_steps = 0
    reqs = [engine.submit(b, max_new_tokens=64) for b in requests()]
    records = device_records(engine.run, GRAPH_KERNELS)
    counts = launch_counts(TOWER_KERNELS + DECODE)
    if int8_llm:
        counts.update(wo_matmul=wo.launches["wo_matmul"], w8a8_matmul=wo.launches["w8a8_matmul"])
    counts.update({k: v for k, v in records.items() if k in counts})
    work = dict(prefill_calls=engine.n_prefill_calls, decode_steps=engine.n_decode_steps,
                decode_graph_steps=engine.n_decode_graph_steps,
                decode_chunks=engine.n_decode_chunks)
    log(f"  launches (K4, K9: device records): {counts}; work: {work}")

    check_requests(reqs, vocab)
    check_tower_launches(tower, counts, work["prefill_calls"])
    if work["decode_graph_steps"] != work["decode_steps"]:
        raise AssertionError(f"a decode step ran outside the graph: {work}")
    if counts["ring_decode_attention"] < 32 * work["decode_steps"]:
        raise AssertionError("K4 launched fewer than 32 times per decode step")
    if counts["fold_ring_into_pages"] < work["decode_chunks"]:
        raise AssertionError("K5 launched fewer times than there were decode chunks")
    if int8_llm and w8a8_prefill:
        check_int8_llm_launches(counts, work["decode_steps"], work["prefill_calls"])
    if int8_llm and not w8a8_prefill:
        check_w8a16_launches(counts, work["decode_steps"], work["prefill_calls"])
        counts.pop("w8a8_matmul")  # checked to be 0
    if not all(counts.values()):
        raise AssertionError(f"a kernel of the path was not launched: {counts}")

    # outputs of the path are finite and shaped: one image through the tower
    # and a short prompt through the decoder
    fidelity = {}
    with torch.inference_mode():
        probe = make_request(rng, vocab, 300, image_size=224, patch=14)
        mm = {"image": {k: torch.from_numpy(v).cuda()
                        for k, v in probe["mm_inputs"]["image"].items()}}
        feats = model.modalities["image"].encode(mm["image"]["values"])
        embeds = model.embed(torch.from_numpy(probe["input_ids"]).cuda(), mm)
        logits, _ = model.llm(inputs_embeds=embeds)
        if int8_llm and w8a8_prefill:
            # the int8 decoder against the bf16 one on the same 300 positions
            w8a16, _ = engine.llm(inputs_embeds=embeds, w8a8_min_rows=0)
            w8a8, _ = engine.llm(inputs_embeds=embeds, w8a8_min_rows=256)
            top2 = logits[0].float().topk(2, dim=-1).values
            fidelity = {"w8a16_vs_bf16": logit_fidelity(logits[0], w8a16[0]),
                        "w8a8_vs_bf16": logit_fidelity(logits[0], w8a8[0]),
                        "w8a8_vs_w8a16": logit_fidelity(w8a16[0], w8a8[0]),
                        "bf16_top2_gap_median": (top2[:, 0] - top2[:, 1]).median().item(),
                        "bf16_logit_std": logits[0].float().std().item()}
            del w8a16, w8a8
    if feats.shape != (1, 256, 4096) or not torch.isfinite(feats).all():
        raise AssertionError(f"image features {tuple(feats.shape)} not finite/shaped")
    if logits.shape != (1, 300, vocab) or not torch.isfinite(logits.float()).all():
        raise AssertionError(f"logits {tuple(logits.shape)} not finite/shaped")
    if fidelity:
        log(f"  int8 decoder vs bf16 on a 300-token probe: {fidelity}")
        # the JAX fidelity contract (docs/known_issues.md:141-144)
        if not all(fidelity[k]["cosine_mean"] > 0.99 and fidelity[k]["top1_agreement"] > 0.9
                   for k in ("w8a16_vs_bf16", "w8a8_vs_bf16", "w8a8_vs_w8a16")):
            raise AssertionError(f"int8 logits miss cosine > 0.99, top-1 > 0.9: {fidelity}")

    # one prefill call of the 8 requests alone (a budget of one token), traced
    batches = requests()

    def prefill_only():
        for b in batches:
            engine.submit(b, max_new_tokens=1)
        engine.run()

    k9_before, calls_before = wo.launches["wo_matmul"], engine.n_prefill_calls
    prefill = busy_profile(prefill_only)
    if int8_llm:
        calls = engine.n_prefill_calls - calls_before
        prefill["k9_launches_per_prefill_call"] = (wo.launches["wo_matmul"] - k9_before) / calls
        # W8A16: every projection and the lm_head; W8A8: the lm_head alone
        want = 1 if w8a8_prefill else K9_PER_STEP
        if prefill["k9_launches_per_prefill_call"] != want:
            raise AssertionError(f"K9 launched {prefill['k9_launches_per_prefill_call']} times a "
                                 f"prefill call, not {want}")
    log(f"  one 8-request prefill: {prefill}")

    out = dict(
        **timed,
        prefill_profile=prefill,
        max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
        launches=counts, **work, **({"fidelity": fidelity} if fidelity else {}))
    log(f"  TTFT p50 {out['ttft_p50_ms']:.1f} ms, p95 {out['ttft_p95_ms']:.1f} ms, decode "
        f"{out['decode_tok_per_s']:.1f} tok/s over {out['timed_decode_steps']} steps, peak "
        f"memory {out['max_memory_allocated_gb']:.2f} GB, wall {wall:.2f} s")
    return out


def run_spec_full_width(model: MultimodalModel, int8_llm: bool = False) -> dict:
    """Speculative serving at full width (the JAX bench's speculative leg,
    k = 4, paged, greedy, scaled to 8 slots): 3 requests of 512 tokens, a
    forked group of 4 over one 512-token prompt and a 1,000-token prompt
    (two chunks), each with one image and 64 new tokens. With ``int8_llm``
    (phase 11) through quantize_llm + w8a8_prefill."""
    engine = ServingEngine(model, EngineConfig(
        max_slots=8, max_seq_len=1152, prefill_buckets=(512,), page_size=128,
        decode_chunk=8, speculative_k=4, do_sample=False, **(INT8_LLM if int8_llm else {})))
    vocab = model.config.llm.vocab_size
    rng = np.random.default_rng(4)

    def request(n):
        return make_request(rng, vocab, n, image_size=224, patch=14)

    # warm-up round (allocator, cuBLAS handles at the verify shapes); not measured
    engine.generate([request(512)], max_new_tokens=4)

    batches = [request(512) for _ in range(3)]
    group_prompt, long_prompt = request(512), request(1000)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    engine.n_prefill_calls = engine.spec_verify_steps = 0
    engine.spec_slot_steps = engine.spec_emitted = 0
    t0 = time.time()
    reqs = [engine.submit(b, max_new_tokens=64) for b in batches]
    reqs += engine.submit_group(group_prompt, 4, max_new_tokens=64)
    reqs.append(engine.submit(long_prompt, max_new_tokens=64))
    engine.step()  # admits all eight: the group's prompt pages are shared 4 ways
    shared = int(engine.page_ref.max())
    engine.run()
    wall = time.time() - t0
    counts = launch_counts(SPEC_SERVING)
    if int8_llm:
        counts.update(wo_matmul=wo.launches["wo_matmul"], w8a8_matmul=wo.launches["w8a8_matmul"])
    work = dict(prefill_calls=engine.n_prefill_calls, verify_steps=engine.spec_verify_steps,
                slot_steps=engine.spec_slot_steps, emitted=engine.spec_emitted)
    log(f"  launches: {counts}; work: {work}; page_ref max after admission {shared}")

    check_requests(reqs, vocab)
    if shared != 4:
        raise AssertionError(f"the group's prompt pages were held {shared} times, not 4")
    if counts["ring_verify_attention"] < 32 * work["verify_steps"]:
        raise AssertionError("K6 launched fewer than 32 times per verify step")
    if counts["fold_ring_into_pages"] < work["verify_steps"]:
        raise AssertionError("K5 launched fewer times than there were verify steps")
    if counts["encoder_attention"] < 24 * work["prefill_calls"]:
        raise AssertionError("K3 launched fewer than 24 times per prefill call")
    if int8_llm:
        check_int8_llm_launches(counts, work["verify_steps"], work["prefill_calls"])
    if not all(counts.values()):
        raise AssertionError(f"a kernel of the path was not launched: {counts}")

    out = dict(
        **latency(reqs),
        accepted_per_slot_step=work["emitted"] / max(work["slot_steps"], 1),
        wall_s=wall,
        max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
        launches=counts, **work)
    log(f"  TTFT p50 {out['ttft_p50_ms']:.1f} ms, decode {out['decode_tok_per_s']:.1f} tok/s "
        f"over {work['verify_steps']} verify steps, {out['accepted_per_slot_step']:.3f} tokens "
        f"per slot-step, peak memory {out['max_memory_allocated_gb']:.2f} GB, wall {wall:.2f} s")
    return out


# ----------------------------------------------------------------------
# Phase 13: the slab KV mode, generate() and K8 at full width
# ----------------------------------------------------------------------
SLAB_CHECKED = ("encoder_attention", "flash_attention_fwd") + PAGED_KERNELS


def check_slab_launches(model: MultimodalModel, counts: dict, decode_steps: int,
                        prefill_calls: int) -> None:
    """K1 runs once a decoder layer (32 at 8B) a live decode step (no K1 in a
    prefill or a verify block: per-slot offsets take the plain path), K3 once
    a tower layer (24) a prefill call, no paged kernel at all."""
    llm_layers = model.config.llm.num_layers
    tower_layers = model.modalities["image"].vit_cfg.num_layers
    if counts["flash_attention_fwd"] != llm_layers * decode_steps:
        raise AssertionError(f"K1 launched {counts['flash_attention_fwd']} times, not "
                             f"{llm_layers} x {decode_steps} live decode steps: {counts}")
    if counts["encoder_attention"] != tower_layers * prefill_calls:
        raise AssertionError(f"K3 launched {counts['encoder_attention']} times, not "
                             f"{tower_layers} x {prefill_calls} prefill calls: {counts}")
    if any(counts[n] for n in PAGED_KERNELS):
        raise AssertionError(f"a paged kernel ran in slab mode: {counts}")


def run_slab_serving(model: MultimodalModel, rng) -> tuple:
    """Phase 5's configuration and requests through kv_mode="slab"; then the
    busy share of one decode chunk. Returns (results, the engine)."""
    vocab = model.config.llm.vocab_size
    engine = ServingEngine(model, EngineConfig(
        max_slots=8, max_seq_len=640, prefill_buckets=(512,), decode_chunk=8,
        temperature=0.7, kv_mode="slab"))
    log(f"  slab engine: KV cache "
        f"{2 * engine.state['k'].numel() * engine.state['k'].element_size() / 1e9:.3f} GB")

    def requests():
        return [make_request(rng, vocab, 512, image_size=224, patch=14) for _ in range(8)]

    engine.generate(requests(), max_new_tokens=4)  # warm-up; not measured
    batches = requests()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    engine.n_prefill_calls = engine.n_decode_steps = engine.n_decode_chunks = 0
    t0 = time.time()
    reqs = [engine.submit(b, max_new_tokens=64) for b in batches]
    engine.run()
    wall = time.time() - t0
    counts = launch_counts(SLAB_CHECKED)
    work = dict(prefill_calls=engine.n_prefill_calls, decode_steps=engine.n_decode_steps,
                decode_chunks=engine.n_decode_chunks)
    log(f"  launches: {counts}; work: {work}")
    check_requests(reqs, vocab)
    check_slab_launches(model, counts, work["decode_steps"], work["prefill_calls"])
    out = dict(**latency(reqs), wall_s=wall,
               max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
               launches=counts, **work)
    # one decode chunk of 8 live steps, traced: admit 8 requests and run
    # their first chunk, then trace the next
    for b in requests():
        engine.submit(b, max_new_tokens=24)
    engine.step()
    out["decode_chunk_profile"] = busy_profile(engine.step)
    engine.run()
    log(f"  TTFT p50 {out['ttft_p50_ms']:.1f} ms, p95 {out['ttft_p95_ms']:.1f} ms, decode "
        f"{out['decode_tok_per_s']:.1f} tok/s over {work['decode_steps']} steps, peak memory "
        f"{out['max_memory_allocated_gb']:.2f} GB, wall {wall:.2f} s; one decode chunk "
        f"{out['decode_chunk_profile']}")
    return out, engine


def run_slab_spec(model: MultimodalModel, rng) -> dict:
    """Phase 8's speculative mix (k = 4, greedy) through kv_mode="slab": 3
    requests of 512 tokens, submit_group(4) over one 512-token prompt (four
    independent requests in slab mode) and a 1,000-token prompt in two
    chunks, each with one image and 64 new tokens."""
    vocab = model.config.llm.vocab_size
    engine = ServingEngine(model, EngineConfig(
        max_slots=8, max_seq_len=1152, prefill_buckets=(512,), decode_chunk=8,
        speculative_k=4, do_sample=False, kv_mode="slab"))

    def request(n):
        return make_request(rng, vocab, n, image_size=224, patch=14)

    engine.generate([request(512)], max_new_tokens=4)  # warm-up; not measured
    batches = [request(512) for _ in range(3)]
    group_prompt, long_prompt = request(512), request(1000)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    engine.n_prefill_calls = engine.spec_verify_steps = 0
    engine.spec_slot_steps = engine.spec_emitted = 0
    t0 = time.time()
    reqs = [engine.submit(b, max_new_tokens=64) for b in batches]
    group = engine.submit_group(group_prompt, 4, max_new_tokens=64)
    reqs += group + [engine.submit(long_prompt, max_new_tokens=64)]
    engine.run()
    wall = time.time() - t0
    counts = launch_counts(SLAB_CHECKED)
    work = dict(prefill_calls=engine.n_prefill_calls, verify_steps=engine.spec_verify_steps,
                slot_steps=engine.spec_slot_steps, emitted=engine.spec_emitted)
    log(f"  launches: {counts}; work: {work}")
    check_requests(reqs, vocab)
    if len(group) != 4 or any(r.forks for r in group):
        raise AssertionError("slab submit_group did not queue four independent requests")
    if work["verify_steps"] == 0:
        raise AssertionError("no verify step ran")
    check_slab_launches(model, counts, 0, work["prefill_calls"])
    out = dict(**latency(reqs),
               accepted_per_slot_step=work["emitted"] / max(work["slot_steps"], 1),
               wall_s=wall, max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
               launches=counts, **work)
    log(f"  TTFT p50 {out['ttft_p50_ms']:.1f} ms, decode {out['decode_tok_per_s']:.1f} tok/s "
        f"over {work['verify_steps']} verify steps, {out['accepted_per_slot_step']:.3f} tokens "
        f"per slot-step, wall {wall:.2f} s")
    return out


def run_generate(model: MultimodalModel, rng, max_new_tokens: int = 64) -> dict:
    """generate() on 8 right-padded prompts of 449..512 tokens in a
    512-wide batch, one uint8 224x224 image each, greedy: TTFT (a call for
    one token: prefill and the first token), then the full call."""
    vocab, B, S, n_emb = model.config.llm.vocab_size, 8, 512, 256
    lens = np.asarray([512, 449, 500, 470, 511, 480, 490, 460])
    mask = (np.arange(S)[None, :] < lens[:, None]).astype(np.int32)
    batch = {"input_ids": rng.integers(2, vocab, (B, S)).astype(np.int32) * mask,
             "attention_mask": mask,
             "mm_inputs": {"image": {
                 "values": rng.integers(0, 256, (B, 224, 224, 3)).astype(np.uint8),
                 "batch_idx": np.repeat(np.arange(B, dtype=np.int32), n_emb),
                 "token_pos": np.tile(np.arange(8, 8 + n_emb, dtype=np.int32), B)}}}
    generate(model, batch, max_new_tokens=2, do_sample=False)  # warm-up; not measured

    def timed(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = generate(model, batch, max_new_tokens=n, do_sample=False)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    _, ttft = timed(1)
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    out, wall = timed(max_new_tokens)
    counts = launch_counts(SLAB_CHECKED)
    out = out.cpu()
    eos = model.config.eos_token_idx
    # the loop's live steps: step s runs while some row of out[:, :s] has no EOS
    live = sum(1 for s in range(1, max_new_tokens) if not (out[:, :s] == eos).any(dim=1).all())
    log(f"  launches: {counts}; live decode steps {live}")
    if out.shape != (B, max_new_tokens) or not ((out >= 0) & (out < vocab)).all():
        raise AssertionError(f"generate output {tuple(out.shape)} not shaped / in the vocab")
    check_slab_launches(model, counts, live, 1)
    res = dict(ttft_ms=ttft * 1000, wall_s=wall, decode_steps=live,
               decode_tok_per_s=B * live / (wall - ttft),
               max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9, launches=counts)
    log(f"  TTFT {res['ttft_ms']:.1f} ms, {res['decode_tok_per_s']:.1f} tok/s over {live} "
        f"steps, wall {wall:.2f} s, peak memory {res['max_memory_allocated_gb']:.2f} GB")
    return res


def run_k8_on_slab(engine: ServingEngine) -> dict:
    """K8 through its own entry point: the slab engine's cache laid out in
    pages of 128 through a shuffled page table, layer by layer; one
    paged_attention call a layer on random bf16 queries, against K1 over the
    contiguous cache (the slab decode step's attention) at the cache's
    lengths. The cache holds the model's K/V, not unit normals, so the
    outputs are not of order 1: the bf16 bound is taken relative to the
    largest output magnitude, where both kernels round their outputs to
    bf16 (one ulp in [2, 4) is 1.6e-2)."""
    st = engine.state
    L, B, Hkv, max_len, D = st["k"].shape
    H, P = engine.model.config.llm.num_heads, 128
    pm = max_len // P
    lengths = st["length"].clone()
    table = torch.from_numpy(np.random.default_rng(13).permutation(np.arange(1, 1 + B * pm))
                             .reshape(B, pm).astype(np.int32)).cuda()
    kv_mask = torch.arange(max_len, device="cuda")[None, :] < lengths[:, None]
    gen = torch.Generator(device="cuda").manual_seed(13)
    reset_launch_counts(("paged_attention",))
    err, scale = 0.0, 1.0
    for layer in range(L):
        pools = []
        for name in ("k", "v"):
            pool = torch.zeros((Hkv, 1 + B * pm, P, D), dtype=st[name].dtype, device="cuda")
            pool[:, table.flatten().long()] = (st[name][layer].reshape(B, Hkv, pm, P, D)
                                               .transpose(0, 1).reshape(Hkv, B * pm, P, D))
            pools.append(pool)
        q = torch.randn(B, H, D, generator=gen, device="cuda", dtype=st["k"].dtype)
        got = paged.paged_attention(q, *pools, table, lengths)
        want = fl.flash_attention(q[:, :, None].contiguous(), st["k"][layer], st["v"][layer],
                                  kv_mask=kv_mask, causal=False)[:, :, 0]
        torch.cuda.synchronize()
        if not torch.isfinite(got).all():
            raise AssertionError(f"K8: non-finite output at layer {layer}")
        err = max(err, (got.float() - want.float()).abs().max().item())
        scale = max(scale, want.float().abs().max().item())
    launches = paged.launches["paged_attention"]
    log(f"  K8 over the slab cache (lengths {lengths.tolist()}): {launches} launches, "
        f"max_abs_err against K1 {err:.3e}, max |output| {scale:.3f} "
        f"(tol {TOL[torch.bfloat16]:g} x max(1, max |output|))")
    if launches != L:
        raise AssertionError(f"K8 launched {launches} times, not once a layer ({L})")
    if not err <= TOL[torch.bfloat16] * scale:
        raise AssertionError(f"K8 disagrees with K1 over the slab cache: {err}")
    return dict(launches=launches, max_abs_err_vs_k1=err, max_abs_output=scale,
                lengths=lengths.tolist())


def run_slab_full_width(model: MultimodalModel) -> dict:
    """Phase 13: slab serving, K8 over its cache, slab speculative serving and
    generate(), at full width."""
    rng = np.random.default_rng(13)
    serving, engine = run_slab_serving(model, rng)
    k8 = run_k8_on_slab(engine)
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    spec = run_slab_spec(model, rng)
    gc.collect()
    torch.cuda.empty_cache()
    gen = run_generate(model, rng)
    return dict(serving=serving, k8_entry_point=k8, spec=spec, generate=gen)


# ----------------------------------------------------------------------
# Phases 6 and 7: the trainer
# ----------------------------------------------------------------------
class RecordingLogger(MetricsLogger):
    """The trainer's stdout/JSONL logger, keeping every step's metrics."""

    def __init__(self, cfg: TrainerConfig):
        super().__init__(cfg)
        self.records = []

    def log(self, step: int, metrics: dict) -> None:
        super().log(step, metrics)
        self.records.append({"step": step, **metrics})


def train_batch(rng, vocab: int, valid, seq: int, image_size: int, patch: int,
                images_per_row: int, image_at: int = 8, gap: int = 8) -> dict:
    """A collated SFT batch as the JAX collator shapes it: one row per entry
    of ``valid`` (its valid length; right padding to ``seq``), each with a
    user turn holding ``images_per_row`` uint8 images of
    (image_size/patch)^2 embeddings, then the assistant's tokens. Labels are
    -100 on the user turn (images included) and on the padding."""
    B, n_emb = len(valid), (image_size // patch) ** 2
    mask = (np.arange(seq)[None, :] < np.asarray(valid)[:, None]).astype(np.int32)
    ids = np.where(mask == 1, rng.integers(2, vocab, (B, seq)), 0).astype(np.int32)
    labels = np.where(mask == 1, ids, -100).astype(np.int32)
    starts = image_at + np.arange(images_per_row) * (n_emb + gap)
    labels[:, :starts[-1] + n_emb + gap] = -100  # the user turn
    positions = np.where(mask == 1, np.cumsum(mask, axis=-1) - 1, 0).astype(np.int32)
    span = (starts[:, None] + np.arange(n_emb)[None, :]).reshape(-1)
    return {
        "input_ids": ids, "attention_mask": mask, "labels": labels, "position_ids": positions,
        "mm_inputs": {"image": {
            "values": rng.integers(0, 256, (B * images_per_row, image_size, image_size, 3),
                                   dtype=np.uint8),
            "batch_idx": np.repeat(np.arange(B, dtype=np.int32), images_per_row * n_emb),
            "token_pos": np.tile(span, B).astype(np.int32),
        }},
    }


def train(model, batches, num_steps: int, output_dir: str, **cfg) -> tuple:
    trainer = MultimodalTrainer(model, TrainerConfig(
        learning_rate=1e-3, min_lr=1e-4, warmup_steps=1, total_steps=20,
        output_dir=output_dir, **cfg))
    logger = RecordingLogger(trainer.cfg)
    trainer.train(iter(batches), num_steps=num_steps, logger=logger)
    logger.close()
    return trainer, logger.records


def check_train_f32_card_vs_cpu() -> None:
    """3 optimizer steps in ALIGNMENT (no remat) and in FULL (remat,
    grad_accum=2) on the card and on the CPU, same weights and batches.

    Losses must agree to 1e-4 relative at every step. Parameters: 99.99% of
    the elements within 1e-5 and every element within 1e-3 after the steps.
    Adam divides each gradient element by its own running magnitude, so an
    element whose gradient is mostly rounding noise can take a step of
    either sign, up to lr = 1e-3 per step, on either device; the bound on
    the share of such elements is what holds the card to the CPU."""
    rng = np.random.default_rng(2)
    batches = [train_batch(rng, 1024, valid, 128, 32, 8, 1) for valid in ([128, 96], [80, 128])]
    for mode, remat, accum in ((TrainingMode.ALIGNMENT, False, 1),
                               (TrainingMode.FULL, True, 2)):
        cpu_model, gpu_model = small_f32_models()
        start = cpu_model.modalities["image"].projector.fc1.weight.detach().clone()
        steps = [batches[i % 2] for i in range(3 * accum)]
        cfg = dict(training_mode=mode, remat=remat, grad_accum=accum)
        with tempfile.TemporaryDirectory() as tmp:
            reset_launch_counts(TRAINING + SERVING)
            card, card_log = train(gpu_model, steps, len(steps), tmp, **cfg)
            counts = launch_counts(TRAINING + ("encoder_attention",))
            cpu, cpu_log = train(cpu_model, steps, len(steps), tmp, **cfg)
        card_loss = np.array([r["loss"] for r in card_log])
        cpu_loss = np.array([r["loss"] for r in cpu_log])
        loss_err = float(np.max(np.abs(card_loss - cpu_loss) / np.abs(cpu_loss)))
        diffs = {name: (a.detach().cpu() - b.detach()).abs().flatten()
                 for (name, a), b in zip(card.model.named_parameters(), cpu.model.parameters())}
        worst = max(diffs, key=lambda n: diffs[n].max().item())
        param_err = diffs[worst].max().item()
        off_share = sum(int((d > 1e-5).sum()) for d in diffs.values()) / sum(
            d.numel() for d in diffs.values())
        moved = (gpu_model.modalities["image"].projector.fc1.weight.detach().cpu()
                 - start).abs().max()
        log(f"  {mode.value}: card losses {card_loss.round(6).tolist()}, relative error "
            f"{loss_err:.2e}; params max_abs_err {param_err:.2e} ({worst}), share of "
            f"elements off by > 1e-5: {off_share:.2e} (projector moved {moved.item():.2e}); "
            f"launches {counts}")
        if not (loss_err <= 1e-4 and param_err <= 1e-3 and off_share <= 1e-4
                and moved.item() > 1e-3):
            raise AssertionError(f"f32 trainer on the card disagrees with the CPU ({mode.value})")
        if not all(counts.values()):
            raise AssertionError(f"a kernel was not launched by the f32 trainer: {counts}")
    check_train_int8_tower_card_vs_cpu(batches)


def check_train_int8_tower_card_vs_cpu(batches) -> None:
    """ALIGNMENT with quantize_frozen_towers, 3 optimizer steps, card against
    CPU: losses within 1e-3 relative (single int8 rounding flips between the
    kernels and the twins are allowed), the projector moves and the master
    tower's parameters do not."""
    cpu_model, gpu_model = small_f32_models()
    tower = {n: p.detach().clone()
             for n, p in gpu_model.modalities["image"].embedder.named_parameters()}
    start = cpu_model.modalities["image"].projector.fc1.weight.detach().clone()
    steps = [batches[i % 2] for i in range(3)]
    cfg = dict(training_mode=TrainingMode.ALIGNMENT, remat=False, quantize_frozen_towers=True)
    with tempfile.TemporaryDirectory() as tmp:
        reset_launch_counts()
        card, card_log = train(gpu_model, steps, len(steps), tmp, **cfg)
        counts = launch_counts(INT8_TOWER + ("encoder_attention",))
        cpu, cpu_log = train(cpu_model, steps, len(steps), tmp, **cfg)
    card_loss = np.array([r["loss"] for r in card_log])
    cpu_loss = np.array([r["loss"] for r in cpu_log])
    loss_err = float(np.max(np.abs(card_loss - cpu_loss) / np.abs(cpu_loss)))
    moved = (gpu_model.modalities["image"].projector.fc1.weight.detach().cpu() - start).abs().max()
    kept = all(torch.equal(p, tower[n])
               for n, p in gpu_model.modalities["image"].embedder.named_parameters())
    log(f"  alignment, quantize_frozen_towers: card losses {card_loss.round(6).tolist()}, "
        f"relative error {loss_err:.2e} (tol 1e-3); projector moved {moved.item():.2e}; "
        f"master tower unchanged {kept}; launches {counts}")
    if not (loss_err <= 1e-3 and moved.item() > 1e-3 and kept):
        raise AssertionError("f32 int8-tower trainer on the card disagrees with the CPU")
    if not all(counts[n] for n in INT8_TOWER):
        raise AssertionError(f"a K7 kernel was not launched by the int8-tower trainer: {counts}")


def run_train_full_width(model: MultimodalModel) -> dict:
    """ALIGNMENT at full width (config/config_alignment.yaml's batch 4 x 4096,
    16 images, remat): one warm-up step, then 3 timed steps."""
    vocab = model.config.llm.vocab_size
    batch = train_batch(np.random.default_rng(3), vocab, [4096, 3584, 2560, 1536], 4096,
                        224, 14, 4)
    llm, tower = model.llm, model.modalities["image"].embedder
    frozen = {"embed_tokens[:64]": lambda: llm.embed_tokens.weight[:64],
              "lm_head[:64]": lambda: llm.lm_head.weight[:64],
              "layers.0.q_proj": lambda: llm.layers[0].q_proj.weight,
              "layers.31.down_proj": lambda: llm.layers[31].down_proj.weight,
              "final_norm": lambda: llm.final_norm.weight,
              "tower.patch_proj": lambda: tower.patch_proj.weight,
              "tower.layers.23.fc2": lambda: tower.layers[23].fc2.weight}
    before = {name: get().detach().clone() for name, get in frozen.items()}
    projector = model.modalities["image"].projector.fc1.weight
    proj_before = projector.detach().clone()
    with tempfile.TemporaryDirectory() as tmp:
        trainer = MultimodalTrainer(model, TrainerConfig(
            learning_rate=1e-4, min_lr=1e-5, total_steps=100,
            training_mode=TrainingMode.ALIGNMENT, remat=True, output_dir=tmp))
        logger = RecordingLogger(trainer.cfg)
        trainer.train(iter([batch]), num_steps=1, logger=logger)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts(TRAINING + SERVING)
        t0 = time.perf_counter()
        last = trainer.train(iter([batch] * 3), num_steps=4, logger=logger)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counts(TRAINING + ("encoder_attention",))
        # one more step under torch.profiler: device time by kernel, busy share
        profile = busy_profile(lambda: trainer.train(iter([batch]), num_steps=5, logger=logger))
        logger.close()
    log(f"  profiled step: wall {profile['wall_ms']:.1f} ms, busy share "
        f"{profile['busy_share']}, top device ops (ms) "
        f"{ {k: round(v, 1) for k, v in profile['top_kernels_ms'].items()} }")
    timed = logger.records[1:4]
    losses = [r["loss"] for r in timed]
    log(f"  losses {losses}, step times {[round(r['step_time_s'], 3) for r in timed]} s, "
        f"launches {counts}")
    if len(timed) != 3 or not all(np.isfinite(losses)):
        raise AssertionError(f"full-width ALIGNMENT steps: {timed}")
    if torch.equal(projector, proj_before):
        raise AssertionError("the projector did not change")
    for name, get in frozen.items():
        if not torch.equal(get(), before[name]):
            raise AssertionError(f"frozen parameter {name} changed")
    if counts["flash_attention_fwd"] < 64 * 3:
        raise AssertionError("K1 launched fewer than 64 times per step (32 + 32 recompute)")
    for name in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
        if counts[name] < 32 * 3:
            raise AssertionError(f"{name} launched fewer than 32 times per step")
    peak = torch.cuda.max_memory_allocated()
    total = torch.cuda.get_device_properties(0).total_memory
    if not peak < total:
        raise AssertionError(f"peak memory {peak} not under the card's {total}")
    out = dict(losses=losses, step_time_s=[r["step_time_s"] for r in timed],
               tokens_per_step=int(batch["input_ids"].size), wall_s=wall,
               tokens_per_sec=last["tokens_per_sec"], mfu=last["mfu"],
               max_memory_allocated_gb=peak / 1e9, launches=counts, profiled_step=profile)
    log(f"  {out['tokens_per_sec']:.0f} tokens/s, MFU {out['mfu']:.4f}, "
        f"peak memory {out['max_memory_allocated_gb']:.2f} GB, wall {wall:.2f} s")
    return out


# ----------------------------------------------------------------------
# Phase 9: int8 encode at full width
# ----------------------------------------------------------------------
def busy_profile(fn) -> dict:
    """One call of ``fn`` under torch.profiler: wall, device busy share (the
    union of kernel intervals over the wall) and the device time by kernel
    family."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = e.name.replace("(anonymous namespace)::", "").replace("void ", "")
            key = name.split("<")[0].split("(")[0].strip()[-48:]
            by_name[key] = by_name.get(key, 0.0) + e.time_range.elapsed_us() / 1e3
    top = dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:8])
    # an empty trace (see device_ms) measured nothing: no busy share
    return dict(wall_ms=wall_us / 1e3, busy_share=busy / wall_us if spans else None,
                top_kernels_ms=top)


def run_int8_encode(model: MultimodalModel, n_batches: int = 8, batch: int = 256) -> dict:
    """The JAX bench's encode leg on the port: uint8 224x224 images -> the
    fused int8 ViT-L/14 -> the int8 projector, against the bf16 tower and
    projector on the same images."""
    mod = model.modalities["image"]
    gen = torch.Generator(device="cuda").manual_seed(9)

    def images(n):
        return torch.randint(0, 256, (n, 224, 224, 3), generator=gen, device="cuda",
                             dtype=torch.uint8)

    calib = images(16)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mod.quantize_params(calib, fused=True)
    qproj = quantize_mlp_projector(mlp_projector_tree(mod.projector))
    torch.cuda.synchronize()
    calib_s = time.perf_counter() - t0
    tower_q = mod.embedder_q
    batches = [images(batch) for _ in range(n_batches)]

    def int8(x):
        return mlp_projector_forward_int8(qproj, tower_q(mod._normalize_wire(x), drop_cls=True))

    def bf16(x):
        return mod.projector(mod.embedder(mod._normalize_wire(x), drop_cls=True))

    def rate(fn):
        fn(batches[0])  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for x in batches:
            fn(x)
        torch.cuda.synchronize()
        return n_batches * batch / (time.perf_counter() - t0)

    with torch.inference_mode():
        reset_launch_counts()
        int8_rate = rate(int8)
        counts = launch_counts(INT8_TOWER + ("encoder_attention",))
        reset_launch_counts(("encoder_attention",))
        bf16_rate = rate(bf16)
        k3_bf16 = launch_counts(("encoder_attention",))["encoder_attention"]
        a, b = int8(batches[0]).float(), bf16(batches[0]).float()
        cos = F.cosine_similarity(a.flatten(), b.flatten(), dim=0).item()
        tok_cos = F.cosine_similarity(a, b, dim=-1).mean().item()
        prof_int8 = busy_profile(lambda: int8(batches[1]))
        prof_bf16 = busy_profile(lambda: bf16(batches[1]))
    counts_ok = (counts["ln_quant"] == n_batches + 1 and counts["encoder_attention"] == 0
                 and all(counts[n] == 24 * (n_batches + 1) for n in INT8_TOWER[1:]))
    log(f"  calibration + packing {calib_s:.2f} s; int8 {int8_rate:.1f} img/s, bf16 "
        f"{bf16_rate:.1f} img/s ({n_batches} batches of {batch} each, after a warm-up batch); "
        f"cosine int8 vs bf16 {cos:.6f} (per token mean {tok_cos:.6f}); launches over the "
        f"{n_batches + 1} int8 batches {counts}")
    log(f"  one int8 batch: {prof_int8}")
    log(f"  one bf16 batch: {prof_bf16}")
    if a.shape != (batch, 256, 4096) or not torch.isfinite(a).all():
        raise AssertionError(f"int8 encode output {tuple(a.shape)} not finite/shaped")
    if not cos >= 0.99:
        raise AssertionError(f"int8 encode cosine {cos} against bf16 below 0.99")
    if not counts_ok:
        raise AssertionError(f"K7 launches are not 1 (K7a) and 24 (others) per batch: {counts}")
    if k3_bf16 != 24 * (n_batches + 1):
        raise AssertionError(f"bf16 encode: K3 launched {k3_bf16} times over {n_batches + 1} "
                             f"batches, not 24 a batch")
    return dict(int8_img_per_s=int8_rate, bf16_img_per_s=bf16_rate, calibration_s=calib_s,
                cosine=cos, token_cosine_mean=tok_cos, batches=n_batches, batch=batch,
                profile_int8=prof_int8, profile_bf16=prof_bf16, launches=counts,
                bf16_encoder_attention_launches=k3_bf16)


# ----------------------------------------------------------------------
# Phase 12: the other calibrations of the fused int8 tower at full width
# ----------------------------------------------------------------------
def encode_unwired(packed: dict, cfg, values: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """The fused tower's ops that have no caller, composed into a tower: K7b
    with int8 q, k, v at the static scales of an (L, 7) calibration ->
    K10 -> K7c (float o) -> K7f, after K7a; NHWC ``values`` -> features."""
    sc = scales.float().cpu().numpy()
    D, H, eps, L = cfg.hidden_size, cfg.num_heads, cfg.layer_norm_eps, sc.shape[0]
    x = embed_patches(packed, cfg, values)
    B, S, _ = x.shape
    M = B * S
    x2d = x.reshape(M, D).contiguous()
    xq = v8.ln_quant(x2d, packed["ln1_w"][0], packed["ln1_b"][0], float(sc[0, 0]), eps)
    for i in range(L):
        s0, s1, s2, s3, sq, sk, sv = (float(v) for v in sc[i, :7])
        q, k, v = v8.qkv_int8(xq, packed["wqkv_q"][i], packed["wqkv_s"][i], packed["qkv_b"][i],
                              s0, qkv_scales=(sq, sk, sv))
        qk = np.float32(sq) * np.float32(sk) * np.float32((D // H) ** -0.5)
        o = enc.encoder_attention_int8(q.view(B, S, D), k.view(B, S, D), v.view(B, S, D), H,
                                       qk, np.float32(sv) / np.float32(127), out_dtype=x2d.dtype)
        xp, xq2 = v8.oproj_ln_quant(o.view(M, D), x2d, packed["wo_q"][i], packed["wo_s"][i],
                                    packed["o_b"][i], packed["ln2_w"][i], packed["ln2_b"][i],
                                    s1, s2, eps)
        x2d, xq = v8.mlp_fused(xq2, xp, packed["w1_q"][i], packed["w1_s"][i], packed["b1"][i],
                               packed["w2_q"][i], packed["w2_s"][i], packed["b2"][i],
                               packed["ln1n_w"][i], packed["ln1n_b"][i], s2, s3,
                               float(sc[(i + 1) % L, 0]), eps, cfg.hidden_act)
    return finish(packed, cfg, x2d.view(B, S, D), True)


def cosines(a: torch.Tensor, b: torch.Tensor) -> tuple:
    a, b = a.float(), b.float()
    return (F.cosine_similarity(a.flatten(), b.flatten(), dim=0).item(),
            F.cosine_similarity(a, b, dim=-1).mean().item())


def run_other_calibrations(model: MultimodalModel, n_batches: int = 8, batch: int = 256) -> dict:
    """Phase 12: the phase-5 model's ViT-L/14 tower, smoothed, packed and
    calibrated on 16 uint8 images as (L, 4) (calibrate_act_scales) and as
    (L, 7) (calibrate_vit_int8_fused cut to seven columns); each tree is
    exported as a JAX checkpoint holds it and loaded back through
    load_jax_params, encodes 8 batches of 256 images through
    ImageModality.encode (img/s, cosine against the bf16 tower + projector)
    and serves phase 5's requests. Then one batch each of the (L, 8) tower
    with int8_o=False and with fuse_l=False, and one of the ops without a
    caller composed (encode_unwired: K7b int8, K10, K7f)."""
    mod = model.modalities["image"]
    cfg = mod.vit_cfg
    gen = torch.Generator(device="cuda").manual_seed(12)
    size, layers = cfg.image_size, cfg.num_layers
    feats_shape = (batch, (size // cfg.patch_size) ** 2, model.config.llm.hidden_size)

    def images(n):
        return torch.randint(0, 256, (n, size, size, 3), generator=gen, device="cuda",
                             dtype=torch.uint8)

    t0 = time.perf_counter()
    with torch.inference_mode():
        calib = mod._normalize_wire(images(16))
        params = v8.smooth_vit_params(vit_params_tree(mod.embedder), cfg, calib)
        packed = v8.pack_vit_int8_fused(params)
        scales8 = v8.calibrate_vit_int8_fused(params, cfg, calib)
        scales = {"L4": calibrate_act_scales(params, cfg, calib),
                  "L7": scales8[:, :7].contiguous()}
    del params
    torch.cuda.synchronize()
    out = dict(calibration_s=time.perf_counter() - t0)
    batches = [images(batch) for _ in range(n_batches)]
    with torch.inference_mode():
        ref = mod.projector(mod.embedder(mod._normalize_wire(batches[0]), drop_cls=True))

    def check(name, a, counts, forwards):
        check_tower_launches(name, counts, forwards, layers)
        if a.shape != feats_shape or not torch.isfinite(a.float()).all():
            raise AssertionError(f"{name}: encode output {tuple(a.shape)} not finite/shaped")
        cos, tok = cosines(a, ref)
        if not cos >= 0.99:
            raise AssertionError(f"{name}: encode cosine {cos} against bf16 below 0.99")
        return cos, tok

    for name in ("L4", "L7"):
        mod.embedder_q = v8.ViTInt8Fused(cfg, packed, scales[name])
        t0 = time.perf_counter()
        tree = export_jax_params(mod)
        mod.embedder_q = None
        load_jax_params(mod, tree)
        del tree
        convert_s = time.perf_counter() - t0
        tower = mod.embedder_q
        cols = scales[name].shape[1]
        if (not isinstance(tower, v8.ViTInt8Fused)
                or tuple(tower.act_scales.shape) != (layers, cols)):
            raise AssertionError(f"{name}: load_jax_params gave {type(tower).__name__}")
        with torch.inference_mode():
            mod.encode(batches[0])  # warm-up
            torch.cuda.synchronize()
            reset_launch_counts()
            t0 = time.perf_counter()
            for x in batches:
                mod.encode(x)
            torch.cuda.synchronize()
            rate = n_batches * batch / (time.perf_counter() - t0)
            counts = launch_counts(TOWER_KERNELS)
            a = mod.encode(batches[0])
        cos, tok = check(name, a, counts, n_batches)
        log(f"  {name}: export + load_jax_params {convert_s:.2f} s; encode {rate:.1f} img/s, "
            f"cosine vs bf16 {cos:.6f} (per token {tok:.6f}); launches {counts}")
        del a
        serving = run_full_width(model, tower=name)
        out[name] = dict(img_per_s=rate, cosine=cos, token_cosine_mean=tok, convert_s=convert_s,
                         launches=counts, serving=serving)
        gc.collect()
        torch.cuda.empty_cache()
    mod.embedder_q = None

    values = mod._normalize_wire(batches[0])
    legs = (("L8_float_out", lambda: v8.vit_forward_int8_fused(packed, cfg, values, scales8,
                                                               int8_o=False)),
            ("L8_no_fuse_l", lambda: v8.vit_forward_int8_fused(packed, cfg, values, scales8,
                                                               fuse_l=False)),
            ("unwired", lambda: encode_unwired(packed, cfg, values, scales["L7"])))
    for name, forward in legs:
        with torch.inference_mode():
            forward()  # warm-up
            torch.cuda.synchronize()
            reset_launch_counts()
            t0 = time.perf_counter()
            a = mod.projector(forward())
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = launch_counts(TOWER_KERNELS)
        if name == "unwired":
            want = {"ln_quant": 1, "qkv_int8": layers, "encoder_attention_int8": layers,
                    "oproj_ln_quant_float": layers, "mlp_fused": layers}
            if {n: c for n, c in counts.items() if c} != want:
                raise AssertionError(f"unwired: launches {counts}, expected {want}")
            cos, tok = cosines(a, ref)
            if not (a.shape == ref.shape and torch.isfinite(a.float()).all() and cos >= 0.99):
                raise AssertionError(f"unwired: cosine {cos} against bf16 below 0.99")
            counts = want
        else:
            cos, tok = check(name, a, counts, 1)
        log(f"  {name}: one batch of {batch} in {wall * 1e3:.1f} ms, cosine vs bf16 {cos:.6f} "
            f"(per token {tok:.6f}); launches {counts}")
        out[name] = dict(batch_ms=wall * 1e3, cosine=cos, token_cosine_mean=tok, launches=counts)
    return out


# ----------------------------------------------------------------------
# Phase 14: Mellum2-12B-A2.5B at full width: the grouped-expert kernel and
# K4 with a window against their twins at the GRPO cell's shapes, then the
# serving engine on the whole model

MELLUM_CONFIG = "bench_torch/configs/mellum2-12b-a2.5b-clip-l14.json"
# each kernel's device records, a decode graph's replays included: the route
# launch stands for the expert kernel's four (route, gate-up, down, combine)
MELLUM_KERNELS = {"grouped_experts": r"\bgrouped_experts_route_kernel\b",
                  "ring_decode_attention": GRAPH_KERNELS["ring_decode_attention"]}


def mellum_k4_case(gen, lengths, T: int = 16):
    """K4 at Mellum2-12B's decode shape: 32 heads over 4 kv heads, D = 128,
    pages of 128, a T-row ring with 8 rows in use; slot b holds lengths[b]
    keys, its own included, in a shuffled page table; one layer's pool."""
    B, H, Hkv, D, P = len(lengths), 32, 4, 128, 128
    pm = -(-max(lengths) // P) + 1
    n_pages = 1 + B * pm
    ids = np.random.default_rng(5).permutation(np.arange(1, n_pages)).reshape(B, pm)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda", dtype=torch.bfloat16)

    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda") - 1
    plen = lens - 7
    return (randn(B, H, D), randn(1, Hkv, n_pages, P, D), randn(1, Hkv, n_pages, P, D),
            randn(1, B, Hkv, T, D), randn(1, B, Hkv, T, D),
            torch.from_numpy(ids.astype(np.int32)).cuda(), plen, lens)


def grpo_long_lengths(seed: int = 4) -> list:
    """128 slots' keys in the GRPO cell: prompts of 320-1,280 tokens, up to
    2,048 generated."""
    rng = np.random.default_rng(seed)
    return (rng.integers(320, 1281, 128) + rng.integers(0, 2049, 128)).tolist()


def check_windowed_k4(gen) -> dict:
    """K4 with Mellum2's 1,024-key window against its twin, over the GRPO
    cell's mix of lengths and over 3,000 keys a slot (also with no window).
    The bf16 tolerance is 1% of the largest output: the twin with the window
    one 64-key tile wider misses it by far more."""
    out = {}
    for tag, lengths in (("cell mix", grpo_long_lengths()), ("3000 keys", [3000] * 128)):
        args = mellum_k4_case(gen, lengths)
        B, H, D = args[0].shape
        Hkv = args[1].shape[1]
        for window in (1024, 0):
            if tag == "cell mix" and window == 0:
                continue
            want = paged.ring_decode_attention_plain(*args, 0, window=window)
            tol = 1e-2 * want.float().abs().max().item()
            err = check_close(f"K4 bf16 Mellum2 {tag}, window {window}",
                              paged.ring_decode_attention(*args, 0, window=window), want, tol)
            if window:
                wider = (paged.ring_decode_attention_plain(*args, 0, window=window + 64).float()
                         - want.float()).abs().max().item()
                log(f"  the twin with a window of {window + 64}: {wider:.3e} from it")
                if not wider > 5 * tol:
                    raise AssertionError(f"K4 window tolerance {tol} does not tell a window "
                                         f"one tile wider ({wider})")
            keys = sum(min(n, window) if window else n for n in lengths)

            def run(window=window):
                return paged.ring_decode_attention(*args, 0, window=window)

            out[f"{tag}, window {window}"] = r = dict(
                max_abs_err=err, tol=tol, ms=time_ms(run), device_ms=device_ms(run, n=16),
                plain_ms=time_ms(lambda: paged.ring_decode_attention_plain(*args, 0,
                                                                           window=window)),
                **bound(torch.bfloat16, (2 * keys * Hkv * D + 2 * B * H * D) * 2,
                        4 * H * D * keys))
            log(f"  K4 Mellum2 {tag}, window {window}: kernel {r['ms']:.4f} ms (device "
                f"{fmt_ms(r['device_ms'])}), plain {r['plain_ms']:.4f}, bound "
                f"{r['bound_ms']:.4f} ({r['bound_by']})")
    if not out["3000 keys, window 1024"]["ms"] < 0.7 * out["3000 keys, window 0"]["ms"]:
        raise AssertionError("K4 over 3,000 keys is not faster with a 1,024-key window: "
                             "the pages before the window were read")
    return out


def check_grouped_experts(gen) -> dict:
    """The grouped-expert kernel against its twin at Mellum2's widths (D
    2,304, 64 experts of 896, top 8 of a softmax, renormalised; expert 63
    chosen by no token): a 128-slot decode step and a 1,024-token prefill
    chunk. The twin without each token's 8th expert misses the output by far
    more than the bf16 tolerance."""
    from multimeditron_torch.ops import grouped_experts as ge

    E, F_, D, k = 64, 896, 2304, 8
    w = [torch.randn(*shape, generator=gen, device="cuda").mul_(fan ** -0.5).bfloat16()
         for shape, fan in (((E, F_, D), D), ((E, F_, D), D), ((E, D, F_), F_))]
    out = {}
    for tag, N in (("decode 128 slots", 128), ("prefill 1024 tokens", 1024)):
        x = torch.randn(N, D, generator=gen, device="cuda").bfloat16()
        scores = torch.randn(N, E, generator=gen, device="cuda")
        scores[:, E - 1] = float("-inf")
        top, ids = torch.topk(torch.softmax(scores, dim=-1), k, dim=-1)
        top = top / top.sum(dim=-1, keepdim=True)
        stats, twin_stats = (torch.zeros(2, dtype=torch.int64, device="cuda") for _ in range(2))
        want = ge.grouped_experts_plain(x, ids, top, *w, twin_stats)
        err = check_close(f"grouped experts {tag}", ge.grouped_experts(x, ids, top, *w, stats),
                          want, TOL[torch.bfloat16])
        if not torch.equal(stats, twin_stats):
            raise AssertionError(f"grouped experts {tag}: counters {stats.tolist()} against "
                                 f"the twin's {twin_stats.tolist()}")
        seven = top[:, :7] / top[:, :7].sum(dim=-1, keepdim=True)
        short = (ge.grouped_experts_plain(x, ids[:, :7].contiguous(), seven, *w).float()
                 - want.float()).abs().max().item()
        log(f"  the twin without each token's 8th expert: {short:.3e} from it")
        if not short > 5 * TOL[torch.bfloat16]:
            raise AssertionError(f"the expert tolerance does not tell a lost expert ({short})")
        touched, assignments = (int(v) for v in stats)
        weight_bytes = touched * 3 * D * F_ * 2
        io_bytes = 2 * N * D * 2 + N * k * (8 + 4)  # x in, y out; ids and weights

        def run(x=x, ids=ids, top=top):
            return ge.grouped_experts(x, ids, top, *w)

        out[tag] = r = dict(
            max_abs_err=err, experts_touched=touched, assignments=assignments, ms=time_ms(run),
            device_ms=device_ms(run, n=16), plain_ms=time_ms(
                lambda x=x, ids=ids, top=top: ge.grouped_experts_plain(x, ids, top, *w)),
            **bound(torch.bfloat16, weight_bytes + io_bytes, 6 * D * F_ * assignments))
        log(f"  grouped experts {tag}: kernel {r['ms']:.4f} ms (device {fmt_ms(r['device_ms'])}), "
            f"plain {r['plain_ms']:.4f}, bound {r['bound_ms']:.4f} ({r['bound_by']}), "
            f"{touched} experts touched")
    return out


def mellum_model() -> MultimodalModel:
    """Mellum2-12B-A2.5B's published decoder keys + the CLIP ViT-L/14 tower,
    bf16, seeded."""
    with open(MELLUM_CONFIG) as f:
        hf = json.load(f)["decoder"]
    img = ImageConfig(model_type="meditron_clip", hidden_size=hf["hidden_size"], clip_name="",
                      param_dtype="bfloat16", wire_dtype="uint8")
    model = MultimodalModel(MultimodalConfig(llm=LlamaConfig.from_hf_dict(hf), modalities=[img],
                                             eos_token_idx=1), device="cuda")
    model.init_weights(torch.Generator(device="cuda").manual_seed(0))
    return model


def run_mellum_full_width() -> dict:
    """The engine on the whole of Mellum2-12B: 5 requests of 400-1,300
    prompt tokens (past 1,024 in two chunks) and a forked group of 4 over
    800, one image each, 64 new tokens, so that the windowed layers drop
    keys. A warm-up round captures the decode graph; in the counted round,
    under torch.profiler, every decode step replays it: the expert kernel
    runs 28 times a step and an eager prefill call's, K4 28 times a step."""
    from multimeditron_torch.ops import grouped_experts as ge

    t0 = time.perf_counter()
    model = mellum_model()
    torch.cuda.synchronize()
    L = model.config.llm.num_layers
    log(f"  model: {sum(p.numel() for p in model.parameters()) / 1e9:.3f} B params, "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB, init {time.perf_counter() - t0:.1f} s")
    engine = ServingEngine(model, EngineConfig(
        max_slots=16, max_seq_len=1408, prefill_buckets=(512, 1024), page_size=128,
        decode_chunk=8, temperature=1.0))
    vocab = model.config.llm.vocab_size
    rng = np.random.default_rng(0)

    def submit_all(budget):
        reqs = [engine.submit(make_request(rng, vocab, n, image_size=224, patch=14),
                              max_new_tokens=budget) for n in (1300, 1100, 900, 600, 400)]
        return reqs + engine.submit_group(make_request(rng, vocab, 800, image_size=224,
                                                       patch=14), 4, max_new_tokens=budget)

    submit_all(4)
    engine.run()
    ge.launches["grouped_experts"] = 0
    reset_launch_counts(("ring_decode_attention",))
    for name in ("n_prefill_calls", "n_decode_steps", "n_decode_chunks", "n_decode_graph_steps",
                 "n_experts_touched", "n_expert_assignments"):
        setattr(engine, name, 0)
    t0 = time.perf_counter()
    reqs = submit_all(64)
    records = device_records(engine.run, MELLUM_KERNELS)
    wall = time.perf_counter() - t0
    check_requests(reqs, vocab)
    steps = engine.n_decode_steps
    work = dict(prefill_calls=engine.n_prefill_calls, decode_steps=steps,
                decode_graph_steps=engine.n_decode_graph_steps,
                experts_touched_per_layer_step=engine.n_experts_touched / max(1, L * steps),
                host_expert_launches=ge.launches["grouped_experts"], wall_s=wall)
    log(f"  device records {records}; work {work}")
    if work["decode_graph_steps"] != steps or steps == 0:
        raise AssertionError(f"a decode step ran outside the graph: {work}")
    # the prefill's calls are eager (counted on the host); each decode step
    # replays L of them
    if records["grouped_experts"] != work["host_expert_launches"] + L * steps:
        raise AssertionError(f"expert kernel launches {records['grouped_experts']}, not "
                             f"{work['host_expert_launches']} + {L} x {steps}")
    if records["ring_decode_attention"] < L * steps:
        raise AssertionError(f"K4 launched fewer than {L} times per decode step: {records}")
    peak = torch.cuda.max_memory_allocated() / 1e9
    del engine, model
    gc.collect()
    torch.cuda.empty_cache()
    return dict(launches=records, memory_peak_gb=peak, **work)


def mellum_phase() -> dict:
    phase("[14] full width Mellum2-12B-A2.5B: the grouped-expert kernel and K4 with a window "
          "against their twins at the GRPO cell's shapes; the engine on the whole model")
    gen = torch.Generator(device="cuda").manual_seed(14)
    kernels = {"grouped_experts": check_grouped_experts(gen),
               "ring_decode_attention_window": check_windowed_k4(gen)}
    torch.cuda.empty_cache()
    return dict(kernels=kernels, engine=run_mellum_full_width())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mellum-only", action="store_true", help="phases 1, 2 and 14 alone")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    phase(f"[1] device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    log(f"  nvidia-smi: {smi}")

    t0 = time.perf_counter()
    _build.library()
    nvcc = ("reused an existing build" if _build.build_seconds is None
            else f"nvcc {_build.build_seconds:.1f} s")
    phase(f"[2] build: {time.perf_counter() - t0:.1f} s ({nvcc}) -> "
        f"{_build.library_path().relative_to(_build.BUILD_DIR.parent.parent)}")
    for source in PTXAS_REPORTED:
        report = _build.ptxas_report(source)
        for k in report["kernels"]:
            log(f"  ptxas -v {source}: {k['entry']}: {k['registers']} registers, "
                f"{k['spill_stores']} bytes spill stores, {k['spill_loads']} bytes spill loads")
        for line in report["warnings"]:
            log(f"  ptxas -v {source}: {line}")

    if args.mellum_only:
        mellum = mellum_phase()
        print(json.dumps({"mellum_full_width": mellum}))
        print(smi)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0

    phase("[3] kernels vs plain twins (times: median of 20 calls, of 10 for flash; ms)")
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = {}
    for names, check in ((("encoder_attention",), check_encoder_attention),
                         (("ring_decode_attention",), check_ring_decode),
                         (("paged_attention",), check_paged_attention),
                         (("flash_attention_fwd_decode",), check_flash_decode),
                         (("ring_verify_attention",), check_ring_verify),
                         (("fold_ring_into_pages",), check_fold),
                         (TRAINING, check_flash)):
        for dtype in (torch.float32, torch.bfloat16):
            res = check(dtype, gen)
            res = res if len(names) > 1 else {names[0]: res}
            for name in names:
                r = res[name]
                lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
                log(f"  {name} {str(dtype)[6:]}: kernel {r['ms']:.4f} ms, "
                    f"plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
                    f"({r['bound_by']}), library call {lib}")
        results.update(res)  # the bf16 numbers, the full-width paths' dtype
    for B, shape in ((8, "serving"), (256, "encode")):
        res = check_int8_kernels(gen, B)
        for name, r in res.items():
            results.setdefault(name, {})[shape] = r
        torch.cuda.empty_cache()
    for name in res:  # the encode shape's numbers head each int8 tower kernel's entry
        results[name] = {**results[name]["encode"], "serving_shape": results[name]["serving"]}
    results["wo_matmul"] = check_wo_matmul(gen)
    sampler = time_sampler(gen)
    log(f"  sampling (8, 128256) f32: threefry categorical {sampler['threefry_ms']:.4f} ms, "
        f"argmax {sampler['argmax_ms']:.4f} ms")
    torch.cuda.empty_cache()

    phase("[4] f32 engine: card vs CPU (greedy, speculative, forked, chunked, staggered)")
    check_f32_card_vs_cpu()

    phase("[5] full width: Llama-3.1-8B widths + CLIP ViT-L/14, bf16, 8 requests")
    t0 = time.perf_counter()
    model = full_width_model()
    torch.cuda.synchronize()
    log(f"  model: {sum(p.numel() for p in model.parameters()) / 1e9:.3f} B params, "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB, init {time.perf_counter() - t0:.1f} s")
    full = run_full_width(model, tower="bf16")
    gc.collect()
    torch.cuda.empty_cache()  # the engine and its KV pool are gone

    phase("[6] f32 trainer: card vs CPU, 3 optimizer steps, ALIGNMENT and FULL")
    check_train_f32_card_vs_cpu()

    phase("[7] full width ALIGNMENT: batch 4 x 4096, 16 images, remat, bf16")
    trained = run_train_full_width(model)
    gc.collect()
    torch.cuda.empty_cache()

    phase("[8] full width speculative serving: k = 4, greedy, 8 slots, forked group, "
        "chunked prompt")
    spec = run_spec_full_width(model)
    gc.collect()
    torch.cuda.empty_cache()

    phase("[9] full width int8 encode: CLIP ViT-L/14 fused W8A8 + int8 projector, 8 x 256 "
        "uint8 images, against bf16")
    encode = run_int8_encode(model)
    gc.collect()
    torch.cuda.empty_cache()

    phase("[10] full width serving with the int8 tower: phase 5 on the quantised model")
    full_int8 = run_full_width(model, tower="L8")
    gc.collect()
    torch.cuda.empty_cache()

    phase("[11] full width int8 LLM serving: quantize_llm + w8a8_prefill, bf16 tower; phase 5's "
        "run, phase 8's speculative run (k = 4), then phase 5's run in W8A16 (no w8a8_prefill)")
    model.modalities["image"].embedder_q = None  # back to phase 5's bf16 tower
    llm_int8 = run_full_width(model, int8_llm=True)
    gc.collect()
    torch.cuda.empty_cache()
    spec_int8 = run_spec_full_width(model, int8_llm=True)
    gc.collect()
    torch.cuda.empty_cache()
    log("  W8A16: quantize_llm without w8a8_prefill, phase 5's requests (K9 in prefill)")
    llm_w8a16 = run_full_width(model, int8_llm=True, w8a8_prefill=False)
    gc.collect()
    torch.cuda.empty_cache()

    phase("[12] full width, the other calibrations of the fused int8 tower: (L, 4) and (L, 7) "
        "through load_jax_params, 8 x 256 images and phase 5's serving each; (L, 8) with "
        "int8_o=False and fuse_l=False; K7b int8 + K10 + K7f composed")
    others = run_other_calibrations(model)
    gc.collect()
    torch.cuda.empty_cache()

    phase("[13] full width slab KV mode: phase 5's requests, phase 8's speculative mix, "
          "generate() on 8 x 512 tokens; K8 over the slab cache")
    model.modalities["image"].embedder_q = None  # phase 5's bf16 tower
    slab = run_slab_full_width(model)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    mellum = mellum_phase()

    # each kernel's launches in the full-width run of its path
    launches = {**full["launches"], **{n: trained["launches"][n] for n in TRAINING},
                "ring_verify_attention": spec["launches"]["ring_verify_attention"],
                **{n: encode["launches"][n] for n in INT8_TOWER},
                "wo_matmul": llm_int8["launches"]["wo_matmul"],
                # phase 12: the (L, 4) and (L, 7) serving runs, the one-batch legs
                "qkv_int8": others["L4"]["serving"]["launches"]["qkv_int8"],
                "oproj_ln_quant_float": others["L4"]["serving"]["launches"]["oproj_ln_quant_float"],
                "qkv_attn_int8_rowmax": others["L7"]["serving"]["launches"]["qkv_attn_int8_rowmax"],
                "qkv_attn_int8_float_out":
                    others["L8_float_out"]["launches"]["qkv_attn_int8_float_out"],
                "qkv_attn_int8_static": others["L8_no_fuse_l"]["launches"]["qkv_attn_int8_static"],
                "mlp_fused": others["unwired"]["launches"]["mlp_fused"],
                "encoder_attention_int8": others["unwired"]["launches"]["encoder_attention_int8"],
                # phase 13: K8 through its entry point, K1 in slab decode
                "paged_attention": slab["k8_entry_point"]["launches"],
                "flash_attention_fwd_decode":
                    slab["serving"]["launches"]["flash_attention_fwd"]}
    kernels = [dict(name=name, route="cuda", source=k["source"], replaces=k["replaces"],
                    launches=launches[name], **results[name])
               for name, k in KERNELS.items()]
    log(f"  all phases: {time.perf_counter() - T_START:.1f} s")
    print(json.dumps({"full_width": {**{k: v for k, v in full.items() if k != "launches"},
                                     "sampler_ms": sampler}}))
    print(json.dumps({"train_full_width": trained}))
    print(json.dumps({"spec_full_width": spec}))
    print(json.dumps({"int8_encode": encode}))
    print(json.dumps({"full_width_int8_tower": {k: v for k, v in full_int8.items()}}))
    print(json.dumps({"full_width_int8_llm": llm_int8, "spec_full_width_int8_llm": spec_int8,
                      "full_width_w8a16": llm_w8a16}))
    print(json.dumps({"other_calibrations": others}))
    print(json.dumps({"slab_full_width": slab}))
    print(json.dumps({"mellum_full_width": mellum}))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

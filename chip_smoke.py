"""Drive the PyTorch port (multimeditron_torch) once on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, each of which raises on failure (non-zero exit):

1. device: a CUDA device must be present; prints nvidia-smi's name and
   power limit;
2. build: compiles the CUDA kernels (csrc/*.cu) into multimeditron_torch/build/;
3. kernels: each kernel (K3 encoder attention, K4 ring decode attention,
   K5 ring fold) against its plain PyTorch twin on the card, at the main
   path's shapes, in float32 and bfloat16, with CUDA-event timings;
4. end to end in float32: the serving engine on the card against the same
   engine and weights on the CPU (greedy tokens must be equal);
5. the slice at full width: seeded random weights at Llama-3.1-8B widths plus
   the CLIP ViT-L/14 tower in bfloat16, 8 requests of 512 prompt tokens with
   one 224x224 uint8 image each and 64 new tokens, through submit() and
   run(); counts each kernel's launches in that run.

The last two lines of standard output are a JSON object describing each
kernel, then {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from multimeditron_torch import _build
from multimeditron_torch.modalities.image_clip import ImageConfig
from multimeditron_torch.models.llama import LlamaConfig
from multimeditron_torch.models.multimodal import MultimodalConfig, MultimodalModel
from multimeditron_torch.ops import encoder_attention as enc
from multimeditron_torch.ops import paged_attention as paged
from multimeditron_torch.serve.engine import EngineConfig, ServingEngine

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}  # max-abs, outputs of order 1
KERNELS = {
    "encoder_attention": dict(
        module=enc, source="multimeditron_torch/csrc/encoder_attention.cu",
        replaces="multimeditron_tpu/ops/encoder_attention.py:31"),
    "ring_decode_attention": dict(
        module=paged, source="multimeditron_torch/csrc/ring_decode.cu",
        replaces="multimeditron_tpu/ops/paged_attention.py:401"),
    "fold_ring_into_pages": dict(
        module=paged, source="multimeditron_torch/csrc/fold_ring.cu",
        replaces="multimeditron_tpu/ops/paged_attention.py:780"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def launch_counts() -> dict:
    return {name: k["module"].launches[name] for name, k in KERNELS.items()}


def reset_launch_counts() -> None:
    for name, k in KERNELS.items():
        k["module"].launches[name] = 0


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


def check_close(name: str, got: torch.Tensor, want: torch.Tensor, tol: float) -> float:
    torch.cuda.synchronize()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    err = (got.float() - want.float()).abs().max().item()
    log(f"  {name}: max_abs_err={err:.3e} (tol {tol:g})")
    if not err <= tol:
        raise AssertionError(f"{name}: max abs error {err} > {tol}")
    return err


# ----------------------------------------------------------------------
# Phase 3: each kernel against its plain twin
# ----------------------------------------------------------------------
def check_encoder_attention(dtype, gen) -> dict:
    B, S, H, Dh = 8, 257, 16, 64  # CLIP ViT-L/14 encode batch of the main path
    q, k, v = (torch.randn(B, S, H * Dh, generator=gen, device="cuda", dtype=dtype)
               for _ in range(3))
    scale = Dh ** -0.5
    tag = f"K3 {str(dtype)[6:]}"
    err = check_close(f"{tag} S={S}", enc.encoder_attention(q, k, v, H),
                      enc.encoder_attention_plain(q, k, v, H, scale), TOL[dtype])
    kv_len = 200  # keys past kv_len masked; rows past it are garbage by contract
    check_close(f"{tag} kv_len={kv_len}",
                enc.encoder_attention(q, k, v, H, kv_len=kv_len)[:, :kv_len],
                enc.encoder_attention_plain(q, k, v, H, scale, kv_len)[:, :kv_len],
                TOL[dtype])
    return dict(max_abs_err=err,
                ms=time_ms(lambda: enc.encoder_attention(q, k, v, H)),
                plain_ms=time_ms(lambda: enc.encoder_attention_plain(q, k, v, H, scale)))


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


def check_ring_decode(dtype, gen) -> dict:
    c = paged_case(dtype, gen)
    args = (c["q"], c["k_pages"], c["v_pages"], c["k_ring"], c["v_ring"],
            c["page_table"], c["pages_len"], c["lengths"], 1)
    err = check_close(f"K4 {str(dtype)[6:]}", paged.ring_decode_attention(*args),
                      paged.ring_decode_attention_plain(*args), TOL[dtype])
    return dict(max_abs_err=err,
                ms=time_ms(lambda: paged.ring_decode_attention(*args)),
                plain_ms=time_ms(lambda: paged.ring_decode_attention_plain(*args)))


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
    return dict(max_abs_err=err,
                ms=time_ms(lambda: paged.fold_ring_into_pages(kk, vk, *tail)),
                plain_ms=time_ms(lambda: paged.fold_ring_into_pages_plain(kp, vp, *tail)))


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


def check_f32_card_vs_cpu() -> None:
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
    ecfg = EngineConfig(max_slots=4, max_seq_len=128, prefill_buckets=(32, 64),
                        page_size=16, decode_chunk=8, do_sample=False, max_new_tokens=12)
    rng = np.random.default_rng(1)
    batches = [make_request(rng, 1024, 30, image_size=32, patch=8, image_at=4),
               make_request(rng, 1024, 20), make_request(rng, 1024, 50)]
    reset_launch_counts()
    on_card = ServingEngine(gpu_model, ecfg).generate(batches)
    counts = launch_counts()
    on_cpu = ServingEngine(cpu_model, ecfg).generate(batches)
    log(f"  card tokens: {on_card}")
    log(f"  cpu tokens:  {on_cpu}")
    log(f"  launches: {counts}")
    if on_card != on_cpu:
        raise AssertionError("f32 engine on the card disagrees with the CPU")
    if not all(counts.values()):
        raise AssertionError(f"a kernel was not launched by the f32 engine: {counts}")


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


def run_full_width() -> dict:
    t0 = time.perf_counter()
    model = full_width_model()
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"  model: {n_params / 1e9:.3f} B params, "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB, init {time.perf_counter() - t0:.1f} s")
    engine = ServingEngine(model, EngineConfig(
        max_slots=8, max_seq_len=640, prefill_buckets=(512,), page_size=128,
        decode_chunk=8, temperature=0.7))
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

    batches = requests()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    engine.n_prefill_calls = engine.n_decode_steps = engine.n_decode_chunks = 0
    t0 = time.time()
    reqs = [engine.submit(b, max_new_tokens=64) for b in batches]
    engine.run()
    wall = time.time() - t0
    counts = launch_counts()
    work = dict(prefill_calls=engine.n_prefill_calls, decode_steps=engine.n_decode_steps,
                decode_chunks=engine.n_decode_chunks)
    log(f"  launches: {counts}; work: {work}")

    for r in reqs:
        if r.finish_reason is None or not 1 <= len(r.tokens) <= 64:
            raise AssertionError(f"request {r.request_id}: {r.finish_reason}, "
                                 f"{len(r.tokens)} tokens")
        if not all(0 <= t < vocab for t in r.tokens):
            raise AssertionError(f"request {r.request_id}: token outside the vocab")
    if counts["encoder_attention"] < 24 * work["prefill_calls"]:
        raise AssertionError("K3 launched fewer than 24 times per prefill call")
    if counts["ring_decode_attention"] < 32 * work["decode_steps"]:
        raise AssertionError("K4 launched fewer than 32 times per decode step")
    if counts["fold_ring_into_pages"] < work["decode_chunks"]:
        raise AssertionError("K5 launched fewer times than there were decode chunks")
    if not all(counts.values()):
        raise AssertionError(f"a kernel of the path was not launched: {counts}")

    # outputs of the path are finite and shaped: one image through the tower
    # and a short prompt through the decoder
    with torch.inference_mode():
        probe = make_request(rng, vocab, 300, image_size=224, patch=14)
        mm = {"image": {k: torch.from_numpy(v).cuda()
                        for k, v in probe["mm_inputs"]["image"].items()}}
        feats = model.modalities["image"].encode(mm["image"]["values"])
        logits, _ = model.llm(inputs_embeds=model.embed(
            torch.from_numpy(probe["input_ids"]).cuda(), mm))
    if feats.shape != (1, 256, 4096) or not torch.isfinite(feats).all():
        raise AssertionError(f"image features {tuple(feats.shape)} not finite/shaped")
    if logits.shape != (1, 300, vocab) or not torch.isfinite(logits.float()).all():
        raise AssertionError(f"logits {tuple(logits.shape)} not finite/shaped")

    ttfts = sorted(r.ttft for r in reqs)
    first = max(r.first_token_time for r in reqs)
    last = max(r.finish_time for r in reqs)
    decode_tokens = sum(len(r.tokens) - 1 for r in reqs)
    out = dict(
        ttft_p50_ms=statistics.median(ttfts) * 1000,
        ttft_max_ms=ttfts[-1] * 1000,
        decode_tok_per_s=decode_tokens / (last - first),
        wall_s=wall,
        max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
        tokens=sum(len(r.tokens) for r in reqs),
        launches=counts, **work)
    log(f"  TTFT p50 {out['ttft_p50_ms']:.1f} ms, decode {out['decode_tok_per_s']:.1f} tok/s "
        f"over {work['decode_steps']} steps, peak memory "
        f"{out['max_memory_allocated_gb']:.2f} GB, wall {wall:.2f} s")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    log(f"[1] device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    log(f"  nvidia-smi: {smi}")

    t0 = time.perf_counter()
    _build.library()
    nvcc = ("reused an existing build" if _build.build_seconds is None
            else f"nvcc {_build.build_seconds:.1f} s")
    log(f"[2] build: {time.perf_counter() - t0:.1f} s ({nvcc}) -> "
        f"{_build.library_path().relative_to(_build.BUILD_DIR.parent.parent)}")

    log("[3] kernels vs plain twins (times: median of 20, ms)")
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = {}
    for name, check in (("encoder_attention", check_encoder_attention),
                        ("ring_decode_attention", check_ring_decode),
                        ("fold_ring_into_pages", check_fold)):
        for dtype in (torch.float32, torch.bfloat16):
            res = check(dtype, gen)
            log(f"  {name} {str(dtype)[6:]}: kernel {res['ms']:.4f} ms, "
                f"plain {res['plain_ms']:.4f} ms")
        results[name] = res  # the bf16 numbers, the serving path's dtype

    log("[4] f32 engine: card vs CPU, greedy")
    check_f32_card_vs_cpu()

    log("[5] full width: Llama-3.1-8B widths + CLIP ViT-L/14, bf16, 8 requests")
    full = run_full_width()

    kernels = [dict(name=name, route="cuda", source=k["source"], replaces=k["replaces"],
                    launches=full["launches"][name], **results[name])
               for name, k in KERNELS.items()]
    print(json.dumps({"full_width": {k: v for k, v in full.items() if k != "launches"}}))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

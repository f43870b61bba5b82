"""SFT trainer for one device: collated batch -> MultimodalModel.forward
(embed splice, no-cache Llama forward with per-layer remat, cross entropy)
-> masked AdamW step.

Counterpart of ``multimeditron_tpu/train/trainer.py``. The optimizer is the
one the JAX trainer builds with optax, written in plain tensor ops:

- ``clip_by_global_norm(max_grad_norm)``: gradients are scaled by
  ``max_grad_norm / norm`` only when the norm is >= the limit (optax's rule);
- AdamW on the trainable parameters only (``optax.masked``): ``b1``, ``b2``,
  ``eps=1e-8``, weight decay decoupled and scaled by the learning rate, and
  the learning rate from ``warmup_cosine_decay_schedule`` evaluated on the
  optimizer's update count;
- moment dtypes as optax gives them: ``mu`` in ``adam_moment_dtype`` if set,
  else the parameter's dtype; ``nu`` in the parameter's dtype (so bf16
  parameters get bf16 moments). The update itself is computed in float32;
- ``grad_accum = k`` with ``optax.MultiSteps`` semantics: the running mean
  of k microbatch gradients, applied on every k-th call; ``step`` counts
  microbatches.

Frozen parameters (``TrainingMode``) have ``requires_grad=False``, so
autograd computes no weight gradient for them, which is what the JAX
trainer's ``stop_gradient`` achieves. ``quantize_frozen_towers`` builds the
fused W8A8 twin of each frozen image tower once, calibrated on the first
batch's first 16 items, and encodes through it from then on; the float tower
stays the master copy. Configurations the port does not run yet raise
``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import math
import os
import time
from typing import Any, Dict, Iterable, List, Optional

import numpy as np
import torch

from multimeditron_torch.models.multimodal import MultimodalModel, TrainingMode, mm_item_count
from multimeditron_torch.profiling import ProfileWindow, ThroughputMeter, profiler_enabled, tracer

logger = logging.getLogger(__name__)

ADAM_EPS = 1e-8


@dataclasses.dataclass
class TrainerConfig:
    """The JAX ``TrainerConfig``'s fields, with the same defaults."""

    learning_rate: float = 1e-4
    min_lr: float = 3e-5
    warmup_steps: int = 0
    total_steps: int = 1000
    weight_decay: float = 0.01
    b1: float = 0.9
    b2: float = 0.999
    max_grad_norm: float = 1.0
    grad_accum: int = 1
    # dtype of Adam's first moment (e.g. "float32"); None: the param's dtype
    adam_moment_dtype: Optional[str] = None
    training_mode: TrainingMode = TrainingMode.ALIGNMENT
    # mesh: only one process on one device is ported
    dp: Optional[int] = None
    fsdp: Optional[int] = None
    tp: int = 1
    sp: int = 1
    ring_attention: bool = False
    ep: int = 1
    pp: int = 1
    pp_microbatches: Optional[int] = None
    # compute
    remat: bool = True
    attn_impl: Optional[str] = None
    quantize_frozen_towers: bool = False
    # logging / ckpt
    log_every: int = 1
    save_every: Optional[int] = None
    output_dir: str = "checkpoints"
    run_name: str = "multimeditron-tpu"
    wandb: bool = False
    wandb_run_id: Optional[str] = None
    # profiling window (ENABLE_TORCH_PROFILER=1)
    profile_start_step: int = 10
    profile_num_steps: int = 5
    seed: int = 0


def _world_size() -> int:
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        return torch.distributed.get_world_size()
    return 1


def _refuse_unported(cfg: TrainerConfig) -> None:
    for name in ("tp", "sp", "ep", "pp"):
        if getattr(cfg, name) > 1:
            raise NotImplementedError(
                f"{name}={getattr(cfg, name)}: tensor/sequence/expert/pipeline parallel "
                "training is not ported yet (ROADMAP queue 1, parallelism)")
    if cfg.ring_attention:
        raise NotImplementedError(
            "ring_attention is not ported yet (ROADMAP queue 1, parallelism)")
    if (cfg.dp or 1) > 1 or (cfg.fsdp or 1) > 1 or _world_size() > 1:
        raise NotImplementedError(
            "data parallel / FSDP training over several processes is not ported yet "
            "(ROADMAP queue 1, training path: multi-process data parallel)")
    if cfg.attn_impl is not None:
        raise NotImplementedError(
            "attn_impl: the port picks attention by device (ops/attention.py)")


def warmup_cosine_decay(cfg: TrainerConfig, count: int) -> float:
    """``optax.warmup_cosine_decay_schedule`` as the JAX trainer builds it."""
    init = 0.0 if cfg.warmup_steps > 0 else cfg.learning_rate
    peak, warmup = cfg.learning_rate, cfg.warmup_steps
    if count < warmup:
        return init + (peak - init) * count / warmup
    decay_steps = max(cfg.total_steps, 1) - warmup
    alpha = 0.0 if peak == 0.0 else cfg.min_lr / peak
    t = min(count - warmup, decay_steps)
    return peak * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * t / decay_steps)) + alpha)


class MetricsLogger:
    """stdout + JSONL (+ optional wandb) metrics sink; rank 0 writes."""

    def __init__(self, cfg: TrainerConfig):
        self.cfg = cfg
        rank = (torch.distributed.get_rank()
                if torch.distributed.is_available() and torch.distributed.is_initialized()
                else 0)
        self._primary = rank == 0
        self._file = None
        self._wandb = None
        if not self._primary:
            return
        os.makedirs(cfg.output_dir, exist_ok=True)
        self._file = open(os.path.join(cfg.output_dir, "metrics.jsonl"), "a", buffering=1)
        if cfg.wandb:
            try:
                import wandb

                self._wandb = wandb.init(**self.wandb_init_kwargs(cfg))
            except Exception as e:
                self._wandb = None
                logger.warning(
                    "wandb was requested but init failed (%s: %s); "
                    "continuing with stdout/JSONL logging only.", type(e).__name__, e)

    @staticmethod
    def wandb_init_kwargs(cfg: TrainerConfig) -> Dict[str, Any]:
        """Resume-aware wandb.init kwargs: a configured run id reattaches."""
        kwargs: Dict[str, Any] = dict(project="MultiMeditron", name=cfg.run_name,
                                      config=dataclasses.asdict(cfg))
        if cfg.wandb_run_id:
            kwargs.update(id=str(cfg.wandb_run_id), resume="allow")
        return kwargs

    def log(self, step: int, metrics: Dict[str, float]) -> None:
        if not self._primary:
            return
        record = {"step": step, **{k: float(v) for k, v in metrics.items()}}
        self._file.write(json.dumps(record) + "\n")
        if self._wandb is not None:
            self._wandb.log(metrics, step=step)
        if step % self.cfg.log_every == 0:
            printable = " ".join(f"{k}={v:.4g}" for k, v in record.items() if k != "step")
            print(f"[step {step}] {printable}", flush=True)

    def close(self):
        if self._file is not None:
            self._file.close()


def _to_device(tree, device: torch.device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (np.ndarray, np.generic)):
        return torch.from_numpy(np.ascontiguousarray(tree)).to(device)
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return tree


def _global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(sum(t.float().pow(2).sum() for t in tensors))


class MultimodalTrainer:
    """Trains ``model`` in place on the device its parameters lie on."""

    def __init__(self, model: MultimodalModel, config: TrainerConfig):
        _refuse_unported(config)
        self.model = model
        self.cfg = config
        self.device = next(model.parameters()).device
        self.trainable_mask = model.trainable_mask(config.training_mode)
        self._trainable = [(n, p) for n, p in model.named_parameters() if self.trainable_mask[n]]
        mu_dtype = (getattr(torch, config.adam_moment_dtype)
                    if config.adam_moment_dtype else None)
        self.opt_state: Dict[str, Any] = {
            "count": 0,  # optimizer updates applied
            "mini_step": 0,  # microbatches in the current accumulation
            "mu": {n: torch.zeros_like(p, dtype=mu_dtype or p.dtype) for n, p in self._trainable},
            "nu": {n: torch.zeros_like(p) for n, p in self._trainable},
        }
        if config.grad_accum > 1:
            self.opt_state["acc_grads"] = {n: torch.zeros_like(p) for n, p in self._trainable}
        self.step = 0
        self._qmods: Optional[Dict[str, Any]] = None  # quantize_frozen_towers, from batch 1

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        """Every parameter of the model by name (live tensors)."""
        return dict(self.model.named_parameters())

    def load_state(self, state: Dict[str, Any]) -> None:
        """Adopt a :meth:`Checkpointer.restore` result: params, optimizer
        state and step, copied onto this trainer's device."""
        with torch.no_grad():
            for name, p in self.model.named_parameters():
                p.copy_(state["params"][name])
        opt = state["opt_state"]
        for key in ("mu", "nu", "acc_grads"):
            if key in self.opt_state:
                for name, t in self.opt_state[key].items():
                    t.copy_(opt[key][name])
        self.opt_state["count"] = int(opt["count"])
        self.opt_state["mini_step"] = int(opt["mini_step"])
        self.step = int(state["step"])

    def lr(self, count: int) -> float:
        return warmup_cosine_decay(self.cfg, count)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def _apply(self, grads: List[torch.Tensor]) -> None:
        cfg, st = self.cfg, self.opt_state
        norm = _global_norm(grads)
        count_inc = st["count"] + 1
        lr = self.lr(st["count"])
        c1, c2 = 1 - cfg.b1 ** count_inc, 1 - cfg.b2 ** count_inc
        for (name, p), g in zip(self._trainable, grads):
            g = g.float()
            g = torch.where(norm < cfg.max_grad_norm, g, (g / norm) * cfg.max_grad_norm)
            mu = (1 - cfg.b1) * g + cfg.b1 * st["mu"][name].float()
            nu = (1 - cfg.b2) * (g * g) + cfg.b2 * st["nu"][name].float()
            update = (mu / c1) / (torch.sqrt(nu / c2) + ADAM_EPS) + cfg.weight_decay * p.float()
            p.copy_(p.float() + (-lr) * update)
            st["mu"][name].copy_(mu)
            st["nu"][name].copy_(nu)
        st["count"] = count_inc

    def train_step(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """One microbatch step. With grad_accum > 1 the optimizer applies
        once every grad_accum calls (optax.MultiSteps)."""
        self._maybe_quantize_frozen_towers(batch)
        with tracer.span("train.feed"):
            batch = _to_device(batch, self.device)
        with tracer.span("train.forward"):
            _, loss = self.model.forward(batch, remat=self.cfg.remat)
        params = [p for _, p in self._trainable]
        with tracer.span("train.backward"):
            grads = torch.autograd.grad(loss, params, allow_unused=True)
        with tracer.span("train.optimizer"):
            grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
            grad_norm = _global_norm(grads)
            k, st = self.cfg.grad_accum, self.opt_state
            if k > 1:
                with torch.no_grad():
                    n = st["mini_step"]
                    for (name, _), g in zip(self._trainable, grads):
                        acc = st["acc_grads"][name]
                        acc.add_((g - acc) / (n + 1))  # Welford mean, as optax
                    if n == k - 1:
                        self._apply(list(st["acc_grads"].values()))
                        for acc in st["acc_grads"].values():
                            acc.zero_()
                    st["mini_step"] = (n + 1) % k
            else:
                self._apply(grads)
        self.step += 1
        return {"loss": loss.detach(), "grad_norm": grad_norm}

    def _maybe_quantize_frozen_towers(self, batch: Dict[str, Any]) -> None:
        """Build the fused int8 twin of each frozen modality tower, once,
        calibrated on the first batch's first 16 items of that modality."""
        if not self.cfg.quantize_frozen_towers or self._qmods is not None:
            return
        if TrainingMode(self.cfg.training_mode) == TrainingMode.FULL:
            raise ValueError("quantize_frozen_towers needs frozen embedders "
                             "(training_mode != FULL)")
        qmods: Dict[str, Any] = {}
        for mtype, pack in (batch.get("mm_inputs") or {}).items():
            mod = self.model.modalities[mtype] if mtype in self.model.modalities else None
            if mod is None or not hasattr(mod, "quantize_params"):
                continue
            values = _to_device(np.asarray(pack["values"])[:16], self.device)
            qmods[mtype] = mod.quantize_params(values, fused=True)
        self._qmods = qmods or None

    # ------------------------------------------------------------------
    def train(
        self,
        data_iter: Iterable[Dict[str, Any]],
        num_steps: Optional[int] = None,
        logger: Optional[MetricsLogger] = None,
        checkpointer=None,
    ) -> Dict[str, float]:
        """Run up to ``num_steps`` microbatch steps (default ``total_steps``);
        returns the last step's metrics. An interrupt saves a checkpoint."""
        logger = logger or MetricsLogger(self.cfg)
        num_steps = num_steps or self.cfg.total_steps
        meter = ThroughputMeter(
            num_params=sum(p.numel() for p in self.model.parameters()),
            num_params_trainable=sum(p.numel() for _, p in self._trainable),
            device=self.device)
        try:
            return self._train_loop(data_iter, num_steps, logger, checkpointer, meter)
        except KeyboardInterrupt:
            if checkpointer is not None:
                print(f"Interrupted at step {self.step}; saving checkpoint")
                checkpointer.save(self.step, self.params, self.opt_state)
            raise

    def _train_loop(self, data_iter, num_steps, logger, checkpointer, meter):
        cfg = self.cfg
        window = (ProfileWindow(os.path.join(cfg.output_dir, "profile"))
                  if profiler_enabled() else None)
        last: Dict[str, float] = {}
        t_prev = time.time()
        for batch in data_iter:
            if self.step >= num_steps:
                break
            if window is not None and self.step == cfg.profile_start_step:
                window.start()
            padded = int(np.prod(np.asarray(batch["input_ids"]).shape))
            mask = batch.get("attention_mask")
            tokens = padded if mask is None else int(np.asarray(mask).sum())
            with tracer.span("train.step", step=self.step, tokens=tokens, padded=padded) as sp:
                if sp:
                    sp.set(images=mm_item_count(batch.get("mm_inputs"),
                                                np.asarray(batch["input_ids"]).shape[0]))
                out = self.train_step(batch)
                with tracer.span("train.wait"):
                    metrics = {k: float(v) for k, v in out.items()}
                dt = time.time() - t_prev
                t_prev = time.time()
                metrics["lr"] = self.lr(self.step)
                metrics.update(meter.update(tokens))
                metrics["step_time_s"] = dt
                logger.log(self.step, metrics)
            last = metrics
            if window is not None and self.step == cfg.profile_start_step + cfg.profile_num_steps:
                window.stop()
            if checkpointer is not None and cfg.save_every and self.step % cfg.save_every == 0:
                checkpointer.save(self.step, self.params, self.opt_state)
        return last

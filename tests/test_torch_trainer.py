"""Port parity: the training path (loss, freeze masks, masked AdamW with
clipping, schedule and gradient accumulation, checkpoints, data loader)
against the JAX trainer on tests.test_multimodal.tiny_mm_config, f32, with
the JAX collator's batches fed to both.

Tolerances: losses agree to 1e-5 relative; parameters after 3 optimizer
steps to 2e-5 absolute. Adam divides each gradient by its own running norm,
so an entry whose gradient is a cancellation residue near Adam's eps (1e-8)
moves by up to lr * (relative noise); with lr = 1e-3 the measured gap is
far below the bound."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from multimeditron_torch.convert import _entries, export_jax_params, load_jax_params
from multimeditron_torch.models import multimodal as tm
from multimeditron_torch.models.common import cross_entropy_loss
from multimeditron_torch.models.llama import LlamaConfig as TLlamaConfig
from multimeditron_torch.train import checkpoint as tckpt
from multimeditron_torch.train import data as tdata
from multimeditron_torch.train import trainer as tt
from multimeditron_tpu.data.chat_template import ChatTemplate
from multimeditron_tpu.data.collator import DataCollatorForMultimodal
from multimeditron_tpu.data.loaders import AutoModalityLoader
from multimeditron_tpu.models import common as jcommon
from multimeditron_tpu.models import multimodal as jm
from multimeditron_tpu.train import data as jdata
from multimeditron_tpu.train import trainer as jt
from tests.fixtures.toy_tokenizer import ToyTokenizer
from tests.test_multimodal import ATTACH, _img, _samples, tiny_mm_config
from tests.test_torch_vit import perturbed

LOSS = dict(rtol=1e-5, atol=1e-6)
PARAMS = dict(rtol=0, atol=2e-5)
Mode = tm.TrainingMode


def _cfg(cls, tmp_path, **kw):
    base = dict(learning_rate=1e-3, min_lr=1e-4, total_steps=10, remat=True,
                output_dir=str(tmp_path / "run"))
    return cls(**{**base, **kw})


def _collator(model):
    return DataCollatorForMultimodal(
        tokenizer=ToyTokenizer(),
        modality_processors=model.processors(),
        modality_loaders={"image": AutoModalityLoader.create("raw-image")},
        attachment_token=ATTACH,
        chat_template=ChatTemplate.llama(),
        pad_to_multiple=16,
        modality_budgets={"image": 2},
    )


def _batches(collator):
    more = [{"conversations": [{"role": "user", "content": f"{ATTACH} and {ATTACH}?"},
                               {"role": "assistant", "content": "two squares"}],
             "modalities": [{"type": "image", "value": _img((0, 0, 255))},
                            {"type": "image", "value": _img((0, 255, 0))}]},
            _samples()[1]]
    return [collator(_samples()), collator(more)]


@pytest.fixture(scope="module")
def jax_setup():
    jmodel = jm.MultimodalModel(tiny_mm_config())
    params = perturbed(jmodel.init_params(jax.random.PRNGKey(0)), seed=1)
    return jmodel, params, _batches(_collator(jmodel))


def _port_model(jmodel, params):
    tmodel = tm.MultimodalModel(tm.MultimodalConfig.from_dict(jmodel.config.to_dict()),
                                device="cpu")
    load_jax_params(tmodel, params)
    return tmodel


def _port_trainer(jax_setup, tmp_path, **kw):
    jmodel, params, _ = jax_setup
    return tt.MultimodalTrainer(_port_model(jmodel, params), _cfg(tt.TrainerConfig, tmp_path, **kw))


def test_cross_entropy_loss_matches_jax():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(2, 7, 11)).astype(np.float32) * 3
    labels = rng.integers(0, 11, (2, 7))
    labels[0, :3] = -100
    labels[1, 5] = -100
    got = cross_entropy_loss(torch.from_numpy(logits), torch.from_numpy(labels))
    want = jcommon.cross_entropy_loss(jnp.asarray(logits), jnp.asarray(labels))
    np.testing.assert_allclose(got.item(), float(want), **LOSS)
    none = np.full_like(labels, -100)
    assert cross_entropy_loss(torch.from_numpy(logits), torch.from_numpy(none)).item() == 0.0


@pytest.mark.parametrize("mode", list(Mode))
def test_trainable_masks_match_jax(jax_setup, mode):
    jmodel, params, _ = jax_setup
    tmodel = _port_model(jmodel, params)
    mask = tmodel.trainable_mask(mode)
    jmask = jmodel.trainable_mask(params, jm.TrainingMode(mode.value))
    entries = _entries(tmodel)
    assert sorted(mask) == sorted(n for _, n, _, _ in entries)
    for path, name, _, layer in entries:
        node = jmask
        for key in path:
            node = node[key]
        assert mask[name] == bool(node), name
    for name, p in tmodel.named_parameters():
        assert p.requires_grad == mask[name], name


def test_alignment_updates_only_projector(jax_setup, tmp_path):
    trainer = _port_trainer(jax_setup, tmp_path, training_mode=Mode.ALIGNMENT)
    before = {n: p.detach().clone() for n, p in trainer.params.items()}
    metrics = trainer.train_step(jax_setup[2][0])
    assert np.isfinite(float(metrics["loss"]))
    for name, p in trainer.params.items():
        if ".projector." in name:
            assert not torch.equal(p, before[name]), name
        else:
            assert torch.equal(p, before[name]), name


@pytest.mark.parametrize("mode,grad_accum", [(Mode.ALIGNMENT, 1), (Mode.FULL, 2)])
def test_three_steps_match_jax_trainer(jax_setup, tmp_path, mode, grad_accum):
    jmodel, params, batches = jax_setup
    cfg_kw = dict(training_mode=mode, grad_accum=grad_accum, warmup_steps=1)
    jtrainer = jt.MultimodalTrainer(jm.MultimodalModel(tiny_mm_config()), params,
                                    _cfg(jt.TrainerConfig, tmp_path, **cfg_kw))
    ttrainer = _port_trainer(jax_setup, tmp_path, **cfg_kw)
    order = [0, 1, 0] * grad_accum  # 3 optimizer steps
    for i in order:
        want = jtrainer.train_step(batches[i])
        got = ttrainer.train_step(batches[i])
        np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), **LOSS)
        np.testing.assert_allclose(float(got["grad_norm"]), float(want["grad_norm"]),
                                   rtol=1e-4)
    assert ttrainer.opt_state["count"] == 3 and ttrainer.step == 3 * grad_accum
    want_p = jax.tree.map(np.asarray, jtrainer.params)
    got_p = export_jax_params(ttrainer.model)
    for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(got_p),
                                 jax.tree_util.tree_leaves_with_path(want_p)):
        np.testing.assert_allclose(a, b, **PARAMS, err_msg=jax.tree_util.keystr(path))
    fc1 = ("modalities", "image", "projector", "fc1")
    start = params
    for key in fc1:
        start, got_p = start[key], got_p[key]
    assert np.abs(got_p - start).max() > 1e-3  # the steps did move the projector


def test_grad_accum_matches_large_batch(jax_setup, tmp_path):
    t1 = _port_trainer(jax_setup, tmp_path, training_mode=Mode.FULL)
    t2 = _port_trainer(jax_setup, tmp_path, training_mode=Mode.FULL, grad_accum=2)
    batch = jax_setup[2][0]
    init = {n: p.detach().clone() for n, p in t2.params.items()}
    t1.train_step(batch)
    t2.train_step(batch)  # accumulates only
    for name, p in t2.params.items():
        assert torch.equal(p, init[name]), name
    t2.train_step(batch)  # applies the mean of two equal gradients
    for (name, a), b in zip(t1.params.items(), t2.params.values()):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5, msg=name)


@pytest.mark.parametrize("warmup", [0, 3])
def test_schedule_matches_optax(warmup):
    cfg = tt.TrainerConfig(learning_rate=2e-4, min_lr=3e-5, warmup_steps=warmup,
                           total_steps=10)
    sched = optax.warmup_cosine_decay_schedule(
        init_value=0.0 if warmup else cfg.learning_rate, peak_value=cfg.learning_rate,
        warmup_steps=warmup, decay_steps=cfg.total_steps, end_value=cfg.min_lr)
    for count in range(14):
        np.testing.assert_allclose(tt.warmup_cosine_decay(cfg, count), float(sched(count)),
                                   rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("moment_dtype", [None, "float32"])
def test_adam_state_dtypes_match_optax_for_bf16_params(tmp_path, moment_dtype):
    llm = TLlamaConfig(vocab_size=64, hidden_size=32, intermediate_size=64, num_layers=1,
                       num_heads=2, num_kv_heads=1, dtype=torch.bfloat16)
    model = tm.MultimodalModel(tm.MultimodalConfig(llm=llm), device="cpu")
    trainer = tt.MultimodalTrainer(model, tt.TrainerConfig(
        training_mode=Mode.FULL, adam_moment_dtype=moment_dtype,
        output_dir=str(tmp_path)))
    state = optax.adamw(1e-3, mu_dtype=moment_dtype).init(
        {"w": jnp.zeros((2, 2), jnp.bfloat16)})[0]
    names = {"bfloat16": torch.bfloat16, "float32": torch.float32}
    for name, _ in trainer._trainable:
        assert trainer.opt_state["mu"][name].dtype == names[state.mu["w"].dtype.name]
        assert trainer.opt_state["nu"][name].dtype == names[state.nu["w"].dtype.name]


def test_checkpoint_restore_gives_identical_next_step(jax_setup, tmp_path):
    batches = jax_setup[2]
    a = _port_trainer(jax_setup, tmp_path, training_mode=Mode.FULL, grad_accum=2)
    for i in (0, 1, 0):
        a.train_step(batches[i])
    ckpt = tckpt.Checkpointer(str(tmp_path / "ckpt"), max_to_keep=2)
    for step in (1, 2, a.step):
        ckpt.save(step, a.params, a.opt_state)
    assert ckpt.latest_step() == 3
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == ["2", "3"]

    b = _port_trainer(jax_setup, tmp_path, training_mode=Mode.FULL, grad_accum=2)
    b.load_state(ckpt.restore())
    ckpt.close()
    assert b.step == 3 and b.opt_state["mini_step"] == 1
    ma, mb = a.train_step(batches[1]), b.train_step(batches[1])
    assert float(ma["loss"]) == float(mb["loss"])
    for (name, pa), pb in zip(a.params.items(), b.params.values()):
        assert torch.equal(pa, pb), name


def test_interrupt_saves_checkpoint(jax_setup, tmp_path):
    trainer = _port_trainer(jax_setup, tmp_path)
    ckpt = tckpt.Checkpointer(str(tmp_path / "ckpt"))

    def batches():
        yield jax_setup[2][0]
        raise KeyboardInterrupt

    with pytest.raises(KeyboardInterrupt):
        trainer.train(batches(), num_steps=5, checkpointer=ckpt)
    assert ckpt.latest_step() == 1
    assert ckpt.restore()["opt_state"]["count"] == 1
    last = trainer.train(iter([jax_setup[2][1]]), num_steps=5)
    assert set(last) >= {"loss", "grad_norm", "lr", "tokens_per_sec", "mfu", "step_time_s"}


def test_profiler_window_writes_a_trace(jax_setup, tmp_path, monkeypatch):
    monkeypatch.setenv("ENABLE_TORCH_PROFILER", "1")
    trainer = _port_trainer(jax_setup, tmp_path, profile_start_step=0, profile_num_steps=1)
    trainer.train(iter(jax_setup[2]), num_steps=2)
    traces = list((tmp_path / "run" / "profile").glob("trace_*.json"))
    assert len(traces) == 1 and traces[0].stat().st_size > 0


def _index_collator(samples):
    return {"input_ids": np.array([[s["i"]] for s in samples], np.int32)}


@pytest.mark.parametrize("rank", [None, 1])
def test_data_loader_yields_jax_loader_batches(rank):
    data = [{"i": i} for i in range(11)]
    kw = dict(batch_size=4, shuffle=True, seed=3, num_epochs=2, num_workers=2)
    if rank is not None:
        kw.update(process_index=rank, process_count=2)
    else:
        kw.update(process_index=0, process_count=1)
    got = [b["input_ids"] for b in tdata.DataLoader(data, _index_collator, **kw)]
    want = [b["input_ids"] for b in jdata.DataLoader(data, _index_collator, **kw)]
    assert len(got) == len(want) == 4
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_data_loader_defaults_to_one_process():
    loader = tdata.DataLoader([{"i": i} for i in range(4)], _index_collator, batch_size=4)
    assert (loader.process_index, loader.process_count) == (0, 1)


@pytest.mark.parametrize("field", [dict(tp=2), dict(sp=2), dict(ep=2), dict(pp=2),
                                   dict(ring_attention=True), dict(dp=2), dict(fsdp=2),
                                   dict(attn_impl="xla")])
def test_unported_config_fields_raise(jax_setup, tmp_path, field):
    with pytest.raises(NotImplementedError):
        _port_trainer(jax_setup, tmp_path, **field)


def test_trainer_config_has_the_jax_fields():
    assert ({f.name for f in dataclasses.fields(tt.TrainerConfig)}
            == {f.name for f in dataclasses.fields(jt.TrainerConfig)})


def test_quantize_frozen_towers_matches_bf16_and_updates_projector(jax_setup, tmp_path):
    """The JAX test of the same name on the port: the frozen tower encodes
    through the fused int8 twin (built once, from the first batch), the loss
    tracks the float run, the projector learns and the master tower stays."""
    from multimeditron_torch.ops.vit_int8_fused import ViTInt8Fused

    batch = jax_setup[2][0]
    tq = _port_trainer(jax_setup, tmp_path, training_mode=Mode.ALIGNMENT,
                       quantize_frozen_towers=True)
    tb = _port_trainer(jax_setup, tmp_path, training_mode=Mode.ALIGNMENT)
    before = {n: p.detach().clone() for n, p in tq.params.items()}
    loss_q = float(tq.train_step(batch)["loss"])
    loss_b = float(tb.train_step(batch)["loss"])
    assert np.isfinite(loss_q)
    assert isinstance(tq._qmods["image"], ViTInt8Fused)
    assert tq.model.modalities["image"].embedder_q is tq._qmods["image"]
    assert abs(loss_q - loss_b) / max(loss_b, 1e-6) < 0.05
    for name, p in tq.params.items():
        if ".projector." in name:
            assert not torch.equal(p, before[name]), name  # the projector learned
        elif ".embedder." in name:
            assert torch.equal(p, before[name]), name  # the master tower is untouched
    qm = tq._qmods
    tq.train_step(batch)
    assert tq._qmods is qm  # the second step reuses the int8 tower


def test_quantize_frozen_towers_rejects_full_mode(jax_setup, tmp_path):
    trainer = _port_trainer(jax_setup, tmp_path, training_mode=Mode.FULL,
                            quantize_frozen_towers=True)
    with pytest.raises(ValueError, match="frozen"):
        trainer.train_step(jax_setup[2][0])


@pytest.mark.parametrize("mode", [Mode.ALIGNMENT, Mode.END2END])
def test_quantize_frozen_towers_first_loss_matches_jax(jax_setup, tmp_path, mode):
    jmodel, params, batches = jax_setup
    cfg_kw = dict(training_mode=mode, quantize_frozen_towers=True)
    jtrainer = jt.MultimodalTrainer(jm.MultimodalModel(tiny_mm_config()), params,
                                    _cfg(jt.TrainerConfig, tmp_path, **cfg_kw))
    ttrainer = _port_trainer(jax_setup, tmp_path, **cfg_kw)
    want = float(jtrainer.train_step(batches[0])["loss"])
    got = float(ttrainer.train_step(batches[0])["loss"])
    np.testing.assert_allclose(got, want, rtol=1e-3)

"""Faults planted under the timed path, for the checks' own tests: each
must turn ``correct`` false. ``control.py --fault`` reads them on the chip.

- ``altered_token``: every token the engine samples, plus one (a token
  altered where it is produced);
- ``unchanged_state``: the optimizer step returns the state unchanged;
- ``half_batch``: the forward drops the second half of the batch's rows and
  takes the loss's mean over the rest.
"""

from __future__ import annotations

import contextlib
import unittest.mock as mock


@contextlib.contextmanager
def altered_token():
    from multimeditron_torch.serve.engine import ServingEngine

    orig = ServingEngine._sample

    def sample(self, logits, *a, **k):
        return (orig(self, logits, *a, **k) + 1) % logits.shape[-1]
    with mock.patch.object(ServingEngine, "_sample", sample):
        yield


@contextlib.contextmanager
def unchanged_state():
    from multimeditron_torch.train.trainer import MultimodalTrainer

    with mock.patch.object(MultimodalTrainer, "_apply", lambda self, grads: None):
        yield


@contextlib.contextmanager
def half_batch():
    from multimeditron_torch.models.multimodal import MultimodalModel

    orig = MultimodalModel.forward

    def forward(self, batch, remat=False):
        h = batch["input_ids"].shape[0] // 2
        kept = {k: v[:h] for k, v in batch.items() if k != "mm_inputs"}
        pack = batch["mm_inputs"]["image"]
        bi = pack["batch_idx"]
        kept["mm_inputs"] = {"image": {"values": pack["values"], "token_pos": pack["token_pos"],
                                       "batch_idx": bi.masked_fill(bi >= h, h)}}
        return orig(self, kept, remat=remat)
    with mock.patch.object(MultimodalModel, "forward", forward):
        yield


FAULTS = {"altered_token": altered_token, "unchanged_state": unchanged_state,
          "half_batch": half_batch}

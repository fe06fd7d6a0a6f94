"""Faults planted in the timed path, to show that `correct` catches them
(the CPU tests) and to read the limits' upper readings on the card
(calibrate.py). Each takes `setattr(obj, name, value)`, which the caller
undoes afterwards (pytest's monkeypatch, or `Patches`)."""

from __future__ import annotations

import torch


class Patches:
    """setattr that remembers the old values; undo() restores them."""

    def __init__(self):
        self._old = []

    def setattr(self, obj, name, value):
        self._old.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    def undo(self):
        while self._old:
            obj, name, value = self._old.pop()
            setattr(obj, name, value)


def unchanged_state(setattr):
    """The train step runs, then puts every parameter back."""
    from diffusionnet_tpu_torch import training
    make = training.make_train_step

    def make_unchanged(loss_fn, optimizer):
        step = make(loss_fn, optimizer)

        def train_step(params, opt_state, batch, generator=None):
            before = {k: v.detach().clone() for k, v in params.items()}
            out = step(params, opt_state, batch, generator)
            with torch.no_grad():
                for k, v in params.items():
                    v.copy_(before[k])
            return out
        return train_step
    setattr(training, "make_train_step", make_unchanged)


def half_batch(setattr):
    """The loss over the first half of each batch, the mean over it."""
    from diffusionnet_tpu_torch import training
    loss = training.loss_and_counts

    def on_half(preds, batch, cfg):
        b = max(1, preds.shape[0] // 2)
        return loss(preds[:b], batch._replace(
            labels=batch.labels[:b], face_mask=batch.face_mask[:b]), cfg)
    setattr(training, "loss_and_counts", on_half)


def altered_training(setattr):
    """The predictions of each batch's first surface replaced by its
    second's (an answer from the wrong input)."""
    from diffusionnet_tpu_torch import training
    apply = training.apply_model

    def altered(*args, **kwargs):
        out = apply(*args, **kwargs)
        return torch.cat([out[1:2], out[1:]])
    setattr(training, "apply_model", altered)


def altered_serving(setattr):
    """One output's first two log-probabilities swapped."""
    from diffusionnet_tpu_torch.serving import export
    call = export.PreparedMesh.__call__

    def altered(self, x):
        out = call(self, x).clone()
        out[..., 0, [0, 1]] = out[..., 0, [1, 0]]
        return out
    setattr(export.PreparedMesh, "__call__", altered)


TRAINING = {"unchanged": unchanged_state, "half": half_batch,
            "altered": altered_training}
SERVING = {"altered": altered_serving}

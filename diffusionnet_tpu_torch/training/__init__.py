"""InferenceSession, and training: Adam with step decay, the model call
and the loss, checkpoints of the full train state, and `profiling` (the
port's spans and counters, and traces of the card). The epoch loop is
`experiments.exp_common.fit`.

Names load when first used (PEP 562), so that the kernel ops and serving
can record into `profiling` without loading the model stack."""

import importlib

_NAMES = {
    "inference": ("InferenceSession",),
    "fit": ("adam_state_from_flat", "adam_state_to_flat",
            "adam_with_step_decay", "make_eval_step", "make_train_step",
            "step_decay_schedule"),
    "task": ("TaskConfig", "apply_model", "loss_and_counts", "loss_sums"),
    "checkpoint": ("latest_checkpoint", "restore_checkpoint",
                   "save_checkpoint"),
    "profiling": ("device_trace",),
}
_HOME = {name: mod for mod, names in _NAMES.items() for name in names}

__all__ = [*_NAMES, *_HOME]


def __getattr__(name):
    if name in _NAMES:
        return importlib.import_module(f".{name}", __name__)
    if name in _HOME:
        return getattr(importlib.import_module(f".{_HOME[name]}", __name__),
                       name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

"""Inference session, and the training step: Adam with step decay, the
model call and the loss."""

from .inference import InferenceSession
from .fit import (adam_state_from_flat, adam_state_to_flat,
                  adam_with_step_decay, make_eval_step, make_train_step,
                  step_decay_schedule)
from .task import TaskConfig, apply_model, loss_and_counts

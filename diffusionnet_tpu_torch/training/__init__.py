"""InferenceSession, and training: Adam with step decay, the model call
and the loss, checkpoints of the full train state, timers. The epoch loop
is `experiments.exp_common.fit`."""

from .inference import InferenceSession
from .fit import (adam_state_from_flat, adam_state_to_flat,
                  adam_with_step_decay, make_eval_step, make_train_step,
                  step_decay_schedule)
from .task import TaskConfig, apply_model, loss_and_counts
from .checkpoint import (latest_checkpoint, restore_checkpoint,
                         save_checkpoint)
from .profiling import StageTimer, device_trace, slope_throughput

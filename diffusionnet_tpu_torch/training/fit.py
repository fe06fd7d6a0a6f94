"""Training-step primitives: the counterpart of
diffusionnet_tpu/training/fit.py.

The JAX package's step is a pure function of (params, opt_state, batch, rng)
built on optax. Here the train state is a dict of leaf tensors in the JAX
parameter layout (`models.flat_params(model, requires_grad=True)`), the
optimizer is torch.optim.Adam with a staircase LambdaLR, and the step keeps
the JAX signature but updates the parameters and the optimizer state in
place (it returns the same objects).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from .profiling import span


def step_decay_schedule(base_lr: float, decay_every_steps: int,
                        decay_rate: float = 0.5) -> Callable[[int], float]:
    """lr(step) = base_lr * decay_rate^floor(step / decay_every_steps): the
    reference's per-epoch decay as a schedule (optax.exponential_decay with
    staircase=True)."""
    if decay_every_steps <= 0:
        return lambda step: base_lr
    return lambda step: base_lr * decay_rate ** (step // decay_every_steps)


class AdamState(NamedTuple):
    """The optimizer state: torch's Adam over the train state's tensors (in
    `keys` order) and the scheduler that sets its lr before each update."""
    keys: tuple
    optimizer: torch.optim.Adam
    scheduler: torch.optim.lr_scheduler.LambdaLR


class Adam(NamedTuple):
    """Adam with a learning-rate schedule (optax.adam's defaults: b1 0.9,
    b2 0.999, eps 1e-8, the same update). `init(params)` gives its state."""
    base_lr: float
    schedule: Callable[[int], float]

    def init(self, params: dict) -> AdamState:
        keys = tuple(params)
        opt = torch.optim.Adam([params[k] for k in keys], lr=self.base_lr,
                               betas=(0.9, 0.999), eps=1e-8)
        # LambdaLR multiplies the base lr; update n (from 0) uses lr(n), as
        # optax's count does
        sched = torch.optim.lr_scheduler.LambdaLR(
            opt, lambda step: self.schedule(step) / self.base_lr)
        return AdamState(keys, opt, sched)


def adam_with_step_decay(base_lr: float = 1e-3, decay_every_steps: int = 0,
                         decay_rate: float = 0.5) -> Adam:
    """The reference's optimizer config (Adam + staircase decay)."""
    return Adam(base_lr, step_decay_schedule(base_lr, decay_every_steps,
                                             decay_rate))


def make_train_step(loss_fn: Callable, optimizer: Adam):
    """loss_fn(params, batch, generator) -> (loss, aux).

    Returns train_step(params, opt_state, batch, generator) ->
    (params, opt_state, loss, aux), the JAX package's signature. params and
    opt_state are updated in place and returned; loss is detached. A step
    records the span dnt.step, with dnt.step.forward, .backward and
    .optimizer inside it (`profiling`)."""

    def train_step(params, opt_state: AdamState, batch, generator=None):
        with span("dnt.step"):
            opt = opt_state.optimizer
            opt.zero_grad(set_to_none=True)
            with span("dnt.step.forward"):
                loss, aux = loss_fn(params, batch, generator)
            with span("dnt.step.backward"):
                loss.backward()
            with span("dnt.step.optimizer"):
                opt.step()
                opt_state.scheduler.step()
        return params, opt_state, loss.detach(), aux

    return train_step


def make_eval_step(metric_fn: Callable):
    """metric_fn(params, batch) -> metrics, run without autograd."""

    def eval_step(params, batch):
        with torch.no_grad():
            return metric_fn(params, batch)

    return eval_step


def adam_state_to_flat(opt_state: AdamState) -> dict[str, np.ndarray]:
    """The Adam state as numpy: 'count' (updates taken), and 'mu/<key>',
    'nu/<key>' per parameter key -- optax's ScaleByAdamState fields. A
    parameter not yet updated has zero moments."""
    opt = opt_state.optimizer
    params = opt.param_groups[0]["params"]
    flat, count = {}, 0
    for k, p in zip(opt_state.keys, params):
        st = opt.state.get(p, {})
        if st:
            count = int(st["step"])
        mu = st.get("exp_avg", torch.zeros_like(p))
        nu = st.get("exp_avg_sq", torch.zeros_like(p))
        flat["mu/" + k] = mu.detach().cpu().numpy().copy()
        flat["nu/" + k] = nu.detach().cpu().numpy().copy()
    flat["count"] = np.asarray(count, np.int32)
    return flat


def adam_state_from_flat(opt_state: AdamState, flat: dict) -> AdamState:
    """Loads `adam_state_to_flat`'s layout (e.g. from optax's state) into
    opt_state in place, and moves the schedule to the same count."""
    opt = opt_state.optimizer
    params = opt.param_groups[0]["params"]
    count = int(flat["count"])
    for k, p in zip(opt_state.keys, params):
        opt.state[p] = {
            "step": torch.tensor(float(count)),
            "exp_avg": torch.as_tensor(flat["mu/" + k]).to(p).clone(),
            "exp_avg_sq": torch.as_tensor(flat["nu/" + k]).to(p).clone()}
    sched = opt_state.scheduler
    sched.last_epoch = count
    for group, base, lam in zip(opt.param_groups, sched.base_lrs,
                                sched.lr_lambdas):
        group["lr"] = base * lam(count)
    sched._last_lr = [g["lr"] for g in opt.param_groups]
    return opt_state

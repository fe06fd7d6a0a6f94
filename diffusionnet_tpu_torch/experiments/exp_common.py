"""The experiment harness: the counterpart of experiments/exp_common.py.

`fit` is the epoch loop every experiment script and example trains
through: seeded shuffles, evaluation every `eval_every` epochs, JSON log
lines, checkpoints of the full train state at each best test accuracy and
at the end, an exact resume from them, a graceful stop on SIGTERM/SIGINT,
and an error on a non-finite loss. One step is `training.task`'s model
call and loss under `training.fit`'s Adam with step decay, on the block
kernels (use_megakernel) or the eager model.

A run's randomness comes from one torch.Generator on the CPU, seeded with
cfg.seed: the initial weights are drawn from it (when no params are
given), then each step draws one seed from it for the step's
own generator (on the CPU on the megakernel path, whose dropout seeds are
drawn on the host; on the training device otherwise), from which the
step's rotation uniforms and then its dropout are drawn
(`training.task.apply_model`). Epoch e shuffles with numpy
RandomState(cfg.seed + e), as the JAX package does. A checkpoint saves the
generator's state, so a resumed run draws what the uninterrupted one would
have drawn.
"""

from __future__ import annotations

import contextlib
import copy
import functools
import json
import math
import os
import signal
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..data import (DeviceDataset, FEATURE_DIMS, make_padded_batches,
                    prefetch_to_device)
from ..models import DiffusionNet, flat_params, to_flat_jax_params
from ..training import (TaskConfig, adam_with_step_decay, apply_model,
                        loss_and_counts, make_eval_step, make_train_step)
from ..training.checkpoint import (latest_checkpoint, load_train_state,
                                   nest, restore_checkpoint, save_checkpoint,
                                   train_state, unnest)
from ..utils import to_np
from .tools.convert_torch_checkpoint import load_reference_checkpoint

# the repository root of a checkout: the drivers' default data and
# pretrained_models directories are the JAX drivers' own, under
# <REPO>/experiments/<suite>/
REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))


class graceful_stop:
    """Context manager for preemption-safe loops: installs SIGTERM/SIGINT
    handlers that append to the returned list (truthy once a signal
    arrived), and always restores the prior dispositions on exit, also
    when the loop body raises. Off the main thread it installs nothing and
    the list stays empty."""

    def __enter__(self):
        self.stop_requested: list = []

        def _request_stop(signum, frame):
            self.stop_requested.append(signum)
            print(f"signal {signum}: checkpointing at the next boundary "
                  "and exiting")
        try:
            self._prev = {s: signal.signal(s, _request_stop)
                          for s in (signal.SIGTERM, signal.SIGINT)}
        except ValueError:  # not the main thread
            self._prev = {}
        return self.stop_requested

    def __exit__(self, *exc):
        for s, h in self._prev.items():
            signal.signal(s, h)
        return False


@dataclass
class FitConfig:
    """The JAX package's FitConfig, field for field."""
    n_epoch: int = 200
    lr: float = 1e-3
    decay_every: int = 50          # epochs (reference semantics)
    decay_rate: float = 0.5
    batch_size: int = 8
    input_features: str = "hks"    # 'xyz' or 'hks'
    augment_rotate: bool = False   # random SO(3) rotation of xyz features
    rotate_axis: str = "full"      # 'full' or 'y'
    label_smoothing: float = 0.0
    labels_kind: str = "global"    # 'global' | 'vertex' | 'face'
    buckets: tuple | None = None   # vertex buckets for mixed-size datasets
    data_parallel: bool = False    # several cards: ROADMAP item A.6
    mesh_shape: tuple | None = None  # (data, vert) sharding: ROADMAP A.6
    bf16: bool = False             # bf16 operands, f32 params and sums
    use_megakernel: bool = False   # blocks on kernels B1/B2
    device_data: bool = False      # the stacked dataset on the card once,
    # batches gathered there (it must fit beside the model and optimizer)
    graceful_sigterm: bool = False  # on SIGTERM/SIGINT: finish the epoch,
    # checkpoint the full train state and return; resume_from continues
    seed: int = 0


def build_model(n_class: int, c_width: int, outputs_at: str,
                dropout: bool, input_features: str, n_block: int = 4,
                bf16: bool = False) -> DiffusionNet:
    return DiffusionNet(
        c_in=FEATURE_DIMS[input_features], c_out=n_class, c_width=c_width,
        n_block=n_block, dropout=dropout, outputs_at=outputs_at,
        last_activation=functools.partial(torch.log_softmax, dim=-1),
        compute_dtype=torch.bfloat16 if bf16 else None)


# ---------------------------------------------------------------------------
# The drivers' shared pieces (experiments/<suite>/<driver>.py)
# ---------------------------------------------------------------------------

def suite_dir(suite: str) -> str:
    """<REPO>/experiments/<suite>: the JAX driver's directory, whose data/
    (laid out by its prepare_data.py) and pretrained_models/ the port's
    driver reads by default. An installed copy passes --data_dir and
    --load_model instead."""
    return os.path.join(REPO, "experiments", suite)


def add_device_arg(parser) -> None:
    parser.add_argument("--device", type=str, default="cuda",
                        help="where precompute, training and evaluation "
                             "run: 'cuda' (default; the kernels) or 'cpu' "
                             "(their plain versions)")


def driver_device(name: str) -> torch.device:
    """--device as a torch.device; 'cuda' without a visible card raises
    (a driver never goes on on the CPU by itself)."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"--device {name}: no CUDA card is visible to torch; pass "
            "--device cpu to run on the CPU")
    return device


def load_weights(path: str, model, device="cuda") -> dict:
    """Weights for `model` as JAX-layout flat tensors on `device`, the form
    fit's train state and `make_evaluate` take, from any of:

      * the reference's torch state_dict (.pth), converted in memory;
      * an .npz of the checkpoint converter (either package's);
      * a checkpoint of fit: a step_N.npz, or its <path>_ckpt directory
        (its latest step), also one the JAX package wrote.

    The keys and shapes must be the model's own (a functional-maps model's
    under `feature_extractor/`); otherwise ValueError names the
    difference."""
    want = {k: v.shape for k, v in to_flat_jax_params(model).items()}
    if os.path.isdir(path):
        ckpt = latest_checkpoint(path)
        if ckpt is None:
            raise FileNotFoundError(f"no checkpoint found under {path}")
        path = ckpt
    if path.endswith(".npz"):
        with np.load(path) as npz:
            is_state = any(k.startswith("[") for k in npz.files)
        if is_state:  # a train state, keyed by tree paths
            template = nest({k: np.zeros(s, np.float32)
                             for k, s in want.items()})
            flat = unnest(restore_checkpoint(path, template))
        else:
            flat = load_reference_checkpoint(path)
    else:
        flat = load_reference_checkpoint(
            path, fmaps=any(k.startswith("params/feature_extractor/")
                            for k in want))
    got = {k: np.shape(v) for k, v in flat.items()}
    if got != want:
        missing = sorted(set(want) - set(got))
        extra = sorted(set(got) - set(want))
        shapes = sorted(k for k in set(want) & set(got) if want[k] != got[k])
        raise ValueError(f"{path} does not fit the model: missing {missing}, "
                         f"extra {extra}, other shapes {shapes}")
    return {k: torch.tensor(np.asarray(v, np.float32), device=device)
            for k, v in flat.items()}


class Stopwatch:
    """Wall seconds of a driver's stages: `with sw("precompute"): ...`;
    `sw.seconds` maps each stage to its total."""

    def __init__(self):
        self.seconds: dict = {}

    @contextlib.contextmanager
    def __call__(self, stage: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if torch.cuda.is_initialized():
                torch.cuda.synchronize()
            self.seconds[stage] = (self.seconds.get(stage, 0.0)
                                   + time.perf_counter() - t0)


def task_config(cfg: FitConfig) -> TaskConfig:
    """The fields of cfg that one step reads."""
    return TaskConfig(input_features=cfg.input_features,
                      labels_kind=cfg.labels_kind,
                      label_smoothing=cfg.label_smoothing, bf16=cfg.bf16,
                      use_megakernel=cfg.use_megakernel,
                      augment_rotate=cfg.augment_rotate,
                      rotate_axis=cfg.rotate_axis)


def batch_source(cfg: FitConfig, device):
    """batches(ds, shuffle, seed=0): a dataset's padded batches on `device`,
    from host stacking and copies on a thread (prefetch_to_device), or with
    cfg.device_data from the stacked dataset uploaded once per dataset."""
    device = torch.device(device)
    device_sets: dict = {}

    def batches(ds, shuffle, seed=0):
        if cfg.device_data:
            if id(ds) not in device_sets:
                device_sets[id(ds)] = DeviceDataset(ds, cfg.buckets, device)
            return device_sets[id(ds)].batches(cfg.batch_size,
                                               shuffle=shuffle, seed=seed)
        return prefetch_to_device(
            make_padded_batches(ds, cfg.batch_size, shuffle=shuffle,
                                seed=seed, buckets=cfg.buckets),
            device=device)
    return batches


def make_evaluate(model, cfg: FitConfig, device="cuda", batches=None):
    """(evaluate, predict) of `model` under cfg (its route, features and
    labels), with no train state: evaluate(params, ds) is the accuracy on a
    dataset, predict(params, batch) the model's predictions on one batch.
    params: JAX-layout flat tensors on `device` (`load_weights`). batches:
    the batch source (default `batch_source(cfg, device)`)."""
    tcfg = task_config(cfg)
    batches = batches if batches is not None else batch_source(cfg, device)

    def predict(params, batch):
        with torch.no_grad():
            return apply_model(model, params, batch, None, tcfg,
                               deterministic=True)

    def metric_fn(params, batch):
        preds = apply_model(model, params, batch, None, tcfg,
                            deterministic=True)
        _, counts = loss_and_counts(preds, batch, tcfg)
        return counts, preds

    eval_step = make_eval_step(metric_fn)

    def evaluate(params, ds):
        correct = total = 0
        for batch in batches(ds, shuffle=False):
            (c, t), _ = eval_step(params, batch)
            correct += int(c)
            total += int(t)
        return correct / max(total, 1)
    return evaluate, predict


def fit(model, train_ds, test_ds, cfg: FitConfig,
        model_save_path: str | None = None,
        params=None, eval_every: int = 1,
        geodesic_eval=None, verbose: bool = True,
        log_path: str | None = None,
        resume_from: str | None = None, device="cuda"):
    """Train `model` on train_ds on `device`, evaluating on test_ds every
    `eval_every` epochs.

    params: initial weights as JAX-layout flat arrays or tensors (the keys
    of `models.flat_params`); None draws them from the run's generator.
    Returns (params, history, evaluate): the train state (JAX-layout flat
    tensors on `device`), [(epoch, train_acc, test_acc or None)], and
    `evaluate(params, ds)`, the accuracy on a dataset.
    geodesic_eval(params, predict): an optional metric called at each
    evaluated epoch, with predict(params, batch) the model's predictions;
    its value is printed and logged (the JAX package accepts this hook but
    never calls it).

    Checkpoints go under `<model_save_path>_ckpt/` and hold the full train
    state (params, Adam state, epoch, generator state), so
    `resume_from=<model_save_path>_ckpt` continues a stopped run exactly as
    the uninterrupted run would have gone on. A non-finite training loss
    raises FloatingPointError at once."""
    if cfg.data_parallel or cfg.mesh_shape is not None:
        raise NotImplementedError(
            "data_parallel and mesh_shape (training over several cards) come "
            "with ROADMAP item A.6; this fit trains on one card")
    device = torch.device(device)
    tcfg = task_config(cfg)
    if log_path is not None:
        os.makedirs(os.path.dirname(os.path.abspath(log_path)),
                    exist_ok=True)
    rng = torch.Generator().manual_seed(cfg.seed)
    if params is None:
        init = copy.deepcopy(model)
        init.reset_parameters(rng)
        params = flat_params(init, device, requires_grad=True)
    else:
        params = {k: torch.tensor(to_np(v), dtype=torch.float32,
                                  device=device).requires_grad_(True)
                  for k, v in params.items()}

    steps_per_epoch = max(1, -(-len(train_ds) // cfg.batch_size))
    decay_steps = cfg.decay_every * steps_per_epoch
    optimizer = adam_with_step_decay(cfg.lr, decay_steps, cfg.decay_rate)
    opt_state = optimizer.init(params)
    gen_device = torch.device("cpu") if cfg.use_megakernel else device

    def step_generator():
        seed = int(torch.randint(0, 2 ** 62, (), generator=rng))
        return torch.Generator(device=gen_device).manual_seed(seed)

    def loss_fn(params, batch, generator):
        preds = apply_model(model, params, batch, generator, tcfg,
                            deterministic=False)
        return loss_and_counts(preds, batch, tcfg)

    train_step = make_train_step(loss_fn, optimizer)
    _batches = batch_source(cfg, device)
    evaluate, predict = make_evaluate(model, cfg, device, _batches)

    # optax keeps a schedule count beside Adam's when the lr is a schedule
    scheduled = decay_steps != 0
    start_epoch = 0
    if resume_from is not None:
        path = latest_checkpoint(resume_from)
        if path is None:
            raise FileNotFoundError(f"no checkpoint found under {resume_from}")
        template = train_state(params, opt_state, 0, rng, scheduled)
        start_epoch = load_train_state(restore_checkpoint(path, template),
                                       params, opt_state, rng) + 1
        if verbose:
            print(f"resumed from {path} at epoch {start_epoch}")

    def save_state(epoch):
        # one directory per config: configs sharing a dataset directory
        # never overwrite each other's step files
        save_checkpoint(model_save_path + "_ckpt",
                        train_state(params, opt_state, epoch, rng, scheduled),
                        step=epoch)

    stack = contextlib.ExitStack()
    stop_requested = (stack.enter_context(graceful_stop())
                      if cfg.graceful_sigterm else [])

    history = []
    best_test_acc = -1.0
    with stack:
        for epoch in range(start_epoch, cfg.n_epoch):
            epoch_t0 = time.time()
            correct = total = 0
            last_loss = None
            for batch in _batches(train_ds, shuffle=True,
                                  seed=cfg.seed + epoch):
                params, opt_state, loss, (c, t) = train_step(
                    params, opt_state, batch, step_generator())
                correct += int(c)
                total += int(t)
                last_loss = float(loss)
                if not math.isfinite(last_loss):
                    raise FloatingPointError(
                        f"non-finite training loss at epoch {epoch}; inspect "
                        "the learning rate and the input data, or resume "
                        "from the last checkpoint")
            train_acc = correct / max(total, 1)

            test_acc = (evaluate(params, test_ds) if epoch % eval_every == 0
                        else None)
            geo = (geodesic_eval(params, predict)
                   if geodesic_eval is not None and test_acc is not None
                   else None)
            history.append((epoch, train_acc, test_acc))
            if verbose:
                ta = (f"{100 * test_acc:06.3f}%" if test_acc is not None
                      else "--")
                print(f"Epoch {epoch} - Train overall: {100 * train_acc:06.3f}%"
                      f"  Test overall: {ta}"
                      + (f"  geodesic_eval: {geo}" if geo is not None else ""))
            if log_path is not None:
                line = {
                    "epoch": epoch, "train_acc": train_acc,
                    "test_acc": test_acc, "train_loss": last_loss,
                    # the staircase factor this epoch's steps used
                    "lr": float(cfg.lr * cfg.decay_rate
                                ** (epoch // max(1, cfg.decay_every))),
                    "epoch_seconds": round(time.time() - epoch_t0, 3)}
                if geo is not None:
                    line["geodesic_eval"] = geo
                with open(log_path, "a") as f:
                    f.write(json.dumps(line) + "\n")
            if (model_save_path is not None and test_acc is not None
                    and test_acc > best_test_acc):
                best_test_acc = test_acc
                save_state(epoch)
            if stop_requested:
                if model_save_path is not None:
                    save_state(epoch)
                    print(f"preemption checkpoint written at epoch {epoch}; "
                          "resume with resume_from=")
                break

    if stop_requested:
        return params, history, evaluate

    if model_save_path is not None and cfg.n_epoch > 0:
        # the stored epoch is the last completed one (resume goes on at +1)
        save_state(cfg.n_epoch - 1)
        if verbose:
            print(" ==> saved model checkpoint near " + model_save_path)

    return params, history, evaluate

"""The port's training harness (`diffusionnet_tpu_torch.experiments.
exp_common.fit`) on the CPU: against the JAX package's `exp_common.fit`
from the same initial weights on both routes, its exact resume, the
SIGTERM stop, the non-finite guard, the log lines and hooks, and that it
learns. JAX runs at `highest` matmul precision with Pallas in interpret
mode; torch at "highest"; the port's kernels run as their plain
versions."""

import json
import os
import signal
import sys
import threading

import jax
import numpy as np
import pytest
import torch

import diffusionnet_tpu.data.dataset as jds_mod
from diffusionnet_tpu.serving.export import _flatten_params
import diffusionnet_tpu_torch.data.dataset as tds_mod
from diffusionnet_tpu_torch.experiments import exp_common as tex
from diffusionnet_tpu_torch.models import flat_params, from_flat_jax_params
from diffusionnet_tpu_torch.training.checkpoint import latest_checkpoint
from tests.meshgen import icosphere, torus
from tests.test_torch_train import _to_jax_ops

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                "experiments"))
import exp_common as jex  # noqa: E402

torch.set_float32_matmul_precision("highest")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread a test: where several test processes share the
    cores, each with a thread per core, the many short ops of these small
    models ran 50-100x slower than alone (the threads' barriers wait on
    each other's cores)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _meshes(n, seed=0):
    """n jittered small meshes (an icosphere or a torus by turns) and their
    classes."""
    rs = np.random.RandomState(seed)
    out = []
    for i in range(n):
        v, f = icosphere(1) if i % 2 == 0 else torus(8, 6)
        out.append((v * (1.0 + 0.05 * rs.randn(*v.shape)), f, i % 2))
    return out


@pytest.fixture(scope="module")
def paired():
    """Six meshes (batch 4 leaves a partial batch) in both packages'
    datasets, sharing one set of host-eigensolver operators (k 16)."""
    tds = tds_mod.SurfaceDataset(labels_kind="global")
    jds = jds_mod.SurfaceDataset(labels_kind="global")
    for v, f, c in _meshes(6):
        tds.add(v, f, c)
        jds.add(v, f, c)
    tds.precompute(k_eig=16, verbose=False, eigensolver="host")
    jds.ops_list = [_to_jax_ops(o) for o in tds.ops_list]
    return tds, jds


def _log(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


@pytest.mark.parametrize("use_megakernel", [False, True])
def test_fit_matches_jax_fit(paired, tmp_path, use_megakernel):
    """Two epochs from the same initial weights (JAX's init, loaded into the
    port through from_flat_jax_params), dropout and augmentation off: the
    per-epoch train loss within rtol 1e-4, train and test accuracies
    equal, the final weights within rtol 1e-4 and atol 1e-5 of each leaf's
    largest entry."""
    tds, jds = paired
    kw = dict(n_epoch=2, lr=1e-2, batch_size=4, input_features="hks",
              label_smoothing=0.2, labels_kind="global",
              use_megakernel=use_megakernel)
    arch = dict(n_class=2, c_width=8, outputs_at="global_mean",
                dropout=False, input_features="hks", n_block=2)
    jmodel = jex.build_model(**arch)
    first = jax.tree.map(jax.numpy.asarray,
                         next(jds_mod.make_padded_batches(jds, 4)))
    feats = jex.get_features("hks", first.verts, first.ops.evals,
                             first.ops.evecs)
    jparams = jmodel.init(jax.random.PRNGKey(5), feats, first.ops.mass,
                          evals=first.ops.evals, evecs=first.ops.evecs,
                          gradX=first.ops.gradX_spec,
                          gradY=first.ops.gradY_spec)
    flat = _flatten_params(jax.tree.map(np.asarray, jparams))
    jp, jhist, _ = jex.fit(jmodel, jds, jds, jex.FitConfig(**kw),
                           params=jparams, verbose=False,
                           log_path=str(tmp_path / "jax.jsonl"))

    model = tex.build_model(**arch)
    model.load_state_dict(from_flat_jax_params(flat))
    tp, thist, _ = tex.fit(model, tds, tds, tex.FitConfig(**kw),
                           params=flat_params(model), verbose=False,
                           log_path=str(tmp_path / "port.jsonl"),
                           device="cpu")
    assert [h[1:] for h in thist] == [h[1:] for h in jhist]
    jl, tl = _log(tmp_path / "jax.jsonl"), _log(tmp_path / "port.jsonl")
    assert len(jl) == len(tl) == 2
    for a, b in zip(tl, jl):
        np.testing.assert_allclose(a["train_loss"], b["train_loss"],
                                   rtol=1e-4)
        assert a["lr"] == b["lr"]
    want = _flatten_params(jax.tree.map(np.asarray, jp))
    assert set(want) == set(tp)
    for k, w in want.items():
        np.testing.assert_allclose(tp[k].detach().numpy(), w, rtol=1e-4,
                                   atol=1e-5 * max(np.abs(w).max(), 1e-30),
                                   err_msg=k)


@pytest.fixture(scope="module")
def port_ds():
    ds = tds_mod.SurfaceDataset(labels_kind="global")
    for v, f, c in _meshes(8, seed=1):
        ds.add(v * (1.0 + c), f, c)
    ds.precompute(k_eig=8, verbose=False, eigensolver="host")
    return ds


def _small_cfg(n_epoch, **kw):
    base = dict(n_epoch=n_epoch, lr=1e-2, batch_size=3, input_features="xyz",
                labels_kind="global")
    base.update(kw)
    return tex.FitConfig(**base)


def _small_model(dropout=False):
    return tex.build_model(n_class=2, c_width=8, outputs_at="global_mean",
                           dropout=dropout, input_features="xyz", n_block=2)


@pytest.mark.parametrize("use_megakernel", [False, True])
def test_fit_resume_bit_identical(port_ds, tmp_path, use_megakernel):
    """Dropout on and random rotations on: a run checkpointed after epoch 1
    and resumed to epoch 3 ends with the uninterrupted run's weights, bit
    for bit, and logs the same last epochs (the checkpoint holds the
    generator that draws the rotations and the dropout)."""
    model = _small_model(dropout=True)
    kw = dict(augment_rotate=True, use_megakernel=use_megakernel)
    p_full, h_full, _ = tex.fit(model, port_ds, port_ds,
                                _small_cfg(4, **kw), verbose=False,
                                device="cpu")
    ck = str(tmp_path / "run" / "model")
    tex.fit(model, port_ds, port_ds, _small_cfg(2, **kw),
            model_save_path=ck, verbose=False, device="cpu")
    p_res, h_res, _ = tex.fit(model, port_ds, port_ds, _small_cfg(4, **kw),
                              model_save_path=ck, resume_from=ck + "_ckpt",
                              verbose=False, device="cpu")
    assert h_res == h_full[2:]
    for k in p_full:
        assert torch.equal(p_full[k], p_res[k]), k


def test_fit_graceful_sigterm_checkpoints_and_resumes(port_ds, tmp_path):
    """graceful_sigterm: a SIGTERM mid-run finishes the epoch in flight,
    checkpoints the full train state and returns early; the prior handler
    is restored; the run resumes at the next epoch."""
    model = _small_model()
    ck = str(tmp_path / "run" / "model")

    def benign(*a):
        return None
    prior_handler = signal.signal(signal.SIGTERM, benign)
    done = threading.Event()

    def keep_signaling():
        while not done.wait(1.0):
            os.kill(os.getpid(), signal.SIGTERM)

    sender = threading.Thread(target=keep_signaling, daemon=True)
    sender.start()
    try:
        _, hist, _ = tex.fit(model, port_ds, port_ds,
                             _small_cfg(100000, graceful_sigterm=True),
                             model_save_path=ck, verbose=False, device="cpu")
        restored_to = signal.getsignal(signal.SIGTERM)
    finally:
        done.set()
        sender.join(timeout=10)
        signal.signal(signal.SIGTERM, prior_handler)
    assert not sender.is_alive()
    assert 0 < len(hist) < 100000, "SIGTERM did not stop the run early"
    assert latest_checkpoint(ck + "_ckpt") is not None
    assert restored_to is benign
    p_res, hist2, _ = tex.fit(model, port_ds, port_ds,
                              _small_cfg(len(hist) + 2, graceful_sigterm=True),
                              model_save_path=ck, resume_from=ck + "_ckpt",
                              verbose=False, device="cpu")
    assert all(torch.isfinite(v).all() for v in p_res.values())
    assert hist2[0][0] == len(hist)


def test_fit_raises_on_nonfinite_loss(port_ds):
    """A learning rate that overflows the weights (1e30: torch's Adam
    refuses a step size past the f32 range, which the JAX test's 1e38
    reaches) makes the loss non-finite, and fit raises at once."""
    with pytest.raises(FloatingPointError):
        tex.fit(_small_model(), port_ds, port_ds, _small_cfg(3, lr=1e30),
                verbose=False, device="cpu")


def test_fit_log_lines_hook_checkpoints_and_refusals(port_ds, tmp_path):
    """log_path gets one JSON line an epoch (test_acc None where the epoch
    is not evaluated), geodesic_eval runs at each evaluated epoch with a
    working predict, the best and the last epochs are checkpointed with
    the full train state, and data_parallel / mesh_shape are refused."""
    calls = []

    def hook(params, predict):
        batch = next(tds_mod.make_padded_batches(port_ds, 3)).to("cpu")
        calls.append(tuple(predict(params, batch).shape))
        return 0.5
    ck = str(tmp_path / "m")
    _, hist, evaluate = tex.fit(_small_model(), port_ds, port_ds,
                                _small_cfg(3), model_save_path=ck,
                                eval_every=2, geodesic_eval=hook,
                                verbose=False, device="cpu",
                                log_path=str(tmp_path / "log.jsonl"))
    lines = _log(tmp_path / "log.jsonl")
    assert [l["epoch"] for l in lines] == [0, 1, 2]
    assert lines[1]["test_acc"] is None and lines[0]["test_acc"] is not None
    assert [l.get("geodesic_eval") for l in lines] == [0.5, None, 0.5]
    assert calls == [(3, 2), (3, 2)]
    assert [h[2] is None for h in hist] == [False, True, False]
    names = sorted(os.listdir(ck + "_ckpt"))
    assert "step_2.npz" in names and names[0] == "step_0.npz"
    with np.load(os.path.join(ck + "_ckpt", "step_2.npz")) as z:
        assert int(z["['epoch']"]) == 2
        assert z["['rng']"].dtype == np.uint8
    for cfg in (_small_cfg(1, data_parallel=True),
                _small_cfg(1, mesh_shape=(1, 2))):
        with pytest.raises(NotImplementedError, match="A.6"):
            tex.fit(_small_model(), port_ds, port_ds, cfg, verbose=False,
                    device="cpu")


# --- learning, mirroring tests/test_e2e.py ----------------------------------

def _classification_sets(n_per_class=6, n_test=2, seed=0):
    """3 classes: sphere, torus, thin torus, with scale jitter (as
    tests/test_e2e.py builds them)."""
    rs = np.random.RandomState(seed)

    def sample(cls):
        if cls == 0:
            v, f = icosphere(subdivisions=2)
        elif cls == 1:
            v, f = torus(n_major=14, n_minor=10, r=0.35)
        else:
            v, f = torus(n_major=14, n_minor=10, r=0.15)
        return v * (1.0 + 0.05 * rs.randn(*v.shape)), f

    train = tds_mod.SurfaceDataset(labels_kind="global")
    test = tds_mod.SurfaceDataset(labels_kind="global")
    for cls in range(3):
        for _ in range(n_per_class):
            train.add(*sample(cls), cls)
        for _ in range(n_test):
            test.add(*sample(cls), cls)
    train.precompute(k_eig=16, verbose=False, eigensolver="host")
    test.precompute(k_eig=16, verbose=False, eigensolver="host")
    return train, test


@pytest.mark.parametrize("use_megakernel", [False, True])
def test_classification_learns(use_megakernel):
    """tests/test_e2e.py::test_classification_pipeline_learns on the port:
    HKS features, 12 epochs, train accuracy >= 0.9, test >= 0.8."""
    train_ds, test_ds = _classification_sets()
    cfg = tex.FitConfig(n_epoch=12, lr=1e-2, decay_every=50, batch_size=6,
                        input_features="hks", label_smoothing=0.2,
                        labels_kind="global", use_megakernel=use_megakernel)
    model = tex.build_model(n_class=3, c_width=16, outputs_at="global_mean",
                            dropout=False, input_features="hks", n_block=2)
    params, history, evaluate = tex.fit(model, train_ds, test_ds, cfg,
                                        verbose=False, device="cpu")
    assert history[-1][1] >= 0.9, history
    assert evaluate(params, test_ds) >= 0.8, history


@pytest.mark.parametrize("use_megakernel", [False, True])
def test_rotation_augmentation_path(use_megakernel):
    """tests/test_e2e.py::test_rotation_augmentation_path on the port: xyz
    features under random SO(3) rotations, 30 epochs, train accuracy >= 0.6
    (chance 1/3)."""
    train_ds, test_ds = _classification_sets(n_per_class=4, n_test=1)
    cfg = tex.FitConfig(n_epoch=30, lr=1e-2, batch_size=6,
                        input_features="xyz", augment_rotate=True,
                        labels_kind="global", use_megakernel=use_megakernel)
    model = tex.build_model(n_class=3, c_width=16, outputs_at="global_mean",
                            dropout=False, input_features="xyz", n_block=2)
    _, history, _ = tex.fit(model, train_ds, test_ds, cfg, verbose=False,
                            device="cpu")
    assert history[-1][1] >= 0.6, history

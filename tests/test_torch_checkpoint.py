"""The port's checkpoints against the JAX package's: the same npz keys for
the same train state, each package restoring the other's params, a
params-only template against a full-train-state file, relative paths; and
the port's timers (mirroring tests/test_training_utils.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusionnet_tpu.serving.export import _flatten_params, _unflatten_params
from diffusionnet_tpu.training import (
    adam_with_step_decay as jax_adam_with_step_decay)
from diffusionnet_tpu.training import checkpoint as jck
from diffusionnet_tpu_torch.training import (adam_state_to_flat,
                                             adam_with_step_decay,
                                             device_trace)
from diffusionnet_tpu_torch.training import checkpoint as tck
from tests.torch_threads import one_torch_thread  # noqa: F401


def _flat_params(seed=0):
    rs = np.random.RandomState(seed)
    return {"params/first_lin/kernel": rs.randn(3, 4).astype(np.float32),
            "params/first_lin/bias": rs.randn(4).astype(np.float32),
            "params/block_0/diffusion/diffusion_time":
                rs.rand(4).astype(np.float32),
            "params/block_0/mlp/dense_000/kernel":
                rs.randn(12, 4).astype(np.float32)}


def _port_state(flat, decay_every_steps, steps=2):
    """A port train state after `steps` Adam updates."""
    params = {k: torch.tensor(v, requires_grad=True) for k, v in flat.items()}
    opt = adam_with_step_decay(1e-3, decay_every_steps, 0.5)
    state = opt.init(params)
    for _ in range(steps):
        state.optimizer.zero_grad()
        sum((p ** 2).sum() for p in params.values()).backward()
        state.optimizer.step()
        state.scheduler.step()
    return params, state


@pytest.mark.parametrize("decay_every_steps", [10, 0])
def test_npz_keys_equal_jax_keys(tmp_path, decay_every_steps):
    """The port's file of {params, opt_state, epoch, rng} has the keys that
    the JAX package's `_path_keys` gives for the same {params, opt_state,
    epoch} (optax's state, with or without a schedule), plus `['rng']`."""
    flat = _flat_params()
    params, state = _port_state(flat, decay_every_steps)
    gen = torch.Generator().manual_seed(3)
    tree = tck.train_state(params, state, 4, gen,
                           scheduled=decay_every_steps != 0)
    path = tck.save_checkpoint(str(tmp_path), tree, step=4)
    jparams = _unflatten_params(flat)
    jopt = jax_adam_with_step_decay(1e-3, decay_every_steps, 0.5)
    jtree = {"params": jparams, "opt_state": jopt.init(jparams),
             "epoch": np.int32(4)}
    want = set(jck._path_keys(jtree)[0]) | {"['rng']"}
    with np.load(path) as z:
        assert set(z.files) == want
        assert int(z["['opt_state'][0].count"]) == 2
        np.testing.assert_array_equal(
            z["['opt_state'][0].mu['params']['first_lin']['kernel']"],
            adam_state_to_flat(state)["mu/params/first_lin/kernel"])


def test_jax_restores_port_params_and_port_restores_jax(tmp_path):
    """JAX restore_checkpoint(<port file>, <params template>) returns the
    port's params; the port restores the params of a file keyed by the JAX
    package's `_path_keys` (its npz layout) into a params-only template."""
    flat = _flat_params(1)
    params, state = _port_state(flat, 10)
    tree = tck.train_state(params, state, 1, torch.Generator())
    path = tck.save_checkpoint(str(tmp_path / "port"), tree, step=1)
    template = jax.tree.map(jnp.zeros_like, _unflatten_params(flat))
    got = _flatten_params(jax.tree.map(np.asarray,
                                       jck.restore_checkpoint(path, template)))
    assert set(got) == set(flat)
    for k in flat:
        np.testing.assert_array_equal(got[k], params[k].detach().numpy())

    jparams = _unflatten_params(flat)
    keys, leaves = jck._path_keys(
        {"params": jparams, "opt_state": jax_adam_with_step_decay(
            1e-3, 10, 0.5).init(jparams), "epoch": np.int32(0)})
    jpath = str(tmp_path / "step_0.npz")
    np.savez(jpath, **{k: np.asarray(v) for k, v in zip(keys, leaves)})
    back = tck.unnest(tck.restore_checkpoint(jpath, tck.nest(flat)))
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k])


def test_full_state_roundtrip_and_params_only_restore(tmp_path, monkeypatch):
    """A full train state restores into the live state (params, Adam moments
    and count, the schedule, the generator) from a relative path; a
    params-only template reads the same file; latest_checkpoint picks the
    highest step; a template the file lacks is refused."""
    flat = _flat_params(2)
    params, state = _port_state(flat, 1, steps=3)
    gen = torch.Generator().manual_seed(9)
    torch.rand(5, generator=gen)
    monkeypatch.chdir(tmp_path)
    tck.save_checkpoint("ck", tck.train_state(params, state, 2, gen), step=2)
    tck.save_checkpoint("ck", tck.train_state(params, state, 0, gen), step=0)
    path = tck.latest_checkpoint("ck")
    assert path == str(tmp_path / "ck" / "step_2.npz")
    assert tck.latest_checkpoint("missing") is None

    p2, s2 = _port_state(_flat_params(5), 1, steps=0)
    g2 = torch.Generator()
    template = tck.train_state(p2, s2, 0, g2)
    epoch = tck.load_train_state(tck.restore_checkpoint(
        "ck/step_2.npz", template), p2, s2, g2)
    assert epoch == 2
    for k in flat:
        assert torch.equal(p2[k], params[k])
    a, b = adam_state_to_flat(state), adam_state_to_flat(s2)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    assert (s2.optimizer.param_groups[0]["lr"]
            == state.optimizer.param_groups[0]["lr"])
    assert torch.equal(torch.rand(4, generator=g2), torch.rand(4, generator=gen))

    only = tck.restore_checkpoint(path, tck.nest(flat))
    np.testing.assert_array_equal(
        only["params"]["first_lin"]["kernel"],
        params["params/first_lin/kernel"].detach().numpy())
    with pytest.raises(ValueError, match="does not contain"):
        tck.restore_checkpoint(path, {"other": np.zeros(2)})


def test_device_trace_writes_a_trace(tmp_path):
    with device_trace(str(tmp_path / "tr")):
        torch.ones(8).sum()
    assert (tmp_path / "tr" / "trace.json").stat().st_size > 0

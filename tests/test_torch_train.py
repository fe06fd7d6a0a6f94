"""The training slice against the JAX package on the CPU: the fast path's
diffusion-time gradient (the straight-through clamp), the eager model's
gradients, one full train step with Adam, padded batching, the learning-rate
schedule and eager dropout. JAX runs at `highest` matmul precision with
Pallas in interpret mode; torch at "highest"."""

import functools
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffusionnet_tpu.data.dataset as jds_mod
import diffusionnet_tpu.geometry as jgeo
from diffusionnet_tpu.models import DiffusionNet as JaxDiffusionNet
from diffusionnet_tpu.models.fast_path import (
    megablock_apply as jax_megablock_apply)
from diffusionnet_tpu.ops.sparse import Ell as JaxEll
from diffusionnet_tpu.serving.export import _flatten_params, _unflatten_params
from diffusionnet_tpu.training import (
    adam_with_step_decay as jax_adam_with_step_decay,
    make_train_step as jax_make_train_step,
    step_decay_schedule as jax_step_decay_schedule)
import diffusionnet_tpu_torch.data.dataset as tds_mod
import diffusionnet_tpu_torch.geometry as tgeo
from diffusionnet_tpu_torch.models import (DiffusionNet, MiniMLP,
                                           megablock_apply, module_state)
from diffusionnet_tpu_torch.training import (
    TaskConfig, adam_state_from_flat, adam_state_to_flat,
    adam_with_step_decay, apply_model, loss_and_counts, make_train_step,
    step_decay_schedule)
from tests.meshgen import flat_grid, icosphere, torus

sys.path.insert(0, "experiments")
import exp_common  # noqa: E402
from tests.torch_threads import one_torch_thread  # noqa: F401

torch.set_float32_matmul_precision("highest")

K = 16


def _jax_params(model, x, mass, **kw):
    params = model.init(jax.random.PRNGKey(3), x, mass, **kw)
    return _flatten_params(jax.tree.map(np.asarray, params))


def _t(flat, grad=True):
    return {k: torch.from_numpy(np.array(v)).requires_grad_(grad)
            for k, v in flat.items()}


def _block_inputs(seed, B=1, V=256, C_in=16):
    rs = np.random.RandomState(seed)
    x = rs.randn(B, V, C_in).astype(np.float32)
    evecs, gX, gY = ((rs.randn(B, V, K) / np.sqrt(V)).astype(np.float32)
                     for _ in range(3))
    mass = rs.rand(B, V).astype(np.float32)
    for a in (evecs, gX, gY, mass):
        a[:, V - 30:] = 0
    evals = np.tile(np.linspace(0.0, 30.0, K, dtype=np.float32), (B, 1))
    return x, mass, evals, evecs, gX, gY


# --- the straight-through clamp of the fast path ----------------------------

def test_fast_path_diffusion_time_gradient_at_zero():
    """Every diffusion time is 0, as a fresh model has them. The gradient of
    a scalar loss through megablock_apply (plain kernels on the CPU) with
    respect to each diffusion time is nonzero and equals jax.grad of the JAX
    megablock_apply in interpret mode within rtol 1e-4. (A plain clamp at
    1e-8 gives 0 here: no time would ever train.)"""
    x, mass, evals, evecs, gX, gY = _block_inputs(0)
    jmodel = JaxDiffusionNet(c_in=16, c_out=4, c_width=8, n_block=2,
                             dropout=False)
    flat = _jax_params(jmodel, jnp.asarray(x[0]), jnp.asarray(mass[0]),
                       evals=jnp.asarray(evals[0]),
                       evecs=jnp.asarray(evecs[0]), gradX=jnp.asarray(gX[0]),
                       gradY=jnp.asarray(gY[0]))
    times = [k for k in flat if k.endswith("diffusion_time")]
    assert len(times) == 2 and all(not flat[k].any() for k in times)
    ct = np.random.RandomState(1).randn(1, 256, 4).astype(np.float32)
    ops = [jnp.asarray(a) for a in (x, mass, evals, evecs, gX, gY)]

    def jloss(p):
        out = jax_megablock_apply(_unflatten_params(p), *ops, n_block=2,
                                  tile_v=128, interpret=True)
        return jnp.sum(out * ct)
    want = jax.grad(jloss)({k: jnp.asarray(v) for k, v in flat.items()})

    params = _t(flat)
    out = megablock_apply(params, *map(torch.from_numpy,
                                       (x, mass, evals, evecs, gX, gY)),
                          n_block=2, tile_v=128)
    (out * torch.from_numpy(ct)).sum().backward()
    for k in times:
        got = params[k].grad.numpy()
        assert np.abs(got).min() > 0, k
        np.testing.assert_allclose(got, np.asarray(want[k]), rtol=1e-4,
                                   err_msg=k)


# --- (e) the eager model's gradients against jax.grad ----------------------

@pytest.fixture(scope="module")
def padded_meshes():
    """A sphere and an ellipsoid sharing one face list, padded to 256."""
    verts, faces = icosphere(2)
    out = []
    for scale in ((1.0, 1.0, 1.0), (1.0, 0.7, 1.3)):
        v = verts * np.asarray(scale)
        ops = tgeo.pad_operators(
            tgeo.compute_operators(v, faces, k_eig=K, eigensolver="host"),
            256)
        x = np.pad(v.astype(np.float32), ((0, 256 - v.shape[0]), (0, 0)))
        out.append(dict(x=x, mass=ops.mass, evals=ops.evals, evecs=ops.evecs,
                        gX=ops.gradX_spec, gY=ops.gradY_spec))
    e = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]])
    return out, faces, np.unique(np.sort(e, axis=1), axis=0)


@pytest.mark.parametrize("outputs_at,batched", [
    ("vertices", False), ("vertices", True), ("faces", True),
    ("global_mean", True), ("edges", False)])
def test_eager_gradients_match_jax_grad(padded_meshes, outputs_at, batched):
    """Every parameter's gradient, dropout off, padding rows of mass 0,
    within rtol 1e-4 (atol 1e-6 times the gradient's scale): f32 sums in
    other orders."""
    ms, faces, edges = padded_meshes
    ms = ms if batched else ms[:1]
    arr = {k: np.stack([m[k] for m in ms]) for k in ms[0]}
    if not batched:
        arr = {k: a[0] for k, a in arr.items()}
    inds = {"faces": faces, "edges": edges}.get(outputs_at)
    if inds is not None and batched:
        inds = np.stack([inds] * len(ms))
    arch = dict(c_in=3, c_out=5, c_width=8, n_block=2,
                mlp_hidden_dims=(16, 8), dropout=False, outputs_at=outputs_at)
    jmodel = JaxDiffusionNet(**arch, last_activation=jax.nn.log_softmax)
    kw = {outputs_at: jnp.asarray(inds)} if inds is not None else {}
    jargs = dict(evals=jnp.asarray(arr["evals"]),
                 evecs=jnp.asarray(arr["evecs"]), gradX=jnp.asarray(arr["gX"]),
                 gradY=jnp.asarray(arr["gY"]), **kw)
    flat = _jax_params(jmodel, jnp.asarray(arr["x"]), jnp.asarray(arr["mass"]),
                       **jargs)
    rs = np.random.RandomState(2)
    for k in flat:
        if k.endswith("diffusion_time"):
            flat[k] = (rs.rand(*flat[k].shape) * 0.05).astype(np.float32)
    out_shape = jax.eval_shape(
        lambda p: jmodel.apply(_unflatten_params(p), jnp.asarray(arr["x"]),
                               jnp.asarray(arr["mass"]), **jargs), flat).shape
    ct = rs.randn(*out_shape).astype(np.float32)

    def jloss(p):
        out = jmodel.apply(_unflatten_params(p), jnp.asarray(arr["x"]),
                           jnp.asarray(arr["mass"]), **jargs)
        return jnp.sum(out * ct)
    want = jax.grad(jloss)({k: jnp.asarray(v) for k, v in flat.items()})

    tmodel = DiffusionNet(**arch, last_activation=functools.partial(
        torch.log_softmax, dim=-1))
    params = _t(flat)
    t = {k: torch.from_numpy(a) for k, a in arr.items()}
    tkw = {outputs_at: torch.from_numpy(inds)} if inds is not None else {}
    out = torch.func.functional_call(
        tmodel, module_state(params), (t["x"], t["mass"]),
        dict(evals=t["evals"], evecs=t["evecs"], gradX=t["gX"],
             gradY=t["gY"], **tkw))
    (out * torch.from_numpy(ct)).sum().backward()
    for k in flat:
        w = np.asarray(want[k])
        np.testing.assert_allclose(params[k].grad.numpy(), w, rtol=1e-4,
                                   atol=1e-6 * max(np.abs(w).max(), 1.0),
                                   err_msg=k)


# --- (g) stack_operators and make_padded_batches ----------------------------

MESHES = [icosphere(1), torus(12, 8), icosphere(2), flat_grid(8)]


@pytest.fixture(scope="module")
def datasets():
    """The same four meshes with face labels in both packages' datasets,
    sharing one set of (host-eigensolver) operators."""
    tds = tds_mod.SurfaceDataset(labels_kind="face")
    jds = jds_mod.SurfaceDataset(labels_kind="face")
    for i, (v, f) in enumerate(MESHES):
        lab = (np.arange(f.shape[0]) * (i + 1)) % 4
        tds.add(v, f, lab)
        jds.add(v, f, lab)
    tds.precompute(k_eig=K, verbose=False, eigensolver="host")
    jds.ops_list = [_to_jax_ops(o) for o in tds.ops_list]
    return tds, jds


def _to_jax_ops(o):
    return jgeo.Operators(*(JaxEll(a.idx, a.val) if isinstance(a, tuple)
                            and not isinstance(a, np.ndarray) else a
                            for a in o))


def _assert_bundle_equal(t, j):
    for f in t._fields:
        a, b = getattr(t, f), getattr(j, f)
        if a is None:
            assert b is None, f
        elif f in ("L", "gradX", "gradY"):
            np.testing.assert_array_equal(a.idx, np.asarray(b.idx), err_msg=f)
            np.testing.assert_array_equal(a.val, np.asarray(b.val), err_msg=f)
        else:
            assert a.dtype == np.asarray(b).dtype, f
            np.testing.assert_array_equal(a, np.asarray(b), err_msg=f)


def test_stack_operators_bit_equal(datasets):
    tds, jds = datasets
    got = tgeo.stack_operators(tds.ops_list, v_pad=200, k_eig=12)
    want = jgeo.stack_operators(jds.ops_list, v_pad=200, k_eig=12)
    _assert_bundle_equal(got, want)
    _assert_bundle_equal(tgeo.stack_operators(tds.ops_list),
                         jgeo.stack_operators(jds.ops_list))


@pytest.mark.parametrize("buckets,shuffle", [(None, False),
                                             ((64, 128, 256), True)])
def test_make_padded_batches_bit_equal(datasets, buckets, shuffle):
    """Buckets, filler rows with labels -1 and face_mask False."""
    tds, jds = datasets
    got = list(tds_mod.make_padded_batches(tds, 3, shuffle=shuffle, seed=5,
                                           buckets=buckets))
    want = list(jds_mod.make_padded_batches(jds, 3, shuffle=shuffle, seed=5,
                                            buckets=buckets))
    assert len(got) == len(want) >= 2
    saw_filler = False
    for g, w in zip(got, want):
        for f in ("verts", "labels", "faces", "face_mask"):
            np.testing.assert_array_equal(getattr(g, f), getattr(w, f),
                                          err_msg=f)
        _assert_bundle_equal(g.ops, w.ops)
        saw_filler |= bool((g.labels == -1).all(axis=-1).any())
    assert saw_filler


# --- (f) one train step against the JAX step -------------------------------

def _step_against_jax(tb, jb, jmodel, model, use_megakernel,
                      through_adam=False):
    """One train step of the port (apply_model + loss_and_counts + Adam with
    step decay, dropout off) against the JAX step (exp_common._apply_model
    + _loss_and_counts + make_train_step), from one numpy train state
    (params and an Adam state at count 3, so the schedule has decayed once):
    loss, every gradient, the updated parameters and the Adam state within
    rtol 1e-4. through_adam: the updated parameters and moments may also
    differ by what the gradient's own tolerance becomes through Adam's
    update (first order, from the JAX state); at C = 256 an MLP kernel has
    2e5 entries, and where the state's nu is near 0 the update divides a
    gradient difference inside its tolerance by sqrt(nu)."""
    cfg = exp_common.FitConfig(labels_kind="face",
                               use_megakernel=use_megakernel,
                               input_features="hks")
    feats = jnp.zeros(jb.verts.shape[:-1] + (16,))
    gX, gY = jgeo.grad_operators(jb.ops)
    flat = _jax_params(jmodel, feats, jb.ops.mass, L=jb.ops.L,
                       evals=jb.ops.evals, evecs=jb.ops.evecs, gradX=gX,
                       gradY=gY, faces=jb.faces)
    rs = np.random.RandomState(4)
    for k in flat:
        if k.endswith("diffusion_time"):
            flat[k] = (rs.rand(*flat[k].shape) * 0.05).astype(np.float32)
    mu = {k: (rs.randn(*v.shape) * 1e-2).astype(np.float32)
          for k, v in flat.items()}
    nu = {k: (rs.rand(*v.shape) * 1e-4).astype(np.float32)
          for k, v in flat.items()}

    def loss_fn(params, batch, rng):
        preds = exp_common._apply_model(jmodel, params, batch, rng, cfg,
                                        deterministic=False)
        return exp_common._loss_and_counts(preds, batch, cfg)
    jopt = jax_adam_with_step_decay(1e-3, 2, 0.5)
    jparams = _unflatten_params(flat)
    adam, sched = jopt.init(jparams)
    count = jnp.asarray(3, jnp.int32)
    jstate = (adam._replace(count=count, mu=_unflatten_params(mu),
                            nu=_unflatten_params(nu)),
              sched._replace(count=count))
    (jloss, _), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(
        jparams, jb, jax.random.PRNGKey(0))
    jstep = jax_make_train_step(loss_fn, jopt, donate=False)
    jp2, js2, jloss2, (jc, jt) = jstep(jparams, jstate, jb,
                                       jax.random.PRNGKey(0))

    tcfg = TaskConfig(labels_kind="face", input_features="hks",
                      use_megakernel=use_megakernel)
    params = _t(flat)
    opt = adam_with_step_decay(1e-3, 2, 0.5)
    state = opt.init(params)
    adam_state_from_flat(state, {"count": np.int32(3),
                                 **{"mu/" + k: v for k, v in mu.items()},
                                 **{"nu/" + k: v for k, v in nu.items()}})
    assert state.optimizer.param_groups[0]["lr"] == pytest.approx(5e-4)

    def tloss_fn(p, batch, gen):
        preds = apply_model(model, p, batch, gen, tcfg, deterministic=False)
        return loss_and_counts(preds, batch, tcfg)
    step = make_train_step(tloss_fn, opt)
    p2, s2, loss, (c, t) = step(params, state, tb.to("cpu"),
                                torch.Generator().manual_seed(0))

    np.testing.assert_allclose(loss.item(), float(jloss2), rtol=1e-4)
    np.testing.assert_allclose(float(jloss), float(jloss2), rtol=1e-6)
    assert (int(c), int(t)) == (int(jc), int(jt))
    jg = _flatten_params(jax.tree.map(np.asarray, jgrads))
    jp = _flatten_params(jax.tree.map(np.asarray, jp2))
    back = adam_state_to_flat(s2)
    jmu = _flatten_params(jax.tree.map(np.asarray, js2[0].mu))
    jnu = _flatten_params(jax.tree.map(np.asarray, js2[0].nu))
    assert int(back["count"]) == int(js2[0].count) == 4
    for k in flat:
        g = params[k].grad.numpy()
        scale = max(np.abs(jg[k]).max(), 1e-3)
        np.testing.assert_allclose(g, jg[k], rtol=1e-4, atol=1e-6 * scale,
                                   err_msg="grad " + k)
        dp = dm = dv = 0.0
        if through_adam:
            dg = 1e-4 * np.abs(jg[k]) + 1e-6 * scale  # the gradient's bound
            b1, b2, lr = 0.9, 0.999, 5e-4               # count 3 -> 4
            m_hat = (b1 * mu[k] + (1 - b1) * jg[k]) / (1 - b1 ** 4)
            sv = np.sqrt((b2 * nu[k] + (1 - b2) * jg[k] ** 2) / (1 - b2 ** 4))
            dm = (1 - b1) * dg
            dv = 2 * (1 - b2) * np.abs(jg[k]) * dg
            dp = lr * (dm / (1 - b1 ** 4) / (sv + 1e-8)
                       + np.abs(m_hat) * dv / (1 - b2 ** 4)
                       / (2 * np.maximum(sv, 1e-30) * (sv + 1e-8) ** 2))
        for what, a, b, atol in (("param", p2[k].detach().numpy(), jp[k],
                                  1e-7 + dp),
                                 ("mu", back["mu/" + k], jmu[k], 1e-7 + dm),
                                 ("nu", back["nu/" + k], jnu[k], 1e-10 + dv)):
            assert a.shape == b.shape, f"{what} {k}"
            err = np.abs(a - b) - (atol + 1e-4 * np.abs(b))
            i = np.unravel_index(np.argmax(err), err.shape)
            assert err[i] <= 0, (f"{what} {k}{list(i)}: {a[i]} against "
                                 f"{b[i]}, allowed {(err[i] + np.abs(a - b)[i])}")


def _first_batches(datasets):
    tds, jds = datasets
    tb = next(tds_mod.make_padded_batches(tds, 2))
    jb = jax.tree.map(jnp.asarray, next(jds_mod.make_padded_batches(jds, 2)))
    return tb, jb


def _port_model(**kw):
    return DiffusionNet(c_in=16, c_out=4, c_width=8, n_block=2,
                        dropout=False, outputs_at="faces",
                        last_activation=functools.partial(torch.log_softmax,
                                                          dim=-1), **kw)


def test_train_step_matches_jax_step(datasets):
    """The megakernel path (B1/B2's plain versions, Pallas in interpret
    mode) against the JAX step."""
    tb, jb = _first_batches(datasets)
    jmodel = exp_common.build_model(n_class=4, c_width=8, outputs_at="faces",
                                    dropout=False, input_features="hks",
                                    n_block=2)
    _step_against_jax(tb, jb, jmodel, _port_model(), use_megakernel=True)


def test_train_step_matches_jax_step_at_c256(datasets):
    """The megakernel path at the sampling_invariance experiment's width
    (c_width 256, hidden [256, 256]: B1 and B2 at C = 256) against the JAX
    step, whose Pallas kernels run there in interpret mode."""
    tb, jb = _first_batches(datasets)
    jmodel = exp_common.build_model(n_class=4, c_width=256,
                                    outputs_at="faces", dropout=False,
                                    input_features="hks", n_block=2)
    model = DiffusionNet(c_in=16, c_out=4, c_width=256, n_block=2,
                         mlp_hidden_dims=[256, 256], dropout=False,
                         outputs_at="faces",
                         last_activation=functools.partial(torch.log_softmax,
                                                           dim=-1))
    _step_against_jax(tb, jb, jmodel, model, use_megakernel=True,
                      through_adam=True)


def test_train_step_matches_jax_step_at_c100(datasets):
    """The megakernel path of a model whose c_width is not a multiple of 8
    (c_width 100, the default hidden [100, 100]): B1 and B2 take C % 8 == 0,
    so the port pads C to 104 around their plain versions here, as around
    the kernels on the card, while the JAX step's Pallas kernels run at
    C = 100 in interpret mode. Loss, every gradient, the updated parameters
    and the Adam state against the JAX step."""
    tb, jb = _first_batches(datasets)
    jmodel = exp_common.build_model(n_class=4, c_width=100,
                                    outputs_at="faces", dropout=False,
                                    input_features="hks", n_block=2)
    model = DiffusionNet(c_in=16, c_out=4, c_width=100, n_block=2,
                         dropout=False, outputs_at="faces",
                         last_activation=functools.partial(torch.log_softmax,
                                                           dim=-1))
    _step_against_jax(tb, jb, jmodel, model, use_megakernel=True,
                      through_adam=True)


def test_fused_train_step_matches_jax_step(datasets):
    """A use_pallas_fused model through apply_model(use_megakernel=False):
    the eager model's blocks on kernel B4 (its plain version here, the
    Pallas op in interpret mode on the JAX side), one tile over the
    bucket."""
    tb, jb = _first_batches(datasets)
    V = tb.verts.shape[1]
    fused_kw = dict(use_pallas_fused=True, pallas_tile_v=V)
    jmodel = JaxDiffusionNet(c_in=16, c_out=4, c_width=8, n_block=2,
                             dropout=False, outputs_at="faces",
                             last_activation=jax.nn.log_softmax, **fused_kw)
    _step_against_jax(tb, jb, jmodel, _port_model(**fused_kw),
                      use_megakernel=False)


@pytest.mark.parametrize("method", ["spectral", "implicit_dense"])
def test_eager_step_on_ell_operators_matches_jax(datasets, method):
    """A batch whose bundle has no dense spectral operators: apply_model
    feeds the eager model the ELL gradients that grad_operators picks, and
    L (read by implicit_dense), as the JAX `_apply_model` does."""
    tb, jb = _first_batches(datasets)
    tb = tb._replace(ops=tb.ops._replace(gradX_spec=None, gradY_spec=None))
    jb = jb._replace(ops=jb.ops._replace(gradX_spec=None, gradY_spec=None))
    jmodel = JaxDiffusionNet(c_in=16, c_out=4, c_width=8, n_block=2,
                             dropout=False, outputs_at="faces",
                             last_activation=jax.nn.log_softmax,
                             diffusion_method=method)
    _step_against_jax(tb, jb, jmodel, _port_model(diffusion_method=method),
                      use_megakernel=False)


def test_train_step_with_dropout_moves_every_parameter(datasets):
    """Dropout on (the segmentation model's setting), megakernel path: a
    finite loss, and one step moves every parameter, diffusion times at 0
    included."""
    tds, _ = datasets
    tb = next(tds_mod.make_padded_batches(tds, 2)).to("cpu")
    model = DiffusionNet(c_in=16, c_out=4, c_width=8, n_block=2,
                         dropout=True, outputs_at="faces",
                         last_activation=functools.partial(torch.log_softmax,
                                                           dim=-1))
    from diffusionnet_tpu_torch.models import flat_params
    params = flat_params(model, requires_grad=True)
    before = {k: v.detach().clone() for k, v in params.items()}
    tcfg = TaskConfig(labels_kind="face")
    opt = adam_with_step_decay(1e-3)
    step = make_train_step(
        lambda p, b, g: loss_and_counts(
            apply_model(model, p, b, g, tcfg, deterministic=False), b, tcfg),
        opt)
    _, _, loss, _ = step(params, opt.init(params), tb,
                         torch.Generator().manual_seed(1))
    assert np.isfinite(loss.item())
    for k, v in params.items():
        assert not torch.equal(v.detach(), before[k]), k


def test_flat_params_do_not_alias_the_module():
    """The train state is a copy on every device: a step that updates it in
    place on the CPU leaves the module's weights (biases and diffusion times
    included, whose flat arrays are views) as they were."""
    from diffusionnet_tpu_torch.models import flat_params
    model = _port_model()
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}
    params = flat_params(model, "cpu", requires_grad=True)
    with torch.no_grad():
        for v in params.values():
            v.add_(1.0)
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k


# --- (h) the schedule, (i) eager dropout ------------------------------------

@pytest.mark.parametrize("decay_every", [1, 5])
def test_step_decay_schedule_matches_optax(decay_every):
    want = jax_step_decay_schedule(1e-3, decay_every, 0.5)
    got = step_decay_schedule(1e-3, decay_every, 0.5)
    for step in range(3 * decay_every + 1):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6)


def test_adam_first_update_uses_lr_at_step_zero():
    """Update n uses lr(n), as optax's count does: a single-parameter step
    from zero moments moves it by lr(0) * sign(grad)."""
    p = {"w": torch.zeros(3, requires_grad=True)}
    opt = adam_with_step_decay(1e-3, 1, 0.5)
    state = opt.init(p)
    step = make_train_step(lambda q, b, g: ((q["w"] * torch.tensor(
        [1.0, -2.0, 3.0])).sum(), None), opt)
    step(p, state, None)
    np.testing.assert_allclose(p["w"].detach().numpy(), [-1e-3, 1e-3, -1e-3],
                               rtol=1e-5)
    step(p, state, None)
    np.testing.assert_allclose(p["w"].detach().numpy(),
                               [-1.5e-3, 1.5e-3, -1.5e-3], rtol=1e-5)


def test_eager_dropout_keeps_half_and_scales_by_two():
    """Held to flax's Dropout(0.5) by its law: 50% +- 1% kept, scale 2, and
    nothing dropped in deterministic mode."""
    mlp = MiniMLP((4, 512, 512), dropout=True)
    mlp.to_empty(device="cpu")
    with torch.no_grad():
        mlp.layers[0].weight.zero_()
        mlp.layers[0].bias.fill_(1.0)       # hidden activations all 1
        mlp.layers[1].weight.copy_(torch.eye(512))
        mlp.layers[1].bias.zero_()
        x = torch.zeros(200, 4)
        out = mlp(x, deterministic=False,
                  generator=torch.Generator().manual_seed(0))
        assert set(torch.unique(out).tolist()) == {0.0, 2.0}
        kept = (out == 2.0).float().mean().item()
        assert abs(kept - 0.5) < 0.01
        assert torch.equal(mlp(x), torch.ones(200, 512))

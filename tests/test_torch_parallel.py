"""The port's parallel modules (diffusionnet_tpu_torch.parallel) against the
JAX package's on the CPU. The port runs one world of 4 ranks (spawned
processes over gloo, `parallel.launch`; tests/torch_parallel_workers.py)
once for the module; the JAX side runs here on 4 of the 8 virtual CPU
devices, with Pallas in interpret mode. Both at full f32 matmul precision,
on the same numpy inputs and weights.

Checked: the data-parallel step on data = 4 (loss, parameters and Adam's
moments after one step; the eval step's summed counts), the vertex-sharded
megakernel forward at vert = 2 and 4, the vertex-sharded eager forward on
its dense-spectral, ELL, face-output, global-mean and fused (B4 a shard)
routes, the gradients of the ELL and fused routes, the (data 2, vert 2)
step (loss, every gradient, parameters and Adam's moments) against JAX's
two-axis step and against one process's step on the whole batch, the
same step of a fused model against one process's and JAX's one-device
fused step, the dropout and rotation rule under
sharding, the mesh refusals, the multi-process dry run and the
host-parallel precompute."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from diffusionnet_tpu.data.dataset import PaddedBatch as JaxPaddedBatch
from diffusionnet_tpu.geometry import (compute_operators, grad_operators,
                                       pad_operators, stack_operators)
from diffusionnet_tpu.models import DiffusionNet as JaxDiffusionNet
from diffusionnet_tpu.models.fast_path import (
    megablock_apply as jax_megablock_apply)
from diffusionnet_tpu.parallel import make_mesh as jax_make_mesh
from diffusionnet_tpu.parallel.data_parallel import (
    make_dp_eval_step as jax_make_dp_eval_step,
    make_dp_train_step as jax_make_dp_train_step)
from diffusionnet_tpu.parallel.vertex_sharded import (
    batch_pspecs, make_two_axis_train_step as jax_two_axis_step,
    vertex_sharded_forward as jax_vertex_sharded_forward,
    vertex_sharded_megakernel_forward as jax_vs_megakernel_forward)
from diffusionnet_tpu.serving.export import _flatten_params, _unflatten_params
from diffusionnet_tpu_torch import geometry as tgeo
from diffusionnet_tpu_torch.models import megablock_apply
from diffusionnet_tpu_torch.parallel import launch, run_multiprocess_dryrun
from diffusionnet_tpu_torch.training import (adam_state_to_flat,
                                             apply_model, loss_and_counts,
                                             make_train_step)
from tests import torch_parallel_workers as W
from tests.meshgen import icosphere, torus
from tests.torch_threads import one_torch_thread  # noqa: F401

torch.set_float32_matmul_precision("highest")


def _flat(params):
    return _flatten_params(jax.tree.map(np.asarray, params))


def _jops(ops):
    return jax.tree.map(jnp.asarray, ops)


def _adam_state(d, prefix, opt, params, seed):
    """An optax Adam state at count 3 with random moments (so the step's
    update is not the first one's g / |g|, which turns a gradient's
    rounding near 0 into a whole step), also written to the npz for the
    port."""
    rs = np.random.RandomState(seed)
    flat = _flat(params)
    mu = {k: (rs.randn(*v.shape) * 1e-2).astype(np.float32)
          for k, v in flat.items()}
    nu = {k: (rs.rand(*v.shape) * 1e-4).astype(np.float32)
          for k, v in flat.items()}
    d[prefix + "count"] = np.asarray(3, np.int32)
    for k in flat:
        d[prefix + "mu/" + k], d[prefix + "nu/" + k] = mu[k], nu[k]
    adam, *rest = opt.init(params)
    return (adam._replace(count=jnp.asarray(3, jnp.int32),
                          mu=_unflatten_params(mu),
                          nu=_unflatten_params(nu)), *rest)


@pytest.fixture(scope="module")
def world(tmp_path_factory, cpu_devices):
    """Inputs and JAX weights, the port's 4-rank world, and the JAX
    results on the same inputs."""
    d, jax_out = {}, {}
    devs = cpu_devices[:4]

    # --- data parallelism: the JAX package's batch of 8 (k 8, v_pad 64)
    vs, fs = icosphere(subdivisions=1)
    vt, ft = torus(n_major=8, n_minor=6)
    ops8 = stack_operators([compute_operators(vs, fs, k_eig=8),
                            compute_operators(vt, ft, k_eig=8)] * 4,
                           v_pad=64)
    x8 = np.zeros((8, 64, 3), np.float32)
    x8[0::2, :42], x8[1::2, :48] = vs, vt
    y8 = np.array([0, 1] * 4, np.int32)
    W.save_ops(d, "dp/ops/", ops8)
    d["dp/x"], d["dp/labels"] = x8, y8
    jm = JaxDiffusionNet(c_in=3, c_out=2, c_width=8, n_block=1,
                         dropout=False, outputs_at="global_mean",
                         last_activation=jax.nn.log_softmax)
    j8 = _jops(ops8)
    params = jm.init(jax.random.PRNGKey(0), x8[:1], j8.mass[:1],
                     L=jax.tree.map(lambda t: t[:1], j8.L),
                     evals=j8.evals[:1], evecs=j8.evecs[:1],
                     gradX=jax.tree.map(lambda t: t[:1], j8.gradX),
                     gradY=jax.tree.map(lambda t: t[:1], j8.gradY))
    for k, v in _flat(params).items():
        d["dp/params/" + k] = v

    def fwd(p, batch):
        o, x, _ = batch
        return jm.apply(p, x, o.mass, L=o.L, evals=o.evals, evecs=o.evecs,
                        gradX=o.gradX, gradY=o.gradY)

    def loss_fn(p, batch, rng):
        return -jnp.mean(jnp.take_along_axis(fwd(p, batch),
                                             batch[2][:, None], axis=-1))
    mesh4 = jax_make_mesh(data=4, vert=1, devices=devs)
    opt = optax.adam(1e-2)
    batch = (j8, jnp.asarray(x8), jnp.asarray(y8))
    p1, s1, loss = jax_make_dp_train_step(loss_fn, opt, mesh4, donate=False)(
        params, _adam_state(d, "dp/adam0/", opt, params, 4), batch,
        jax.random.PRNGKey(1))
    jax_out["dp/loss"] = float(loss)
    jax_out["dp/params"] = _flat(p1)
    jax_out["dp/mu"], jax_out["dp/nu"] = _flat(s1[0].mu), _flat(s1[0].nu)
    m = jax_make_dp_eval_step(
        lambda p, b: {"correct": jnp.sum(jnp.argmax(fwd(p, b), -1) == b[2]),
                      "total": b[2].shape[0]}, mesh4)(p1, batch)
    jax_out["dp/counts"] = (int(m["correct"]), int(m["total"]))

    # --- the vertex-sharded megakernel forward: a torus of 224 vertices
    # padded to 256, so that every shard holds real vertices (a shard of
    # padding alone would hide a missing sum or its transpose)
    verts, faces = torus(n_major=16, n_minor=14)
    n = len(verts)
    ops = pad_operators(compute_operators(verts, faces, k_eig=16),
                        v_pad=256)
    x = np.pad(verts.astype(np.float32), ((0, 256 - n), (0, 0)))
    W.save_ops(d, "mf/ops/", ops)
    d["mf/x"] = x
    jm = JaxDiffusionNet(c_in=3, c_out=4, c_width=8, n_block=2,
                         dropout=False)
    jops = _jops(ops)
    gX, gY = grad_operators(ops)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), jops.mass,
                     evals=jops.evals, evecs=jops.evecs,
                     gradX=jnp.asarray(gX), gradY=jnp.asarray(gY))
    for k, v in _flat(params).items():
        d["mf/params/" + k] = v
    for vert in (4, 2):
        jax_out[f"mf/vert{vert}"] = np.asarray(jax_vs_megakernel_forward(
            params, jnp.asarray(x), jops,
            jax_make_mesh(data=1, vert=vert, devices=devs[:vert]),
            n_block=2, tile_v=64, interpret=True))

    # --- the vertex-sharded eager forward (the torus, v_pad 256)
    W.save_ops(d, "sf/ops/", ops)
    d["sf/x"], d["sf/faces"] = x, faces.astype(np.int64)
    d["sf/weights"] = np.random.RandomState(6).randn(256, 4).astype(
        np.float32)
    jops = _jops(ops)
    ell_ops = jops._replace(gradX_spec=None, gradY_spec=None)
    mesh = jax_make_mesh(data=1, vert=4, devices=devs)
    sf_params = {}
    for outputs_at, routes in (("vertices", (("dense", jops),
                                             ("ell", ell_ops))),
                               ("faces", (("faces", jops),)),
                               ("global_mean", (("ell_mean", ell_ops),)),
                               ("implicit", (("implicit", ell_ops),))):
        jm = JaxDiffusionNet(
            c_in=3, c_out=4, c_width=16, n_block=2, dropout=False,
            outputs_at="vertices" if outputs_at == "implicit" else outputs_at,
            diffusion_method=("implicit_dense" if outputs_at == "implicit"
                              else "spectral"))
        extra = ({"faces": jnp.asarray(faces)} if outputs_at == "faces"
                 else {})
        params = jm.init(jax.random.PRNGKey(1), jnp.asarray(x), jops.mass,
                         L=jops.L, evals=jops.evals, evecs=jops.evecs,
                         gradX=jops.gradX, gradY=jops.gradY, **extra)
        sf_params[outputs_at] = params
        for k, v in _flat(params).items():
            d[f"sf/{outputs_at}/params/" + k] = v
        for route, o in routes:
            jax_out["sf/" + route] = np.asarray(jax_vertex_sharded_forward(
                jm, params, jnp.asarray(x), o, mesh, **extra))
    # the fused model (B4, Pallas in interpret mode) with the vertex
    # outputs' weights: its sharded forward and jax.grad of sum(w * out)
    # through it
    jm = JaxDiffusionNet(c_in=3, c_out=4, c_width=16, n_block=2,
                         dropout=False, use_pallas_fused=True,
                         pallas_tile_v=64)
    weights = jnp.asarray(d["sf/weights"])

    def fused_out(p):
        return jax_vertex_sharded_forward(jm, p, jnp.asarray(x), jops, mesh)
    jax_out["sf/fused"] = np.asarray(fused_out(sf_params["vertices"]))
    jax_out["sf/fused_grad"] = _flat(jax.grad(
        lambda p: jnp.sum(weights * fused_out(p)))(sf_params["vertices"]))

    # --- the (data 2, vert 2) step (the torus, B 2, v_pad 256)
    B, v_pad = 2, 256
    ops = stack_operators([compute_operators(verts, faces, k_eig=16)] * B,
                          v_pad=v_pad)
    x = np.zeros((B, v_pad, 3), np.float32)
    x[:, :n] = verts
    labels = np.full((B, v_pad), -1, np.int32)
    labels[:, :n] = (verts[:, 2] > 0).astype(np.int32)
    W.save_ops(d, "ta/ops/", ops)
    d["ta/x"], d["ta/labels"] = x, labels
    jbatch = JaxPaddedBatch(verts=jnp.asarray(x), ops=_jops(ops),
                            labels=jnp.asarray(labels),
                            faces=jnp.zeros((B, 4, 3), jnp.int32),
                            face_mask=jnp.zeros((B, 4), bool))
    jm = JaxDiffusionNet(c_in=3, c_out=2, c_width=8, n_block=2,
                         dropout=False)
    gX, gY = grad_operators(ops)
    params = jm.init(jax.random.PRNGKey(0), jbatch.verts, jbatch.ops.mass,
                     evals=jbatch.ops.evals, evecs=jbatch.ops.evecs,
                     gradX=jnp.asarray(gX), gradY=jnp.asarray(gY))
    for k, v in _flat(params).items():
        d["ta/params/" + k] = v

    def sums(p, b, vert_axis=None):
        xr = None if vert_axis is None else (
            lambda h: jax.lax.psum(h, vert_axis))
        preds = jax.nn.log_softmax(jax_megablock_apply(
            p, b.verts, b.ops.mass, b.ops.evals, b.ops.evecs,
            b.ops.gradX_spec, b.ops.gradY_spec, n_block=2, tile_v=128,
            xhat_reduce=xr, interpret=True))
        valid = b.labels >= 0
        per = -jnp.take_along_axis(preds, jnp.maximum(b.labels, 0)[..., None],
                                   axis=-1)[..., 0]
        return (jnp.sum(per * valid),
                jnp.sum((jnp.argmax(preds, -1) == b.labels) & valid),
                jnp.sum(valid))

    def vs_loss(p, b, rng):
        S, C, N = sums(p, b, "vert")
        return S, N, (C, N)
    opt = optax.adam(1e-2)
    mesh22 = jax_make_mesh(data=2, vert=2, devices=devs)
    state0 = _adam_state(d, "ta/adam0/", opt, params, 5)
    p1, s1, loss, (c, t) = jax_two_axis_step(
        vs_loss, opt, mesh22, batch_pspecs(jbatch, "vertex"),
        donate=False)(params, state0, jbatch, jax.random.PRNGKey(1))
    jax_out["ta/loss"], jax_out["ta/counts"] = float(loss), (int(c), int(t))
    jax_out["ta/params"] = _flat(p1)
    jax_out["ta/mu"], jax_out["ta/nu"] = _flat(s1[0].mu), _flat(s1[0].nu)
    # the step's gradients, from Adam's first moment: mu = 0.9 mu0 + 0.1 g
    jax_out["ta/grads"] = {k: (m - 0.9 * d["ta/adam0/mu/" + k]) / 0.1
                           for k, m in jax_out["ta/mu"].items()}

    # the same step's model on the fused route (B4, Pallas in interpret
    # mode), one device, the whole batch: the masked mean NLL, from the
    # same Adam state
    jm = JaxDiffusionNet(c_in=3, c_out=2, c_width=8, n_block=2,
                         dropout=False, use_pallas_fused=True,
                         pallas_tile_v=64, last_activation=jax.nn.log_softmax)

    def fused_loss(p):
        o = jbatch.ops
        preds = jm.apply(p, jbatch.verts, o.mass, evals=o.evals,
                         evecs=o.evecs, gradX=o.gradX_spec,
                         gradY=o.gradY_spec)
        valid = jbatch.labels >= 0
        per = -jnp.take_along_axis(
            preds, jnp.maximum(jbatch.labels, 0)[..., None], axis=-1)[..., 0]
        return jnp.sum(per * valid) / jnp.sum(valid)
    loss, grads = jax.value_and_grad(fused_loss)(params)
    updates, s1 = opt.update(grads, state0, params)
    jax_out["taf/loss"], jax_out["taf/grads"] = float(loss), _flat(grads)
    jax_out["taf/params"] = _flat(optax.apply_updates(params, updates))
    jax_out["taf/mu"], jax_out["taf/nu"] = _flat(s1[0].mu), _flat(s1[0].nu)

    inputs = str(tmp_path_factory.mktemp("parallel") / "inputs.npz")
    np.savez(inputs, **d)
    ranks = launch(W.parallel_rank, 4, (inputs,),
                   workdir=str(tmp_path_factory.mktemp("ranks")),
                   timeout_s=400)
    return d, jax_out, ranks


def _close(got: dict, want: dict, rtol, scale_atol):
    """Every tensor of got within rtol and scale_atol times the largest
    entry of want."""
    assert set(got) == set(want)
    scale = max(float(np.abs(v).max()) for v in want.values())
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol,
                                   atol=scale_atol * scale, err_msg=k)


def _sub(rank: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in rank.items()
            if k.startswith(prefix)}


def test_dp_step_matches_jax_on_four_ranks(world):
    """From one Adam state at count 3: the loss within rtol 1e-5; the
    parameters and Adam's moments after one step within rtol 1e-4 (atol
    1e-6 of the largest entry); every rank the same bits."""
    _, jo, ranks = world
    for r in ranks:
        np.testing.assert_allclose(float(r["dp/loss"]), jo["dp/loss"],
                                   rtol=1e-5)
        _close(_sub(r, "dp/param/"), jo["dp/params"], 1e-4, 1e-6)
        adam = _sub(r, "dp/adam/")
        _close({k[3:]: v for k, v in adam.items() if k.startswith("mu/")},
               jo["dp/mu"], 1e-4, 1e-6)
        _close({k[3:]: v for k, v in adam.items() if k.startswith("nu/")},
               jo["dp/nu"], 1e-4, 1e-6)
        for k in _sub(r, "dp/param/"):
            np.testing.assert_array_equal(r["dp/param/" + k],
                                          ranks[0]["dp/param/" + k])


def test_dp_eval_step_sums_counts_over_ranks(world):
    _, jo, ranks = world
    for r in ranks:
        assert (int(r["dp/correct"]), int(r["dp/total"])) == jo["dp/counts"]
        assert int(r["dp/total"]) == 8


@pytest.mark.parametrize("vert", [2, 4])
def test_vertex_sharded_megakernel_forward(world, vert):
    """Each rank's rows (a (4 / vert, vert) mesh) assembled against JAX's
    sharded forward and the port's one-process megablock_apply (rtol 2e-4,
    atol 2e-5: JAX's own sharded-against-single bound)."""
    d, jo, ranks = world
    got = np.concatenate([ranks[r][f"mf/vert{vert}"] for r in range(vert)])
    np.testing.assert_allclose(got, jo[f"mf/vert{vert}"], rtol=2e-4,
                               atol=2e-5)
    o = W.load_ops(d, "mf/ops/")
    params = W.load_params(d, "mf/params/", grad=False)

    def b(a):
        return torch.from_numpy(np.asarray(a))[None]
    single = megablock_apply(params, b(d["mf/x"]), b(o.mass), b(o.evals),
                             b(o.evecs), b(o.gradX_spec), b(o.gradY_spec),
                             n_block=2, tile_v=64)[0].detach().numpy()
    np.testing.assert_allclose(got, single, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("route", ["dense", "ell", "faces", "ell_mean",
                                   "implicit", "fused"])
def test_vertex_sharded_forward_matches_jax(world, route):
    """vert = 4 against JAX's vertex_sharded_forward (rtol 1e-4, atol 1e-5
    of the largest output): vertex outputs assembled from the ranks' rows,
    face and global-mean outputs whole on every rank. "fused": a
    use_pallas_fused model, B4 on each rank's 64 rows (its plain version
    here) against JAX's fused model, Pallas in interpret mode."""
    _, jo, ranks = world
    want = jo["sf/" + route]
    atol = 1e-5 * float(np.abs(want).max())
    if route in ("dense", "ell", "implicit", "fused"):
        got = np.concatenate([r["sf/" + route] for r in ranks])
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=atol)
    else:
        for r in ranks:
            np.testing.assert_allclose(r["sf/" + route], want, rtol=1e-4,
                                       atol=atol)


def test_vertex_sharded_ell_route_gradients(world):
    """The gradient of sum(w * out) through the ELL route over 4 shards
    (each rank's rows; the all-gather of x transposes to a sum of the
    cotangents), summed over the ranks, against one process's autograd on
    the whole surface: within rtol 1e-4, atol 1e-6 of the largest."""
    from diffusionnet_tpu_torch.models import DiffusionNet
    d, _, ranks = world
    o = W.load_ops(d, "sf/ops/", spectral=False)
    params = W.load_params(d, "sf/vertices/params/")
    model = DiffusionNet(c_in=3, c_out=4, c_width=16, n_block=2,
                         dropout=False)
    t = {f: torch.from_numpy(np.asarray(getattr(o, f)))
         for f in ("mass", "evals", "evecs")}
    ell = [W.Ell(torch.from_numpy(e.idx), torch.from_numpy(e.val))
           for e in (o.gradX, o.gradY, o.L)]
    y = torch.func.functional_call(
        model, W.module_state(params),
        (torch.from_numpy(d["sf/x"]), t["mass"]),
        dict(evals=t["evals"], evecs=t["evecs"], gradX=ell[0], gradY=ell[1],
             L=ell[2]))
    (y * torch.from_numpy(d["sf/weights"])).sum().backward()
    want = {k: p.grad.numpy() for k, p in params.items()}
    for r in ranks:
        _close(_sub(r, "sf/ell_grad/"), want, 1e-4, 1e-6)


def _one_process_fused_grad(d):
    """The gradient of sum(w * out) through the fused model on the whole
    surface, one process."""
    from diffusionnet_tpu_torch.models import DiffusionNet
    o = W.load_ops(d, "sf/ops/")
    params = W.load_params(d, "sf/vertices/params/")
    model = DiffusionNet(c_in=3, c_out=4, c_width=16, n_block=2,
                         dropout=False, use_pallas_fused=True,
                         pallas_tile_v=64)
    t = {f: torch.from_numpy(np.asarray(getattr(o, f)))
         for f in ("mass", "evals", "evecs", "gradX_spec", "gradY_spec")}
    y = torch.func.functional_call(
        model, W.module_state(params),
        (torch.from_numpy(d["sf/x"]), t["mass"]),
        dict(evals=t["evals"], evecs=t["evecs"], gradX=t["gradX_spec"],
             gradY=t["gradY_spec"]))
    (y * torch.from_numpy(d["sf/weights"])).sum().backward()
    return {k: p.grad.numpy() for k, p in params.items()}


@pytest.mark.parametrize("against", ["jax", "one_process"])
def test_vertex_sharded_fused_route_gradients(world, against):
    """The gradient of sum(w * out) through the fused route over 4 shards
    (B4 on each rank's rows; x_hat's cotangent all-reduced, each rank's
    dcoefs from its own ds), summed over the ranks, against jax.grad
    through JAX's fused vertex_sharded_forward and against one process's
    autograd through the fused model on the whole surface: within rtol
    1e-4, atol 1e-6 of the largest."""
    d, jo, ranks = world
    want = (jo["sf/fused_grad"] if against == "jax"
            else _one_process_fused_grad(d))
    for r in ranks:
        _close(_sub(r, "sf/fused_grad/"), want, 1e-4, 1e-6)


def _single_step(d):
    """One process's step on the whole batch: the port's train step."""
    params = W.load_params(d, "ta/params/")
    adam, state = W.load_adam(d, "ta/adam0/", params, 1e-2)

    def loss_fn(p, b, gen):
        S, C, N = W.mega_sums(p, b, 2)
        return S / N.clamp(min=1), (C, N)
    _, _, loss, _ = make_train_step(loss_fn, adam)(
        params, state, W.padded_batch(d, "ta/").to("cpu"))
    return float(loss), params, adam_state_to_flat(state)


def test_two_axis_step_matches_jax_and_one_process(world):
    """(data 2, vert 2), each shard holding real vertices of the torus: the
    loss within rtol 1e-5 of JAX's two-axis step
    and of one process's step; every gradient (the partial x_hat's sum
    carries its cotangent back to each shard) within rtol 1e-4, atol 1e-6
    of the largest, against JAX's (from its Adam moment) and one process's
    autograd; the
    parameters and Adam's moments after one step from an Adam state at
    count 3 within rtol 1e-4, atol 1e-6 of the largest entry; every rank
    the same bits."""
    d, jo, ranks = world
    loss_sd, p_sd, adam_sd = _single_step(d)
    grads_sd = {k: p.grad.numpy() for k, p in p_sd.items()}
    p_sd = {k: p.detach().numpy() for k, p in p_sd.items()}
    for r in ranks:
        np.testing.assert_allclose(float(r["ta/loss"]), jo["ta/loss"],
                                   rtol=1e-5)
        np.testing.assert_allclose(float(r["ta/loss"]), loss_sd, rtol=1e-5)
        assert (int(r["ta/correct"]), int(r["ta/total"])) == jo["ta/counts"]
        assert int(r["ta/total"]) == 2 * 224
        _close(_sub(r, "ta/grad/"), jo["ta/grads"], 1e-4, 1e-6)
        _close(_sub(r, "ta/grad/"), grads_sd, 1e-4, 1e-6)
        _close(_sub(r, "ta/param/"), jo["ta/params"], 1e-4, 1e-6)
        _close(_sub(r, "ta/param/"), p_sd, 1e-4, 1e-6)
        adam = _sub(r, "ta/adam/")
        _close({k[3:]: v for k, v in adam.items() if k.startswith("mu/")},
               jo["ta/mu"], 1e-4, 1e-6)
        _close({k[3:]: v for k, v in adam.items() if k.startswith("nu/")},
               jo["ta/nu"], 1e-4, 1e-6)
        for k, v in _sub(r, "ta/param/").items():
            np.testing.assert_array_equal(v, ranks[0]["ta/param/" + k])


def _single_fused_step(d):
    """One process's step of the fused model on the whole batch (B4 at
    V = 256): the port's train step through apply_model."""
    params = W.load_params(d, "ta/params/")
    adam, state = W.load_adam(d, "ta/adam0/", params, 1e-2)
    model = W.fused_vertex_model()

    def loss_fn(p, b, gen):
        preds = apply_model(model, p, b, gen, W.FUSED_TASK, True)
        return loss_and_counts(preds, b, W.FUSED_TASK)
    _, _, loss, _ = make_train_step(loss_fn, adam)(
        params, state, W.padded_batch(d, "ta/").to("cpu"))
    return (float(loss), {k: p.grad.numpy() for k, p in params.items()},
            {k: p.detach().numpy() for k, p in params.items()},
            adam_state_to_flat(state))


@pytest.mark.parametrize("against", ["jax", "one_process"])
def test_two_axis_fused_step_matches_one_device(world, against):
    """(data 2, vert 2) of a use_pallas_fused model through apply_model (B4
    on each shard's 128 rows, every shard holding real vertices of the
    torus), against JAX's one-device step of the fused model on the whole
    batch (Pallas in interpret mode) and against the port's one-process
    step: the loss within rtol 1e-5; every gradient, the parameters and
    Adam's moments after one step from an Adam state at count 3 within
    rtol 1e-4, atol 1e-6 of the largest entry; every rank the same bits."""
    d, jo, ranks = world
    if against == "jax":
        want = (jo["taf/loss"], jo["taf/grads"], jo["taf/params"],
                jo["taf/mu"], jo["taf/nu"])
    else:
        loss, grads, params, adam = _single_fused_step(d)
        want = (loss, grads, params,
                {k[3:]: v for k, v in adam.items() if k.startswith("mu/")},
                {k[3:]: v for k, v in adam.items() if k.startswith("nu/")})
    for r in ranks:
        np.testing.assert_allclose(float(r["taf/loss"]), want[0], rtol=1e-5)
        assert int(r["taf/total"]) == 2 * 224
        _close(_sub(r, "taf/grad/"), want[1], 1e-4, 1e-6)
        _close(_sub(r, "taf/param/"), want[2], 1e-4, 1e-6)
        adam = _sub(r, "taf/adam/")
        _close({k[3:]: v for k, v in adam.items() if k.startswith("mu/")},
               want[3], 1e-4, 1e-6)
        _close({k[3:]: v for k, v in adam.items() if k.startswith("nu/")},
               want[4], 1e-4, 1e-6)
        for k, v in _sub(r, "taf/param/").items():
            np.testing.assert_array_equal(v, ranks[0]["taf/param/" + k])


def test_sharded_dropout_and_rotation_rule(world):
    """Ranks (data, vert) = (r // 2, r % 2): the two vert shards of one
    surface rotate it alike and draw different dropout seeds (and masks);
    the two data ranks draw different rotations and seeds."""
    ranks = world[2]
    u = [r["dr/uniforms"] for r in ranks]
    seeds = [r["dr/seeds"] for r in ranks]
    masks = [r["dr/mask"] for r in ranks]
    for dr in (0, 2):
        np.testing.assert_array_equal(u[dr], u[dr + 1])
        assert not set(seeds[dr]) & set(seeds[dr + 1])
        assert not np.array_equal(masks[dr], masks[dr + 1])
    assert not np.array_equal(u[0], u[2])
    assert not set(seeds[0]) & set(seeds[2])


def test_make_mesh_and_pod_mesh_refuse_bad_shapes(world):
    for r in world[2]:
        assert "!= n_devices = 4" in str(r["refuse/make_mesh"])
        assert "not divisible by vert=3" in str(r["refuse/pod_divisible"])
        assert "would span nodes" in str(r["refuse/pod_straddle"])


def test_two_process_dryrun(tmp_path):
    """The counterpart of tests/test_multihost.py: two processes, a
    data-parallel step with equal parameters in both, the (data 1, vert 2)
    step across the process boundary against one process's step (max error
    1e-3 of the largest parameter, JAX's bound), and the host-sharded
    precompute partitioning 4 meshes into one shared cache."""
    reports = run_multiprocess_dryrun(2, timeout_s=300,
                                      workdir=str(tmp_path))
    assert len(reports) == 2
    for r in reports:
        assert r["process_count"] == 2
        assert r["loss"] == reports[0]["loss"]
        assert r["all_cached_after_barrier"]
        assert r["two_axis/mesh_shape"] == [1, 2]
        assert r["two_axis/vs_single_max_rel_err"] <= 1e-3
    assert reports[0]["param_hash"] == reports[1]["param_hash"]
    assert reports[0]["two_axis/param_hash"] == \
        reports[1]["two_axis/param_hash"]
    assert sorted(i for r in reports for i in r["computed_indices"]) == \
        [0, 1, 2, 3]


def test_get_all_operators_parallel_keeps_order(tmp_path):
    """Three shapes, one already cached, over a pool of two spawned
    workers: in input order and equal to get_all_operators."""
    meshes = [icosphere(subdivisions=1), torus(n_major=8, n_minor=6),
              icosphere(subdivisions=2)]
    vl, fl = [m[0] for m in meshes], [m[1] for m in meshes]
    cache = str(tmp_path / "cache")
    tgeo.get_operators(vl[1], fl[1], k_eig=8, op_cache_dir=cache,
                       eigensolver="host", device="cpu")
    got = tgeo.get_all_operators_parallel(vl, fl, k_eig=8,
                                          op_cache_dir=cache, n_workers=2)
    want = tgeo.get_all_operators(vl, fl, k_eig=8, eigensolver="host",
                                  device="cpu", verbose=False)
    assert [o.mass.shape[0] for o in got] == [v.shape[0] for v in vl]
    for a, b in zip(got, want):
        for f in ("mass", "evals", "frames"):
            np.testing.assert_allclose(getattr(a, f), getattr(b, f),
                                       rtol=1e-5, atol=1e-6, err_msg=f)
        np.testing.assert_allclose(np.abs(a.evecs), np.abs(b.evecs),
                                   rtol=1e-4, atol=1e-5)

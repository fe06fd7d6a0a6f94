"""The port's vertex-sharded serving artifact (serving.export:
export_sharded_forward, load_sharded_serving_model, ShardedServingModel,
PreparedSurface) against the JAX package's sharded artifact on the CPU:
the counterparts of tests/test_serving.py::test_sharded_artifact_roundtrip
and ::test_sharded_artifact_global_mean.

The port exports in this process (no process group) and serves in one
world of 4 ranks (spawned processes over gloo, `parallel.launch`;
tests/torch_sharded_workers.py); JAX exports and serves on 4 of the 8
virtual CPU devices. The surface is icosphere(3), 642 vertices in a
768-vertex bucket, so every rank's 192 rows hold real vertices. The same
weights (JAX's init, carried over with from_flat_jax_params); outputs
within the JAX serving tests' tolerance (rtol 2e-5, atol 2e-6)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusionnet_tpu.geometry import compute_operators, stack_operators
from diffusionnet_tpu.models import DiffusionNet as JaxDiffusionNet
from diffusionnet_tpu.serving import (
    export_sharded_forward as jax_export_sharded,
    load_sharded_serving_model as jax_load_sharded)
from diffusionnet_tpu.serving.export import _flatten_params
from diffusionnet_tpu_torch.models import DiffusionNet, from_flat_jax_params
from diffusionnet_tpu_torch.parallel import launch
from diffusionnet_tpu_torch.serving import (export_forward,
                                            export_sharded_forward,
                                            load_serving_model)
from diffusionnet_tpu_torch.serving.export import (MANIFEST_NAME, host_reads,
                                                   kernel_ops)
from tests import torch_sharded_workers as W
from tests.meshgen import icosphere
from tests.torch_threads import one_torch_thread  # noqa: F401

torch.set_float32_matmul_precision("highest")

K = 16
V_BUCKET = 768
WORLD = 4
TILE_V = 64   # the fused model's B4 row tile: 192 rows a rank
TOL = dict(rtol=2e-5, atol=2e-6)  # the JAX serving tests' tolerance


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL)


@pytest.fixture(scope="module")
def world(tmp_path_factory, cpu_devices):
    """Artifacts of both packages, the JAX references, and the port's 4
    ranks serving each artifact."""
    d = tmp_path_factory.mktemp("serving_sharded")
    verts, faces = icosphere(subdivisions=3)
    ops = compute_operators(verts, faces, k_eig=K)
    sops = stack_operators([ops], v_pad=V_BUCKET)
    v = verts.shape[0]
    x = np.zeros((1, V_BUCKET, 3), np.float32)
    x[0, :v] = verts
    kw = dict(evals=jnp.asarray(sops.evals), evecs=jnp.asarray(sops.evecs),
              gradX=jnp.asarray(sops.gradX_spec),
              gradY=jnp.asarray(sops.gradY_spec))
    jax_mesh = jax.sharding.Mesh(np.array(cpu_devices[:WORLD]), ("vert",))
    res = dict(verts=verts, ops=ops, v=v, dirs={}, ref={}, jax_out={},
               models={})
    for name, outputs_at, c_out, fused in (
            ("vertices", "vertices", 5, False),
            ("global_mean", "global_mean", 6, False),
            ("fused", "vertices", 5, True)):
        arch = dict(c_in=3, c_out=c_out, c_width=16, n_block=2,
                    dropout=False, outputs_at=outputs_at)
        jmodel = JaxDiffusionNet(**arch)
        params = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x),
                             jnp.asarray(sops.mass), **kw)
        res["ref"][name] = np.asarray(jmodel.apply(
            params, jnp.asarray(x), jnp.asarray(sops.mass), **kw))[0]
        model = DiffusionNet(**arch, use_pallas_fused=fused,
                             pallas_tile_v=TILE_V)
        model.load_state_dict(from_flat_jax_params(_flatten_params(params)))
        res["models"][name] = model
        out_dir = str(d / name)
        export_sharded_forward(model, V_BUCKET, out_dir, K, n_devices=WORLD,
                               device="cpu")
        res["dirs"][name] = out_dir
        if not fused:
            jd = str(d / ("jax_" + name))
            jax_export_sharded(jmodel, params, v_bucket=V_BUCKET,
                               out_dir=jd, k_eig=K, mesh=jax_mesh)
            sm = jax_load_sharded(jd, devices=cpu_devices)
            res["jax_out"][name] = np.asarray(sm.call_operators(
                verts.astype(np.float32), ops))
    single = str(d / "single")
    export_forward(res["models"]["vertices"], v_buckets=(V_BUCKET,),
                   out_dir=single, k_eig=K, device="cpu")
    res["single_dir"] = single
    inputs = str(d / "inputs.npz")
    np.savez(inputs, x=verts.astype(np.float32), bucket=V_BUCKET,
             single_dir=single,
             **{"ops/" + f: np.asarray(getattr(ops, f), np.float32)
                for f in ("mass", "evals", "evecs", "gradX_spec",
                          "gradY_spec")})
    res["ranks"] = launch(W.serving_rank, WORLD,
                          (inputs, [f"{k}={p}" for k, p in
                                    res["dirs"].items()]),
                          workdir=str(d / "ranks"))
    return res


@pytest.mark.parametrize("name", ["vertices", "global_mean"])
def test_sharded_artifact_matches_jax_sharded_artifact(world, name):
    """load -> serve over 4 ranks: every rank returns the whole output,
    the JAX sharded artifact's and JAX model.apply's within tolerance."""
    v = world["v"]
    want = world["jax_out"][name]
    ref = world["ref"][name]
    if name == "vertices":
        ref = ref[:v]
        assert want.shape == (v, 5)
    else:
        assert want.shape == (6,)
    for r in world["ranks"]:
        for call in ("call", "wide_k", "prepared", "prepared_tensor"):
            assert r[f"{name}/{call}"].shape == want.shape
            _close(r[f"{name}/{call}"], want)
            _close(r[f"{name}/{call}"], ref)


def test_every_rank_returns_the_same_bits(world):
    r0 = world["ranks"][0]
    for r in world["ranks"][1:]:
        for k, a in r.items():
            if not k.startswith("refuse/"):
                assert a.tobytes() == r0[k].tobytes(), k


def test_fused_model_runs_b4_on_each_shard(world):
    """A use_pallas_fused model's program holds B4's ops (projection and
    apply a block) and the sums between them; served over 4 ranks it
    computes JAX's unfused function."""
    p = torch.export.load(os.path.join(world["dirs"]["fused"],
                                       f"sharded_{V_BUCKET}x{WORLD}.pt2"))
    assert kernel_ops(p) == {"spectral_project": 2, "spectral_apply": 2,
                             "vert_sum": 2}
    assert host_reads(p) == []
    plain = torch.export.load(os.path.join(
        world["dirs"]["vertices"], f"sharded_{V_BUCKET}x{WORLD}.pt2"))
    assert kernel_ops(plain) == {"vert_sum": 2}
    gm = torch.export.load(os.path.join(
        world["dirs"]["global_mean"], f"sharded_{V_BUCKET}x{WORLD}.pt2"))
    assert kernel_ops(gm) == {"vert_sum": 4}   # 2 blocks + num, den
    v = world["v"]
    for r in world["ranks"]:
        for call in ("call", "prepared"):
            _close(r[f"fused/{call}"], world["jax_out"]["vertices"])
            _close(r[f"fused/{call}"], world["ref"]["fused"][:v])


def test_loader_moves_a_program_traced_on_another_device(world):
    """The traced device is read from the program's inputs; a program
    traced on this device loads as it is (on another card its graph's
    device assertions would fail, so the loader moves it)."""
    from diffusionnet_tpu_torch.serving.export import (_load_program,
                                                       _traced_device)
    name = f"sharded_{V_BUCKET}x{WORLD}.pt2"
    p = _load_program(world["dirs"]["vertices"], name, torch.device("cpu"))
    assert _traced_device(p) == torch.device("cpu")
    meta = torch.device("meta")
    assert _traced_device(_load_program(world["dirs"]["vertices"], name,
                                        meta)) == meta


def test_loader_runs_a_program_traced_on_another_device(world, tmp_path,
                                                        monkeypatch):
    """A program traced on another device (the single-card artifact's,
    moved to meta and saved: it stands in for another card) fails its
    graph's device assertions where it is served unless the loader moves
    it; `_load_program` moves it, and it serves the bits of the program
    traced where it runs."""
    import shutil

    from torch.export.passes import move_to_device_pass

    from diffusionnet_tpu_torch.serving import export as E
    name = f"bucket_{V_BUCKET}.pt2"
    src = world["single_dir"]
    p = torch.export.load(os.path.join(src, name))
    torch.export.save(move_to_device_pass(p, torch.device("meta")),
                      str(tmp_path / name))
    for f in (MANIFEST_NAME, "params.npz"):
        shutil.copy(os.path.join(src, f), tmp_path / f)
    assert E._traced_device(torch.export.load(str(tmp_path / name))) == \
        torch.device("meta")
    ops = world["ops"]
    x = world["verts"].astype(np.float32)
    want = load_serving_model(src, device="cpu").call_operators(x, ops)
    got = load_serving_model(str(tmp_path), device="cpu").call_operators(
        x, ops)
    assert got.numpy().tobytes() == want.numpy().tobytes()
    monkeypatch.setattr(E, "_load_program", lambda d, n, dev:
                        torch.export.load(os.path.join(d, n)))
    with pytest.raises(RuntimeError, match="meta"):
        load_serving_model(str(tmp_path), device="cpu").call_operators(
            x, ops)


def test_manifest_and_params_match_jax(world, tmp_path):
    import json
    with open(os.path.join(world["dirs"]["vertices"], MANIFEST_NAME)) as f:
        m = json.load(f)
    assert {k: m[k] for k in ("kind", "c_in", "c_out", "k_eig",
                              "outputs_at", "v_bucket", "n_devices")} == {
        "kind": "sharded_forward", "c_in": 3, "c_out": 5, "k_eig": K,
        "outputs_at": "vertices", "v_bucket": V_BUCKET, "n_devices": WORLD}
    assert m["platforms"] == ["cpu"]
    with np.load(os.path.join(world["dirs"]["vertices"], "params.npz")) as z:
        keys = sorted(z.files)
    jd = os.path.dirname(world["dirs"]["vertices"])
    with np.load(os.path.join(jd, "jax_vertices", "params.npz")) as z:
        assert keys == sorted(z.files)


def test_guards_and_kind_dispatch(world):
    for r in world["ranks"]:
        assert "ONE surface" in str(r["refuse/one_surface"])
        assert "c_in" in str(r["refuse/c_in"])
        assert "bucket" in str(r["refuse/bucket"])
        assert "k_eig" in str(r["refuse/narrow_k"])
        assert "prepared" in str(r["refuse/prepared"])
        assert "load_serving_model" in str(r["refuse/kind"])
        assert "devices" in str(r["refuse/devices"])
    with pytest.raises(ValueError, match="sharded"):
        load_serving_model(world["dirs"]["vertices"], device="cpu")


def test_export_refusals(world, tmp_path):
    model = world["models"]["vertices"]
    with pytest.raises(ValueError, match="divisible"):
        export_sharded_forward(model, V_BUCKET + 2, str(tmp_path / "a"), K,
                               n_devices=WORLD, device="cpu")
    with pytest.raises(ValueError, match="pallas_tile_v"):
        export_sharded_forward(world["models"]["fused"], 384,
                               str(tmp_path / "b"), K, n_devices=WORLD,
                               device="cpu")
    with pytest.raises(ValueError, match="n_devices"):
        export_sharded_forward(model, V_BUCKET, str(tmp_path / "c"), K,
                               device="cpu")
    faces = DiffusionNet(c_in=3, c_out=2, c_width=8, n_block=1,
                         outputs_at="faces")
    with pytest.raises(ValueError, match="outputs_at"):
        export_sharded_forward(faces, V_BUCKET, str(tmp_path / "d"), K,
                               n_devices=WORLD, device="cpu")
    implicit = DiffusionNet(c_in=3, c_out=2, c_width=8, n_block=1,
                            diffusion_method="implicit_dense")
    with pytest.raises(ValueError, match="spectral"):
        export_sharded_forward(implicit, V_BUCKET, str(tmp_path / "e"), K,
                               n_devices=WORLD, device="cpu")
    for sub in "abcde":
        assert not os.path.exists(str(tmp_path / sub / MANIFEST_NAME))


def _block_inputs(seed, V, K=8, C=4):
    rs = np.random.RandomState(seed)
    x, evecs, gX, gY = (torch.from_numpy(rs.randn(1, V, n).astype(
        np.float32)) for n in (C, K, K, K))
    mass = torch.from_numpy(rs.rand(1, V).astype(np.float32))
    coefs = torch.from_numpy(rs.rand(1, K, C).astype(np.float32))
    return x, evecs, gX, gY, mass, coefs


class _ShardBlock(torch.nn.Module):
    """The fused block on one shard's rows with coefs a parameter, each
    projection summed by dnt_torch::vert_sum (TracedVert's sum)."""

    def __init__(self, coefs):
        super().__init__()
        self.coefs = torch.nn.Parameter(coefs)

    def forward(self, x, evecs, gX, gY, mass):
        from diffusionnet_tpu_torch.ops.collectives import TracedVert
        from diffusionnet_tpu_torch.ops.fused import (
            fused_spectral_block_sharded)
        return fused_spectral_block_sharded(x, evecs, gX, gY, mass,
                                            self.coefs,
                                            TracedVert(WORLD).sum, TILE_V)


def test_sharded_fused_block_traces_to_the_registered_ops(world):
    """Traced without autograd, as export_sharded_forward traces, the
    sharded block is the registered projection, vert_sum and apply, in
    that order, and nothing else (no autograd node), though x and coefs
    require grad; the fused artifact's program holds no autograd node
    either. Run eagerly, the block records its two autograd pieces only
    where autograd records: `reduce` receives a partial with no grad_fn
    under no_grad, and the projection's node otherwise."""
    from diffusionnet_tpu_torch.ops.fused import fused_spectral_block_sharded
    x, evecs, gX, gY, mass, coefs = _block_inputs(0, TILE_V)
    seen = []

    def reduce(t):
        seen.append(type(t.grad_fn).__name__)
        return t
    for grad in (False, True):
        with torch.set_grad_enabled(grad):
            outs = fused_spectral_block_sharded(
                x.requires_grad_(True), evecs, gX, gY, mass,
                coefs.requires_grad_(True), reduce, TILE_V)
        assert [type(o.grad_fn).__name__ for o in outs] == 3 * [
            "_SpectralApplyBackward" if grad else "NoneType"]
    assert seen == ["NoneType", "_SpectralProjectBackward"]
    x, coefs = x.detach(), coefs.detach()
    with torch.no_grad():
        p = torch.export.export(_ShardBlock(coefs), (
            x.requires_grad_(True), evecs, gX, gY, mass))
    calls = [str(n.target) for n in p.graph.nodes if n.op == "call_function"
             and "getitem" not in str(n.target)]
    assert calls == ["dnt_torch.spectral_project.default",
                     "dnt_torch.vert_sum.default",
                     "dnt_torch.spectral_apply.default"]
    art = torch.export.load(os.path.join(world["dirs"]["fused"],
                                         f"sharded_{V_BUCKET}x{WORLD}.pt2"))
    assert not [n for n in art.graph.nodes if n.op == "call_function"
                and "autograd" in str(n.target)]


def test_sharded_fused_block_with_a_plain_reduce(world):
    """Under no_grad, with x and coefs requiring grad, a `reduce` that is a
    plain function (no autograd, no process group: each shard's partial
    plus the other shards' partials) gives the whole surface's fused block
    on each of 4 shards of V = 256: within rtol 1e-5, atol 1e-6 of the
    largest entry, and no output requires grad."""
    from diffusionnet_tpu_torch.ops.fused import (
        fused_spectral_block_batched, fused_spectral_block_sharded,
        spectral_project)
    V = WORLD * TILE_V
    x, evecs, gX, gY, mass, coefs = _block_inputs(1, V)
    x.requires_grad_(True)
    coefs.requires_grad_(True)
    with torch.no_grad():
        want = fused_spectral_block_batched(x, evecs, gX, gY, mass, coefs,
                                            TILE_V)
        rows = [slice(r * TILE_V, (r + 1) * TILE_V) for r in range(WORLD)]
        parts = [spectral_project(x[:, s], evecs[:, s], mass[:, s])
                 for s in rows]
        got = []
        for r, s in enumerate(rows):
            others = sum(q for i, q in enumerate(parts) if i != r)
            got.append(fused_spectral_block_sharded(
                x[:, s].contiguous(), *(t[:, s].contiguous() for t in (
                    evecs, gX, gY, mass)), coefs,
                lambda t, o=others: t + o, TILE_V))
    for i, w in enumerate(want):
        g = torch.cat([o[i] for o in got], dim=1)
        assert not g.requires_grad
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5,
                                   atol=1e-6 * float(w.abs().max()))

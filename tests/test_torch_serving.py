"""The port's serving artifacts (diffusionnet_tpu_torch.serving) against the
JAX package's model and its own serving artifacts, on the CPU.

The same weights (the JAX init, carried over with from_flat_jax_params)
and the same operators (the JAX package's, numpy) go through JAX's
model.apply and through the port's exported programs; outputs within the
JAX serving tests' own tolerance (rtol 2e-5, atol 2e-6). The JAX tests of
the vertex-sharded artifact have no counterpart here: it comes with
ROADMAP item A.6. The hot path's no-sync test needs the card and lives in
tests/test_torch_cuda.py."""

import json
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusionnet_tpu.geometry import compute_operators, stack_operators
from diffusionnet_tpu.models import DiffusionNet as JaxDiffusionNet
from diffusionnet_tpu.serving import export_forward as jax_export_forward
from diffusionnet_tpu.serving import load_serving_model as jax_load
from diffusionnet_tpu.serving.export import _flatten_params
from diffusionnet_tpu_torch.models import DiffusionNet, from_flat_jax_params
from diffusionnet_tpu_torch.ops import fused
from diffusionnet_tpu_torch.serving import (export_forward,
                                            export_sharded_forward,
                                            load_serving_model,
                                            load_sharded_serving_model)
from diffusionnet_tpu_torch.serving.export import (MANIFEST_NAME, host_reads,
                                                   kernel_ops)
from tests.meshgen import icosphere

torch.set_float32_matmul_precision("highest")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K = 16
V_BUCKET = 256
TOL = dict(rtol=2e-5, atol=2e-6)  # the JAX serving tests' tolerance


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL)


def _setup(outputs_at="vertices", c_out=5, **model_kw):
    """icosphere(2) (162 vertices) padded to V_BUCKET, the JAX model's
    weights from its init, the port's model with the same weights, and
    JAX's model.apply on the padded batch as the reference."""
    verts, faces = icosphere(subdivisions=2)
    ops = compute_operators(verts, faces, k_eig=K)
    arch = dict(c_in=3, c_out=c_out, c_width=16, n_block=2, dropout=False,
                outputs_at=outputs_at, **model_kw)
    jmodel = JaxDiffusionNet(**arch)
    sops = stack_operators([ops], v_pad=V_BUCKET)
    x = np.zeros((1, V_BUCKET, 3), np.float32)
    x[0, :verts.shape[0]] = verts
    kw = dict(evals=jnp.asarray(sops.evals), evecs=jnp.asarray(sops.evecs),
              gradX=jnp.asarray(sops.gradX_spec),
              gradY=jnp.asarray(sops.gradY_spec))
    if outputs_at == "faces":
        kw["faces"] = jnp.asarray(faces, jnp.int32)[None]
    params = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x),
                         jnp.asarray(sops.mass), **kw)
    ref = np.asarray(jmodel.apply(params, jnp.asarray(x),
                                  jnp.asarray(sops.mass), **kw))
    model = DiffusionNet(**arch)
    model.load_state_dict(from_flat_jax_params(_flatten_params(params)))
    return dict(verts=verts, faces=faces, ops=ops, sops=sops, x=x, ref=ref,
                model=model, jmodel=jmodel, params=params)


@pytest.fixture(scope="module")
def vertex_artifact(tmp_path_factory):
    s = _setup()
    d = str(tmp_path_factory.mktemp("serving_artifact"))
    export_forward(s["model"], v_buckets=(V_BUCKET, 2 * V_BUCKET), out_dir=d,
                   k_eig=K)
    return dict(s, dir=d)


@pytest.fixture(scope="module")
def faces_artifact(tmp_path_factory):
    s = _setup(outputs_at="faces", c_out=4)
    d = str(tmp_path_factory.mktemp("faces_artifact"))
    export_forward(s["model"], v_buckets=(V_BUCKET,), out_dir=d, k_eig=K)
    return dict(s, dir=d)


def _load(a):
    return load_serving_model(a["dir"], device="cpu")


def test_roundtrip_parity_batched(vertex_artifact):
    a = vertex_artifact
    s = a["sops"]
    out = _load(a)(a["x"], s.mass, s.evals, s.evecs, s.gradX_spec,
                   s.gradY_spec)
    assert isinstance(out, torch.Tensor) and out.device.type == "cpu"
    _close(out, a["ref"])


def test_unbatched_unpadded_input_pads_to_bucket(vertex_artifact):
    a = vertex_artifact
    v, ops = a["verts"].shape[0], a["ops"]
    out = _load(a)(a["verts"].astype(np.float32), ops.mass, ops.evals,
                   ops.evecs, ops.gradX_spec, ops.gradY_spec)
    assert out.shape == (v, a["ref"].shape[-1])
    _close(out, a["ref"][0, :v])


@pytest.mark.parametrize("batch", [1, 3, 5])
def test_symbolic_batch_serves_any_batch_size(vertex_artifact, batch):
    """One program, traced at batch 2, serves batch 1, 3 and 5."""
    a = vertex_artifact
    s = a["sops"]
    rep = lambda arr: np.tile(np.asarray(arr),
                              (batch,) + (1,) * (np.ndim(arr) - 1))
    out = _load(a)(rep(a["x"]), rep(s.mass), rep(s.evals), rep(s.evecs),
                   rep(s.gradX_spec), rep(s.gradY_spec))
    assert out.shape[0] == batch
    for i in range(batch):
        _close(out[i], a["ref"][0])


def test_k_truncation_and_errors(vertex_artifact):
    a = vertex_artifact
    sm = _load(a)
    ops = a["ops"]
    v = a["verts"].shape[0]
    pad_k = lambda arr: np.pad(np.asarray(arr), [(0, 0)] * (arr.ndim - 1)
                               + [(0, 4)])
    # K wider than the artifact: exact truncation (the basis is ordered)
    out = sm(a["verts"].astype(np.float32), ops.mass, pad_k(ops.evals),
             pad_k(ops.evecs), pad_k(ops.gradX_spec), pad_k(ops.gradY_spec))
    _close(out, a["ref"][0, :v])
    with pytest.raises(ValueError, match="k_eig"):
        sm(a["verts"].astype(np.float32), ops.mass, ops.evals[:4],
           ops.evecs[:, :4], ops.gradX_spec[:, :4], ops.gradY_spec[:, :4])
    with pytest.raises(ValueError, match="c_in"):
        sm(np.zeros((v, 7), np.float32), ops.mass, ops.evals, ops.evecs,
           ops.gradX_spec, ops.gradY_spec)
    big = 3 * V_BUCKET
    with pytest.raises(ValueError, match="bucket"):
        sm(np.zeros((big, 3), np.float32), np.ones(big, np.float32),
           ops.evals, np.zeros((big, K), np.float32),
           np.zeros((big, K), np.float32), np.zeros((big, K), np.float32))


def test_manifest_contents(vertex_artifact):
    """The JAX manifest's keys, with the port's platform; one .pt2 a
    bucket; programs that hold no weights."""
    d = vertex_artifact["dir"]
    with open(os.path.join(d, "manifest.json")) as f:
        m = json.load(f)
    assert m["c_in"] == 3 and m["k_eig"] == K and m["c_out"] == 5
    assert m["v_buckets"] == [V_BUCKET, 2 * V_BUCKET]
    assert m["outputs_at"] == "vertices" and m["index_input"] is None
    assert m["platforms"] == ["cpu"] and m["kind"] == "forward"
    assert m["format_version"] == 1 and m["batch_symbolic"] is True
    assert sorted(os.listdir(d)) == ["bucket_256.pt2", "bucket_512.pt2",
                                     "manifest.json", "params.npz"]
    sm = _load(vertex_artifact)
    for ep in sm.programs.values():
        assert not ep.state_dict and not host_reads(ep)
    assert not sm.dense_operands  # broadcasts stay stride-0 views


def test_faces_output_artifact(faces_artifact):
    a = faces_artifact
    s, faces = a["sops"], a["faces"]
    sm = _load(a)
    with pytest.raises(ValueError, match="inds"):
        sm(a["x"], s.mass, s.evals, s.evecs, s.gradX_spec, s.gradY_spec)
    f_inds = np.asarray(faces, np.int32)[None]
    out = sm(a["x"], s.mass, s.evals, s.evecs, s.gradX_spec, s.gradY_spec,
             inds=f_inds)
    assert out.shape == (1, faces.shape[0], 4)
    _close(out, a["ref"])
    # symbolic element count: a face subset through the same program
    out_half = sm(a["x"], s.mass, s.evals, s.evecs, s.gradX_spec,
                  s.gradY_spec, inds=f_inds[:, ::2])
    _close(out_half, a["ref"][:, ::2])


def test_prepared_mesh_parity_and_guards(vertex_artifact):
    """prepare() puts the operators on the device once; handle(x) parity
    unbatched and batched (the batch broadcasts the resident operators)."""
    a = vertex_artifact
    sm = _load(a)
    ops, v = a["ops"], a["verts"].shape[0]
    h = sm.prepare(ops.mass, ops.evals, ops.evecs, ops.gradX_spec,
                   ops.gradY_spec)
    assert h.v == v and h.bucket == V_BUCKET
    x = a["verts"].astype(np.float32)
    _close(h(x), a["ref"][0, :v])
    out3 = h(np.tile(x, (3, 1, 1)))
    assert out3.shape == (3, v, a["ref"].shape[-1])
    for i in range(3):
        _close(out3[i], a["ref"][0, :v])
    h2 = sm.prepare_operators(ops)
    _close(h2(x), a["ref"][0, :v])
    pad_k = lambda arr: np.pad(np.asarray(arr), [(0, 0)] * (arr.ndim - 1)
                               + [(0, 4)])
    h3 = sm.prepare(ops.mass, pad_k(ops.evals), pad_k(ops.evecs),
                    pad_k(ops.gradX_spec), pad_k(ops.gradY_spec))
    _close(h3(x), a["ref"][0, :v])
    s = a["sops"]
    with pytest.raises(ValueError, match="UNBATCHED"):
        sm.prepare(s.mass, s.evals, s.evecs, s.gradX_spec, s.gradY_spec)
    with pytest.raises(ValueError, match="prepared for V"):
        h(np.zeros((v + 1, 3), np.float32))
    with pytest.raises(ValueError, match="c_in"):
        h(np.zeros((v, 7), np.float32))
    with pytest.raises(ValueError, match="no index input"):
        sm.prepare(ops.mass, ops.evals, ops.evecs, ops.gradX_spec,
                   ops.gradY_spec, inds=np.zeros((4, 3), np.int32))


def test_prepared_mesh_faces_artifact(faces_artifact):
    """prepare() with an index-input artifact: the faces stay in the
    handle; requests stream x only."""
    a = faces_artifact
    ops, verts, faces = a["ops"], a["verts"], a["faces"]
    sm = _load(a)
    with pytest.raises(ValueError, match="inds"):
        sm.prepare(ops.mass, ops.evals, ops.evecs, ops.gradX_spec,
                   ops.gradY_spec)
    h = sm.prepare(ops.mass, ops.evals, ops.evecs, ops.gradX_spec,
                   ops.gradY_spec, inds=faces)
    _close(h(verts.astype(np.float32)), a["ref"][0])
    out2 = h(np.tile(verts.astype(np.float32), (2, 1, 1)))
    for i in range(2):
        _close(out2[i], a["ref"][0])


def test_call_operators_convenience(vertex_artifact):
    a = vertex_artifact
    v = a["verts"].shape[0]
    out = _load(a).call_operators(a["verts"].astype(np.float32), a["ops"])
    _close(out, a["ref"][0, :v])


def test_fused_artifact_matches_jax_fused_export(tmp_path):
    """A use_pallas_fused model (pallas_tile_v 128): the port's program
    holds B4's two registered ops once a block and no host read, and
    serves what JAX's export of the same model (the Pallas kernel in
    interpret mode) serves, through __call__ and a PreparedMesh."""
    s = _setup(use_pallas_fused=True, pallas_tile_v=128)
    d, jd = str(tmp_path / "port"), str(tmp_path / "jax")
    export_forward(s["model"], v_buckets=(V_BUCKET,), out_dir=d, k_eig=K)
    jax_export_forward(s["jmodel"], s["params"], v_buckets=(V_BUCKET,),
                       out_dir=jd, k_eig=K, platforms=("cpu",))
    sm = load_serving_model(d, device="cpu")
    ep = sm.programs[V_BUCKET]
    assert kernel_ops(ep) == {"spectral_project": 2, "spectral_apply": 2}
    assert host_reads(ep) == []
    assert sm.dense_operands
    ops, v = s["ops"], s["verts"].shape[0]
    x = s["verts"].astype(np.float32)
    want = np.asarray(jax_load(jd).call_operators(x, ops))
    _close(want, s["ref"][0, :v])
    fused.reset_launches()
    _close(sm.call_operators(x, ops), want)
    h = sm.prepare_operators(ops)
    _close(h(x), want)
    out3 = h(np.tile(x, (3, 1, 1)))
    for i in range(3):
        _close(out3[i], want)
    assert fused.LAUNCHES == {"spectral_project": 0, "spectral_apply": 0,
                              "spectral_ds": 0}


def test_fused_handle_keeps_one_dense_copy(tmp_path):
    """A PreparedMesh of a fused program materializes its operators for a
    batch B > 1 (the kernels read dense operands) and keeps only the copy
    of the last such B; each batch size still serves the eager model's
    output (the same weights, use_pallas_fused=False)."""
    s = _setup(use_pallas_fused=True, pallas_tile_v=128)
    d = str(tmp_path / "fused")
    export_forward(s["model"], v_buckets=(V_BUCKET,), out_dir=d, k_eig=K)
    sm = load_serving_model(d, device="cpu")
    eager = DiffusionNet(c_in=3, c_out=5, c_width=16, n_block=2,
                         dropout=False)
    eager.load_state_dict(s["model"].state_dict())
    ops, v = s["ops"], s["verts"].shape[0]
    x = s["verts"].astype(np.float32)
    with torch.no_grad():
        want = eager(*(torch.from_numpy(np.asarray(a))[None] for a in (
            x, ops.mass, ops.evals, ops.evecs, ops.gradX_spec,
            ops.gradY_spec)))[0]
    h = sm.prepare_operators(ops)
    for b, kept in ((1, [1]), (3, [1, 3]), (2, [1, 2]), (1, [1, 2]),
                    (4, [1, 4])):
        out = h(np.tile(x, (b, 1, 1)))
        for i in range(b):
            _close(out[i], want)
        assert sorted(h._cache) == kept
        dense = [a for k, c in h._cache.items() if k > 1 for a in c]
        assert all(a.is_contiguous() and a.stride(0) > 0 for a in dense)


def test_params_npz_matches_jax_export(vertex_artifact, tmp_path):
    """The JAX package's export and the port's, of the same weights, write
    params.npz with the same '/'-joined keys and equal arrays."""
    a = vertex_artifact
    jd = str(tmp_path / "jax")
    jax_export_forward(a["jmodel"], a["params"], v_buckets=(V_BUCKET,),
                       out_dir=jd, k_eig=K, platforms=("cpu",))
    mine = np.load(os.path.join(a["dir"], "params.npz"))
    theirs = np.load(os.path.join(jd, "params.npz"))
    assert sorted(mine.files) == sorted(theirs.files)
    for k in theirs.files:
        np.testing.assert_array_equal(mine[k], theirs[k])


def _op_inputs(rs, B=2, V=40, K=8, C=4):
    r = lambda *s: torch.from_numpy(rs.randn(*s).astype(np.float32))
    return dict(x=r(B, V, C), evecs=r(B, V, K), gX=r(B, V, K), gY=r(B, V, K),
                mass=torch.from_numpy(rs.rand(B, V).astype(np.float32)),
                coefs=torch.from_numpy(rs.rand(B, K, C).astype(np.float32)),
                x_hat=r(B, K, C), dy=r(B, V, C))


@pytest.mark.parametrize("op", ["spectral_project", "spectral_apply",
                                "spectral_ds"])
def test_kernel_ops_pass_opcheck(op):
    """torch.library.opcheck of each registered op on CPU tensors: schema,
    fake (shapes and strides against the CPU kernel), and its use under
    AOT dispatch with dynamic shapes."""
    t = _op_inputs(np.random.RandomState(3))
    args = {"spectral_project": (t["x"], t["evecs"], t["mass"], False),
            "spectral_apply": (t["x_hat"], t["coefs"], t["evecs"], t["gX"],
                               t["gY"], torch.float32),
            "spectral_ds": (t["evecs"], t["gX"], t["gY"], t["dy"], t["dy"],
                            t["dy"])}[op]
    torch.library.opcheck(getattr(torch.ops.dnt_torch, op).default, args)


def test_explicit_device_honored(vertex_artifact, tmp_path):
    """An explicit device is recorded exactly; the default is the model's
    parameters' device; "cuda" without a card raises in the exporter and
    in the loader instead of writing or serving a CPU artifact."""
    a = vertex_artifact
    d = str(tmp_path / "cpu")
    export_forward(a["model"], v_buckets=(V_BUCKET,), out_dir=d, k_eig=K,
                   device="cpu")
    with open(os.path.join(d, MANIFEST_NAME)) as f:
        assert json.load(f)["platforms"] == ["cpu"]
    if not torch.cuda.is_available():
        bad = str(tmp_path / "bad")
        with pytest.raises(RuntimeError, match="cuda"):
            export_forward(a["model"], v_buckets=(V_BUCKET,), out_dir=bad,
                           k_eig=K, device="cuda")
        assert not os.path.exists(os.path.join(bad, MANIFEST_NAME))
        with pytest.raises(RuntimeError, match="cuda"):
            load_serving_model(d)
    with pytest.raises(ValueError, match="spectral"):
        export_forward(DiffusionNet(c_in=3, c_out=2, c_width=8, n_block=1,
                                    diffusion_method="implicit_dense"),
                       v_buckets=(V_BUCKET,), out_dir=str(tmp_path / "x"),
                       k_eig=K)


def test_sharded_entry_points_name_their_roadmap_item(vertex_artifact):
    for fn in (export_sharded_forward, load_sharded_serving_model):
        with pytest.raises(NotImplementedError, match="A.6"):
            fn(vertex_artifact["dir"])


def test_format_version_mismatch_rejected(vertex_artifact, tmp_path):
    """A loader from another format generation refuses the artifact, as
    does one whose manifest has no version field."""
    d = str(tmp_path / "stale_artifact")
    shutil.copytree(vertex_artifact["dir"], d)
    mpath = os.path.join(d, MANIFEST_NAME)
    with open(mpath) as f:
        manifest = json.load(f)
    manifest["format_version"] = 999
    with open(mpath, "w") as f:
        json.dump(manifest, f)
    with pytest.raises(ValueError, match="format_version"):
        load_serving_model(d, device="cpu")
    del manifest["format_version"]
    with open(mpath, "w") as f:
        json.dump(manifest, f)
    with pytest.raises(ValueError, match="format_version"):
        load_serving_model(d, device="cpu")


_HERMETIC_LOADER = r"""
import sys
import numpy as np

# The artifact must load and serve WITHOUT the model stack: bar jax, flax,
# the JAX package and the port's model, geometry, training, data and
# experiments modules from import (relative imports included), then import
# the serving package, whose package __init__ loads nothing eagerly.
BARRED = ("jax", "jaxlib", "flax", "optax", "diffusionnet_tpu")
PORT_BARRED = tuple("diffusionnet_tpu_torch." + m for m in
                    ("models", "geometry", "training", "data", "experiments"))
class Bar:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BARRED or name.startswith(PORT_BARRED):
            raise ImportError("hermetic serving loader tried to import " + name)
sys.meta_path.insert(0, Bar())

import torch
torch.set_float32_matmul_precision("highest")
from diffusionnet_tpu_torch.serving import load_serving_model

artifact, inputs = sys.argv[1], sys.argv[2]
z = np.load(inputs)
sm = load_serving_model(artifact, device="cpu")
out = sm(z["x"], z["mass"], z["evals"], z["evecs"], z["gX"], z["gY"])
print("CHECKSUM", float(np.abs(out.numpy() - z["ref"]).max()))
loaded = sorted(m for m in sys.modules if m.split(".")[0] in BARRED
                or m.startswith(PORT_BARRED))
print("LOADED", ",".join(loaded))
"""


def test_hermetic_subprocess_load(vertex_artifact, tmp_path):
    """A fresh process loads and serves the artifact with jax, flax, the
    JAX package and the port's model stack barred from import: its
    sys.modules then holds none of them."""
    a = vertex_artifact
    s = a["sops"]
    inputs = str(tmp_path / "inputs.npz")
    np.savez(inputs, x=a["x"], mass=s.mass, evals=s.evals, evecs=s.evecs,
             gX=s.gradX_spec, gY=s.gradY_spec, ref=a["ref"])
    script = str(tmp_path / "loader.py")
    with open(script, "w") as f:
        f.write(_HERMETIC_LOADER)
    proc = subprocess.run(
        [sys.executable, script, a["dir"], inputs], capture_output=True,
        text=True, timeout=300, cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO))
    assert proc.returncode == 0, proc.stderr
    lines = dict(line.split(" ", 1) for line in proc.stdout.splitlines()
                 if line.startswith(("CHECKSUM", "LOADED")))
    assert float(lines["CHECKSUM"]) < 1e-4
    assert lines["LOADED"] == ""


def test_serving_example_runs_on_the_cpu(tmp_path):
    """The example exports, loads and serves its two meshes on the CPU at
    k_eig 16, with the smallest buckets that hold them (icosphere(3), 642
    vertices; torus(48, 24), 1152); its lines name the artifact and each
    mesh with its output shape and bucket."""
    out_dir = str(tmp_path / "artifact")
    proc = subprocess.run(
        [sys.executable, "-m", "diffusionnet_tpu_torch.examples.serving_export",
         "--device", "cpu", "--buckets", "1024", "2048", "--k_eig", "16",
         "--out_dir", out_dir],
        capture_output=True, text=True, timeout=300, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert len(lines) == 3, proc.stdout
    assert lines[0].startswith(f"exported [1024, 2048] buckets to {out_dir} (")
    assert lines[1].startswith("sphere: 642 verts -> logits (642, 8) "
                               "(bucket 1024, ")
    assert lines[2].startswith("torus: 1152 verts -> logits (1152, 8) "
                               "(bucket 2048, ")


def test_serving_example_writes_under_tmpdir_by_default(tmp_path):
    """Without --out_dir the example writes its artifact to a new
    directory under TMPDIR, never to a fixed path."""
    proc = subprocess.run(
        [sys.executable, "-m", "diffusionnet_tpu_torch.examples.serving_export",
         "--device", "cpu", "--buckets", "1024", "2048", "--k_eig", "16"],
        capture_output=True, text=True, timeout=300, cwd=REPO,
        env=dict(os.environ, TMPDIR=str(tmp_path)))
    assert proc.returncode == 0, proc.stderr
    (made,) = os.listdir(tmp_path)
    assert made.startswith("dnt_artifact_")
    out_dir = str(tmp_path / made)
    assert proc.stdout.startswith(f"exported [1024, 2048] buckets to {out_dir} (")
    assert sorted(os.listdir(out_dir)) == ["bucket_1024.pt2", "bucket_2048.pt2",
                                           "manifest.json", "params.npz"]

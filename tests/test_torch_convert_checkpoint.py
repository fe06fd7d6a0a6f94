"""The port's reference-checkpoint converter
(diffusionnet_tpu_torch/experiments/tools/convert_torch_checkpoint.py)
against the JAX tool (experiments/tools/convert_torch_checkpoint.py) on a
synthetic state_dict with the reference's module names (4 blocks, MiniMLP's
`miniMLP_mlp_layer_00k` Linear layers, with and without the functional-maps
model's `feature_extractor.` prefix): the same keys and arrays, the same
.npz from the command line, `.pth` and `.npz` loading to the same tensors,
n_block inferred, the port's DiffusionNet and FunctionalMapCorrespondence on
the converted weights against the JAX models' apply, and the repository's
converted pretrained weights loading into the port's models key for key."""

import glob
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusionnet_tpu.models import DiffusionNet as JaxDiffusionNet
from diffusionnet_tpu.models.fmaps import FunctionalMapCorrespondence as JaxFMC
from diffusionnet_tpu_torch.experiments.exp_common import (build_model,
                                                           load_weights)
from diffusionnet_tpu_torch.experiments.tools import (
    convert_torch_checkpoint as tconv)
from diffusionnet_tpu_torch.geometry import compute_operators, pad_operators
from diffusionnet_tpu_torch.models import (DiffusionNet,
                                           FunctionalMapCorrespondence,
                                           from_flat_jax_params,
                                           to_flat_jax_params)
from tests.meshgen import icosphere

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "experiments", "tools"))
import convert_torch_checkpoint as jconv  # noqa: E402

torch.set_float32_matmul_precision("highest")

C_IN, C_WIDTH, C_OUT, N_BLOCK = 3, 32, 32, 4


def reference_state_dict(prefix="", seed=0):
    """A state_dict shaped as the reference DiffusionNet saves it (its
    MiniMLP is an nn.Sequential of `miniMLP_mlp_layer_00k` Linears with
    dropout and activation modules between them, which hold no weights)."""
    g = torch.Generator().manual_seed(seed)

    def lin(o, i, bias=True):
        w = {"weight": torch.randn(o, i, generator=g) / np.sqrt(i)}
        if bias:
            w["bias"] = 0.1 * torch.randn(o, generator=g)
        return w

    sd = {}

    def put(name, mod):
        sd.update({f"{prefix}{name}.{k}": v for k, v in mod.items()})
    put("first_lin", lin(C_WIDTH, C_IN))
    for b in range(N_BLOCK):
        sd[f"{prefix}block_{b}.diffusion.diffusion_time"] = (
            0.05 * torch.rand(C_WIDTH, generator=g))
        put(f"block_{b}.gradient_features.A_re", lin(C_WIDTH, C_WIDTH, False))
        put(f"block_{b}.gradient_features.A_im", lin(C_WIDTH, C_WIDTH, False))
        sizes = [3 * C_WIDTH, C_WIDTH, C_WIDTH, C_WIDTH]
        for i in range(3):
            put(f"block_{b}.mlp.miniMLP_mlp_layer_{i:03d}",
                lin(sizes[i + 1], sizes[i]))
    put("last_lin", lin(C_OUT, C_WIDTH))
    return sd


def _np(sd):
    return {k: v.numpy() for k, v in sd.items()}


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """Both state_dicts saved as .pth."""
    d = tmp_path_factory.mktemp("ckpt")
    paths = {}
    for fmaps in (False, True):
        sd = reference_state_dict("feature_extractor." if fmaps else "",
                                  seed=int(fmaps))
        paths[fmaps] = str(d / f"ref_{int(fmaps)}.pth")
        torch.save(sd, paths[fmaps])
    return paths


@pytest.mark.parametrize("fmaps", [False, True])
def test_convert_matches_jax_tool(saved, fmaps):
    """convert_state_dict: the JAX tool's flatten(convert_state_dict(...))
    keys (under params/) and arrays; load_reference_checkpoint of the .pth
    equal to it, with n_block inferred from the key names."""
    sd = _np(torch.load(saved[fmaps], weights_only=True))
    prefix = "feature_extractor." if fmaps else ""
    assert tconv._infer_n_block(sd, prefix) == N_BLOCK
    assert jconv._infer_n_block(sd, prefix) == N_BLOCK
    want = jconv.convert_state_dict(sd, N_BLOCK, prefix=prefix)
    if fmaps:
        want = {"feature_extractor": want}
    want = {"params/" + k: v for k, v in jconv.flatten(want).items()}
    got = tconv.convert_state_dict(sd, N_BLOCK, prefix=prefix)
    assert sorted(got) == sorted(want)
    assert len(got) == 4 + N_BLOCK * 9
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    loaded = tconv.load_reference_checkpoint(saved[fmaps], fmaps=fmaps)
    assert sorted(loaded) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(loaded[k], want[k], err_msg=k)
    with pytest.raises(ValueError, match="no block_i"):
        tconv._infer_n_block(sd, "other.")


@pytest.mark.parametrize("fmaps", [False, True])
def test_cli_writes_the_jax_tools_npz(saved, fmaps, tmp_path, monkeypatch):
    """The command line writes the JAX tool's keys and arrays; the .npz and
    the .pth load to the same tensors in both packages' loaders."""
    out_t, out_j = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    flag = ["--fmaps"] if fmaps else []
    tconv.main([saved[fmaps], out_t] + flag)
    monkeypatch.setattr(sys, "argv", ["convert", saved[fmaps], out_j] + flag)
    jconv.main()
    with np.load(out_t) as a, np.load(out_j) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    from_pth = tconv.load_reference_checkpoint(saved[fmaps], fmaps=fmaps)
    for path in (out_t, out_j):
        from_npz = tconv.load_converted(path)
        assert sorted(from_npz) == sorted(from_pth)
        for k in from_pth:
            np.testing.assert_array_equal(from_npz[k], from_pth[k])
    jtree = jconv.load_converted(out_t)["params"]
    for k, v in from_pth.items():
        node = jtree
        for part in k.split("/")[1:]:
            node = node[part]
        np.testing.assert_array_equal(node, v)


def _operators(v, f, v_pad, k):
    ops = pad_operators(compute_operators(v, f, k_eig=k, eigensolver="host",
                                          device="cpu"), v_pad)
    x = np.pad(v.astype(np.float32), ((0, v_pad - v.shape[0]), (0, 0)))
    return dict(features=x, mass=ops.mass, evals=ops.evals, evecs=ops.evecs,
                gradX=ops.gradX_spec, gradY=ops.gradY_spec)


def _on(s, fn):
    """A shape dict as fn's arrays, with L absent (spectral diffusion)."""
    return dict({k: fn(a) for k, a in s.items()}, L=None)


def _jax_tree(params):
    """The port's flat params as the JAX model's variables."""
    return {"params": jconv.unflatten(
        {k[len("params/"):]: v for k, v in params.items()})}


def _assert_close(got, want):
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-6)


def test_converted_diffusionnet_matches_jax_apply(saved):
    """The converted weights in the port's DiffusionNet and in the JAX
    model's apply give the same outputs on one seeded mesh."""
    params = tconv.load_reference_checkpoint(saved[False])
    v, f = icosphere(subdivisions=2)
    v = v + 0.01 * np.random.RandomState(0).randn(*v.shape)
    s = _operators(v, f, 256, 16)
    jmodel = JaxDiffusionNet(c_in=C_IN, c_out=C_OUT, c_width=C_WIDTH,
                             n_block=N_BLOCK)
    j = _on(s, jnp.asarray)
    want = jmodel.apply(_jax_tree(params), j["features"], j["mass"],
                        evals=j["evals"], evecs=j["evecs"], gradX=j["gradX"],
                        gradY=j["gradY"])
    model = DiffusionNet(c_in=C_IN, c_out=C_OUT, c_width=C_WIDTH,
                         n_block=N_BLOCK)
    model.load_state_dict(from_flat_jax_params(params))
    t = {k: torch.from_numpy(a) for k, a in s.items()}
    with torch.no_grad():
        got = model(t["features"], t["mass"], evals=t["evals"],
                    evecs=t["evecs"], gradX=t["gradX"], gradY=t["gradY"])
    _assert_close(got.numpy(), want)


def test_converted_fmaps_model_matches_jax_apply(saved):
    """The converted functional-maps weights: the port's
    FunctionalMapCorrespondence against the JAX model's apply. Both
    feature sets within rtol 1e-5 (atol 1e-6 of their largest entry, about
    4 here); the map, an f32 regularised solve whose rounding the two
    libraries do not share, within the head's own tolerance (rtol 1e-4,
    atol 1e-5 of its largest entry, as tests/test_torch_fmaps.py)."""
    params = tconv.load_reference_checkpoint(saved[True], fmaps=True)
    v, f = icosphere(subdivisions=2)
    sx = _operators(v, f, 256, 32)
    sy = _operators(v * np.asarray([1.0, 0.8, 1.2]), f, 256, 32)
    jmodel = JaxFMC(c_in=C_IN, c_out=C_OUT, c_width=C_WIDTH, n_block=N_BLOCK,
                    n_fmap=20)
    want = [np.asarray(w) for w in jmodel.apply(
        _jax_tree(params), _on(sx, jnp.asarray), _on(sy, jnp.asarray))]
    model = FunctionalMapCorrespondence(c_in=C_IN, c_out=C_OUT,
                                        c_width=C_WIDTH, n_block=N_BLOCK,
                                        n_fmap=20)
    model.load_state_dict(from_flat_jax_params(params))
    with torch.no_grad():
        got = [g.numpy() for g in model(_on(sx, torch.from_numpy),
                                        _on(sy, torch.from_numpy))]
    np.testing.assert_allclose(got[0], want[0], rtol=1e-4,
                               atol=1e-5 * np.abs(want[0]).max())
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g, w, rtol=1e-5,
                                   atol=1e-6 * np.abs(w).max())


PRETRAINED = sorted(glob.glob(os.path.join(REPO, "experiments", "*",
                                           "pretrained_models", "*.npz")))


@pytest.mark.parametrize("path", PRETRAINED,
                         ids=[os.path.basename(p) for p in PRETRAINED])
def test_repository_pretrained_weights_load(path):
    """Each converted reference checkpoint of the repository loads into the
    port's model of its driver with no missing or extra key (strict
    load_state_dict), through load_weights as the drivers load it."""
    name = os.path.basename(path)[:-4]
    feats = "hks" if "hks" in name else "xyz"
    c_in = 16 if feats == "hks" else 3
    if name.startswith("human_seg"):
        model = build_model(n_class=8, c_width=128, outputs_at="faces",
                            dropout=True, input_features=feats)
        params = load_weights(path, model, "cpu")
    else:
        model = FunctionalMapCorrespondence(c_in=c_in, c_out=128,
                                            c_width=128, n_fmap=30)
        params = load_weights(path, model, "cpu")
    flat = tconv.load_converted(path)
    assert sorted(params) == sorted(to_flat_jax_params(model)) == sorted(flat)
    model.load_state_dict(from_flat_jax_params(params), strict=True)
    back = to_flat_jax_params(model)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


@pytest.mark.parametrize("fmaps", [False, True])
def test_load_weights_reads_a_pth(saved, fmaps):
    """load_weights takes the reference's .pth for either model (the
    functional-maps prefix from the model's own keys), equal to the
    converter's arrays."""
    model = (FunctionalMapCorrespondence(c_in=C_IN, c_out=C_OUT,
                                         c_width=C_WIDTH, n_block=N_BLOCK)
             if fmaps else DiffusionNet(c_in=C_IN, c_out=C_OUT,
                                        c_width=C_WIDTH, n_block=N_BLOCK))
    got = load_weights(saved[fmaps], model, "cpu")
    want = tconv.load_reference_checkpoint(saved[fmaps], fmaps=fmaps)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)


def test_load_weights_refuses_a_model_it_does_not_fit(saved):
    """A checkpoint of another width is refused, naming what differs."""
    model = build_model(n_class=8, c_width=64, outputs_at="faces",
                        dropout=True, input_features="xyz")
    with pytest.raises(ValueError, match="does not fit the model"):
        load_weights(saved[False], model, "cpu")

"""The PyTorch port's package boundary: it loads no JAX module, its kernel
module imports without nvcc, and the kernel wrapper dispatches by device
with no fallback."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_imports_no_jax():
    """Every module of the package, found by pkgutil.walk_packages (so the
    modules later PRs add are covered too), imports in one process that
    then holds no jax, jaxlib, flax, optax or diffusionnet_tpu module, nor
    a module loaded from the root experiments/ directory (the JAX drivers'
    exp_common or a suite's module)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import diffusionnet_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__,\n"
        "                                               pkg.__name__ + '.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "need = {'diffusionnet_tpu_torch.experiments.exp_common',\n"
        "        'diffusionnet_tpu_torch.examples.synthetic_shrec',\n"
        "        'diffusionnet_tpu_torch.examples.serving_export',\n"
        "        'diffusionnet_tpu_torch.serving.export',\n"
        "        'diffusionnet_tpu_torch.ops.megablock',\n"
        "        'diffusionnet_tpu_torch._build',\n"
        "        'diffusionnet_tpu_torch.native.build',\n"
        "        'diffusionnet_tpu_torch.geometry.knn_host',\n"
        "        'diffusionnet_tpu_torch.geometry.point_cloud',\n"
        "        'diffusionnet_tpu_torch.geometry.tufted',\n"
        "        'diffusionnet_tpu_torch.geometry.io',\n"
        "        'diffusionnet_tpu_torch.geometry.geodesics',\n"
        "        'diffusionnet_tpu_torch.geometry.heat_device',\n"
        "        'diffusionnet_tpu_torch.examples.fmaps_synthetic',\n"
        "        'diffusionnet_tpu_torch.examples.sampling_invariance_synthetic',\n"
        "        'diffusionnet_tpu_torch.experiments.layouts',\n"
        "        'diffusionnet_tpu_torch.experiments.tools.convert_torch_checkpoint',\n"
        "        'diffusionnet_tpu_torch.experiments.human_segmentation_original.human_segmentation_original',\n"
        "        'diffusionnet_tpu_torch.experiments.human_segmentation_original.human_segmentation_original_dataset',\n"
        "        'diffusionnet_tpu_torch.experiments.rna_mesh_segmentation.rna_mesh_segmentation',\n"
        "        'diffusionnet_tpu_torch.experiments.rna_mesh_segmentation.rna_mesh_dataset',\n"
        "        'diffusionnet_tpu_torch.experiments.classification_shrec11.classification_shrec11',\n"
        "        'diffusionnet_tpu_torch.experiments.classification_shrec11.shrec11_dataset',\n"
        "        'diffusionnet_tpu_torch.experiments.sampling_invariance.sampling_invariance',\n"
        "        'diffusionnet_tpu_torch.experiments.sampling_invariance.faust_with_robust_test_dataset',\n"
        "        'diffusionnet_tpu_torch.experiments.functional_correspondence.functional_correspondence',\n"
        "        'diffusionnet_tpu_torch.experiments.functional_correspondence.faust_scape_dataset'}\n"
        "missing = need - set(names)\n"
        "import os\n"
        "exp = os.path.join(os.getcwd(), 'experiments') + os.sep\n"
        "bad = sorted(m for m, mod in list(sys.modules.items())\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax',\n"
        "                                    'diffusionnet_tpu')\n"
        "             or (getattr(mod, '__file__', None) or '').startswith(exp))\n"
        "print(len(names), 'modules; missing', sorted(missing), '; loaded', bad)\n"
        "sys.exit(1 if bad or missing else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_build_raises_without_nvcc(tmp_path, monkeypatch):
    """The kernel module imports here (no nvcc, no card); building raises
    with the reason instead of falling back."""
    from diffusionnet_tpu_torch import _build
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    with pytest.raises(RuntimeError, match="nvcc|cannot run"):
        _build.build(nvcc=str(tmp_path / "no-such-nvcc"))
    monkeypatch.setenv("PATH", str(tmp_path))
    if not os.path.exists("/usr/local/cuda/bin/nvcc"):
        with pytest.raises(RuntimeError, match="nvcc not found"):
            _build.find_nvcc()


def _small_block(rs, B=1, V=40, K=8, C=4):
    def r(*shape):
        return torch.from_numpy(rs.randn(*shape).astype(np.float32))
    Ws = [r(3 * C, 8), r(8, C)]
    bs = [r(8), r(C)]
    return (r(B, V, C), r(B, V, K), r(B, V, K), r(B, V, K),
            torch.from_numpy(rs.rand(B, V).astype(np.float32)),
            torch.from_numpy(rs.rand(B, K, C).astype(np.float32)),
            r(C, C), r(C, C), Ws, bs, r(B, K, C))


def test_megablock_dispatch_by_device():
    """CPU tensors take the plain version and launch nothing; tensors on a
    device that is neither CPU nor CUDA are refused."""
    from diffusionnet_tpu_torch.ops import megablock as mb
    args = _small_block(np.random.RandomState(0))
    mb.reset_launches()
    out, xn = mb.megablock_chained(*args, emit_next=True, lowp=False)
    ref, rxn = mb.megablock_chained_reference(*args, emit_next=True)
    assert torch.equal(out, ref) and torch.equal(xn, rxn)
    assert mb.LAUNCHES == {"megablock_fwd": 0, "megablock_fwd_xhat": 0,
                           "megablock_fwd_wide": 0, "xhat_reduce": 0,
                           "megablock_bwd_rows": 0,
                           "megablock_bwd_grads": 0, "grad_reduce": 0}
    meta = [a.to("meta") if torch.is_tensor(a) else [t.to("meta") for t in a]
            for a in args]
    with pytest.raises(ValueError, match="unsupported device"):
        mb.megablock_chained(*meta)
    mixed = list(args)
    mixed[0] = mixed[0].to("meta")
    with pytest.raises(ValueError, match="several devices"):
        mb.megablock_chained(*mixed)


def test_fused_dispatch_by_device():
    """The fused block's wrappers (the backward's ds included): CPU tensors
    take the plain versions and launch nothing; a device that is neither
    CPU nor CUDA, or tensors on several devices, are refused."""
    from diffusionnet_tpu_torch.ops import fused
    x, evecs, gX, gY, mass, coefs = _small_block(np.random.RandomState(1),
                                                 B=2, V=64)[:6]
    fused.reset_launches()
    x_hat = fused.spectral_project(x, evecs, mass)
    fused.spectral_apply(x_hat, coefs, evecs, gX, gY, torch.float32)
    fused.spectral_ds(evecs, gX, gY, x, x, x)
    assert fused.LAUNCHES == {"spectral_project": 0, "spectral_apply": 0,
                              "spectral_ds": 0}
    with pytest.raises(ValueError, match="unsupported device"):
        fused.spectral_project(x.to("meta"), evecs.to("meta"),
                               mass.to("meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        fused.spectral_ds(*(t.to("meta") for t in (evecs, gX, gY, x, x, x)))
    with pytest.raises(ValueError, match="several devices"):
        fused.spectral_apply(x_hat.to("meta"), coefs, evecs, gX, gY,
                             torch.float32)

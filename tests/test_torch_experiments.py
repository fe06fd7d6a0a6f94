"""What the port's five experiment drivers share, on the CPU: --device
cuda without a card raises, and a driver's default data and
pretrained_models directories are the JAX driver's own. Each suite's
drivers and datasets against the JAX package's are in
tests/test_torch_experiments_<suite>.py (helpers in
tests/torch_experiments_common.py)."""

import os

import pytest
import torch

from diffusionnet_tpu_torch.experiments.classification_shrec11 import (
    classification_shrec11 as t_shrec)
from diffusionnet_tpu_torch.experiments.functional_correspondence import (
    functional_correspondence as t_fmaps)
from diffusionnet_tpu_torch.experiments.human_segmentation_original import (
    human_segmentation_original as t_hseg)
from diffusionnet_tpu_torch.experiments.rna_mesh_segmentation import (
    rna_mesh_segmentation as t_rna)
from diffusionnet_tpu_torch.experiments.sampling_invariance import (
    sampling_invariance as t_si)
from tests.torch_experiments_common import EXP
from tests.torch_threads import one_torch_thread  # noqa: F401

torch.set_float32_matmul_precision("highest")


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
@pytest.mark.parametrize("main", [t_hseg.main, t_rna.main, t_shrec.main,
                                  t_si.main, t_fmaps.main])
def test_device_cuda_without_a_card_raises(main, tmp_path):
    with pytest.raises(RuntimeError, match="no CUDA card"):
        main(["--data_dir", str(tmp_path)])


def test_default_paths_are_the_jax_drivers(monkeypatch):
    """Run from the repo, a driver's default data and pretrained_models
    directories are the JAX driver's own."""
    from diffusionnet_tpu_torch.experiments import exp_common
    assert exp_common.suite_dir("sampling_invariance") == os.path.join(
        EXP, "sampling_invariance")
    seen = {}

    def stop(root, **kw):
        seen["root"] = root
        raise SystemExit
    monkeypatch.setattr(t_rna, "RNAMeshDataset", stop)
    with pytest.raises(SystemExit):
        t_rna.main(["--device", "cpu"])
    assert seen["root"] == os.path.join(EXP, "rna_mesh_segmentation", "data")

"""High-level inference session: mesh in, predictions out.

The counterpart of diffusionnet_tpu/training/inference.py: operator
precompute (with the disk cache; a cold mesh's eigensolve runs on the
session's device), bucket padding, features and the forward pass behind one
object, on the card unless the caller asks for the CPU.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import utils
from ..data.features import get_features
from ..geometry import get_operators, grad_operators, pad_operators
from ..models.params import from_flat_jax_params


class InferenceSession:
    """session = InferenceSession(model, None, k_eig=128, device="cuda")
    preds = session(verts, faces)          # numpy in, numpy out
    """

    def __init__(self, model, params=None, k_eig: int = 128,
                 input_features: str = "hks",
                 op_cache_dir: str | None = None,
                 buckets=utils.DEFAULT_BUCKETS,
                 use_megakernel: bool = False,
                 bf16: bool = False,
                 device="cuda"):
        """model: the port's DiffusionNet, moved to `device` (the CUDA card
        unless the caller passes device="cpu"), where a cold request's
        eigensolve also runs. params: None
        to use the model's own weights, or the JAX package's flat params
        ('/'-joined keys, serving's params.npz) loaded into it.

        use_megakernel: one block-kernel launch per block (on a CUDA device
        the hand-written kernel; on the CPU its plain version). Any vertex
        bucket works: the kernel masks its last row tile.
        bf16 (megakernel only): feats, evecs, gX and gY go to bf16, and every
        product in the blocks then runs on bf16 operands."""
        if model.outputs_at == "edges":
            raise ValueError(
                "InferenceSession does not support outputs_at='edges' (it "
                "has no edge list input); call the model directly with an "
                "edges tensor")
        if use_megakernel and (model.diffusion_method != "spectral"
                               or not model.with_gradient_features):
            raise ValueError("use_megakernel needs spectral diffusion with "
                             "gradient features")
        self.device = torch.device(device)
        if params is not None:
            model.load_state_dict(from_flat_jax_params(params))
        self.model = model.to(self.device).eval()
        self.k_eig = k_eig
        self.input_features = input_features
        self.op_cache_dir = op_cache_dir
        self.buckets = buckets
        self.use_megakernel = use_megakernel
        self.bf16 = bf16
        # wall seconds of the last call: operator precompute (cache read or
        # compute, and padding) and the rest (features, forward, copy back)
        self.timings: dict[str, float] = {}
        self._flat = None
        if use_megakernel:
            from ..models.fast_path import flat_params
            self._flat = flat_params(self.model, self.device)

    def _forward(self, feats, mass, evals, evecs, gX, gY, faces, L):
        m = self.model
        if not self.use_megakernel:
            return m(feats, mass, evals=evals, evecs=evecs, gradX=gX,
                     gradY=gY, faces=faces if m.outputs_at == "faces" else None,
                     L=L)
        from ..models.fast_path import megablock_apply
        out = megablock_apply(self._flat, feats[None], mass[None],
                              evals[None], evecs[None], gX[None], gY[None],
                              n_block=m.n_block)[0].float()
        # outputs_at remap BEFORE last_activation (reference
        # layers.py:376-405 order)
        if m.outputs_at == "global_mean":
            out = (out * mass[:, None]).sum(0) / mass.sum()
        elif m.outputs_at == "faces":
            out = sum(out[faces[:, i]] for i in range(3)) / 3.0
        if m.last_activation is not None:
            out = m.last_activation(out)
        return out

    @torch.no_grad()
    def __call__(self, verts, faces=None, normals=None):
        t0 = time.perf_counter()
        verts = np.asarray(verts, dtype=np.float32)
        V = verts.shape[0]
        ops = get_operators(verts, faces, k_eig=self.k_eig,
                            op_cache_dir=self.op_cache_dir, normals=normals,
                            device=self.device)
        v_pad = utils.bucket_size(V, self.buckets)
        ops = pad_operators(ops, v_pad)
        t1 = time.perf_counter()
        dev = self.device
        to = ops.to(dev)
        # implicit_dense diffusion solves against L and applies the ELL
        # gradient operators; the dense spectral ones are only valid for
        # diffusion_method='spectral'
        spectral = self.model.diffusion_method == "spectral"
        gX, gY = grad_operators(to, prefer_spectral=spectral)
        x = torch.from_numpy(utils.pad_to(verts, v_pad)).to(dev)
        feats = get_features(self.input_features, x, to.evals, to.evecs)
        evecs = to.evecs
        if self.bf16 and self.use_megakernel:
            bf16 = torch.bfloat16
            feats, evecs = feats.to(bf16), evecs.to(bf16)
            gX, gY = gX.to(bf16), gY.to(bf16)
        faces_t = (torch.from_numpy(np.asarray(faces, np.int64)).to(dev)
                   if faces is not None and np.asarray(faces).size
                   else torch.zeros((1, 3), dtype=torch.int64, device=dev))
        out = self._forward(feats, to.mass, to.evals, evecs, gX, gY, faces_t,
                            to.L)
        out = out.float().cpu().numpy()
        self.timings = {"precompute_s": t1 - t0,
                        "forward_s": time.perf_counter() - t1}
        if self.model.outputs_at == "vertices":
            return out[:V]
        return out  # faces/global outputs are already unpadded-or-global

"""The model call and the loss of a training step: the counterparts of
`_apply_model` and `_loss_and_counts` in experiments/exp_common.py. (The
experiment drivers themselves come with ROADMAP item A.11.)"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..data.features import get_features
from ..geometry import grad_operators
from ..models.fast_path import megablock_apply
from ..models.params import module_state

# megakernel dropout tiles, largest first: the first that divides V is used
MEGA_TILES = (2048, 1024, 512, 256, 128)


@dataclass
class TaskConfig:
    """The fields of the JAX package's FitConfig that the step reads."""
    input_features: str = "hks"    # 'xyz' or 'hks'
    labels_kind: str = "global"    # 'global' | 'vertex' | 'face'
    label_smoothing: float = 0.0
    bf16: bool = False             # bf16 operands in the block kernels
    use_megakernel: bool = True    # block kernels; False: the eager model


def apply_model(model, params: dict, batch, generator, cfg: TaskConfig,
                deterministic: bool):
    """Predictions of `model`'s architecture with the train state `params`
    (JAX-layout leaf tensors) on a PaddedBatch of tensors.

    With cfg.use_megakernel the blocks run as kernels B1/B2
    (`megablock_apply`); else the eager model runs on the same tensors (a
    model built with use_pallas_fused runs its blocks on kernel B4 there).
    generator: the torch.Generator of the dropout masks, used when the model
    has dropout and deterministic is False."""
    ops = batch.ops
    feats = get_features(cfg.input_features, batch.verts, ops.evals, ops.evecs)
    # the dense spectral operators where the batch has them, else the ELL
    # ones (as the JAX package's `_apply_model`)
    gX, gY = grad_operators(ops)
    dropout_rng = (generator if model.dropout and not deterministic
                   else None)
    if not cfg.use_megakernel:
        kwargs = dict(evals=ops.evals, evecs=ops.evecs, gradX=gX, gradY=gY,
                      deterministic=deterministic, generator=dropout_rng,
                      L=ops.L)
        if model.outputs_at == "faces":
            kwargs["faces"] = batch.faces.long().clamp(min=0)
        return torch.func.functional_call(model, module_state(params),
                                          (feats, ops.mass), kwargs)

    V = feats.shape[-2]
    mega_tile = next((t for t in MEGA_TILES if V % t == 0), None)
    problems = []
    if model.diffusion_method != "spectral":
        problems.append("diffusion_method must be 'spectral'")
    if not model.with_gradient_features:
        problems.append("gradient features required")
    if model.outputs_at == "edges":
        problems.append("outputs_at='edges' not supported")
    if mega_tile is None:
        problems.append(f"padded V={V} has no tile divisor in {MEGA_TILES}")
    if problems:
        raise ValueError("use_megakernel unsupported for this model: "
                         + "; ".join(problems))
    evecs = ops.evecs
    if cfg.bf16:
        # bf16 operand streams; accumulation stays f32 inside the kernels
        feats, evecs = feats.to(torch.bfloat16), evecs.to(torch.bfloat16)
        gX, gY = gX.to(torch.bfloat16), gY.to(torch.bfloat16)
    logits = megablock_apply(params, feats, ops.mass, ops.evals, evecs, gX,
                             gY, n_block=model.n_block, tile_v=mega_tile,
                             dropout_rng=dropout_rng).float()
    if model.outputs_at == "global_mean":
        logits = ((logits * ops.mass[..., None]).sum(-2)
                  / ops.mass.sum(-1, keepdim=True))
    elif model.outputs_at == "faces":
        # mean over the 3 incident vertices (reference layers.py:386-391)
        f = batch.faces.long().clamp(min=0)
        C = logits.shape[-1]
        logits = sum(torch.gather(logits, -2,
                                  f[..., i, None].expand(f.shape[:-1] + (C,)))
                     for i in range(3)) / 3.0
    return (model.last_activation(logits)
            if model.last_activation is not None else logits)


def loss_and_counts(preds, batch, cfg: TaskConfig):
    """Masked mean loss and (correct, total) counts; labels -1 are ignored.
    'global': cross-entropy on log-probabilities with label smoothing;
    'vertex'/'face': per-element NLL (faces also masked by face_mask)."""
    preds = preds.float()
    labels = batch.labels.long()
    valid = labels >= 0
    safe = labels.clamp(min=0)
    if cfg.labels_kind == "global":
        n_class = preds.shape[-1]
        s = cfg.label_smoothing
        one_hot = torch.nn.functional.one_hot(safe, n_class).to(preds.dtype)
        one_hot = one_hot * (1.0 - s) + (1.0 - one_hot) * s / (n_class - 1)
        per = -(one_hot * preds).sum(-1)
    else:
        if cfg.labels_kind == "face":
            valid = valid & batch.face_mask
        per = -torch.gather(preds, -1, safe[..., None])[..., 0]
    total = valid.sum()
    loss = (per * valid).sum() / total.clamp(min=1)
    correct = ((preds.argmax(-1) == labels) & valid).sum()
    return loss, (correct, total)

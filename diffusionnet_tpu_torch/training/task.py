"""The model call and the loss of a training step: the counterparts of
`_augment`, `_apply_model` and `_loss_and_counts` in
experiments/exp_common.py. The epoch loop around them is
`experiments.exp_common.fit`, which the experiment drivers
(`experiments.<suite>.<driver>`) train through."""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..data.features import get_features
from ..geometry import grad_operators
from ..models.diffusion_net import MeanPlan, gather_mean
from ..models.fast_path import megablock_apply
from ..models.params import module_state
from ..utils import rotation_from_uniforms, rotation_y_from_uniform

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
    augment_rotate: bool = False   # random SO(3) rotation of xyz features
    rotate_axis: str = "full"      # 'full' or 'y'


def augment(verts, generator, cfg: TaskConfig):
    """Each batch element's vertices rotated by its own random rotation
    (cfg.augment_rotate with xyz features; else verts as given). The
    uniforms are drawn from `generator` on its device in one call: (B, 3)
    for 'full', (B,) for 'y'."""
    if not (cfg.augment_rotate and cfg.input_features == "xyz"):
        return verts
    B = verts.shape[0]
    if cfg.rotate_axis == "y":
        u = torch.rand(B, generator=generator, device=generator.device)
        R = rotation_y_from_uniform(u)
    else:
        u = torch.rand(B, 3, generator=generator, device=generator.device)
        R = rotation_from_uniforms(u)
    return verts @ R.to(verts.device, verts.dtype)


def apply_model(model, params: dict, batch, generator, cfg: TaskConfig,
                deterministic: bool):
    """Predictions of `model`'s architecture with the train state `params`
    (JAX-layout leaf tensors) on a PaddedBatch of tensors.

    With cfg.use_megakernel the blocks run as kernels B1/B2
    (`megablock_apply`); else the eager model runs on the same tensors (a
    model built with use_pallas_fused runs its blocks on kernel B4 there).

    generator: None (evaluation), or the torch.Generator of the step's
    randomness, drawn in this order: first the rotation uniforms of
    `augment` (with cfg.augment_rotate and xyz features), then the dropout
    (when the model has dropout and deterministic is False): one seed per
    block on the megakernel path (a generator on the CPU), the masks on the
    eager path (a generator on the tensors' device)."""
    ops = batch.ops
    verts = batch.verts
    if generator is not None:
        verts = augment(verts, generator, cfg)
    feats = get_features(cfg.input_features, verts, ops.evals, ops.evecs)
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
            kwargs["faces"] = batch.faces.long()
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
    faces = plan = None
    if model.outputs_at == "faces":
        faces = batch.faces.long()
        if torch.is_grad_enabled():  # the backward's plan, made early
            plan = MeanPlan(faces, V)
    logits = megablock_apply(params, feats, ops.mass, ops.evals, evecs, gX,
                             gY, n_block=model.n_block, tile_v=mega_tile,
                             dropout_rng=dropout_rng).float()
    if model.outputs_at == "global_mean":
        logits = ((logits * ops.mass[..., None]).sum(-2)
                  / ops.mass.sum(-1, keepdim=True))
    elif model.outputs_at == "faces":
        # mean over the 3 incident vertices (reference layers.py:386-391)
        logits = gather_mean(logits, faces, plan)
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

"""Adam with the reference's staircase decay, in plain PyTorch.

Adam (Kingma & Ba) with b1 0.9, b2 0.999, eps 1e-8, bias-corrected, and
the learning rate lr * rate^floor(step / decay_steps) at update `step`
(from 0): the optimizer of the DiffusionNet reference experiments
(torch.optim.Adam and a StepLR of every `decay_every` epochs).
"""

from __future__ import annotations

import torch


def train(params0: dict, losses_of_steps, lr: float, decay_steps: int,
          decay_rate: float):
    """Runs one Adam update per callable in `losses_of_steps` (each maps
    the parameter dict to a scalar loss) from copies of params0.

    Returns (losses, first_grads, params): each step's loss before its
    update, the first step's gradients, and the parameters after the last
    update."""
    p = {k: v.detach().clone().requires_grad_(True) for k, v in params0.items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    losses, first = [], None
    for step, loss_of in enumerate(losses_of_steps):
        loss = loss_of(p)
        grads = torch.autograd.grad(loss, list(p.values()))
        losses.append(float(loss.detach()))
        if first is None:
            first = {k: g.detach().clone() for k, g in zip(p, grads)}
        t = step + 1
        rate = (decay_rate ** (step // decay_steps)) if decay_steps else 1.0
        with torch.no_grad():
            for (k, w), g in zip(p.items(), grads):
                m[k].mul_(0.9).add_(g, alpha=0.1)
                v2[k].mul_(0.999).addcmul_(g, g, value=0.001)
                m_hat = m[k] / (1 - 0.9 ** t)
                v_hat = v2[k] / (1 - 0.999 ** t)
                w.sub_(lr * rate * m_hat / (v_hat.sqrt() + 1e-8))
    return losses, first, {k: w.detach() for k, w in p.items()}

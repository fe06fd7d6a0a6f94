"""Inputs made from the run's seed: weights, operator bundles, faces,
labels, positions and request signals. The same seed gives the same
inputs; the port and the reference are handed the same ones.

Operator bundles are synthetic with the published shapes: mass positive
and summing to 1 (a surface of unit area), evals ascending from 0 (about
4 pi k, as a unit-area surface's Laplacian gives), Phi orthonormal in the
mass inner product, dense spectral gradients GX, GY (V, K) of magnitude
sqrt(lambda_k / 2). Faces are a grid triangulation (F about 2V) with its
own width and a cyclic relabelling per surface. The sparse fields the
spectral route does not read (L, gradX, gradY as ELL; frames) are
placeholders of the right type.
"""

from __future__ import annotations

import hashlib
import math

import numpy as np
import torch


def sub_seed(seed: int, tag: str, bound: int = 2 ** 31) -> int:
    """A seed for one part of a run, below `bound`, from the run's seed
    (any whole number) and the part's name."""
    h = hashlib.blake2b(f"{int(seed)}:{tag}".encode(), digest_size=8)
    return int.from_bytes(h.digest(), "little") % bound


def param_shapes(m: dict) -> dict:
    """JAX-layout parameter keys and shapes of a DiffusionNet with
    gradient rotations: kernels (in, out)."""
    C, widths = m["c_width"], [3 * m["c_width"], *m["mlp_hidden_dims"],
                               m["c_width"]]
    shapes = {"params/first_lin/kernel": (m["c_in"], C),
              "params/first_lin/bias": (C,)}
    for b in range(m["n_block"]):
        p = f"params/block_{b}/"
        shapes[p + "diffusion/diffusion_time"] = (C,)
        shapes[p + "gradient_features/A_re/kernel"] = (C, C)
        shapes[p + "gradient_features/A_im/kernel"] = (C, C)
        for l, (a, o) in enumerate(zip(widths[:-1], widths[1:])):
            shapes[f"{p}mlp/dense_{l:03d}/kernel"] = (a, o)
            shapes[f"{p}mlp/dense_{l:03d}/bias"] = (o,)
    shapes["params/last_lin/kernel"] = (C, m["n_class"])
    shapes["params/last_lin/bias"] = (m["n_class"],)
    return shapes


def weights(m: dict, seed: int, device, trained: bool) -> dict:
    """Flat f32 parameters on `device`, from two draws of a generator
    there. Kernels: a normal clipped to +-2 sigma, sigma = 1 /
    sqrt(fan_in) / 0.8796 (flax's lecun_normal, the port's init). With
    `trained` the biases are N(0, 0.01^2) and the diffusion times
    10^U(-3, -1) (a trained model's range); else both are 0, as `fit`
    starts."""
    shapes = param_shapes(m)
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, "weights"))
    kernels = [k for k in shapes if k.endswith("/kernel")]
    others = [k for k in shapes if not k.endswith("/kernel")]
    n_k = sum(math.prod(shapes[k]) for k in kernels)
    n_o = sum(math.prod(shapes[k]) for k in others)
    z = torch.randn(n_k, generator=g, device=device).clamp_(-2.0, 2.0)
    u = torch.rand(n_o, generator=g, device=device)
    flat, i = {}, 0
    for k in kernels:
        n = math.prod(shapes[k])
        std = 1.0 / math.sqrt(shapes[k][0]) / 0.87962566103423978
        flat[k] = (z[i:i + n] * std).view(shapes[k]).contiguous()
        i += n
    i = 0
    for k in others:
        n = math.prod(shapes[k])
        v = u[i:i + n].view(shapes[k])
        i += n
        if not trained:
            flat[k] = torch.zeros_like(v)
        elif k.endswith("diffusion_time"):
            flat[k] = 10.0 ** (-3.0 + 2.0 * v)
        else:
            flat[k] = 0.01 * math.sqrt(2.0) * torch.erfinv(2.0 * v - 1.0)
    return {k: flat[k] for k in shapes}


def bundle(V: int, K: int, seed: int, device) -> dict:
    """One surface's spectral operators on `device`: mass (V,), evals
    (K,), evecs, gX, gY (V, K), f32."""
    g = torch.Generator(device=device).manual_seed(seed)
    mass = 0.5 + torch.rand(V, generator=g, device=device)
    mass = mass / mass.sum()
    gauss = torch.randn(V, K, generator=g, device=device)
    root = mass.sqrt()[:, None]
    q = torch.linalg.qr(root * gauss).Q
    evecs = (q / root).contiguous()
    steps = 4.0 * math.pi * (0.5 + torch.rand(K, generator=g, device=device))
    evals = torch.cumsum(steps, 0) - steps[0]
    scale = (evals / 2.0).sqrt()[None, :]
    gX = torch.randn(V, K, generator=g, device=device) * scale
    gY = torch.randn(V, K, generator=g, device=device) * scale
    return dict(mass=mass, evals=evals, evecs=evecs, gX=gX, gY=gY)


def grid_faces(V: int, seed: int) -> np.ndarray:
    """A grid triangulation of V vertices, (F, 3) int64 with F about 2V:
    a seeded width in [64, 256], two triangles per grid square whose four
    corners exist, and every index shifted cyclically by a seeded offset."""
    rs = np.random.RandomState(seed)
    w = int(rs.randint(64, 257))
    rows = -(-V // w)
    r, c = np.meshgrid(np.arange(rows - 1), np.arange(w - 1), indexing="ij")
    a = (r * w + c).ravel()
    quads = np.stack([a, a + 1, a + w, a + w + 1], 1)
    quads = quads[quads[:, 3] < V]
    faces = np.concatenate([quads[:, [0, 1, 2]], quads[:, [1, 3, 2]]])
    return (faces + int(rs.randint(V))) % V



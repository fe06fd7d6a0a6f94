"""The random draws of one training step, worked out again from the seeds.

A step of the port's `fit` gets its randomness from one seed: a torch
Generator seeded with it supplies, in this order, the rotation uniforms of
the augmentation and then the dropout (Dropout(0.5) before every MLP layer
but the first). The two routes draw dropout differently, and the
reference reproduces both from the published definitions:

* the eager route (a generator on the card): one `torch.rand` of the whole
  padded batch's shape per dropout layer, block by block; keep where the
  uniform is >= 0.5;
* the block-kernel route (a generator on the CPU): one seed per block,
  `randint(0, 2^31 - 1)`; each element's keep bit is a counter hash of
  (seed, batch row, tile of `tile_v` vertices, layer) and its place in the
  tile, kept where the 32-bit hash is >= 2^31 (the splitmix/xorshift hash
  of the JAX package's megablock kernel, `_hash_bits` and `_keep_mask`).

torch only: nothing of the port, nothing of JAX.
"""

from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF
_THRESHOLD = 2 ** 31  # round(0.5 * 2^32)


def step_seeds(fit_seed: int, n_steps: int) -> list[int]:
    """The seeds of a run's first steps: `fit` draws one per step,
    randint(0, 2^62), from a CPU generator seeded with the run's seed."""
    rng = torch.Generator().manual_seed(fit_seed)
    return [int(torch.randint(0, 2 ** 62, (), generator=rng))
            for _ in range(n_steps)]


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    lo, hi = c & 0xFFFF, c >> 16
    return (h * lo + (((h * hi) & 0xFFFF) << 16)) & _M32


def _hash(idx: torch.Tensor, *seeds) -> torch.Tensor:
    h = idx & _M32
    for s in seeds:
        s = torch.as_tensor(s, dtype=torch.int64, device=h.device) & _M32
        h = h ^ ((s + 0x9E3779B9 + ((h << 6) & _M32) + (h >> 2)) & _M32)
    h = h ^ (h >> 16)
    h = _mul32(h, 0x7FEB352D)
    h = h ^ (h >> 15)
    h = _mul32(h, 0x846CA68B)
    return h ^ (h >> 16)


class KernelDraws:
    """The block-kernel route's draws of a step: the rotation uniforms
    (with `rotate`) and then one dropout seed per block, from a CPU
    generator seeded with the step's seed."""

    def __init__(self, step_seed: int, B: int, n_block: int, rotate: bool):
        g = torch.Generator().manual_seed(step_seed)
        self.rot_u = torch.rand(B, generator=g) if rotate else None
        self.seeds = [int(torch.randint(0, 2 ** 31 - 1, (), generator=g))
                      for _ in range(n_block)]

    def masks(self, row: int, tile_v: int, device):
        """masks(block, layer, rows, width) of batch row `row`."""
        def keep(block, layer, rows, width):
            v = torch.arange(rows, dtype=torch.int64, device=device)[:, None]
            c = torch.arange(width, dtype=torch.int64, device=device)[None]
            key = (row * 65536 + v // tile_v) * 16 + (layer - 1)
            return _hash((v % tile_v) * width + c, self.seeds[block],
                         key) >= _THRESHOLD
        return keep


class EagerDraws:
    """The eager route's draws of a step over a padded batch (B, v_pad):
    the rotation uniforms (with `rotate`), then each block's dropout
    uniforms, on `device`, from a generator seeded with the step's seed.
    widths: the input widths of the MLP's dense layers."""

    def __init__(self, step_seed: int, B: int, v_pad: int, n_block: int,
                 widths: list[int], rotate: bool, dropout: bool, device):
        g = torch.Generator(device=device).manual_seed(step_seed)
        self.rot_u = (torch.rand(B, generator=g, device=device) if rotate
                      else None)
        self.keep = {}
        if dropout:
            for b in range(n_block):
                for l, w in enumerate(widths[1:], start=1):
                    self.keep[b, l] = torch.rand(
                        (B, v_pad, w), generator=g, device=device) >= 0.5

    def masks(self, row: int, tile_v: int, device):
        """masks(block, layer, rows, width) of batch row `row`."""
        return lambda b, l, rows, width: self.keep[b, l][row, :rows]

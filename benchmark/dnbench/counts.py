"""Operations and bytes from shapes, and the peaks every share is taken
against. Frozen: a later change to the program does not move these.

Peaks (NVIDIA H100 SXM data sheet, dense, at the 700 W power limit):
PEAK_FLOPS = 495e12, the TF32 tensor rate, the fastest rate at which the
card multiplies f32 operands; HBM_BYTES_S = 3.35e12. Both configurations
are float32, so no share can pass 100% whatever later kernels do (the
port's kernels today take three TF32 passes per f32 product, so their own
ceiling is a third of this).

The kernel bounds are `chip_smoke.py`'s `megablock_bound` and
`fused_bound` (operations counted from the code's products, each input
and output byte once), taken against PEAK_FLOPS instead of a third of it.
"""

from __future__ import annotations

PEAK_FLOPS = 495e12
HBM_BYTES_S = 3.35e12


def bound_s(n_bytes: float, flops: float) -> float:
    """The least seconds: the larger of bytes over the HBM rate and
    operations over the peak."""
    return max(n_bytes / HBM_BYTES_S, flops / PEAK_FLOPS)


def megablock_bound_s(B: int, V: int, K: int, C: int, widths, emit_next: bool,
                      backward: bool) -> float:
    """One f32 block on kernels B1 (forward: the row kernel, x_hat_next and
    its sum) or B2 (backward: rows, grads and sums), over B x V rows.
    Per vertex: Phi s, GX s, GY s 3 * 2KC; the complex map 8C^2; the MLP
    2 sum w_l w_l+1; x_hat_next 2KC. The backward recomputes the forward up
    to the last layer, then the MLP's two products per layer, 16C^2 for the
    complex map, 3 * 2KC for ds and 2KC for m Phi dx_hat. Bytes: x, Phi,
    GX, GY, mass, out (and dout, dx) once. widths: the MLP's layer sizes
    [3C, hidden..., C]."""
    mlp = [2 * a * b for a, b in zip(widths[:-1], widths[1:])]
    fwd = 6 * K * C + 8 * C * C + sum(mlp)
    if backward:
        flops = (fwd - mlp[-1] + 2 * sum(mlp) + 16 * C * C + 6 * K * C
                 + (2 * K * C if emit_next else 0))
        row_bytes = 3 * C * 4 + 3 * K * 4 + 4
    else:
        flops = fwd + (2 * K * C if emit_next else 0)
        row_bytes = 2 * C * 4 + 3 * K * 4 + 4
    return bound_s(B * V * row_bytes, B * V * flops)


def megablock_step_bound_s(B: int, V: int, K: int, C: int, widths,
                           n_block: int) -> float:
    """B1 and B2 over one train step's blocks (every block but the last
    emits x_hat_next)."""
    return sum(megablock_bound_s(B, V, K, C, widths, b < n_block - 1, bwd)
               for b in range(n_block) for bwd in (False, True))


def fused_bound_s(B: int, V: int, K: int, C: int) -> float:
    """One f32 block on kernel B4 (`spectral_project`, its sum, and
    `spectral_apply`): bytes of x and mass, Phi, GX and GY and the three
    outputs, each once; 2VKC operations per product (one for the
    projection, three for the outputs)."""
    n_bytes = (B * V * (C * 4 + K * 4 + 4) + B * K * C * 4
               + B * V * (3 * K * 4 + 3 * C * 4) + 2 * B * K * C * 4)
    return bound_s(n_bytes, 8 * B * V * K * C)


def model_flops(V: int, K: int, c_in: int, C: int, hidden, n_class: int,
                n_block: int, hks: bool) -> float:
    """The forward's products on V real vertices: HKS (2VK * 16) when the
    input is HKS, first_lin, per block the projection, Phi s, GX s, GY s
    (4 * 2VKC), the complex map (8VC^2) and the MLP, then last_lin.
    Elementwise work, the face mean and the softmax are not counted."""
    widths = [3 * C, *hidden, C]
    mlp = sum(2 * a * b for a, b in zip(widths[:-1], widths[1:]))
    block = 8 * K * C + 8 * C * C + mlp
    return V * ((2 * K * 16 if hks else 0) + 2 * c_in * C + n_block * block
                + 2 * C * n_class)

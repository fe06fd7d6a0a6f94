"""Operations and bytes of the functional-map correspondence model, from
shapes. Frozen beside `counts.py`: a later change to the program does not
move these.

`ell_shape_bytes`: the least bytes of one shape's ELL gradient products in
a train step (`ell_matvec`, forward and backward), over its V real rows
with nnz entries a row in each operator: the forward reads both operators'
column indices (int32) and values (f32) once and the diffused signal once,
for gradX and gradY together, and writes both products; the backward (the
transposed products into dx, the operators taking no gradient) reads the
operators again and both cotangents and writes dx once. At 3.35 TB/s
(`HBM_BYTES_S`) that is the products' least time.

`model_flops` / `head_flops`: the forward's products on a shape's real
vertices, and the functional-map head's of a pair, for `mfu.train`.
"""

from __future__ import annotations

from dnbench.counts import HBM_BYTES_S


def ell_shape_bytes(V: int, nnz_per_row: float, C: int,
                    n_block: int) -> float:
    """Least bytes of one shape's ELL products in a train step: V real
    rows, nnz_per_row the mean entries a row of an operator, width C,
    n_block blocks."""
    operators = 2 * 2 * V * nnz_per_row * (4 + 4)  # fwd + bwd, X and Y
    signals = (1 + 2) * V * C * 4 + (2 + 1) * V * C * 4  # fwd, bwd
    return n_block * (operators + signals)


def model_flops(V: int, nnz_per_row: float, K: int, c_in: int, C: int,
                hidden, c_out: int, n_block: int, n_fmap: int) -> float:
    """One shape's extractor forward on V real vertices: first_lin, per
    block the projection and Phi s (2 * 2VKC), the two ELL gradients
    (2 * 2 V nnz C, nnz the mean entries a row), the complex map (8VC^2)
    and the MLP, then last_lin; and the projection of its features onto
    n_fmap eigenvectors (2 V n_fmap c_out). Elementwise work is not
    counted."""
    widths = [3 * C, *hidden, C]
    mlp = sum(2 * a * b for a, b in zip(widths[:-1], widths[1:]))
    block = 4 * K * C + 4 * nnz_per_row * C + 8 * C * C + mlp
    return V * (2 * c_in * C + n_block * block + 2 * C * c_out
                + 2 * n_fmap * c_out)


def head_flops(c_out: int, n_fmap: int) -> float:
    """A pair's map from its spectral coefficients: A A^T and B A^T
    (2 * 2 k^2 c_out) and k LU solves of k x k systems (2/3 k^3 each)."""
    k = n_fmap
    return 4 * k * k * c_out + k * (2.0 / 3.0) * k ** 3

"""Panel-blocked batched Cholesky + triangular solves.

An alternative to XLA's native ``cho_factor``/``TriangularSolve`` for the
partitioned-Schur interior factorizations: both are re-expressed as a
SHORT static chain of batched matmuls plus small p x p panel factors:

* ``blocked_cholesky`` — right-looking blocked Cholesky.  Per panel: a
  small native Cholesky + explicit triangular inverse of the diagonal
  block, one matmul for the column below it, one matmul for the trailing
  update.  ~n/p sequential steps of matmul work instead of O(n) scalar
  panel steps.
* ``solve_lower`` / ``solve_lower_t`` — panel forward/backward substitution
  using the stored panel inverses: one matmul per panel step.

Everything is batched over arbitrary leading dims and uses
``precision=HIGHEST`` (true f32 products; the normal equations are
squared-conditioned).  Exactness vs ``jax.scipy.linalg.cho_factor/cho_solve``
is pinned in ``tests/test_schur.py``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

Array = jax.Array
_PREC = jax.lax.Precision.HIGHEST


def _mm(a, b):
    return jnp.matmul(a, b, precision=_PREC, preferred_element_type=a.dtype)


def _chol_panel(a: Array) -> Array:
    """Cholesky of the (..., p, p) diagonal panel.  The panel is small,
    so XLA's native op is cheap here -- the blocking structure around it
    is what removes the O(n) sequential panel chain."""
    return jnp.linalg.cholesky(a)


def _inv_lower_panel(l: Array) -> Array:
    """Explicit inverse of the (..., p, p) lower-triangular panel, so every
    downstream panel solve is a plain matmul."""
    eye = jnp.broadcast_to(
        jnp.eye(l.shape[-1], dtype=l.dtype), l.shape
    )
    return jax.scipy.linalg.solve_triangular(l, eye, lower=True)


class BlockedCholesky:
    """Factorization container: full lower factor + per-panel inverses."""

    def __init__(self, L: Array, inv_diag: list[Array], panel: int, n: int):
        self.L = L                  # (..., n_pad, n_pad) lower
        self.inv_diag = inv_diag    # list of (..., p, p) panel inverses
        self.panel = panel
        self.n = n                  # original (unpadded) size


def _panel_factor(a: Array, inner: int) -> tuple[Array, Array]:
    """Cholesky + explicit inverse of one (..., p, p) diagonal panel.

    ``inner > 0`` adds a SECOND blocking level: the panel itself is
    factored as an inner-blocked Cholesky, and its inverse is built by
    panel forward substitution against identity -- so the only native
    ops are inner x inner, with everything else batched matmuls.
    """
    p = a.shape[-1]
    if not inner or p <= inner or p % inner:
        L = _chol_panel(a)
        return L, _inv_lower_panel(L)
    fac = blocked_cholesky(a, panel=inner)  # p % inner == 0: no padding
    eye = jnp.broadcast_to(jnp.eye(p, dtype=a.dtype), a.shape)
    inv = solve_lower(fac, eye)
    return fac.L, inv


def blocked_cholesky(A: Array, panel: int = 16,
                     inner: int = 0) -> BlockedCholesky:
    """Right-looking blocked Cholesky of batched SPD matrices (..., n, n).

    Pads to a multiple of ``panel`` with an identity block (benign for SPD;
    padded rows/columns stay zero in solves).  ``inner`` optionally blocks
    the diagonal-panel factorization itself (see ``_panel_factor``)."""
    n = A.shape[-1]
    p = panel
    n_pad = -(-n // p) * p
    if n_pad != n:
        pad = n_pad - n
        eye = jnp.eye(pad, dtype=A.dtype)
        eye = jnp.broadcast_to(eye, A.shape[:-2] + (pad, pad))
        top = jnp.concatenate(
            [A, jnp.zeros(A.shape[:-2] + (n, pad), A.dtype)], axis=-1
        )
        bot = jnp.concatenate(
            [jnp.zeros(A.shape[:-2] + (pad, n), A.dtype), eye], axis=-1
        )
        A = jnp.concatenate([top, bot], axis=-2)

    steps = n_pad // p
    T = A
    col_blocks = []
    inv_diag = []
    for i in range(steps):
        L11, inv11 = _panel_factor(T[..., :p, :p], inner)
        inv_diag.append(inv11)
        L21 = _mm(T[..., p:, :p], jnp.swapaxes(inv11, -1, -2))
        col = jnp.concatenate(
            [jnp.zeros(A.shape[:-2] + (i * p, p), A.dtype), L11, L21],
            axis=-2,
        )
        col_blocks.append(col)
        T = T[..., p:, p:] - _mm(L21, jnp.swapaxes(L21, -1, -2))
    L = jnp.concatenate(col_blocks, axis=-1)
    return BlockedCholesky(L, inv_diag, p, n)


def _pad_rhs(fac: BlockedCholesky, B: Array) -> tuple[Array, bool]:
    n_pad = fac.L.shape[-1]
    vec = B.ndim == fac.L.ndim - 1
    if vec:
        B = B[..., None]
    if n_pad != fac.n:
        B = jnp.concatenate(
            [B, jnp.zeros(B.shape[:-2] + (n_pad - fac.n, B.shape[-1]),
                          B.dtype)],
            axis=-2,
        )
    return B, vec


def solve_lower(fac: BlockedCholesky, B: Array) -> Array:
    """Solve ``L Y = B`` by panel forward substitution (padded shapes)."""
    p = fac.panel
    steps = fac.L.shape[-1] // p
    ys = []
    for i in range(steps):
        s = i * p
        rhs = B[..., s : s + p, :]
        if i:
            Yprev = jnp.concatenate(ys, axis=-2)
            rhs = rhs - _mm(fac.L[..., s : s + p, :s], Yprev)
        ys.append(_mm(fac.inv_diag[i], rhs))
    return jnp.concatenate(ys, axis=-2)


def solve_lower_t(fac: BlockedCholesky, Y: Array) -> Array:
    """Solve ``L^T X = Y`` by panel backward substitution."""
    p = fac.panel
    steps = fac.L.shape[-1] // p
    xs: list[Array] = []
    for i in range(steps - 1, -1, -1):
        s = i * p
        rhs = Y[..., s : s + p, :]
        if xs:
            Xnext = jnp.concatenate(xs, axis=-2)
            # Rows below panel i of column block i: L[s+p:, s:s+p]^T X.
            rhs = rhs - _mm(
                jnp.swapaxes(fac.L[..., s + p :, s : s + p], -1, -2), Xnext
            )
        xs.insert(0, _mm(jnp.swapaxes(fac.inv_diag[i], -1, -2), rhs))
    return jnp.concatenate(xs, axis=-2)


def _unpadded(fac: BlockedCholesky, B: Array, *solves) -> Array:
    """Apply panel ``solves`` to an unpadded (..., n) or (..., n, k) RHS.
    The padded block of L is the identity, so padded rows stay zero."""
    X, vec = _pad_rhs(fac, B)
    for solve in solves:
        X = solve(fac, X)
    X = X[..., : fac.n, :]
    return X[..., 0] if vec else X


def forward_blocked(fac: BlockedCholesky, B: Array) -> Array:
    """Solve ``L Y = B`` (accepts (..., n) or (..., n, k))."""
    return _unpadded(fac, B, solve_lower)


def backward_blocked(fac: BlockedCholesky, Y: Array) -> Array:
    """Solve ``L^T X = Y`` (accepts (..., n) or (..., n, k))."""
    return _unpadded(fac, Y, solve_lower_t)


def cho_solve_blocked(fac: BlockedCholesky, B: Array) -> Array:
    """Solve ``L L^T X = B`` (accepts (..., n) or (..., n, k))."""
    return _unpadded(fac, B, solve_lower, solve_lower_t)

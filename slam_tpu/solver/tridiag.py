"""Block-tridiagonal (odometry-chain) preconditioner via cyclic reduction.

Pose graphs are an odometry chain plus sparse loop closures: the
block-tridiagonal part of the (damped) normal matrix -- node diagonals plus
the couplings between consecutive nodes -- captures the dominant chain
stiffness exactly.  Solving that tridiagonal system as the PCG
preconditioner collapses the chain's long-wavelength modes that defeat
block-Jacobi (SURVEY §7 'preconditioner quality is the risk').

A sequential block-Thomas sweep would cost O(N) tiny dependent steps, each
a kernel launch on an accelerator.  **Block cyclic reduction** instead
eliminates odd-indexed blocks level by level: log2(N) levels, each a batch
of DxD inverses/matmuls over a halving array.  The block count is padded
to a power of two (identity blocks, decoupled), so every level has even
length and interleaving is a stack+reshape -- no gather/scatter anywhere.

Factors are built once per LM iteration and reused across CG iterations.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from slam_tpu.solver.linear import _inv_blocks
from slam_tpu.solver.linearize import BlockSystem
from slam_tpu.solver.problem import EdgeSet

Array = jax.Array


def extract_tridiag(
    system: BlockSystem, edges: EdgeSet, Hd: Array
) -> tuple[Array, Array]:
    """Damped diagonal blocks ``D (N,B,B)`` and super-diagonal blocks
    ``U (N-1,B,B)`` with ``U[i] = H[i, i+1]``.

    ``U`` sums the off-diagonal blocks of all consecutive-index edges,
    honouring orientation: an edge (a, b=a+1) contributes ``Hoff`` at
    position a; an edge (a, b=a-1) contributes ``Hoff^T`` at position b.
    Computed with an incidence matmul against a mask derived from ``ij`` --
    no scatter.
    """
    n = Hd.shape[0]
    a = edges.ij[:, 0]
    b = edges.ij[:, 1]
    E = edges.num_edges
    fwd = (b - a == 1).astype(Hd.dtype)   # a -> a+1
    rev = (a - b == 1).astype(Hd.dtype)   # b -> b+1 (transposed block)

    Hoff_flat = system.Hoff.reshape(E, -1)
    HoffT_flat = jnp.swapaxes(system.Hoff, -1, -2).reshape(E, -1)

    # scatter_a/scatter_b pick the right tier (index ops, full incidence,
    # or chain-compressed slices) per the EdgeSet's representation.
    U = edges.scatter_a(fwd[:, None] * Hoff_flat, n)
    U = U + edges.scatter_b(rev[:, None] * HoffT_flat, n)
    B = Hd.shape[-1]
    return Hd, U.reshape(n, B, B)[: n - 1]


# HIGHEST is pinned on every contraction here: the factors serve not only
# the PCG preconditioner (where error only slows convergence) but also the
# Woodbury direct solver (where chain-solve error lands in the answer).
_PREC = jax.lax.Precision.HIGHEST


def _bmm(x, y):
    return jnp.einsum("nij,njk->nik", x, y, precision=_PREC)


def _bmv(m, v):
    return jnp.einsum("nij,nj->ni", m, v, precision=_PREC)


def _bmv_t(m, v):
    return jnp.einsum("nji,nj->ni", m, v, precision=_PREC)


def _bmm_t(m, v):
    return jnp.einsum("nji,njk->nik", m, v, precision=_PREC)


def build_cr_factors(D: Array, U: Array):
    """Cyclic-reduction factorisation of the SPD block-tridiagonal (D, U).

    Returns ``(levels, root_inv, m, n)`` consumed by :func:`cr_solve`.
    Each level holds ``(Dinv_odd, U_left, U_right)`` where, for odd block
    ``j = 2t+1`` at that level, ``U_left[t] = U[2t]`` couples it to even
    ``2t`` and ``U_right[t] = U[2t+1]`` (zero-padded at the tail) couples
    it to even ``2t+2``.
    """
    n, B, _ = D.shape
    m = 1
    while m < n:
        m *= 2
    eye = jnp.eye(B, dtype=D.dtype)
    D = jnp.concatenate([D, jnp.tile(eye, (m - n, 1, 1))], axis=0)
    U = jnp.concatenate(
        [U, jnp.zeros((m - 1 - U.shape[0], B, B), D.dtype)], axis=0
    )

    levels = []
    while D.shape[0] > 1:
        t = D.shape[0] // 2
        D_even, D_odd = D[0::2], D[1::2]
        U_left = U[0::2]                        # (t, B, B)
        U_right = jnp.concatenate(             # (t, B, B), tail zero
            [U[1::2], jnp.zeros((1, B, B), D.dtype)], axis=0
        )[:t]
        Dinv_odd = _inv_blocks(D_odd)

        # Even-block updates:
        #  from right neighbour odd 2t'+1:  U_left Dinv U_left^T
        right_term = _bmm(_bmm(U_left, Dinv_odd),
                          jnp.swapaxes(U_left, -1, -2))
        #  from left neighbour odd 2t'-1:   U_right^T Dinv U_right, shifted
        left_src = _bmm(
            _bmm(jnp.swapaxes(U_right, -1, -2), Dinv_odd), U_right
        )
        left_term = jnp.concatenate(
            [jnp.zeros((1, B, B), D.dtype), left_src[: t - 1]], axis=0
        )
        D_new = D_even - right_term - left_term
        # Coupling even 2t' <-> even 2t'+2 through odd 2t'+1.
        U_new = -_bmm(_bmm(U_left, Dinv_odd), U_right)[: t - 1]

        levels.append((Dinv_odd, U_left, U_right))
        D, U = D_new, U_new

    root_inv = _inv_blocks(D)  # (1, B, B)
    return levels, root_inv, m, n


def cr_solve(factors, r: Array) -> Array:
    """Solve the block-tridiagonal system for ``r (N, B)``."""
    levels, root_inv, m, n = factors
    B = r.shape[-1]
    r = jnp.concatenate([r, jnp.zeros((m - n, B), r.dtype)], axis=0)

    # Forward reduction.
    odd_rhs = []
    for Dinv_odd, U_left, U_right in levels:
        r_even, r_odd = r[0::2], r[1::2]
        zp = _bmv(Dinv_odd, r_odd)
        right_term = _bmv(U_left, zp)
        left_term = jnp.concatenate(
            [jnp.zeros((1, B), r.dtype), _bmv_t(U_right, zp)[:-1]], axis=0
        )
        odd_rhs.append(r_odd)
        r = r_even - right_term - left_term

    z = _bmv(root_inv, r)

    # Back-substitution.
    for (Dinv_odd, U_left, U_right), r_odd in zip(
        reversed(levels), reversed(odd_rhs)
    ):
        t = r_odd.shape[0]
        z_even = z
        z_next = jnp.concatenate(
            [z_even[1:], jnp.zeros((1, B), z.dtype)], axis=0
        )
        rhs = r_odd - _bmv_t(U_left, z_even) - _bmv(U_right, z_next)
        z_odd = _bmv(Dinv_odd, rhs)
        z = jnp.stack([z_even, z_odd], axis=1).reshape(2 * t, B)

    return z[:n]


def cr_solve_mrhs(factors, r: Array) -> Array:
    """Solve the block-tridiagonal system for ``K`` right-hand sides at once:
    ``r (N, B, K)`` -> ``(N, B, K)``.

    Identical recursion to :func:`cr_solve` but every block-vector product
    becomes a batched ``(B,B) @ (B,K)`` matmul -- with K in the hundreds
    (the Woodbury solver's whitened closure columns) these are real
    matmuls, which is what makes one multi-RHS chain solve far cheaper
    than K sequential ones.
    """
    levels, root_inv, m, n = factors
    _, B, K = r.shape
    r = jnp.concatenate([r, jnp.zeros((m - n, B, K), r.dtype)], axis=0)

    odd_rhs = []
    for Dinv_odd, U_left, U_right in levels:
        r_even, r_odd = r[0::2], r[1::2]
        zp = _bmm(Dinv_odd, r_odd)
        right_term = _bmm(U_left, zp)
        left_term = jnp.concatenate(
            [jnp.zeros((1, B, K), r.dtype), _bmm_t(U_right, zp)[:-1]], axis=0
        )
        odd_rhs.append(r_odd)
        r = r_even - right_term - left_term

    z = _bmm(root_inv, r)

    for (Dinv_odd, U_left, U_right), r_odd in zip(
        reversed(levels), reversed(odd_rhs)
    ):
        t = r_odd.shape[0]
        z_even = z
        z_next = jnp.concatenate(
            [z_even[1:], jnp.zeros((1, B, K), z.dtype)], axis=0
        )
        rhs = r_odd - _bmm_t(U_left, z_even) - _bmm(U_right, z_next)
        z_odd = _bmm(Dinv_odd, rhs)
        z = jnp.stack([z_even, z_odd], axis=1).reshape(2 * t, B, K)

    return z[:n]

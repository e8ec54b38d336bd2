"""Linear solvers for the block-sparse normal equations ``(H + lam D) dx = -g``.

The reference delegates to Ceres' ``SPARSE_NORMAL_CHOLESKY``
(``DCS-ceres/main.cpp:156``).  Sparse direct Cholesky has no
good mapping onto batched accelerator kernels (irregular fill,
scalar-heavy pivoting), so we provide:

* ``dense``: materialise the weighted Jacobian via incidence matmuls and
  Cholesky-factor ``J^T W J``.  For pose graphs up to a few hundred nodes
  this is the simple choice: two big matmul-shaped kernels, no sparsity
  bookkeeping, no gather/scatter in the compiled program.
* ``pcg``: matrix-free preconditioned conjugate gradients.  The matvec is two
  incidence matmuls + batched 3x3-block products, preconditioned
  with the exactly-inverted block-Jacobi diagonal.  Scales to arbitrary N and
  is the building block of the distributed solver.

On CPU (tests) the same entry points fall back to XLA gather/segment_sum when
the EdgeSet carries no incidence matrices.

Vectors over the unknowns are carried as a pair ``(p, s)`` with ``p (N,D)``
pose updates and ``s (E,)`` switch updates (neutral slots solve to 0).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from slam_tpu.solver.linearize import BlockSystem
from slam_tpu.solver.problem import EdgeSet

Array = jax.Array

# Ceres clamps the LM diagonal to [1e-6, 1e32] (trust_region_strategy
# defaults); we adopt the same floor for the damping diagonal.
_DIAG_MIN = 1e-6
_DIAG_MAX = 1e32


class Update(NamedTuple):
    poses: Array     # (N, D) tangent-space pose updates
    switches: Array  # (E,)


def _damped_diag(system: BlockSystem, lam: Array) -> tuple[Array, Array]:
    """LM-damped diagonal blocks: ``Hdiag + lam * clip(diag(Hdiag))`` and the
    damped switch diagonal."""
    d = jnp.diagonal(system.Hdiag, axis1=-2, axis2=-1)
    damp = lam * jnp.clip(d, _DIAG_MIN, _DIAG_MAX)
    D = system.Hdiag.shape[-1]
    Hd = system.Hdiag + jnp.eye(D, dtype=d.dtype)[None] * damp[:, :, None]
    Hss = system.Hss + lam * jnp.clip(system.Hss, _DIAG_MIN, _DIAG_MAX)
    return Hd, Hss


def matvec(
    system: BlockSystem,
    edges: EdgeSet,
    Hd: Array,
    Hss: Array,
    x: Update,
) -> Update:
    """``y = (H + lam D) x`` using only block-sparse pieces.

    Off-diagonal action: for each edge ``e=(a,b)``, ``y[a] += Hoff_e @ x[b]``
    and ``y[b] += Hoff_e^T @ x[a]`` -- incidence gathers, batched (E,D,D)
    block products, incidence scatters.  Duplicate (a, b) pairs accumulate
    naturally.
    """
    n = Hd.shape[0]
    xp, xs = x

    y = jnp.einsum("nij,nj->ni", Hd, xp)
    xb = edges.gather_b(xp)
    xa = edges.gather_a(xp)
    contrib_a = jnp.einsum("eij,ej->ei", system.Hoff, xb)
    contrib_b = jnp.einsum("eji,ej->ei", system.Hoff, xa)
    y = y + edges.scatter_a(contrib_a, n)
    y = y + edges.scatter_b(contrib_b, n)

    # Switch couplings (zero unless SC).
    y = y + edges.scatter_a(system.Hps_a * xs[:, None], n)
    y = y + edges.scatter_b(system.Hps_b * xs[:, None], n)
    ys = Hss * xs
    ys = ys + jnp.einsum("ei,ei->e", system.Hps_a, xa)
    ys = ys + jnp.einsum("ei,ei->e", system.Hps_b, xb)
    return Update(poses=y, switches=ys)


def _inv_blocks(m: Array) -> Array:
    """Batched small-block inverse: closed-form adjugate for 3x3 (cheaper and
    more fusion-friendly than LU), ``jnp.linalg.inv`` for other widths."""
    if m.shape[-1] != 3:
        return jnp.linalg.inv(m)
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    D = -(b * i - c * h)
    E = a * i - c * g
    F = -(a * h - b * g)
    G = b * f - c * e
    H = -(a * f - c * d)
    I = a * e - b * d
    det = a * A + b * B + c * C
    inv_det = 1.0 / det
    adj = jnp.stack(
        [
            jnp.stack([A, D, G], -1),
            jnp.stack([B, E, H], -1),
            jnp.stack([C, F, I], -1),
        ],
        axis=-2,
    )
    return adj * inv_det[..., None, None]


def _dot(x: Update, y: Update) -> Array:
    return jnp.sum(x.poses * y.poses) + jnp.sum(x.switches * y.switches)


@partial(jax.jit, static_argnames=("max_iters", "preconditioner"))
def pcg_solve(
    system: BlockSystem,
    edges: EdgeSet,
    lam: Array,
    max_iters: int = 250,
    rtol: float = 1e-8,
    preconditioner: str = "tridiag",
) -> tuple[Update, Array]:
    """Preconditioned CG on the damped normal equations.

    ``preconditioner``: "tridiag" (block-tridiagonal odometry-chain solve
    via cyclic reduction -- see ``solver/tridiag.py``; the default) or
    "jacobi" (exactly-inverted node-diagonal blocks).  Returns
    ``(dx, iters_used)``.  Everything is a fixed-shape ``lax.while_loop``
    -- no host round-trips inside the solve.
    """
    Hd, Hss = _damped_diag(system, lam)
    Msinv = 1.0 / Hss

    if preconditioner == "tridiag":
        from slam_tpu.solver import tridiag as _td

        Dt, Ut = _td.extract_tridiag(system, edges, Hd)
        factors = _td.build_cr_factors(Dt, Ut)

        def precond(r: Update) -> Update:
            return Update(
                poses=_td.cr_solve(factors, r.poses),
                switches=Msinv * r.switches,
            )
    else:
        Minv = _inv_blocks(Hd)

        def precond(r: Update) -> Update:
            return Update(
                poses=jnp.einsum("nij,nj->ni", Minv, r.poses),
                switches=Msinv * r.switches,
            )

    bvec = Update(poses=-system.g, switches=-system.gs)
    x0 = Update(
        poses=jnp.zeros_like(bvec.poses), switches=jnp.zeros_like(bvec.switches)
    )
    r0 = bvec  # b - A*0
    z0 = precond(r0)
    p0 = z0
    rz0 = _dot(r0, z0)
    bnorm = jnp.sqrt(_dot(bvec, bvec)) + 1e-30
    tol2 = (rtol * bnorm) ** 2

    def cond(state):
        _, r, _, _, k, _ = state
        return (k < max_iters) & (_dot(r, r) > tol2)

    def body(state):
        x, r, p, rz, k, _ = state
        Ap = matvec(system, edges, Hd, Hss, p)
        alpha = rz / (_dot(p, Ap) + 1e-30)
        x = Update(x.poses + alpha * p.poses, x.switches + alpha * p.switches)
        r = Update(r.poses - alpha * Ap.poses, r.switches - alpha * Ap.switches)
        z = precond(r)
        rz_new = _dot(r, z)
        beta = rz_new / (rz + 1e-30)
        p = Update(z.poses + beta * p.poses, z.switches + beta * p.switches)
        return (x, r, p, rz_new, k + 1, k + 1)

    x, _, _, _, _, iters = jax.lax.while_loop(
        cond, body, (x0, r0, p0, rz0, jnp.int32(0), jnp.int32(0))
    )
    return x, iters


def eliminate_switches(system: BlockSystem, edges: EdgeSet, lam: Array):
    """Exactly eliminate the switch unknowns from the damped joint system.

    ``Hss`` is DIAGONAL (each switch couples only to its own edge's
    residual and prior, ``ceres_error.cpp:226-317``), so the Schur
    complement onto poses is a closed-form per-edge correction that fits
    the existing :class:`BlockSystem` sparsity exactly: the switch of edge
    ``e=(a,b)`` corrects ``Hdiag[a]``, ``Hdiag[b]``, the edge's own
    ``Hoff[e]`` block, and ``g[a]/g[b]`` -- O(E) work, no new structure.
    This is what lets method 2 (joint SC) ride the partitioned Schur /
    PCG pose solvers at M3500+ scale instead of capping at the dense path.

    Returns ``(reduced_system, backsub)`` where ``backsub(xp) -> xs``
    recovers the switch updates.  The elimination uses the DAMPED switch
    diagonal (the joint system's own damping); the pose damping applied by
    the downstream solver then acts on the *reduced* diagonal -- a
    legitimate damped system with the same ``lam -> 0`` fixed points as
    the joint one (LM damping is a trust-region heuristic, not part of the
    objective), verified against the joint dense solve at small lam.
    """
    E = system.Hss.shape[0]
    n = system.Hdiag.shape[0]
    D = system.Hdiag.shape[-1]
    Hss_d = system.Hss + lam * jnp.clip(system.Hss, _DIAG_MIN, _DIAG_MAX)
    inv = 1.0 / Hss_d                                   # (E,)
    gs_inv = system.gs * inv                            # (E,)

    ca = -(system.Hps_a[:, :, None] * system.Hps_a[:, None, :]
           ) * inv[:, None, None]                       # (E, D, D)
    cb = -(system.Hps_b[:, :, None] * system.Hps_b[:, None, :]
           ) * inv[:, None, None]
    Hdiag = (
        system.Hdiag
        + edges.scatter_a(ca.reshape(E, D * D), n).reshape(n, D, D)
        + edges.scatter_b(cb.reshape(E, D * D), n).reshape(n, D, D)
    )
    Hoff = system.Hoff - (
        system.Hps_a[:, :, None] * system.Hps_b[:, None, :]
    ) * inv[:, None, None]
    g = (
        system.g
        - edges.scatter_a(system.Hps_a * gs_inv[:, None], n)
        - edges.scatter_b(system.Hps_b * gs_inv[:, None], n)
    )
    reduced = system._replace(
        Hdiag=Hdiag, Hoff=Hoff, g=g,
        Hps_a=jnp.zeros_like(system.Hps_a),
        Hps_b=jnp.zeros_like(system.Hps_b),
        Hss=jnp.ones_like(system.Hss),
        gs=jnp.zeros_like(system.gs),
    )

    def backsub(xp: Array) -> Array:
        xa = edges.gather_a(xp)
        xb = edges.gather_b(xp)
        return -(system.gs
                 + jnp.einsum("ei,ei->e", system.Hps_a, xa)
                 + jnp.einsum("ei,ei->e", system.Hps_b, xb)) * inv

    return reduced, backsub


def dense_solve(
    system: BlockSystem,
    edges: EdgeSet,
    lam: Array,
    include_switches: bool = False,
) -> Update:
    """Dense normal-equation Cholesky.

    With incidence matrices (accelerator path) the weighted Jacobian is materialised
    as ``Jd[e,k,(n,j)] = Ja[e,k,j] inc_a[e,n] + Jb[e,k,j] inc_b[e,n]`` --
    broadcast multiplies, no scatter -- and ``H = A^T A`` with
    ``A = sqrt(w) Jd`` is one matmul.  Without them (CPU path) the blocks are
    scatter-added into the dense matrix.  With ``include_switches`` the
    system is extended by one scalar column/row per edge (frozen rows solve
    to 0 harmlessly).
    """
    if edges.inc_a is not None and edges.inc_a.shape[0] == edges.num_edges:
        return _dense_solve_matmul(system, edges, lam, include_switches)
    if edges.inc_a is not None:
        raise ValueError(
            "dense solver needs FULL incidence; chain-compressed EdgeSets "
            "are for the matvec/linearize paths (incidence=True)"
        )
    return _dense_solve_scatter(system, edges, lam, include_switches)


def _finish_dense(H, rhs, n, D, E, include_switches, dtype,
                  coord_major=False):
    # Jacobi equilibration improves f32 conditioning markedly.
    dscale = 1.0 / jnp.sqrt(jnp.clip(jnp.diagonal(H), 1e-12, None))
    Hs = H * dscale[:, None] * dscale[None, :]
    factor = jax.scipy.linalg.cho_factor(Hs, lower=True)
    sol = jax.scipy.linalg.cho_solve(factor, rhs * dscale) * dscale
    if coord_major:
        dp = sol[: D * n].reshape(D, n).T
    else:
        dp = sol[: D * n].reshape(n, D)
    ds = sol[D * n :] if include_switches else jnp.zeros((E,), dtype)
    return Update(poses=dp, switches=ds)


def _dense_solve_matmul(
    system: BlockSystem,
    edges: EdgeSet,
    lam: Array,
    include_switches: bool,
) -> Update:
    E, R, D = system.Ja.shape
    n = system.Hdiag.shape[0]
    dtype = system.Ja.dtype

    # Dense Jacobian rows from per-edge blocks -- broadcast, no scatter.
    # Unknowns are ordered COORDINATE-MAJOR (x = [all x0.., all x1.., ...],
    # flat index j*n + node): the materialised Jacobian then has the large
    # node axis trailing, so tiled layouts pad it benignly; a node-major
    # layout would put a 3-wide axis last.
    Jd = (
        system.Ja[:, :, :, None] * edges.inc_a[:, None, None, :]
        + system.Jb[:, :, :, None] * edges.inc_b[:, None, None, :]
    ).reshape(E * R, D * n)
    wsqrt = jnp.sqrt(system.w)
    wr = jnp.repeat(wsqrt, R)  # per-row weights
    if include_switches:
        eyeE = jnp.eye(E, dtype=dtype)
        Jsw = (system.Js[:, :, None] * eyeE[:, None, :]).reshape(E * R, E)
        Jd = jnp.concatenate([Jd, Jsw], axis=1)
    A = Jd * wr[:, None]
    # precision='highest': the normal equations are squared-conditioned; a
    # reduced-precision (bf16 or TF32) matmul here would destroy the
    # factorisation.
    H = jnp.matmul(A.T, A, precision=jax.lax.Precision.HIGHEST,
                   preferred_element_type=dtype)
    rflat = (system.r * wsqrt[:, None]).reshape(E * R)
    g = jnp.matmul(A.T, rflat, precision=jax.lax.Precision.HIGHEST,
                   preferred_element_type=dtype)

    # Diagonal extras that A^T A does not carry, matching linearize():
    # identity on gauge-fixed / fully-masked pose columns (their diagonal is
    # exactly 0 since the Jacobian columns were zeroed), and for SC the
    # switch-prior lambda on live slots / identity on frozen slots.
    dim = H.shape[0]
    base_diag = jnp.diagonal(H)
    extra = jnp.zeros((dim,), dtype)
    pose_part = base_diag[: n * D]
    extra = extra.at[: n * D].set(jnp.where(pose_part == 0.0, 1.0, 0.0))
    if include_switches:
        live = edges.active * edges.is_loop.astype(dtype)
        extra = extra.at[n * D :].set(live * _sc_lam(system) + (1.0 - live))
        # Prior gradient contribution (gs minus its measurement part).
        g = g.at[n * D :].add(
            system.gs - system.w * jnp.einsum("ei,ei->e", system.Js, system.r)
        )
    eye = jnp.eye(dim, dtype=dtype)
    H = H + eye * extra[None, :]
    d0 = jnp.diagonal(H)
    H = H + eye * (lam * jnp.clip(d0, _DIAG_MIN, _DIAG_MAX))[None, :]
    return _finish_dense(H, -g, n, D, E, include_switches, dtype,
                         coord_major=True)


def _sc_lam(system: BlockSystem) -> Array:
    """Recover the switch-prior lambda from the assembled switch diagonal:
    ``Hss_live = w * |Js|^2 + lam``."""
    meas = system.w * jnp.sum(system.Js**2, axis=-1)
    return system.Hss - meas


def _dense_solve_scatter(
    system: BlockSystem,
    edges: EdgeSet,
    lam: Array,
    include_switches: bool,
) -> Update:
    n = system.Hdiag.shape[0]
    D = system.Hdiag.shape[-1]
    E = edges.num_edges
    dtype = system.Hdiag.dtype
    Hd, Hss = _damped_diag(system, lam)

    dim = D * n + (E if include_switches else 0)
    H = jnp.zeros((dim, dim), dtype)

    node_rows = (D * jnp.arange(n)[:, None, None] + jnp.arange(D)[None, :, None])
    node_cols = (D * jnp.arange(n)[:, None, None] + jnp.arange(D)[None, None, :])
    H = H.at[
        jnp.broadcast_to(node_rows, (n, D, D)),
        jnp.broadcast_to(node_cols, (n, D, D)),
    ].add(Hd)

    a = edges.ij[:, 0]
    b = edges.ij[:, 1]
    ra = D * a[:, None, None] + jnp.arange(D)[None, :, None]
    cb = D * b[:, None, None] + jnp.arange(D)[None, None, :]
    H = H.at[
        jnp.broadcast_to(ra, (E, D, D)), jnp.broadcast_to(cb, (E, D, D))
    ].add(system.Hoff)
    rb = D * b[:, None, None] + jnp.arange(D)[None, :, None]
    ca = D * a[:, None, None] + jnp.arange(D)[None, None, :]
    H = H.at[
        jnp.broadcast_to(rb, (E, D, D)), jnp.broadcast_to(ca, (E, D, D))
    ].add(jnp.swapaxes(system.Hoff, -1, -2))

    rhs = -system.g.reshape(-1)
    if include_switches:
        srow = D * n + jnp.arange(E)
        H = H.at[srow, srow].add(Hss)
        colsD = jnp.arange(D)
        H = H.at[
            jnp.broadcast_to(srow[:, None], (E, D)),
            D * a[:, None] + colsD[None, :],
        ].add(system.Hps_a)
        H = H.at[
            D * a[:, None] + colsD[None, :],
            jnp.broadcast_to(srow[:, None], (E, D)),
        ].add(system.Hps_a)
        H = H.at[
            jnp.broadcast_to(srow[:, None], (E, D)),
            D * b[:, None] + colsD[None, :],
        ].add(system.Hps_b)
        H = H.at[
            D * b[:, None] + colsD[None, :],
            jnp.broadcast_to(srow[:, None], (E, D)),
        ].add(system.Hps_b)
        rhs = jnp.concatenate([rhs, -system.gs])

    return _finish_dense(H, rhs, n, D, E, include_switches, dtype)

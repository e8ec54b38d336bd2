"""Chain + low-rank Woodbury direct solver.

A pose graph is an odometry *chain* plus sparse loop closures
(``DCS-ceres/g2o_util.h:68``: consecutive indices are
odometry).  The damped normal matrix therefore splits exactly as

    H + lam D = T + U U^T

where ``T`` is the block-tridiagonal part (all consecutive-index edges plus
every diagonal/damping/gauge term of the *chain*) and ``U`` stacks the
whitened Jacobian columns of the ``C`` non-consecutive edges (3 columns per
edge for SE(2)).  The Woodbury identity turns the solve into

    x = T^{-1} b - T^{-1} U (I + U^T T^{-1} U)^{-1} U^T T^{-1} b

-- one multi-RHS block-tridiagonal solve (cyclic reduction, log-depth,
batched (3,3)@(3,K) matmuls; ``solver/tridiag.py``) plus one small dense
``K x K`` Cholesky, ``K = 3C`` (INTEL+50: K = 918 vs 3N = 3684).

**Earlier verdict: negative.**  The multi-RHS CR solve streams
(N,3,K)-sized tensors through every reduction level (memory bound, far
slower than Schur on the bench workload before the GPU port; not
re-measured on the GPU) and the f32 correction ``z - W y`` cancels
catastrophically when closures carry most of the stiffness.  Kept as an
exact, tested solver (f64/CPU-clean; ``--linear-solver woodbury``); the
partitioned Schur path remains the default.

Exactness: ``T`` is built by *subtracting* the non-chain edges' diagonal
blocks from the assembled ``Hdiag`` (which `linearize` accumulated over all
edges), so ``T + U U^T`` reproduces the damped system bit-for-bit in exact
arithmetic; `test_woodbury.py` pins agreement with the dense solver to
1e-9 in f64.

Like the distributed/Schur paths this supports robust modes without extra
unknowns ("none"/"dcs"/"sc_varpro"); joint SC carries switch variables and
uses dense/pcg.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from slam_tpu.solver import tridiag
from slam_tpu.solver.linear import Update, _damped_diag
from slam_tpu.solver.linearize import BlockSystem
from slam_tpu.solver.problem import EdgeSet

Array = jax.Array
_PREC = jax.lax.Precision.HIGHEST


class WoodburyOps(NamedTuple):
    """Static per-graph operators (host-built one-hots, like SchurPartition
    a pytree of device buffers, not jit constants).

    * ``sel``:   (C, E) one-hot picking the non-chain ("low-rank") edges
    * ``inc_a``: (C, N) one-hot of those edges' a-endpoints
    * ``inc_b``: (C, N) one-hot of their b-endpoints
    """

    sel: Array
    inc_a: Array
    inc_b: Array

    @property
    def num_lowrank(self) -> int:
        return self.sel.shape[0]


def build_woodbury_ops(
    ij: np.ndarray, n: int, dtype=jnp.float32, pad_to: int | None = None
) -> WoodburyOps:
    """Classify edges: |a-b| == 1 lives in the tridiagonal ``T`` (whatever
    its type -- consecutive bogus edges fit the bandwidth for free); all
    other edges (loop closures, bogus, and any |a-b| in 2..4 odometry the
    reference's <5 rule admits) become Woodbury columns.

    ``pad_to`` pads the low-rank count with all-zero rows (zero U columns
    make identity core rows -- exactly neutral) so independently seeded
    problems share shapes and can be vmapped together."""
    ij = np.asarray(ij)
    span = np.abs(ij[:, 0].astype(np.int64) - ij[:, 1].astype(np.int64))
    idx = np.where(span != 1)[0]
    c = len(idx)
    if pad_to is not None:
        assert pad_to >= c, (pad_to, c)
        c = pad_to
    e = ij.shape[0]
    sel = np.zeros((c, e), np.float32)
    k = np.arange(len(idx))
    sel[k, idx] = 1.0
    inc_a = np.zeros((c, n), np.float32)
    inc_a[k, ij[idx, 0]] = 1.0
    inc_b = np.zeros((c, n), np.float32)
    inc_b[k, ij[idx, 1]] = 1.0
    return WoodburyOps(
        sel=jnp.asarray(sel, dtype),
        inc_a=jnp.asarray(inc_a, dtype),
        inc_b=jnp.asarray(inc_b, dtype),
    )


def woodbury_solve(
    system: BlockSystem,
    edges: EdgeSet,
    ops: WoodburyOps,
    lam: Array,
) -> Update:
    """Solve ``(H + lam D) dx = -g`` exactly via chain + low-rank Woodbury."""
    n, B, _ = system.Hdiag.shape
    E, R, _ = system.Ja.shape
    dtype = system.Hdiag.dtype
    sel = ops.sel.astype(dtype)
    inc_a = ops.inc_a.astype(dtype)
    inc_b = ops.inc_b.astype(dtype)
    C = sel.shape[0]
    K = C * R

    Hd, _ = _damped_diag(system, lam)
    D, Uoff = tridiag.extract_tridiag(system, edges, Hd)

    # Remove the non-chain edges' diagonal contributions from T: they are
    # carried by U U^T instead.  (1 - chain) masks exactly the edges in
    # ``sel``; weights/active/gauge masking already live in Ja/Jb/w.
    a, b = edges.ij[:, 0], edges.ij[:, 1]
    chain = (jnp.abs(a - b) == 1).astype(dtype)
    nc_w = (1.0 - chain) * system.w
    Haa = nc_w[:, None, None] * jnp.einsum(
        "eki,ekj->eij", system.Ja, system.Ja, precision=_PREC)
    Hbb = nc_w[:, None, None] * jnp.einsum(
        "eki,ekj->eij", system.Jb, system.Jb, precision=_PREC)
    D = D - edges.scatter_a(Haa.reshape(E, -1), n).reshape(n, B, B)
    D = D - edges.scatter_b(Hbb.reshape(E, -1), n).reshape(n, B, B)

    factors = tridiag.build_cr_factors(D, Uoff)
    bvec = -system.g  # (N, B)

    if C == 0:
        dp = tridiag.cr_solve(factors, bvec)
        return Update(poses=dp, switches=jnp.zeros((E,), dtype))

    # Whitened low-rank columns: U[n, i, (c,k)] = sqrt(w_c) J{a|b}[c, k, i]
    # at the edge's endpoint rows.  One-hot matmuls only -- no gather.
    sqw = jnp.sqrt(jnp.maximum(system.w, 0.0))
    JaL = jnp.einsum("ce,eki->cki", sel, sqw[:, None, None] * system.Ja,
                     precision=_PREC)
    JbL = jnp.einsum("ce,eki->cki", sel, sqw[:, None, None] * system.Jb,
                     precision=_PREC)
    U = (
        jnp.einsum("cn,cki->nick", inc_a, JaL, precision=_PREC)
        + jnp.einsum("cn,cki->nick", inc_b, JbL, precision=_PREC)
    ).reshape(n, B, K)

    # One multi-RHS chain solve for [b | U].
    rhs = jnp.concatenate([bvec[:, :, None], U], axis=-1)
    Y = tridiag.cr_solve_mrhs(factors, rhs)
    z, W = Y[:, :, 0], Y[:, :, 1:]

    # Dense K x K core.
    Uf = U.reshape(n * B, K)
    Wf = W.reshape(n * B, K)
    core = jnp.eye(K, dtype=dtype) + jnp.matmul(
        Uf.T, Wf, precision=_PREC, preferred_element_type=dtype)
    rhs_core = jnp.matmul(Uf.T, z.reshape(n * B), precision=_PREC,
                          preferred_element_type=dtype)
    factor = jax.scipy.linalg.cho_factor(core, lower=True)
    y = jax.scipy.linalg.cho_solve(factor, rhs_core)

    dp = z - jnp.einsum("nbk,k->nb", W, y, precision=_PREC)
    return Update(poses=dp, switches=jnp.zeros((E,), dtype))

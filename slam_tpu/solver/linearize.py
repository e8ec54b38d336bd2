"""Batched residual evaluation and normal-equation assembly.

This is the hot loop of the whole framework: what Ceres does per LM iteration
with per-edge autodiff functors and a sparse-matrix build
(``DCS-ceres/main.cpp:154-163``), done here as one fused
batched pass over all edges:

    gather 2 poses per edge -> closed-form residual + analytic Jacobians
    -> DCS / switchable scaling (differentiated through)
    -> Huber IRLS weight -> per-edge 3x3 H blocks + gradient -> segment-sum

The output is a *block-sparse* normal system: node-diagonal blocks
``Hdiag (N,3,3)``, per-edge off-diagonal blocks ``Hoff (E,3,3)`` (at (a, b)),
and gradient ``g (N,3)``.  Downstream solvers consume this either by
scattering to dense (small graphs) or via matrix-free matvecs (PCG/Schur).

All robustness semantics match the reference -- see
``slam_tpu/robust/kernels.py`` for the mapping.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from slam_tpu.robust import kernels
from slam_tpu.solver.problem import EdgeSet, FreeMask

Array = jax.Array


class BlockSystem(NamedTuple):
    """Block-sparse Gauss-Newton system ``H dx = -g`` plus the current cost.

    Block width D is the model's tangent dimension (3 for SE(2), 6 for
    SE(3)); shapes below are written for D=3.

    Switch-variable entries (``Hss``, ``gs``, couplings) are populated only
    for ``robust='sc'``; otherwise they are neutral (identity / zero) and
    solvers skip them statically.
    """

    Hdiag: Array   # (N, 3, 3) node-diagonal blocks
    Hoff: Array    # (E, 3, 3) off-diagonal block of edge e at (a_e, b_e)
    g: Array       # (N, 3) gradient J^T W r
    cost: Array    # scalar: 0.5 * sum rho(|r|^2) (Ceres cost convention)
    # Per-edge linearisation pieces (cheap: O(E*9)); the dense solver builds
    # J directly from these via incidence matmuls, and the Schur solver
    # re-blocks them.
    Ja: Array      # (E, R, D) Jacobian wrt endpoint a (robust-scaled, gauged)
    Jb: Array      # (E, R, D) Jacobian wrt endpoint b
    r: Array       # (E, R) robust-scaled residual
    w: Array       # (E,) Huber IRLS weight * active
    # Switchable-constraints extension (one switch slot per edge; non-loop
    # and inactive slots are frozen with Hss=1, gs=0).
    Js: Array      # (E, R) residual Jacobian wrt the switch variable
    Hps_a: Array   # (E, 3) coupling H[pose_a, s_e]
    Hps_b: Array   # (E, 3) coupling H[pose_b, s_e]
    Hss: Array     # (E,) switch diagonal
    gs: Array      # (E,) switch gradient


def linearize(
    poses: Array,
    switches: Array,
    edges: EdgeSet,
    free: FreeMask,
    *,
    model,
    robust: str,
    dcs_phi: float,
    huber_delta: float,
    sc_prior_lambda: float,
    fixed_identity_scale: float = 1.0,
) -> BlockSystem:
    """Linearise the robust pose-graph objective at ``poses`` (+``switches``).

    ``robust`` is static: "none" (method 0), "dcs" (method 1) or "sc"
    (method 2), applied to loop edges only -- odometry edges always use the
    plain residual (``main.cpp:95-100``).

    ``fixed_identity_scale`` scales the identity placed on fixed-node
    diagonals; distributed callers that psum partial systems over an axis of
    size P pass ``1/P`` so the summed system carries exactly one identity.
    """
    n = poses.shape[0]
    dtype = poses.dtype
    pa = edges.gather_a(poses)
    pb = edges.gather_b(poses)

    e, Ja, Jb = model.residual_and_jacobians(pa, pb, edges.meas)

    # Gauge projection: zero Jacobian columns of fixed nodes so every H/g
    # entry touching them vanishes (equivalent to SetParameterBlockConstant).
    fa = edges.gather_a(free.node)[:, None, None]
    fb = edges.gather_b(free.node)[:, None, None]
    Ja = Ja * fa
    Jb = Jb * fb

    loop = edges.is_loop
    loop_f = loop.astype(dtype)

    Js = jnp.zeros_like(e)  # d r / d s  (zero unless SC)
    if robust == "dcs":
        ed, Jad, Jbd = kernels.dcs_scale(e, Ja, Jb, dcs_phi, dims=model.dcs_dims)
        m = loop_f[:, None]
        mm = loop_f[:, None, None]
        e = m * ed + (1 - m) * e
        Ja = mm * Jad + (1 - mm) * Ja
        Jb = mm * Jbd + (1 - mm) * Jb
    elif robust == "sc":
        es, Jas, Jbs, Jss = kernels.switch_scale(e, Ja, Jb, switches)
        m = loop_f[:, None]
        mm = loop_f[:, None, None]
        Js = m * Jss
        e = m * es + (1 - m) * e
        Ja = mm * Jas + (1 - mm) * Ja
        Jb = mm * Jbs + (1 - mm) * Jb
    elif robust == "sc_varpro":
        ev, Jav, Jbv = kernels.sc_varpro_scale(e, Ja, Jb, sc_prior_lambda)
        m = loop_f[:, None]
        mm = loop_f[:, None, None]
        e = m * ev + (1 - m) * e
        Ja = mm * Jav + (1 - mm) * Ja
        Jb = mm * Jbv + (1 - mm) * Jb
    elif robust != "none":
        raise ValueError(f"unknown robust mode {robust!r}")

    # Huber IRLS weight on the (possibly scaled) residual block output.
    s2 = jnp.sum(e * e, axis=-1)
    w = kernels.huber_weight(s2, huber_delta) * edges.active
    cost = 0.5 * jnp.sum(edges.active * kernels.huber_rho(s2, huber_delta))

    # Per-edge weighted blocks; einsum keeps everything batched.
    wj = w[:, None, None]
    Haa = wj * jnp.einsum("eki,ekj->eij", Ja, Ja)
    Hbb = wj * jnp.einsum("eki,ekj->eij", Jb, Jb)
    Hoff = wj * jnp.einsum("eki,ekj->eij", Ja, Jb)
    ga = w[:, None] * jnp.einsum("eki,ek->ei", Ja, e)
    gb = w[:, None] * jnp.einsum("eki,ek->ei", Jb, e)

    Hdiag = edges.scatter_a(Haa, n) + edges.scatter_b(Hbb, n)
    g = edges.scatter_a(ga, n) + edges.scatter_b(gb, n)

    # Keep fixed-node diagonals identity so solvers stay nonsingular; the
    # corresponding g rows are already zero, hence dx = 0 there.
    D = model.tangent_dim
    fixed = (1.0 - free.node)[:, None, None] * jnp.eye(D, dtype=dtype)
    Hdiag = Hdiag + fixed_identity_scale * fixed

    if robust == "sc":
        live = edges.active * loop_f
        # Couplings between pose blocks and this edge's switch variable.
        Hps_a = w[:, None] * jnp.einsum("eki,ek->ei", Ja, Js)
        Hps_b = w[:, None] * jnp.einsum("eki,ek->ei", Jb, Js)
        Hss_meas = w * jnp.sum(Js * Js, axis=-1)
        gs_meas = w * jnp.sum(Js * e, axis=-1)
        # Switch prior sqrt(lambda)(1 - s), no loss (``main.cpp:124-125``).
        lam = sc_prior_lambda
        prior_r = kernels.switch_prior_residual(switches, lam)
        cost = cost + 0.5 * jnp.sum(live * prior_r * prior_r)
        Hss = live * (Hss_meas + lam) + (1.0 - live)  # frozen slots -> 1
        gs = live * (gs_meas - jnp.sqrt(lam) * prior_r)
        Hps_a = live[:, None] * Hps_a
        Hps_b = live[:, None] * Hps_b
    else:
        E = edges.num_edges
        Hps_a = jnp.zeros((E, model.tangent_dim), dtype)
        Hps_b = jnp.zeros((E, model.tangent_dim), dtype)
        Hss = jnp.ones((E,), dtype)
        gs = jnp.zeros((E,), dtype)

    return BlockSystem(
        Hdiag=Hdiag, Hoff=Hoff, g=g, cost=cost,
        Ja=Ja, Jb=Jb, r=e, w=w, Js=Js,
        Hps_a=Hps_a, Hps_b=Hps_b, Hss=Hss, gs=gs,
    )


def cost_only(
    poses: Array,
    switches: Array,
    edges: EdgeSet,
    *,
    model,
    robust: str,
    dcs_phi: float,
    huber_delta: float,
    sc_prior_lambda: float,
) -> Array:
    """Objective value only (for LM step accept/reject) -- no Jacobians."""
    dtype = poses.dtype
    pa = edges.gather_a(poses)
    pb = edges.gather_b(poses)
    e = model.residual(pa, pb, edges.meas)
    loop_f = edges.is_loop.astype(dtype)
    if robust == "dcs":
        psi = kernels.dcs_psi(e, dcs_phi, dims=model.dcs_dims)
        scale = loop_f * psi + (1 - loop_f)
        e = scale[:, None] * e
    elif robust == "sc":
        scale = loop_f * switches + (1 - loop_f)
        e = scale[:, None] * e
    elif robust == "sc_varpro":
        psi = kernels.sc_varpro_switch(e, sc_prior_lambda)
        scale = loop_f * psi + (1 - loop_f)
        e = scale[:, None] * e
    s2 = jnp.sum(e * e, axis=-1)
    cost = 0.5 * jnp.sum(edges.active * kernels.huber_rho(s2, huber_delta))
    if robust == "sc":
        live = edges.active * loop_f
        pr = kernels.switch_prior_residual(switches, sc_prior_lambda)
        cost = cost + 0.5 * jnp.sum(live * pr * pr)
    return cost


def loop_psi(poses: Array, edges: EdgeSet, model, phi: float) -> Array:
    """Per-edge DCS psi at ``poses`` (all edges; mask with
    ``edges.is_loop``/``edges.active`` as needed).  Uses the solver's own
    psi semantics: RAW xy residual, no information weighting
    (``ceres_error.cpp:186``)."""
    pa = edges.gather_a(poses)
    pb = edges.gather_b(poses)
    e = model.residual(pa, pb, edges.meas)
    return kernels.dcs_psi(e, phi, dims=model.dcs_dims)


def loop_psi_mean(poses: Array, edges: EdgeSet, model, phi: float) -> Array:
    """Mean DCS psi over live loop edges at ``poses`` -- the closure-dropout
    probe for the auto-retry policy (SolverConfig.dcs_auto_retry)."""
    psi = loop_psi(poses, edges, model, phi)
    live = edges.active * edges.is_loop.astype(poses.dtype)
    return jnp.sum(live * psi) / jnp.maximum(jnp.sum(live), 1.0)


def edge_residuals(poses: Array, edges: EdgeSet, model=None) -> Array:
    """Raw (unscaled) residuals for all edges at given poses -- used by the
    layering methods' residual feedback (``layer_manager.cpp:181-228``)."""
    from slam_tpu.geometry import se2
    if model is None:
        return se2.residual(
            poses[edges.ij[:, 0]], poses[edges.ij[:, 1]], edges.meas
        )
    return model.residual(
        poses[edges.ij[:, 0]], poses[edges.ij[:, 1]], edges.meas
    )


def edge_mahalanobis(poses: Array, edges: EdgeSet) -> Array:
    """Per-edge Mahalanobis distance ``sqrt(r^T Omega r)``.

    Used by method 4's outlier gate (``simple_layer_manager.cpp:388-442``).
    Note the reference's gate computes r with a small-angle approximation and
    a wrapped angle; we use the exact residual with a wrapped angle, which
    agrees to first order.
    """
    r = edge_residuals(poses, edges)
    i = edges.info
    # r^T Omega r expanded from the 6 upper-tri entries.
    q = (
        i[:, 0] * r[:, 0] ** 2
        + i[:, 3] * r[:, 1] ** 2
        + i[:, 5] * r[:, 2] ** 2
        + 2.0 * i[:, 1] * r[:, 0] * r[:, 1]
        + 2.0 * i[:, 2] * r[:, 0] * r[:, 2]
        + 2.0 * i[:, 4] * r[:, 1] * r[:, 2]
    )
    return jnp.sqrt(jnp.maximum(q, 0.0))


def edge_info_gain(edges: EdgeSet) -> Array:
    """D-opt proxy ``0.5 * logdet(I + Omega)`` per edge
    (``layer_manager.cpp:284-298``)."""
    i = edges.info
    O = jnp.stack(
        [
            jnp.stack([i[:, 0], i[:, 1], i[:, 2]], -1),
            jnp.stack([i[:, 1], i[:, 3], i[:, 4]], -1),
            jnp.stack([i[:, 2], i[:, 4], i[:, 5]], -1),
        ],
        axis=-2,
    )
    eye = jnp.eye(3, dtype=i.dtype)
    sign, logdet = jnp.linalg.slogdet(eye + O)
    return 0.5 * logdet


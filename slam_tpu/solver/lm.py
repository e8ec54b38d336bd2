"""Levenberg-Marquardt trust-region loop as a pure jitted function.

Replaces the Ceres minimizer the reference invokes at
``DCS-ceres/main.cpp:163``.  Design:

* The whole loop is a ``lax.while_loop`` over a small pytree state -- one
  compilation, zero host round-trips per iteration, which is what makes
  "optimizer iterations/s" a meaningful device metric.
* Damping follows Marquardt scaling with the Nielsen lambda update
  (accept: ``lam *= max(1/3, 1 - (2*rho - 1)^3)``; reject: ``lam *= nu``,
  ``nu *= 2``).  The reference relies on Ceres' default trust-region LM; we
  match its *fixed points* (same stationary equations), not its exact path.
* The model reduction for the gain ratio uses the identity
  ``m = 0.5 * dx^T (lam*D*dx - g)`` valid when ``(H + lam D) dx = -g``,
  avoiding an extra matvec.
* On rejection we keep the linearisation implicitly (it is recomputed at the
  unchanged point next iteration): simpler state, identical trajectory.

DCS semantics note: psi is inside the residual and differentiated through
(see ``robust/kernels.py``), so each LM iteration re-linearises the robust
weighting exactly like the reference (SURVEY §3.1 "defining DCS behavior").
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from slam_tpu.config import SolverConfig
from slam_tpu.solver import linear
from slam_tpu.solver.linearize import cost_only, linearize
from slam_tpu.solver.models import SE2Model
from slam_tpu.solver.problem import EdgeSet, FreeMask

Array = jax.Array


class LMState(NamedTuple):
    poses: Array      # (N, 3)
    switches: Array   # (E,)
    cost: Array       # scalar current cost
    lam: Array        # LM damping
    nu: Array         # rejection growth factor
    it: Array         # iterations executed
    accepted: Array   # accepted steps
    converged: Array  # bool
    lin_iters: Array  # cumulative inner (PCG) iterations


class LMResult(NamedTuple):
    poses: Array
    switches: Array
    cost: Array
    initial_cost: Array
    iterations: Array
    accepted: Array
    converged: Array
    lin_iters: Array
    # Final damping state -- thread back in via lm_fixed_iters(lam0=, nu0=,
    # it0=) to continue a chunked solve without resetting the trust region
    # (or the GNC anneal position).  nu matters too: consecutive rejections
    # straddling a chunk boundary must keep doubling the growth factor.
    final_lambda: Array | None = None
    final_nu: Array | None = None


def _gnc_phi(cfg: SolverConfig, it: Array, dtype) -> Array | float:
    """Annealed DCS phi at iteration ``it`` (graduated non-convexity).

    ``phi * scale^(1 - min(it, K)/K)``: starts at ``phi*scale``, decays
    geometrically to ``phi`` by iteration K, constant after.  Returns the
    plain config value when GNC is off so the static-phi program is
    unchanged.
    """
    K = cfg.gnc_anneal_iters
    if not K or cfg.robust != "dcs":
        return cfg.dcs_phi
    frac = jnp.minimum(it.astype(dtype) / K, 1.0)
    return cfg.dcs_phi * jnp.asarray(cfg.gnc_init_scale, dtype) ** (1.0 - frac)


def _solve_linear(system, edges, lam, cfg: SolverConfig, partition=None):
    if cfg.linear_solver == "dense":
        dx = linear.dense_solve(
            system, edges, lam, include_switches=(cfg.robust == "sc")
        )
        return dx, jnp.int32(0)
    elif cfg.linear_solver == "pcg":
        return linear.pcg_solve(
            system, edges, lam, max_iters=cfg.pcg_max_iters,
            rtol=cfg.pcg_rtol,
            preconditioner=getattr(cfg, "pcg_preconditioner", "jacobi"),
        )
    elif cfg.linear_solver == "schur":
        from slam_tpu.solver import schur
        if partition is None:
            raise ValueError("linear_solver='schur' requires a partition")
        if cfg.robust == "sc":
            # Joint SC at scale: the diagonal switch block is eliminated
            # exactly (O(E) corrections, linear.eliminate_switches) and the
            # pose system rides the partitioned Schur solver; switches come
            # back by substitution.
            reduced, backsub = linear.eliminate_switches(system, edges, lam)
            dxp = schur.schur_solve(
                reduced, edges, partition, lam,
                blocked=getattr(cfg, "schur_blocked", False),
                panel=getattr(cfg, "schur_panel", 16),
                panel_inner=getattr(cfg, "schur_panel_inner", 0),
            )
            return (
                linear.Update(poses=dxp.poses,
                              switches=backsub(dxp.poses)),
                jnp.int32(0),
            )
        return (
            schur.schur_solve(
                system, edges, partition, lam,
                blocked=getattr(cfg, "schur_blocked", False),
                panel=getattr(cfg, "schur_panel", 16),
                panel_inner=getattr(cfg, "schur_panel_inner", 0),
            ),
            jnp.int32(0),
        )
    elif cfg.linear_solver == "woodbury":
        from slam_tpu.solver import woodbury
        if partition is None:
            raise ValueError(
                "linear_solver='woodbury' requires WoodburyOps (pass as "
                "partition)")
        if cfg.robust == "sc":
            # Same switch pre-elimination as the schur path.
            reduced, backsub = linear.eliminate_switches(system, edges, lam)
            dxp = woodbury.woodbury_solve(reduced, edges, partition, lam)
            return (
                linear.Update(poses=dxp.poses,
                              switches=backsub(dxp.poses)),
                jnp.int32(0),
            )
        return (
            woodbury.woodbury_solve(system, edges, partition, lam),
            jnp.int32(0),
        )
    raise ValueError(f"unknown linear solver {cfg.linear_solver!r}")


@partial(jax.jit, static_argnames=("cfg", "model"))
def lm_solve(
    poses0: Array,
    switches0: Array,
    edges: EdgeSet,
    free: FreeMask,
    cfg: SolverConfig,
    model=None,
    partition=None,
) -> LMResult:
    """Run LM to convergence (or ``cfg.max_iterations``)."""
    model = model or SE2Model
    dtype = jnp.dtype(cfg.dtype)
    poses0 = poses0.astype(dtype)
    switches0 = switches0.astype(dtype)

    kw = dict(
        model=model,
        robust=cfg.robust,
        dcs_phi=cfg.dcs_phi,
        huber_delta=cfg.huber_delta,
        sc_prior_lambda=cfg.sc_prior_lambda,
    )

    cost0 = cost_only(poses0, switches0, edges, **kw)

    def cond(s: LMState):
        return (s.it < cfg.max_iterations) & (~s.converged)

    gnc = bool(cfg.gnc_anneal_iters) and cfg.robust == "dcs"

    def body(s: LMState) -> LMState:
        phi_t = _gnc_phi(cfg, s.it, dtype)
        kw_t = dict(kw, dcs_phi=phi_t)
        system = linearize(s.poses, s.switches, edges, free, **kw_t)
        # Under GNC the objective changes each iteration; compare at the
        # CURRENT phi (system.cost is the objective at s.poses and phi_t).
        prev_cost = system.cost if gnc else s.cost
        dx, inner = _solve_linear(system, edges, s.lam, cfg, partition)

        new_poses = model.retract(s.poses, dx.poses)
        new_switches = s.switches + dx.switches
        new_cost = cost_only(new_poses, new_switches, edges, **kw_t)

        # Gain ratio: actual / model reduction.
        d = jnp.diagonal(system.Hdiag, axis1=-2, axis2=-1)
        damp = s.lam * jnp.clip(d, linear._DIAG_MIN, linear._DIAG_MAX)
        ds = s.lam * jnp.clip(system.Hss, linear._DIAG_MIN, linear._DIAG_MAX)
        model_red = 0.5 * (
            jnp.sum(dx.poses * (damp * dx.poses - system.g))
            + jnp.sum(dx.switches * (ds * dx.switches - system.gs))
        )
        rho = (prev_cost - new_cost) / jnp.maximum(model_red, 1e-30)
        accept = new_cost < prev_cost

        factor = jnp.maximum(1.0 / 3.0, 1.0 - (2.0 * rho - 1.0) ** 3)
        lam_acc = jnp.clip(s.lam * factor, cfg.min_lambda, cfg.max_lambda)
        lam_rej = jnp.clip(s.lam * s.nu, cfg.min_lambda, cfg.max_lambda)

        rel_decrease = (prev_cost - new_cost) / jnp.maximum(prev_cost, 1e-30)
        converged = accept & (rel_decrease < cfg.function_tolerance)
        if gnc:  # don't declare convergence while phi is still annealing
            converged = converged & (s.it >= cfg.gnc_anneal_iters)

        return LMState(
            poses=jnp.where(accept, new_poses, s.poses),
            switches=jnp.where(accept, new_switches, s.switches),
            cost=jnp.where(accept, new_cost, prev_cost),
            lam=jnp.where(accept, lam_acc, lam_rej),
            nu=jnp.where(accept, jnp.full_like(s.nu, 2.0), s.nu * 2.0),
            it=s.it + 1,
            accepted=s.accepted + accept.astype(jnp.int32),
            converged=converged,
            lin_iters=s.lin_iters + inner,
        )

    init = LMState(
        poses=poses0,
        switches=switches0,
        cost=cost0,
        lam=jnp.asarray(cfg.init_lambda, dtype),
        nu=jnp.asarray(2.0, dtype),
        it=jnp.int32(0),
        accepted=jnp.int32(0),
        converged=jnp.asarray(False),
        lin_iters=jnp.int32(0),
    )
    out = jax.lax.while_loop(cond, body, init)
    return LMResult(
        poses=out.poses,
        switches=out.switches,
        cost=out.cost,
        initial_cost=cost0,
        iterations=out.it,
        accepted=out.accepted,
        converged=out.converged,
        lin_iters=out.lin_iters,
        final_lambda=out.lam,
        final_nu=out.nu,
    )


@partial(jax.jit, static_argnames=("cfg", "num_iters", "model"))
def lm_fixed_iters(
    poses0: Array,
    switches0: Array,
    edges: EdgeSet,
    free: FreeMask,
    cfg: SolverConfig,
    num_iters: int,
    model=None,
    partition=None,
    lam0: Array | None = None,
    it0: Array | None = None,
    nu0: Array | None = None,
) -> LMResult:
    """Exactly ``num_iters`` LM iterations via ``lax.scan`` (benchmarking and
    the short inner solves of methods 3/4, which cap Ceres at 1-2 iterations,
    e.g. ``layer_manager.cpp:642``).

    ``lam0``/``nu0``/``it0`` continue a chunked solve from a previous
    result's ``final_lambda``/``final_nu``/``iterations`` instead of
    restarting the trust region (required for GNC, whose phi schedule keys
    off the iteration index)."""
    model = model or SE2Model
    dtype = jnp.dtype(cfg.dtype)
    poses0 = poses0.astype(dtype)
    switches0 = switches0.astype(dtype)
    kw = dict(
        model=model,
        robust=cfg.robust,
        dcs_phi=cfg.dcs_phi,
        huber_delta=cfg.huber_delta,
        sc_prior_lambda=cfg.sc_prior_lambda,
    )
    cost0 = cost_only(poses0, switches0, edges, **kw)

    gnc = bool(cfg.gnc_anneal_iters) and cfg.robust == "dcs"

    def step(s: LMState, _):
        phi_t = _gnc_phi(cfg, s.it, dtype)
        kw_t = dict(kw, dcs_phi=phi_t)
        system = linearize(s.poses, s.switches, edges, free, **kw_t)
        prev_cost = system.cost if gnc else s.cost
        dx, inner = _solve_linear(system, edges, s.lam, cfg, partition)
        new_poses = model.retract(s.poses, dx.poses)
        new_switches = s.switches + dx.switches
        new_cost = cost_only(new_poses, new_switches, edges, **kw_t)
        if getattr(cfg, "trust_region", "nielsen") == "ceres":
            # Stock-Ceres bookkeeping (r5, opt-in -- the short-solve eval
            # path of methods 3/4 uses it for decision parity with the
            # manager oracle).  With (H + lam clip(diag)) dx = -g, the
            # damped-step identity 0.5 dx^T(lam D dx - g) EQUALS Ceres'
            # model_cost_change -(Jh)^T(r + Jh/2); lam = 1/radius, the
            # clip bounds match Ceres' (1e-6/1e32), init_lambda 1e-4 =
            # 1/initial_radius, and the reject update (lam*nu, nu*=2) is
            # already Ceres' decrease_factor rule -- the ONLY deltas vs
            # the default path are the acceptance test
            # (relative_decrease > 1e-3 on a positive model reduction)
            # and the rho-dependent accepted-radius update.
            d = jnp.diagonal(system.Hdiag, axis1=-2, axis2=-1)
            damp = s.lam * jnp.clip(d, linear._DIAG_MIN, linear._DIAG_MAX)
            ds_ = s.lam * jnp.clip(system.Hss, linear._DIAG_MIN,
                                   linear._DIAG_MAX)
            model_red = 0.5 * (
                jnp.sum(dx.poses * (damp * dx.poses - system.g))
                + jnp.sum(dx.switches * (ds_ * dx.switches - system.gs))
            )
            rho = (prev_cost - new_cost) / jnp.maximum(model_red, 1e-30)
            accept = (model_red > 0.0) & (rho > 1e-3)
            factor = jnp.maximum(1.0 / 3.0, 1.0 - (2.0 * rho - 1.0) ** 3)
            lam = jnp.where(
                accept,
                jnp.clip(s.lam * factor, cfg.min_lambda, cfg.max_lambda),
                jnp.minimum(s.lam * s.nu, cfg.max_lambda),
            )
        else:
            accept = new_cost < prev_cost
            lam = jnp.where(
                accept,
                jnp.maximum(s.lam / 3.0, cfg.min_lambda),
                jnp.minimum(s.lam * s.nu, cfg.max_lambda),
            )
        s = LMState(
            poses=jnp.where(accept, new_poses, s.poses),
            switches=jnp.where(accept, new_switches, s.switches),
            cost=jnp.where(accept, new_cost, prev_cost),
            lam=lam,
            nu=jnp.where(accept, jnp.full_like(s.nu, 2.0), s.nu * 2.0),
            it=s.it + 1,
            accepted=s.accepted + accept.astype(jnp.int32),
            converged=jnp.asarray(False),
            lin_iters=s.lin_iters + inner,
        )
        return s, s.cost

    init = LMState(
        poses=poses0,
        switches=switches0,
        cost=cost0,
        lam=(jnp.asarray(cfg.init_lambda, dtype) if lam0 is None
             else jnp.asarray(lam0, dtype)),
        nu=(jnp.asarray(2.0, dtype) if nu0 is None
            else jnp.asarray(nu0, dtype)),
        it=jnp.int32(0) if it0 is None else jnp.asarray(it0, jnp.int32),
        accepted=jnp.int32(0),
        converged=jnp.asarray(False),
        lin_iters=jnp.int32(0),
    )
    out, _ = jax.lax.scan(step, init, None, length=num_iters)
    return LMResult(
        poses=out.poses,
        switches=out.switches,
        cost=out.cost,
        initial_cost=cost0,
        iterations=out.it,
        accepted=out.accepted,
        converged=out.converged,
        lin_iters=out.lin_iters,
        final_lambda=out.lam,
        final_nu=out.nu,
    )

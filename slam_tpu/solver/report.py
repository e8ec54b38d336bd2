"""Structured per-solve report -- the ``Summary::FullReport()`` analog.

The reference prints Ceres' full report after every global solve
(``DCS-ceres/main.cpp:164``): cost before/after, iteration
counts, termination type, and a per-stage time breakdown.  The jitted LM
loop here is a single fused device program (that is what makes it fast), so
the equivalents are assembled differently:

* termination / step counts / costs come from the :class:`LMResult`
  carried out of the ``lax.while_loop``;
* per-stage times (linearize / linear solve / retract+cost) cannot be
  observed inside the fused loop -- they are measured by timing one
  representative jitted call per stage at the final iterate
  (:func:`measure_stages`), which is exactly the steady-state per-iteration
  cost because every LM iteration runs the same static-shape program.

``measure_stages`` compiles each stage standalone (persistent-cached), so
it is optional (CLI ``--report-stages``); the textual report itself is
free and always printed.
"""

from __future__ import annotations

import dataclasses
import time

import jax
import jax.numpy as jnp


@dataclasses.dataclass
class SolveReport:
    termination: str          # CONVERGENCE | NO_CONVERGENCE
    termination_detail: str
    initial_cost: float
    final_cost: float
    iterations: int
    accepted_steps: int
    rejected_steps: int
    inner_linear_iters: int
    final_trust_lambda: float
    wall_s: float
    stage_times_s: dict | None = None   # linearize / linear_solve / retract_cost

    def fields(self) -> dict:
        d = dataclasses.asdict(self)
        st = d.pop("stage_times_s") or {}
        for k, v in st.items():
            d[f"t_{k}_s"] = round(v, 6)
        return d

    def text(self) -> str:
        lines = [
            "Solver report (slam_tpu; FullReport analog of main.cpp:164)",
            f"  Cost:        initial {self.initial_cost:.6e}  "
            f"final {self.final_cost:.6e}  "
            f"change {self.initial_cost - self.final_cost:.6e}",
            f"  Iterations:  {self.iterations} "
            f"(accepted {self.accepted_steps}, rejected {self.rejected_steps})",
            f"  Inner linear iterations: {self.inner_linear_iters}",
            f"  Final trust-region lambda: {self.final_trust_lambda:.3e}",
            f"  Termination: {self.termination} ({self.termination_detail})",
            f"  Wall time:   {self.wall_s:.3f}s total"
            + (f", {self.wall_s / max(self.iterations, 1):.4f}s/iteration"
               if self.iterations else ""),
        ]
        if self.stage_times_s:
            lines.append("  Per-iteration stage times (one representative "
                         "jitted call each; the solve loop itself is fused "
                         "on device):")
            for name, dt in self.stage_times_s.items():
                lines.append(f"    {name:<14s} {dt * 1e3:9.3f} ms")
        return "\n".join(lines)


def build_report(res, scfg, wall_s: float,
                 stage_times: dict | None = None) -> SolveReport:
    """Classify termination and assemble the report from an LMResult."""
    it = int(res.iterations)
    acc = int(res.accepted)
    lam = float(res.final_lambda) if res.final_lambda is not None else 0.0
    if bool(res.converged):
        term = "CONVERGENCE"
        detail = (f"relative cost decrease below function_tolerance="
                  f"{scfg.function_tolerance:g} after {it} iterations")
    elif lam >= 0.99 * scfg.max_lambda:
        term = "NO_CONVERGENCE"
        detail = (f"trust region stalled: lambda reached max_lambda="
                  f"{scfg.max_lambda:g} (every recent step rejected)")
    else:
        term = "NO_CONVERGENCE"
        detail = f"max_iterations={scfg.max_iterations} reached"
    return SolveReport(
        termination=term,
        termination_detail=detail,
        initial_cost=float(res.initial_cost),
        final_cost=float(res.cost),
        iterations=it,
        accepted_steps=acc,
        rejected_steps=it - acc,
        inner_linear_iters=int(res.lin_iters),
        final_trust_lambda=lam,
        wall_s=wall_s,
        stage_times_s=stage_times,
    )


def measure_stages(poses, switches, edges, free, scfg, model,
                   partition=None, reps: int = 2) -> dict:
    """Per-stage wall time at the final iterate: linearize, linear solve,
    retract+cost.  Each stage is a standalone jit (persistent-cached); the
    measured call uses per-rep input perturbation plus ``jax.device_get``
    as the barrier."""
    from functools import partial

    from slam_tpu.solver.lm import _solve_linear
    from slam_tpu.solver.linearize import cost_only, linearize

    kw = dict(model=model, robust=scfg.robust, dcs_phi=scfg.dcs_phi,
              huber_delta=scfg.huber_delta,
              sc_prior_lambda=scfg.sc_prior_lambda)

    lin_jit = jax.jit(partial(linearize, **kw))
    solve_jit = jax.jit(
        lambda system, edges_, lam_, partition_: _solve_linear(
            system, edges_, lam_, scfg, partition_)[0]
    )
    cost_jit = jax.jit(partial(cost_only, **kw))

    def retract_cost(p, dx, sw, dsw, edges_):
        return cost_only(model.retract(p, dx), sw + dsw, edges_, **kw)
    retract_jit = jax.jit(retract_cost)

    dtype = poses.dtype
    lam = jnp.asarray(scfg.init_lambda, dtype)
    times: dict[str, float] = {}

    def timed(name, make_args, fn):
        best = float("inf")
        out = None
        for r in range(reps + 1):  # rep 0 = warm-up/compile, discarded
            args = make_args(r)    # per-rep perturbation defeats the
            t0 = time.perf_counter()  # backend's identical-run caching
            out = fn(*args)
            jax.device_get(jax.tree_util.tree_leaves(out)[0])
            dt = time.perf_counter() - t0
            if r > 0:
                best = min(best, dt)
        times[name] = best
        return out

    def eps(r):
        return jnp.asarray(1e-7 * (r + 1), dtype)

    system = timed(
        "linearize", lambda r: (poses + eps(r), switches, edges, free),
        lin_jit)
    dx = timed(
        "linear_solve", lambda r: (system, edges, lam * (1 + eps(r)),
                                   partition),
        solve_jit)
    timed(
        "retract_cost",
        lambda r: (poses + eps(r), dx.poses, switches, dx.switches, edges),
        retract_jit)
    return times

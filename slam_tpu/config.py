"""Configuration dataclasses for the solver and method drivers.

The reference hard-codes nearly everything: Huber delta 0.01
(``DCS-ceres/main.cpp:68``), DCS phi 0.5
(``ceres_error.cpp:185``), SC prior lambda 1.0 (``main.cpp:107``), Ceres
defaults for the trust-region loop, and per-method structs
(``layer_manager.h:15-33``, ``simple_layer_manager.h:18-36``).  Here every
knob is an explicit field with the reference value as default, overridable
from the CLI.

Fields that select code paths (``robust``, ``linear_solver``, iteration caps)
are static under ``jax.jit``; numeric fields are traced.
"""

from __future__ import annotations

import dataclasses

# Method numbering follows the reference CLI (``main.cpp:27``).
METHOD_BASELINE = 0
METHOD_DCS = 1
METHOD_SC = 2
METHOD_LAYERING = 3
METHOD_MCTS = 4


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Gauss-Newton / Levenberg-Marquardt solve configuration."""

    # Robustification of loop-closure edges: "none" | "dcs" | "sc".
    robust: str = "none"
    dcs_phi: float = 0.5          # ceres_error.cpp:185
    huber_delta: float = 0.01     # main.cpp:68 (applied to every block)
    sc_prior_lambda: float = 1.0  # main.cpp:107

    # Graduated non-convexity for DCS (extension; off by default for
    # reference parity).  When ``gnc_anneal_iters > 0`` the effective phi is
    # annealed geometrically from ``dcs_phi * gnc_init_scale`` down to
    # ``dcs_phi`` over the first ``gnc_anneal_iters`` LM iterations.  Large
    # phi makes psi ~ 1 (quadratic, convex-ish); shrinking it gradually
    # re-introduces the robustness.  Fixes the DCS chicken-and-egg on badly
    # drifted initial guesses (e.g. sphere2500: the whitened closure
    # residuals start so large that psi turns ALL closures off and LM
    # converges to the odometry-only local minimum).
    gnc_anneal_iters: int = 0
    gnc_init_scale: float = 1e4

    # DCS closure-dropout auto-retry (method 1, global solve only).  DCS has
    # a pathological fixed point on poorly-initialized graphs: the whitened
    # closure residuals start huge, psi ~ 0 turns every closure OFF, and LM
    # converges to the (lower-cost!) odometry-only minimum -- measured on
    # M3500 (ATE ~10 m at ATE-0 achievable) and MIT.  After a plain DCS
    # solve, if the mean psi over loop edges at the FINAL iterate is below
    # ``dcs_retry_threshold`` the solve "gave up" on loop closures;
    # re-solve from the same init with GNC annealing.  The retry result
    # joins the common candidate pool and is kept only if it wins the
    # full-objective ranking (see the psi-consensus block below).  Costs
    # one extra solve only when triggered; healthy runs (final mean psi
    # near 1) never trigger, preserving reference-identical behaviour.
    dcs_auto_retry: bool = True
    dcs_retry_threshold: float = 0.35
    dcs_retry_gnc_iters: int = 20

    # DCS psi-consensus re-solve (method 1, global solve only).  On
    # raw-odometry graphs at high outlier counts (the reference's own
    # headline regime, README.md:41-42: INTEL at 100-200 injected
    # outliers) plain DCS settles in a PARTIALLY poisoned basin: most
    # bogus loops are suppressed (psi ~ 0) but so are 30-40% of the real
    # ones, and the survivors' consensus is bent meters away (measured
    # INTEL+100: ATE 6.17 m, 94/256 real loops dropped).  GNC annealing
    # makes this WORSE (re-admits the bogus edges and locks them in:
    # 10.6 m measured), and PCM/chordal are untrustworthy at this drift
    # rate (solver/init.py tiers).  What works is an EM-style consensus
    # loop: hard-drop loops whose final psi < dcs_consensus_cut, re-solve
    # from the ORIGINAL init (cold restart -- warm restarts stay in the
    # bent basin, measured), re-admit any loop that fits the improved
    # solution, iterate to a fixed point.  Each round re-admits reals
    # whose residuals shrink as the map straightens; bogus edges never
    # fit again.  Measured (f64, seeds 0/1/2): INTEL+100 6.17 -> 0.017 m,
    # INTEL+200 8.74 -> 0.018 m, all 256 real loops re-admitted.
    # Triggered when > dcs_consensus_drop_frac of live loops end with
    # psi < 0.2; healthy runs (final psi near 1 on most loops) never
    # trigger.  Candidate acceptance is by the ACCEPTANCE rule below --
    # argmin of the common full objective with a >2% improvement gate.
    # On hard draws the single trim-from-full chain can land in a
    # smaller self-consistent coalition (measured INTEL+200 seed 42: a
    # 90-real + 8-bogus fixed point at ATE 7.4 while the true basin
    # explains 262 loops).  Run ``dcs_consensus_chains`` independent
    # chains -- chain 0 trims from the full loop set, the rest start
    # from seeded random half-subsets of the loops (the RANSAC move) --
    # and pick the chain explaining the most loops (measured: 4 of 6
    # chains find the 262-loop basin on that seed).  All chains re-solve
    # the same compiled program (the active mask is an input).
    # ACCEPTANCE: every candidate (plain solve, each chain's fixed
    # point, the GNC retry) is scored on the COMMON full objective
    # (cost over every live edge); the argmin wins, and replaces the
    # plain solve only on a >2% improvement.  Loop-count votes and mean
    # psi are both gameable by a mutually-consistent bogus coalition on
    # small floppy maps (measured on a two-lap-circle fixture); the full
    # objective prices the odometry bending a coalition fit requires.
    # Measured (f64): INTEL+100 plain/GNC/consensus cost 2.25/1.85/1.17
    # at ATE 6.2/10.7/0.018.
    dcs_consensus: bool = True
    dcs_consensus_drop_frac: float = 0.25
    dcs_consensus_cut: float = 0.5
    dcs_consensus_rounds: int = 8
    dcs_consensus_chains: int = 6

    # LM trust-region loop (Ceres defaults: 50 iters, ftol 1e-6).
    # ``trust_region``: "nielsen" (default; the production damping whose
    # fixed points are golden-pinned) or "ceres" (r5, opt-in in
    # lm_fixed_iters only: stock-Ceres acceptance + radius update, used
    # by the method-3/4 eval path for decision parity with the manager
    # oracle -- see solver/lm.py).
    trust_region: str = "nielsen"
    max_iterations: int = 50
    function_tolerance: float = 1e-6
    init_lambda: float = 1e-4
    min_lambda: float = 1e-12
    max_lambda: float = 1e10

    # Linear solver: "auto" (dense up to 512 nodes, schur above), "dense"
    # (dense Cholesky), "pcg" (block-Jacobi preconditioned CG), or "schur"
    # (partitioned two-level direct solve).
    linear_solver: str = "auto"
    pcg_max_iters: int = 250
    pcg_rtol: float = 1e-8
    # "tridiag": odometry-chain block-tridiagonal preconditioner (cyclic
    # reduction); "jacobi": block-diagonal.
    pcg_preconditioner: str = "tridiag"

    # Schur factorization kernels: False = XLA native cho_factor /
    # TriangularSolve; True = panel-blocked Cholesky/solves
    # (blocked_chol.py).  The solve turns it on for interiors up to
    # schur.BLOCKED_MAX_DIM on accelerators (``with_default_interiors``);
    # PERF.md records both sides on the H100.
    schur_blocked: bool = False
    # Panel width for the blocked path.
    schur_panel: int = 16
    # Second blocking level (r4): factor each diagonal panel itself with
    # inner-width blocked Cholesky, so the only batch-serialized native
    # ops are inner x inner.  0 = off (single-level native panel).
    schur_panel_inner: int = 0
    # Partition SCHEME for the Schur solver: "index" = contiguous index
    # ranges, "graph" = recursive-spectral-bisection node->block
    # assignment (solver/partition.py), "auto" = cost-model choice between
    # the two (schur.choose_partition).  Graph partitions keep
    # long-index-span loop closures inside blocks: the M10000 separator
    # shrinks from 1793 to 428 nodes at P=24; index-ordered graphs
    # (INTEL) keep the contiguous scheme.
    schur_partition: str = "auto"

    # Numerics.  float32 on accelerators; tests validate f32 vs f64 fixed
    # points.
    dtype: str = "float32"

    def replace(self, **kw) -> "SolverConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class LayeringConfig:
    """Method 3 (probabilistic layering + UCT) -- ``layer_manager.h:15-33``."""

    max_layers: int = 50
    local_iters: int = 2
    commit_local_iters: int = 1
    commit_window_radius: int = 30
    window_radius: int = 20
    huber_delta: float = 0.01
    ema_alpha: float = 0.1
    epsilon: float = 1e-3
    theta_weight: float = 1.0
    conflict_tau: float = 0.5
    uct_top_k: int = 3
    uct_c: float = 1.0
    # Reward shaping (``layer_manager.cpp:454-455``).
    alpha_info: float = 0.1
    beta_sparse: float = 0.05
    # Fused engine: candidates per device call (state stays on device
    # between chunks, so this only bounds per-call runtime).  None =
    # adaptive: the chunk runner times each device call and resizes to
    # stay under its bound (methods/_fused_common.py); an explicit value
    # is honored as given.
    scan_chunk: int | None = None
    # Short-solve bookkeeping for the candidate evaluations: "ceres"
    # switches lm_fixed_iters to stock-Ceres acceptance/radius updates
    # (r5 -- decision parity with the manager oracle; "nielsen" is the
    # r1-r4 behaviour the committed goldens pin).
    eval_trust_region: str = "nielsen"
    # Inner-solve accuracy for the candidate evaluations when the eval
    # solver is PCG.  The reference's evaluate_cost runs 1-2 *inexact*
    # Ceres iterations (``layer_manager.cpp:642``); a loose CG tolerance is
    # the faithful analog and ~5x cheaper than rtol 1e-8.
    eval_pcg_rtol: float = 1e-3
    eval_pcg_max_iters: int = 64
    # Fused-engine eval linear solver: "auto" = exact partitioned Schur
    # on accelerators (loose PCG above ~2k nodes when scan_chunk is
    # fixed), dense on small CPU graphs; or explicit "schur"/"pcg"/
    # "dense".  Schur uses one shared partition for every
    # masked eval (masked-out edges contribute zero blocks).
    eval_linear: str = "auto"
    eval_schur_blocks: int = 16


@dataclasses.dataclass(frozen=True)
class MctsConfig:
    """Method 4 (MCTS layer tree) -- ``simple_layer_manager.h:18-36``."""

    max_layers: int = 20
    local_iters: int = 2
    huber_delta: float = 0.01
    ema_alpha: float = 0.1
    epsilon: float = 1e-3
    conflict_tau: float = 0.3
    alpha_info: float = 1.1
    beta_sparse: float = 0.1
    exploration_c: float = 1.414
    residual_low: float = 3.0
    residual_high: float = 50.0
    local_window: int = 20
    # Fused engine chunking + inner-solve accuracy (see LayeringConfig).
    scan_chunk: int | None = None
    eval_trust_region: str = "nielsen"
    eval_pcg_rtol: float = 1e-3
    eval_pcg_max_iters: int = 64
    eval_linear: str = "auto"
    eval_schur_blocks: int = 16


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """Top-level run description (CLI surface ``main.cpp:25-31``)."""

    dataset: str = "INTEL"
    num_outliers: int = 0
    method: int = METHOD_BASELINE
    seed: int = 0
    save_path: str = "save"
    # Initial guess: "auto" (default) = PCM-gated chordal when the pairwise
    # consistency test is trustworthy (fixes the M3500-family bad-init
    # failure), un-gated chordal on rotation-corrupted-but-translation-sane
    # graphs (M3500b/c), dataset estimates on high-drift raw-odometry
    # graphs (INTEL/MIT -- the reference's behaviour preserved where it
    # works); "dataset" = always the g2o vertex estimates
    # (g2o_util.h:37-47); "chordal" = always the rotation-first linear
    # initialization (solver/init.py).
    init: str = "auto"
    # Time the linearize / linear-solve / retract stages for the solve
    # report (one standalone jitted call each -- extra compiles, hence
    # opt-in; the report's termination/step/cost fields are always free).
    report_stages: bool = False
    solver: SolverConfig = dataclasses.field(default_factory=SolverConfig)
    layering: LayeringConfig = dataclasses.field(default_factory=LayeringConfig)
    mcts: MctsConfig = dataclasses.field(default_factory=MctsConfig)


def solver_config_for_method(method: int, base: SolverConfig | None = None) -> SolverConfig:
    base = base or SolverConfig()
    if method == METHOD_SC and base.robust == "sc_varpro":
        return base  # variable-projection variant of method 2
    robust = {METHOD_BASELINE: "none", METHOD_DCS: "dcs", METHOD_SC: "sc"}.get(
        method, "none"
    )
    return base.replace(robust=robust)

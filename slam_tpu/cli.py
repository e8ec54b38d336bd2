"""Command-line driver.

Reference CLI surface (``DCS-ceres/main.cpp:25-31``):

    ./main DATASET NUM_OUTLIER_LOOPS METHOD
    METHOD: 0=baseline, 1=DCS, 2=Switchable, 3=Layering, 4=MCTS

Same positional interface here plus explicit flags for everything the
reference hard-codes:

    python -m slam_tpu.cli INTEL 50 1 --save-path save --seed 42
"""

from __future__ import annotations

import argparse
import sys

from slam_tpu.config import (
    LayeringConfig,
    MctsConfig,
    RunConfig,
    SolverConfig,
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="slam_tpu",
        description="Robust pose-graph SLAM backend",
    )
    p.add_argument("dataset", help="dataset name (INTEL, M3500, CSAIL, ...) or .g2o path")
    p.add_argument("num_outliers", type=int, help="number of bogus loops to inject")
    p.add_argument("method", type=int, choices=[0, 1, 2, 3, 4],
                   help="0=baseline 1=DCS 2=SC 3=layering 4=MCTS")
    p.add_argument("--sweep", action="store_true",
                   help="run the full outlier sweep grid (methods x counts) "
                        "instead of a single solve; num_outliers becomes the "
                        "maximum count and method the maximum method id")
    p.add_argument("--sweep-seeds", type=int, default=1,
                   help="number of outlier seeds per sweep cell")
    p.add_argument("--save-path", default="save")
    p.add_argument("--seed", type=int, default=0,
                   help="outlier-injection PRNG seed (reference: srand(time(0)))")
    p.add_argument("--dcs-phi", type=float, default=0.5)
    p.add_argument("--gnc-iters", type=int, default=0,
                   help="graduated non-convexity: anneal DCS phi from "
                        "phi*gnc-scale down to phi over this many LM "
                        "iterations (0 = off, the reference behaviour)")
    p.add_argument("--gnc-scale", type=float, default=1e4,
                   help="initial phi multiplier for --gnc-iters")
    p.add_argument("--no-dcs-auto-retry", action="store_true",
                   help="disable the DCS closure-dropout auto-retry (the "
                        "GNC-annealed re-solve when a plain DCS solve ends "
                        "with most closures suppressed -- the M3500/MIT "
                        "bad-init failure mode)")
    p.add_argument("--init", default="auto",
                   choices=["auto", "dataset", "chordal"],
                   help="initial guess: auto (default) picks PCM-gated / "
                        "plain chordal or the dataset estimates by "
                        "measured drift (solver/init.py); dataset = the "
                        "reference behaviour (g2o_util.h:37-47); chordal "
                        "= always the rotation-first init")
    p.add_argument("--huber-delta", type=float, default=0.01)
    p.add_argument("--sc-lambda", type=float, default=1.0)
    p.add_argument("--sc-varpro", action="store_true",
                   help="method 2 with variable-projection switch "
                        "elimination (closed-form s*, Geman-McClure "
                        "equivalent) -- rejects outliers where the "
                        "reference's Huber-wrapped joint SC cannot")
    p.add_argument("--max-iterations", type=int, default=50)
    p.add_argument("--linear-solver", default="auto",
                   choices=["auto", "dense", "pcg", "schur", "woodbury"],
                   help="auto: dense below ~2k nodes, schur above; "
                        "woodbury: exact chain+low-rank solver for "
                        "closure-sparse graphs")
    p.add_argument("--dtype", default=None, choices=[None, "float32", "float64"],
                   help="default: float32 on accelerators, float64 on CPU")
    p.add_argument("--report-stages", action="store_true",
                   help="add per-stage (linearize / linear solve / "
                        "retract+cost) timings to the solve report -- "
                        "times one standalone jitted call per stage "
                        "(extra compiles, persistent-cached)")
    p.add_argument("--plot", action="store_true", help="write trajectory PNG")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="capture a jax.profiler trace of the solve into DIR "
                        "(TensorBoard-loadable)")
    p.add_argument("--checkpoint", default=None, metavar="FILE",
                   help="resumable solves: methods 0-2 persist chunked LM "
                        "state, methods 3/4 persist the fused scan state at "
                        "chunk boundaries (utils/checkpoint.py); re-running "
                        "with the same FILE resumes")
    p.add_argument("--eval-against", default=None,
                   help="nodes file to compute ATE against (e.g. a reference opt_nodes.txt)")
    p.add_argument("--fused", default="auto", choices=["auto", "on", "off"],
                   help="methods 3/4 engine: fused single-program lax.scan "
                        "vs host-driven loop (auto: fused on accelerators)")
    p.add_argument("--scan-chunk", type=int, default=None,
                   help="fused methods 3/4: candidates per device call "
                        "(default: adaptive on accelerators, 64 on CPU)")
    p.add_argument("--eval-linear", default=None,
                   choices=[None, "auto", "schur", "pcg", "dense"],
                   help="fused methods 3/4: candidate-evaluation solver "
                        "(auto: exact partitioned Schur on accelerators, "
                        "dense on small and loose PCG on large CPU graphs; "
                        "pcg is the analog of the reference's 1-2 inexact "
                        "inner Ceres iterations)")
    p.add_argument("--eval-trust-region", default=None,
                   choices=[None, "nielsen", "ceres"],
                   help="methods 3/4: short-solve bookkeeping for the "
                        "candidate evaluations (ceres = stock-Ceres "
                        "acceptance/radius updates for decision parity "
                        "with the manager oracle; default nielsen)")
    p.add_argument("--eval-pcg-iters", type=int, default=None,
                   help="fused methods 3/4: CG cap of the PCG candidate "
                        "evaluations (default 64; lower is faster and "
                        "still in the spirit of the reference's inexact "
                        "inner solves)")
    p.add_argument("--eval-pcg-rtol", type=float, default=None,
                   help="fused methods 3/4: relative tolerance of the PCG "
                        "candidate evaluations (default 1e-3)")
    return p


def config_from_args(args) -> RunConfig:
    import jax

    platform = jax.default_backend()
    dtype = args.dtype or ("float64" if platform == "cpu" else "float32")
    linear_solver = args.linear_solver
    solver = SolverConfig(
        robust="sc_varpro" if getattr(args, "sc_varpro", False) else "none",
        dcs_phi=args.dcs_phi,
        huber_delta=args.huber_delta,
        sc_prior_lambda=args.sc_lambda,
        max_iterations=args.max_iterations,
        linear_solver=linear_solver,
        dtype=dtype,
        gnc_anneal_iters=getattr(args, "gnc_iters", 0),
        gnc_init_scale=getattr(args, "gnc_scale", 1e4),
        dcs_auto_retry=not getattr(args, "no_dcs_auto_retry", False),
    )
    return RunConfig(
        dataset=args.dataset,
        num_outliers=args.num_outliers,
        method=args.method,
        seed=args.seed,
        save_path=args.save_path,
        init=getattr(args, "init", "dataset"),
        report_stages=getattr(args, "report_stages", False),
        solver=solver,
        layering=LayeringConfig(**_fused_overrides(args)),
        mcts=MctsConfig(**_fused_overrides(args)),
    )


def _fused_overrides(args) -> dict:
    """Shared fused-engine (methods 3/4) config overrides from CLI flags."""
    out = {}
    if args.scan_chunk:
        out["scan_chunk"] = args.scan_chunk
    if getattr(args, "eval_linear", None):
        out["eval_linear"] = args.eval_linear
    if getattr(args, "eval_pcg_iters", None):
        out["eval_pcg_max_iters"] = args.eval_pcg_iters
    if getattr(args, "eval_pcg_rtol", None):
        out["eval_pcg_rtol"] = args.eval_pcg_rtol
    if getattr(args, "eval_trust_region", None):
        out["eval_trust_region"] = args.eval_trust_region
    return out


def main(argv=None) -> int:
    from slam_tpu.utils.cache import enable_persistent_cache
    enable_persistent_cache()
    args = build_parser().parse_args(argv)
    cfg = config_from_args(args)

    if args.sweep:
        from slam_tpu.eval import harness
        from slam_tpu.utils.logging import RunLogger
        import os
        os.makedirs(cfg.save_path, exist_ok=True)
        counts = sorted({0, *(c for c in (10, 50, 100) if c <= cfg.num_outliers),
                         cfg.num_outliers})
        methods = [m for m in (0, 1, 2) if m <= max(cfg.method, 1)]
        logger = RunLogger(os.path.join(cfg.save_path, "sweep.log"))
        cells = harness.run_sweep(
            cfg.dataset,
            methods=methods,
            outlier_counts=counts,
            seeds=list(range(args.sweep_seeds)),
            solver=cfg.solver,
            reference_nodes=args.eval_against,
            save_path=cfg.save_path,
            logger=logger,
        )
        print(harness.format_table(cells))
        logger.close()
        return 0

    import contextlib

    if args.profile:
        from slam_tpu.utils.profiling import trace
        profile_cm = trace(args.profile)
    else:
        profile_cm = contextlib.nullcontext()

    with profile_cm:
        if cfg.method in (0, 1, 2) and args.checkpoint:
            out = _run_checkpointed(cfg, args.checkpoint)
        elif cfg.method in (0, 1, 2):
            from slam_tpu.methods.global_solve import run_from_config
            out = run_from_config(cfg)
        elif cfg.method == 3:
            from slam_tpu.methods.layering import run_from_config as run3
            out = run3(cfg, fused=args.fused, checkpoint=args.checkpoint)
        else:
            from slam_tpu.methods.mcts import run_from_config as run4
            out = run4(cfg, fused=args.fused, checkpoint=args.checkpoint)

    if args.eval_against:
        from slam_tpu.eval import metrics
        from slam_tpu.io import g2o as g2o_io
        ref = g2o_io.load_nodes(args.eval_against)
        print(f"[eval] ATE vs {args.eval_against}: "
              f"{metrics.ate(out.poses, ref):.6f} m")

    if args.plot:
        from slam_tpu.viz import plot
        import os
        # Mirror the reference's do_plot.sh dispatch (do_plot.sh:2-9):
        # the 6-panel dashboard for a method-4 run, else the plain
        # trajectory overlay.  Keyed on cfg.method, not on a (possibly
        # stale) method4_stats.txt left in a reused save dir.
        if cfg.method == 4 and os.path.exists(
                os.path.join(cfg.save_path, "method4_stats.txt")):
            plot.plot_method4_dashboard(cfg.save_path)
        else:
            plot.plot_trajectories(
                os.path.join(cfg.save_path, "init_nodes.txt"),
                os.path.join(cfg.save_path, "opt_nodes.txt"),
                os.path.join(cfg.save_path, "trajectory.png"),
            )
    return 0


def _run_checkpointed(cfg, ckpt_path):
    """Methods 0-2 with chunked checkpoint/resume (utils/checkpoint.py)."""
    import os

    import jax.numpy as jnp
    import numpy as np

    from slam_tpu.config import solver_config_for_method
    from slam_tpu.io import g2o as g2o_io
    from slam_tpu.methods.global_solve import GlobalSolveOutput
    from slam_tpu.solver.problem import anchor_first_node, edge_set_from_graph
    from slam_tpu.utils.checkpoint import CheckpointingSolver
    from slam_tpu.utils.logging import RunLogger

    os.makedirs(cfg.save_path, exist_ok=True)
    logger = RunLogger(os.path.join(cfg.save_path, f"method{cfg.method}.log"))
    graph = g2o_io.load_g2o(g2o_io.find_dataset(cfg.dataset))
    graph = graph.add_random_outliers(cfg.num_outliers, seed=cfg.seed)
    from slam_tpu.solver.init import apply_init
    graph = apply_init(graph, cfg, logger)
    g2o_io.write_nodes(os.path.join(cfg.save_path, "init_nodes.txt"),
                       graph.poses)
    g2o_io.write_edges(os.path.join(cfg.save_path, "init_edges.txt"), graph)

    scfg = solver_config_for_method(cfg.method, cfg.solver)
    if scfg.linear_solver in ("auto", "schur", "woodbury"):
        # The chunked driver re-enters lm_fixed_iters; keep the solver
        # partition-free for simplicity.
        scfg = scfg.replace(
            linear_solver="dense" if graph.num_nodes <= 2048 else "pcg"
        )
    dtype = jnp.dtype(scfg.dtype)
    canon = graph.canonical_order()
    edges = edge_set_from_graph(canon, dtype=dtype)
    free = anchor_first_node(canon.num_nodes, dtype=dtype)
    poses0 = jnp.asarray(canon.poses, dtype)
    sw0 = jnp.ones((edges.num_edges,), dtype)

    solver = CheckpointingSolver(ckpt_path, chunk_iters=10)
    poses, switches, res = solver.run(
        poses0, sw0, edges, free, scfg,
        total_iters=scfg.max_iterations,
    )
    if res is not None:
        final_cost = float(res.cost)
    else:  # resumed at completion: read the recorded cost
        from slam_tpu.utils.checkpoint import load_checkpoint
        state, _ = load_checkpoint(ckpt_path)
        final_cost = float(state["cost"])
    logger.log("solve", method=cfg.method, robust=scfg.robust,
               checkpointed=True, final_cost=final_cost,
               iterations=scfg.max_iterations)
    g2o_io.write_nodes(os.path.join(cfg.save_path, "opt_nodes.txt"),
                       np.asarray(poses))
    g2o_io.write_edges(os.path.join(cfg.save_path, "opt_edges.txt"), graph)
    logger.close()
    return GlobalSolveOutput(
        graph=graph, poses=np.asarray(poses),
        switches=np.asarray(switches), result=res, wall_time_s=0.0,
    )


if __name__ == "__main__":
    sys.exit(main())

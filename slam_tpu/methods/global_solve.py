"""Methods 0/1/2: the single global robust solve.

Reproduces the reference driver flow (``DCS-ceres/main.cpp:32-173``):

    read g2o -> inject bogus loops -> write init_nodes/init_edges
    -> build robust problem (baseline / DCS / switchable)
    -> LM solve with gauge fixed at pose 0
    -> report -> write opt_nodes/opt_edges (+ switches.txt for SC)

but as a pure-function pipeline: ingestion and file IO on the host, one
jitted LM solve on device.
"""

from __future__ import annotations

import dataclasses
import os
import time

import jax
import jax.numpy as jnp
import numpy as np

from slam_tpu.config import METHOD_SC, RunConfig, solver_config_for_method
from slam_tpu.graph import PoseGraph
from slam_tpu.io import g2o
from slam_tpu.solver.lm import LMResult, lm_solve
from slam_tpu.solver.problem import anchor_first_node, edge_set_from_graph
from slam_tpu.utils.logging import RunLogger


from functools import partial as _partial


@_partial(jax.jit, static_argnames=("cfg", "model"))
def _psi_probe(poses, edges, cfg, model):
    """Jitted per-edge DCS psi at ``poses`` -- the rescue trigger probe,
    as one compiled program instead of op-by-op eager dispatch."""
    from slam_tpu.solver.linearize import loop_psi
    return loop_psi(poses, edges, model, cfg.dcs_phi)


@_partial(jax.jit, static_argnames=("cfg", "model"))
def _batched_full_cost(poses_b, switches_b, edges, cfg, model):
    """Common full objective (cost over every live edge) for a stacked
    batch of candidate solutions, as ONE compiled program instead of
    per-candidate eager cost_only calls."""
    from slam_tpu.solver.linearize import cost_only

    def one(p, s):
        return cost_only(p, s, edges, model=model, robust="dcs",
                         dcs_phi=cfg.dcs_phi, huber_delta=cfg.huber_delta,
                         sc_prior_lambda=cfg.sc_prior_lambda)

    return jax.vmap(one)(poses_b, switches_b)


@_partial(jax.jit, static_argnames=("cfg", "model"))
def _chain_solve_batch(poses0, switches0, edges, masks, free, cfg, model,
                       partition=None):
    """One psi-consensus round for ALL chains as ONE device program.

    vmaps the full LM solve over the per-chain active-mask axis (the mask
    is already a program input -- same compiled program the sequential
    r3 loop re-dispatched per chain) and fuses the per-chain final-psi
    evaluation into the same dispatch.  Replaces 6 chains x up-to-8
    rounds of separate host-driven dispatches with <= rounds batched
    dispatches.
    """
    def one(mask):
        es = edges._replace(active=mask)
        r = lm_solve(poses0, switches0, es, free, cfg,
                     model=model, partition=partition)
        from slam_tpu.solver.linearize import loop_psi
        return r, loop_psi(r.poses, edges, model, cfg.dcs_phi)

    return jax.vmap(one)(masks)


@dataclasses.dataclass
class GlobalSolveOutput:
    graph: PoseGraph          # graph with outliers injected
    poses: np.ndarray         # optimized poses
    switches: np.ndarray      # optimized switch values (SC), aligned with
                              # canonical edge order
    result: LMResult
    wall_time_s: float


def pick_linear_solver(graph: PoseGraph, robust: str) -> str:
    """Size-based default.  Dense Cholesky is exact and simplest for
    small graphs; from a few hundred nodes the partitioned Schur solver
    is exact and does O(P (n/P)^3 + ns^3) work instead of O(n^3), so the
    INTEL/CSAIL/MIT product pipelines ride it.  Joint SC rides Schur too: the
    diagonal switch block is exactly pre-eliminated
    (``linear.eliminate_switches``), so method 2 no longer caps at the
    dense path."""
    return "dense" if graph.num_nodes <= 512 else "schur"


def run_global_solve(
    graph: PoseGraph,
    cfg: RunConfig,
    logger: RunLogger | None = None,
) -> GlobalSolveOutput:
    """Solve a (possibly outlier-injected) graph with method 0, 1 or 2."""
    from slam_tpu.solver.models import SE2Model, SE3Model

    logger = logger or RunLogger()
    scfg = solver_config_for_method(cfg.method, cfg.solver)
    if scfg.linear_solver == "auto":
        scfg = scfg.replace(linear_solver=pick_linear_solver(graph, scfg.robust))
    dtype = jnp.dtype(scfg.dtype)
    model = SE3Model if graph.dim == 7 else SE2Model

    from slam_tpu.solver.init import apply_init
    canon = apply_init(graph.canonical_order(), cfg, logger)
    # Bucket-pad the edge count so sweeps over outlier counts (E changes by
    # a few dozen) reuse one compiled program; inactive padding is free.
    pad_to = -(-canon.num_edges // 256) * 256
    # PCG's matvec bandwidth is dominated by the incidence operators;
    # chain compression (see EdgeSet) slices the odometry prefix for free.
    # dense/schur consume full incidence directly.
    import jax as _jax
    if scfg.linear_solver in ("pcg", "woodbury", "schur"):
        # schur takes all topology from the precomputed SchurPartition
        # endpoint maps, so its linearize path can ride the chain-compressed
        # incidence like pcg's.
        inc = "chain" if _jax.default_backend() != "cpu" else None
    else:
        inc = None  # backend auto (dense: incidence on accelerators, index
                    # ops on CPU)
    edges = edge_set_from_graph(canon, dtype=dtype, pad_to=pad_to,
                                incidence=inc)
    free = anchor_first_node(canon.num_nodes, dtype=dtype)
    poses0 = jnp.asarray(canon.poses, dtype)
    # Switch variables initialised to 1.0 (``main.cpp:117``).
    switches0 = jnp.ones((edges.num_edges,), dtype)

    partition = None
    if scfg.linear_solver == "woodbury":
        from slam_tpu.solver.woodbury import build_woodbury_ops

        partition = build_woodbury_ops(
            np.asarray(edges.ij), canon.num_nodes, dtype=dtype
        )
        logger.log("woodbury", lowrank_edges=partition.num_lowrank)
    if scfg.linear_solver == "schur":
        from slam_tpu.solver.schur import build_partition, choose_partition

        # Tile-padded cost-model choice over block count AND partition
        # scheme (contiguous index ranges vs recursive-spectral-bisection
        # graph cuts; the graph scheme wins wherever loop closures span
        # many indices, e.g. M10000's separator shrinks about 4x).
        nblocks, node_block = choose_partition(
            np.asarray(edges.ij), canon.num_nodes,
            tangent_dim=model.tangent_dim,
            scheme=scfg.schur_partition,
        )
        # Partition over the PADDED edge list so shapes line up with the
        # EdgeSet; pad edges self-loop on node 0 (a separator) with zero
        # weight, so they are unowned and contribute nothing.
        partition = build_partition(
            np.asarray(edges.ij), canon.num_nodes, nblocks, dtype=dtype,
            node_block=node_block,
        )
        logger.log(
            "partition", blocks=nblocks, ni_max=partition.ni_max,
            ns=partition.ns, ek_max=partition.ek_max,
            scheme=("graph" if node_block is not None else "index"),
        )
        from slam_tpu.solver.schur import with_default_interiors
        scfg = with_default_interiors(
            scfg, model.tangent_dim * partition.ni_max)

    t0 = time.perf_counter()
    # When the psi-consensus rescue is configured, run the PLAIN solve
    # through the SAME compiled chain-batch program (all lanes at the
    # full active mask; lane results are identical, lane 0 is taken):
    # one compile and one program load serve the plain solve and every
    # chain round.  Whether that still beats a separate plain program on
    # the GPU is unmeasured (ROADMAP D4).  Healthy runs keep
    # reference-identical behaviour
    # (lane 0 IS the plain solve; nothing else is consulted unless the
    # rescue triggers).
    # Size-gated: the redundant lanes cost C x the plain solve, which is
    # sub-second at raw-odometry-graph scale (INTEL/CSAIL/MIT -- exactly
    # the graphs the rescue exists for) but minutes at M3500+/M10000
    # scale, where the PCM-gated chordal init already prevents the
    # poisoned basin and a triggered rescue loads its program lazily.
    # Accelerator-only: on CPU the redundant lanes would just multiply the
    # f64 test-suite compute by C.
    rescue_ready = (scfg.robust == "dcs" and not scfg.gnc_anneal_iters
                    and scfg.dcs_consensus and canon.num_nodes <= 2048
                    and _jax.default_backend() != "cpu")
    psi_plain_dev = None
    if rescue_ready:
        C = max(1, scfg.dcs_consensus_chains)
        res_b, psi_b = _chain_solve_batch(
            poses0, switches0, edges,
            jnp.ones((C, edges.num_edges), dtype), free, scfg, model,
            partition,
        )
        res = jax.tree.map(lambda x: x[0], res_b)
        psi_plain_dev = psi_b[0]
    else:
        res = lm_solve(
            poses0, switches0, edges, free, scfg,
            model=model, partition=partition,
        )
    jax.block_until_ready(res.poses)

    # ---- DCS rescue passes (psi-consensus + GNC retry) -----------------
    # Plain DCS has two failure modes on outlier-injected graphs:
    # (a) the PARTIALLY poisoned basin on raw-odometry graphs at the
    #     reference's headline outlier counts (INTEL 100-200,
    #     README.md:41-42): most bogus loops end suppressed (psi ~ 0) but
    #     so do 30-60% of the real ones, and the surviving consensus is
    #     bent meters away (measured INTEL+100: ATE 6.17 m, 94/256 real
    #     loops dropped);
    # (b) TOTAL closure dropout from a bad init (M3500/MIT): psi ~ 0 on
    #     everything and LM settles in the odometry-only minimum.
    # For (a), run multi-chain psi-consensus: hard-drop loops whose final
    # psi < cut, re-solve from the ORIGINAL init (cold restart -- warm
    # restarts stay in the bent basin, measured), re-admit loops that fit
    # the improved solution, iterate to a mask fixed point; chain 0 trims
    # from the full loop set, the rest start from seeded random
    # half-subsets (the RANSAC move that cracks coalition traps --
    # measured INTEL+200 seed 42).  For (b), re-solve with GNC annealing.
    # ALL candidates (plain, every chain, GNC) are then ranked on the
    # COMMON full objective (cost_only over every live edge): loop-count
    # votes and mean-psi scores are both gameable by a mutually-
    # consistent bogus COALITION (measured on a 120-node two-lap circle:
    # the coalition "explains" more loops / raises mean psi while
    # tripling ATE), but fitting a coalition must bend the odometry, and
    # the full objective prices that.  Measured rankings (f64):
    # INTEL+100 plain/GNC/consensus cost 2.25/1.85/1.17 at ATE
    # 6.2/10.7/0.018 -- argmin-cost picks the quality winner.
    if (scfg.robust == "dcs" and not scfg.gnc_anneal_iters
            and (scfg.dcs_consensus or scfg.dcs_auto_retry)):
        cut = scfg.dcs_consensus_cut
        live_loop = (np.asarray(edges.active)
                     * np.asarray(edges.is_loop, np.float64))
        n_live = max(float(live_loop.sum()), 1.0)
        psi_plain = np.asarray(jax.device_get(
            psi_plain_dev if psi_plain_dev is not None
            else _psi_probe(res.poses, edges, scfg, model)))
        drop_frac = float((live_loop * (psi_plain < 0.2)).sum() / n_live)
        mean_psi = float((live_loop * psi_plain).sum() / n_live)
        candidates = []  # (tag, result)
        rounds_run = 0   # consensus rounds executed (batched dispatches)

        if (scfg.dcs_consensus
                and drop_frac > scfg.dcs_consensus_drop_frac):
            # All chains advance together: each consensus round is ONE
            # vmapped device program over the chain axis
            # (_chain_solve_batch) instead of a sequential per-chain
            # dispatch loop (chains are embarrassingly parallel and the
            # active mask is a program input).  Per-chain mask sequences are unchanged:
            # chain 0 trims from the full loop set via the plain solve's
            # psi, chains 1+ start from seeded random half-subsets (the
            # RANSAC move), every chain thereafter re-admits loops whose
            # psi clears the cut and freezes at its mask fixed point.
            base_active = np.asarray(edges.active)
            rng = np.random.default_rng(getattr(cfg, "seed", 0))
            C = max(1, scfg.dcs_consensus_chains)
            first = [np.where(live_loop > 0,
                              (psi_plain > cut).astype(base_active.dtype),
                              1.0)]
            for _ in range(1, C):
                sub = rng.random(base_active.shape) < 0.5
                first.append(np.where((live_loop > 0) & ~sub, 0.0,
                                      1.0).astype(base_active.dtype))
            cur = np.stack(first)                      # (C, E) chain masks
            fixed = np.zeros(C, dtype=bool)
            res_b = None
            for _ in range(scfg.dcs_consensus_rounds):
                rounds_run += 1
                res_b, psi_b = _chain_solve_batch(
                    poses0, switches0, edges,
                    jnp.asarray(cur * base_active[None], dtype),
                    free, scfg, model, partition,
                )
                psi_b = np.asarray(jax.device_get(psi_b))
                for c in range(C):
                    if fixed[c]:
                        continue  # frozen at its mask fixed point
                    new_mask = np.where(
                        live_loop > 0,
                        (psi_b[c] > cut).astype(base_active.dtype), 1.0)
                    if (new_mask == cur[c]).all():
                        fixed[c] = True
                    else:
                        cur[c] = new_mask
                if fixed.all():
                    break
            # A frozen chain keeps solving its frozen mask (the solve is a
            # pure function, so re-running is bit-identical) -- the LAST
            # round's batch therefore holds every chain's fixed-point
            # result, and per-chain slicing happens exactly once here
            # instead of per round (each slice is a device dispatch).
            for c in range(C):
                candidates.append(
                    (f"consensus{c}", jax.tree.map(lambda x, c=c: x[c],
                                                   res_b)))

        if scfg.dcs_auto_retry and mean_psi < scfg.dcs_retry_threshold:
            retry_cfg = scfg.replace(
                gnc_anneal_iters=scfg.dcs_retry_gnc_iters)
            res_g = lm_solve(
                poses0, switches0, edges, free, retry_cfg,
                model=model, partition=partition,
            )
            candidates.append(("gnc", res_g))

        if candidates:
            # Score plain + every candidate on the COMMON full objective
            # in ONE batched program.
            all_res = [res] + [r for _, r in candidates]
            costs = np.asarray(jax.device_get(_batched_full_cost(
                jnp.stack([r.poses for r in all_res]),
                jnp.stack([r.switches for r in all_res]),
                edges, scfg, model)))
            plain_cost = float(costs[0])
            scored = [(float(costs[1 + i]), tag, r)
                      for i, (tag, r) in enumerate(candidates)]
            best_cost, best_tag, best_res = min(scored, key=lambda x: x[0])
            # Replace the plain solve only on a clear (>2%) objective
            # improvement -- ties within noise keep reference behaviour.
            kept = best_cost < 0.98 * plain_cost
            logger.log(
                "retry", reason="dcs-rescue",
                drop_frac=round(drop_frac, 3),
                mean_psi=round(mean_psi, 3),
                rounds=rounds_run,
                candidates=len(candidates),
                plain_cost=round(plain_cost, 4),
                best_cost=round(best_cost, 4), best=best_tag,
                kept=bool(kept),
            )
            if kept:
                res = best_res
    wall = time.perf_counter() - t0

    logger.log(
        "solve",
        method=cfg.method,
        robust=scfg.robust,
        initial_cost=float(res.initial_cost),
        final_cost=float(res.cost),
        iterations=int(res.iterations),
        accepted=int(res.accepted),
        converged=bool(res.converged),
        linear_iters=int(res.lin_iters),
        wall_s=wall,
    )
    # FullReport analog (main.cpp:164): termination classification + step
    # accounting always; per-stage timing when cfg.report_stages.
    from slam_tpu.solver.report import build_report, measure_stages

    stage_times = None
    if cfg.report_stages:
        stage_times = measure_stages(
            res.poses, res.switches, edges, free, scfg, model,
            partition=partition,
        )
    report = build_report(res, scfg, wall, stage_times)
    logger.log("report", **report.fields())
    print(report.text())
    return GlobalSolveOutput(
        graph=graph,
        poses=np.asarray(jax.device_get(res.poses)),
        switches=np.asarray(jax.device_get(res.switches)),
        result=res,
        wall_time_s=wall,
    )


def run_from_config(cfg: RunConfig) -> GlobalSolveOutput:
    """Full reference-equivalent pipeline with ``save/`` artifacts."""
    os.makedirs(cfg.save_path, exist_ok=True)
    logger = RunLogger(os.path.join(cfg.save_path, f"method{cfg.method}.log"))

    graph = g2o.load_g2o(g2o.find_dataset(cfg.dataset))
    logger.log("init", dataset=cfg.dataset, **_counts(graph))
    graph = graph.add_random_outliers(cfg.num_outliers, seed=cfg.seed)
    logger.log("inject", num_bogus=cfg.num_outliers, seed=cfg.seed)

    # init_nodes/init_edges (``main.cpp:58-59``).
    g2o.write_nodes(os.path.join(cfg.save_path, "init_nodes.txt"), graph.poses)
    g2o.write_edges(os.path.join(cfg.save_path, "init_edges.txt"), graph)

    out = run_global_solve(graph, cfg, logger)

    g2o.write_nodes(os.path.join(cfg.save_path, "opt_nodes.txt"), out.poses)
    g2o.write_edges(os.path.join(cfg.save_path, "opt_edges.txt"), graph)
    if cfg.method == METHOD_SC:
        canon = graph.canonical_order()
        loop_mask = canon.edge_type != 0
        scfg = solver_config_for_method(cfg.method, cfg.solver)
        if scfg.robust == "sc_varpro":
            # Switches were eliminated; recover s* from final residuals.
            from slam_tpu.geometry import se2 as _se2
            from slam_tpu.robust.kernels import sc_varpro_switch
            import jax.numpy as _jnp
            pa = out.poses[canon.edges_ij[:, 0]]
            pb = out.poses[canon.edges_ij[:, 1]]
            e = _se2.residual(
                _jnp.asarray(pa), _jnp.asarray(pb),
                _jnp.asarray(canon.edges_meas),
            )
            sw_all = np.asarray(sc_varpro_switch(e, scfg.sc_prior_lambda))
            sw = sw_all[loop_mask]
        else:
            # out.switches covers the bucket-padded edge array; real first.
            sw = out.switches[: loop_mask.shape[0]][loop_mask]
        g2o.write_switches(
            os.path.join(cfg.save_path, "switches.txt"),
            graph,
            priors=np.ones_like(sw),
            optimized=sw,
        )
    logger.close()
    return out


def _counts(g: PoseGraph) -> dict:
    return dict(
        nodes=g.num_nodes,
        odometry=g.num_odometry,
        closure=g.num_closure,
        bogus=g.num_bogus,
    )

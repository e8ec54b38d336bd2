#!/usr/bin/env python
"""End-to-end smoke test of the robust pose-graph solver on one GPU.

    python chip_smoke.py              # phases 1-5 on one card
    python chip_smoke.py --four-gpu   # only the 4-card distributed Schur

Every phase runs in this one process (a second JAX process on the card
would fail for want of memory) and compares what the card computed with a
reference:

1. device    -- JAX's first device must be a GPU; no CPU fallback.
2. INTEL+50  -- the CLI product pipeline (``slam_tpu.cli.main``, method 1,
   seed 42): ATE of ``opt_nodes`` against the committed f64 golden; the
   plain DCS solve (dense, 100 iterations, no rescue) against its CPU f64
   anchor costs; and the bench workload (50 fixed iterations) solved
   dense, by native Schur P=16 and by blocked-Cholesky Schur P=16, each
   against its CPU f64 anchor.
3. M10000+50 -- DCS, spectral-partitioned Schur with the default
   (blocked) interior factorization, 50 iterations in chunks of 10: gate
   ``cost < 0.8 cost0``; the first chunk, in f32 and in f64 on the card,
   against the solver in f64 on the host CPU with LAPACK's factorization.
4. sphere2500 SE(3)+20 corrupted closures -- Schur P=4, 30 iterations:
   gate ``cost < cost0``; first chunk against f64 as in phase 3.
5. fused methods 3 and 4 on an INTEL prefix slice -- each fused scan
   engine makes the same decisions as its host manager, both on the card
   in f32, and fused method 3 with exact-Schur candidate evaluation makes
   the same decisions as with dense.  Both host managers must split the
   slice into several layers, so the comparison covers the split and
   selection logic.

``--four-gpu``: ``parallel/schur_dist.py`` with its block axis over four
cards on M3500+50, against the single-card Schur solve of the same graph.

Each phase prints its wall and compile time beside the card's name and
power limit.  A failed check raises; the last line of a passing run is the
JSON device record.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import jax
import jax.numpy as jnp
import numpy as np

import bench
from slam_tpu.config import MctsConfig, RunConfig, SolverConfig
from slam_tpu.eval import metrics
from slam_tpu.graph import PoseGraph
from slam_tpu.io import g2o
from slam_tpu.solver import schur
from slam_tpu.utils.logging import RunLogger

_REPO = os.path.dirname(os.path.abspath(__file__))
INTEL_GOLDEN = os.path.join(_REPO, "results", "golden",
                            "INTEL_50out_seed42.npy")

# Tolerances, all against f64 references computed on a CPU.
#: ATE (m) of the f32 product pipeline against the f64 golden trajectory.
INTEL_ATE_TOL = 0.05
#: Plain DCS solve of INTEL+50 seed 42 (dense, 100 iterations, no rescue):
#: CPU f64 initial and final cost, and the relative tolerance of the f32
#: solve against them.
INTEL_PLAIN_ANCHOR = (2.969723, 1.508126)
INTEL_PLAIN_RTOL = 1e-3
#: The bench workload, INTEL+50 seed 42 with ``lm_fixed_iters`` for 50
#: iterations: CPU f64 initial and final cost (dense and Schur agree to
#: 1e-12).  Each f32 solve on the card is held to ``INTEL_PLAIN_RTOL``.
INTEL_FIXED_ANCHOR = (2.969723, 1.516733)
FIXED_ITERS = 50
#: Same solver in f64 on the card against f64 on the CPU (costs).
F64_RTOL = 1e-8
#: f32 initial cost against the f64 one.
COST0_RTOL = 1e-5
#: f32 cost after the first chunk against f64.  At M10000 and M3500 scale
#: f32 steps are measurably less accurate than f64's (M10000's CPU f32 run
#: sits as far from f64 as the card's does), so their bound is wider.
LARGE_F32_RTOL = 0.1
SPHERE_F32_RTOL = 1e-3


class SmokeError(AssertionError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeError(what)


def require_gpu():
    """Phase 1: the first JAX device must be a GPU."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"chip_smoke.py needs a GPU; JAX found {dev}")
    return dev


class _CompileClock:
    """Sums JAX's compile-stage durations (trace, lowering, backend)."""

    _EVENTS = ("/jax/core/compile/jaxpr_trace_duration",
               "/jax/core/compile/jaxpr_to_mlir_module_duration",
               "/jax/core/compile/backend_compile_duration")

    def __init__(self):
        self.total = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on)

    def _on(self, name, secs, **_):
        if name in self._EVENTS:
            self.total += secs


def on_cpu_f64(fn):
    """Run ``fn()`` on the host CPU with 64-bit types enabled."""
    with jax.enable_x64(True), jax.default_device(jax.devices("cpu")[0]):
        return fn()


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


# ---------------------------------------------------------------------------
# phase 2: INTEL+50 through the CLI
# ---------------------------------------------------------------------------

def phase_intel(save_dir: str, dataset: str = "INTEL",
                num_outliers: int = 50, seed: int = 42,
                golden: np.ndarray | None = None,
                plain_anchor: tuple[float, float] = INTEL_PLAIN_ANCHOR,
                plain_iters: int = 100,
                fixed_anchor: tuple[float, float] = INTEL_FIXED_ANCHOR,
                nblocks: int = bench.NUM_BLOCKS) -> dict:
    from slam_tpu import cli
    from slam_tpu.methods.global_solve import run_global_solve

    rc = cli.main([dataset, str(num_outliers), "1", "--seed", str(seed),
                   "--save-path", save_dir])
    check(rc == 0, f"cli.main returned {rc}")
    opt = g2o.load_nodes(os.path.join(save_dir, "opt_nodes.txt"))
    golden = np.load(INTEL_GOLDEN) if golden is None else golden
    check(opt.shape == golden.shape and np.isfinite(opt).all(),
          f"opt_nodes shape {opt.shape} / finite vs golden {golden.shape}")
    ate = metrics.ate(opt, golden)
    check(ate <= INTEL_ATE_TOL, f"product ATE {ate} m > {INTEL_ATE_TOL} m")

    graph = g2o.load_g2o(g2o.find_dataset(dataset))
    graph = graph.add_random_outliers(num_outliers, seed=seed)
    plain = run_global_solve(graph, RunConfig(
        dataset=dataset, method=1, num_outliers=num_outliers, seed=seed,
        init="dataset",
        solver=SolverConfig(dtype="float32", linear_solver="dense",
                            max_iterations=plain_iters,
                            dcs_consensus=False, dcs_auto_retry=False),
    ), RunLogger(echo=False)).result
    c0, c = float(plain.initial_cost), float(plain.cost)
    check(_rel(c0, plain_anchor[0]) <= INTEL_PLAIN_RTOL,
          f"plain initial cost {c0} vs anchor {plain_anchor[0]}")
    check(_rel(c, plain_anchor[1]) <= INTEL_PLAIN_RTOL,
          f"plain final cost {c} vs anchor {plain_anchor[1]}")
    out = {"ate_m": ate, "plain_cost0": c0, "plain_cost": c,
           "plain_iters": int(plain.iterations)}
    out.update(fixed_iters_vs_anchor(graph.canonical_order(), fixed_anchor,
                                     nblocks))
    return out


def fixed_iters_vs_anchor(g: PoseGraph, anchor: tuple[float, float],
                          nblocks: int) -> dict:
    """``FIXED_ITERS`` f32 LM iterations solved dense, by native Schur and
    by panel-128 blocked-Cholesky Schur, each against the f64 anchor."""
    from slam_tpu.solver.lm import lm_fixed_iters
    from slam_tpu.solver.problem import anchor_first_node, edge_set_from_graph

    dt = jnp.float32
    edges = edge_set_from_graph(g, dtype=dt, incidence=True)
    free = anchor_first_node(g.num_nodes, dtype=dt)
    part = schur.build_partition(g.edges_ij, g.num_nodes, nblocks, dtype=dt)
    dense = SolverConfig(robust="dcs", linear_solver="dense", dtype="float32")
    native = dense.replace(linear_solver="schur")
    out = {}
    for name, cfg in (("dense", dense), ("schur", native),
                      ("schur_blocked", native.replace(schur_blocked=True,
                                                       schur_panel=128))):
        r = lm_fixed_iters(jnp.asarray(g.poses, dt),
                           jnp.ones((edges.num_edges,), dt), edges, free,
                           cfg, FIXED_ITERS,
                           partition=None if name == "dense" else part)
        c0, c = float(r.initial_cost), float(r.cost)
        check(_rel(c0, anchor[0]) <= INTEL_PLAIN_RTOL
              and _rel(c, anchor[1]) <= INTEL_PLAIN_RTOL,
              f"{name} {FIXED_ITERS} iterations {c0} -> {c} vs anchor "
              f"{anchor[0]} -> {anchor[1]}")
        out[f"{name}_cost{FIXED_ITERS}"] = c
    return out


# ---------------------------------------------------------------------------
# phases 3 and 4: single large problems against f64 on the CPU
# ---------------------------------------------------------------------------

def _chunked_vs_cpu(make_problem, iters: int, gate, gate_what: str,
                    f32_rtol: float, memory: bool = False) -> dict:
    """f32 on the card for ``iters`` iterations behind ``gate``; then the
    first chunk in f64 on the card, and both against f64 on the host CPU
    with LAPACK's factorization."""
    prob = make_problem(jnp.float32)
    out = {"blocks": prob.nblocks, "scheme": prob.scheme,
           "blocked": prob.cfg.schur_blocked}
    if memory:
        mem = bench.chunk_compiled(prob).memory_analysis()
        print(f"  memory_analysis: {mem}")
        if mem is not None:
            out["temp_bytes"] = int(mem.temp_size_in_bytes)
            out["argument_bytes"] = int(mem.argument_size_in_bytes)
    _, cost0, costs = bench.solve_chunks(prob, iters)
    check(all(np.isfinite(costs)), f"non-finite costs {costs}")
    check(gate(costs[-1], cost0), f"{gate_what}: cost0 {cost0} -> {costs}")
    stats = jax.devices()[0].memory_stats()
    if stats and "peak_bytes_in_use" in stats:
        out["peak_bytes_in_use"] = int(stats["peak_bytes_in_use"])

    def first_chunk(native: bool = False):
        p = make_problem(jnp.float64)
        if native:  # LAPACK's factorization: independent of blocked_chol
            p = p._replace(cfg=p.cfg.replace(schur_blocked=False))
        return bench.solve_chunks(p, bench.CHUNK)[1:]

    ref0, ref = on_cpu_f64(lambda: first_chunk(native=True))
    with jax.enable_x64(True):
        dev0, dev = first_chunk()
    check(_rel(dev0, ref0) <= F64_RTOL and _rel(dev[0], ref[0]) <= F64_RTOL,
          f"f64 on the card {dev0} -> {dev[0]} vs CPU {ref0} -> {ref[0]}")
    check(_rel(cost0, ref0) <= COST0_RTOL,
          f"f32 initial cost {cost0} vs f64 {ref0}")
    check(_rel(costs[0], ref[0]) <= f32_rtol,
          f"f32 cost after {bench.CHUNK} iterations {costs[0]} vs f64 "
          f"{ref[0]} (rtol {f32_rtol})")
    out.update(cost0=cost0, costs=costs, f64_cost0=ref0,
               f64_chunk_cost=ref[0], f64_card_chunk_cost=dev[0],
               f32_vs_f64_rel=_rel(costs[0], ref[0]))
    return out


def phase_m10000(graph: PoseGraph | None = None, iters: int = 50) -> dict:
    dirty = bench.m10000_graph() if graph is None else graph
    choice = schur.choose_partition(dirty.edges_ij, dirty.num_nodes)
    return _chunked_vs_cpu(
        lambda dt: bench.m10000_problem(dirty, dt, choice), iters,
        lambda c, c0: c < 0.8 * c0, "cost < 0.8 cost0", LARGE_F32_RTOL,
        memory=True)


def phase_sphere(graph: PoseGraph | None = None, nblocks: int = 4,
                 iters: int = 30) -> dict:
    dirty = bench.sphere_graph() if graph is None else graph
    return _chunked_vs_cpu(
        lambda dt: bench.sphere_problem(dirty, dt, nblocks), iters,
        lambda c, c0: c < c0, "cost < cost0", SPHERE_F32_RTOL)


# ---------------------------------------------------------------------------
# phase 5: fused method 4 against the host manager
# ---------------------------------------------------------------------------

def intel_prefix_slice(graph: PoseGraph | None = None, closures: int = 40,
                       outliers: int = 4, seed: int = 7) -> PoseGraph:
    """The prefix of INTEL that holds its first ``closures`` loop closures
    (~300 nodes), with ``outliers`` seeded bogus loops."""
    g = g2o.load_g2o(g2o.find_dataset("INTEL")) if graph is None else graph
    ij, et = np.asarray(g.edges_ij), np.asarray(g.edge_type)
    loops = np.where(et != 0)[0]
    maxn = int(ij[loops[:closures]].max()) + 1
    keep = (ij[:, 0] < maxn) & (ij[:, 1] < maxn)
    sub = PoseGraph(poses=np.asarray(g.poses)[:maxn], edges_ij=ij[keep],
                    edges_meas=np.asarray(g.edges_meas)[keep],
                    edges_info=np.asarray(g.edges_info)[keep],
                    edge_type=et[keep])
    return sub.add_random_outliers(outliers, seed=seed)


#: MCTS split threshold for phase 5.  The default (0.3) never splits the
#: slice; at 0.01 the host manager grows four layers, its most-edges
#: pick differs from its best one, and every split decision clears the
#: threshold by over 1e-4 (costs are ~0.04, so far above f32 noise).
MCTS_CONFLICT_TAU = 0.01


def phase_methods(graph: PoseGraph | None = None,
                  min_layers: int = 2) -> dict:
    from slam_tpu.config import LayeringConfig
    from slam_tpu.methods.layering import LayeringManager
    from slam_tpu.methods.layering_fused import FusedLayeringManager
    from slam_tpu.methods.mcts import MctsManager
    from slam_tpu.methods.mcts_fused import FusedMctsManager

    sub = intel_prefix_slice(graph)
    solver = SolverConfig(linear_solver="dense", dtype="float32")

    def run(manager, cfg, solver_cfg=solver):
        return manager(sub, cfg, solver_cfg, RunLogger(echo=False)).run()

    lcfg = LayeringConfig(local_iters=2, max_layers=10)
    host3, fused3 = run(LayeringManager, lcfg), run(FusedLayeringManager, lcfg)
    check(len(host3.layers) >= min_layers,
          f"method 3 host made {len(host3.layers)} layers")
    check(fused3.assignments == host3.assignments,
          "method 3 fused and host edge assignments differ")
    check(fused3.best_layer == host3.best_layer, "method 3 best layer differs")
    check(len(fused3.layers) == len(host3.layers),
          "method 3 layer count differs")
    d3 = float(np.abs(np.asarray(fused3.poses) - host3.poses).max())
    check(d3 <= 5e-4, f"method 3 fused poses differ from host by {d3}")

    schur3 = run(FusedLayeringManager,
                 LayeringConfig(local_iters=2, max_layers=10,
                                eval_linear="schur", eval_schur_blocks=8),
                 solver.replace(linear_solver="schur"))
    check(schur3.assignments == fused3.assignments,
          "method 3 exact-Schur evaluation assignments differ from dense")
    check(schur3.best_layer == fused3.best_layer,
          "method 3 exact-Schur evaluation best layer differs")
    check(len(schur3.layers) == len(fused3.layers),
          "method 3 exact-Schur evaluation layer count differs")
    ds = float(np.abs(np.asarray(schur3.poses) - fused3.poses).max())
    check(ds <= 5e-3, f"method 3 Schur-evaluated poses differ by {ds}")

    mcfg = MctsConfig(local_iters=2, max_layers=10,
                      conflict_tau=MCTS_CONFLICT_TAU)
    host4, fused4 = run(MctsManager, mcfg), run(FusedMctsManager, mcfg)
    check(len(host4.layers) >= min_layers,
          f"method 4 host made {len(host4.layers)} layers")
    check(fused4.assignments == host4.assignments,
          "method 4 fused and host edge assignments differ")
    check(fused4.best_layer == host4.best_layer, "best layer differs")
    check(fused4.most_visited_layer == host4.most_visited_layer,
          "most-visited layer differs")
    check(fused4.most_edges_layer == host4.most_edges_layer,
          "most-edges layer differs")
    check([l.visits for l in fused4.layers.values()]
          == [l.visits for l in host4.layers.values()], "layer visits differ")
    return {"nodes": sub.num_nodes,
            "m3_decisions": len(host3.assignments),
            "m3_layers": len(host3.layers), "m3_pose_diff": d3,
            "m3_schur_pose_diff": ds,
            "m4_decisions": len(host4.assignments),
            "m4_layers": len(host4.layers),
            "m4_visits": [l.visits for l in host4.layers.values()],
            "m4_best": host4.best_layer,
            "m4_most_edges": host4.most_edges_layer}


# ---------------------------------------------------------------------------
# --four-gpu: distributed Schur over a 4-device block mesh
# ---------------------------------------------------------------------------

def phase_four_gpu(graph: PoseGraph | None = None, iters: int = 10,
                   num_devices: int = 4) -> dict:
    """Distributed Schur with one block per device against the one-device
    Schur solve of the same partition: in f64 to ``F64_RTOL``, and the f32
    distributed solve against f64 to ``LARGE_F32_RTOL``."""
    from slam_tpu.parallel.mesh import make_block_mesh
    from slam_tpu.parallel.schur_dist import (
        build_dist_problem, distributed_schur_lm)
    from slam_tpu.solver.lm import lm_fixed_iters
    from slam_tpu.solver.problem import anchor_first_node, edge_set_from_graph

    check(len(jax.devices()) >= num_devices,
          f"needs {num_devices} devices, found {len(jax.devices())}")
    if graph is None:
        graph = g2o.load_g2o(g2o.find_dataset("M3500"))
        graph = graph.add_random_outliers(50, seed=0)
    g = graph.canonical_order()
    mesh = make_block_mesh(num_devices)

    def solve(dt, distributed: bool):
        cfg = SolverConfig(robust="dcs", linear_solver="schur",
                           dtype=jnp.dtype(dt).name)
        free = anchor_first_node(g.num_nodes, dtype=dt)
        poses0 = jnp.asarray(g.poses, dt)
        if distributed:
            prob = build_dist_problem(g, num_devices, dtype=dt)
            poses, cost, cost0, _ = distributed_schur_lm(
                poses0, free, prob, cfg, mesh, iters)
        else:
            edges = edge_set_from_graph(g, dtype=dt, incidence=False)
            part = schur.build_partition(g.edges_ij, g.num_nodes,
                                         num_devices, dtype=dt)
            r = lm_fixed_iters(poses0, jnp.ones((edges.num_edges,), dt),
                               edges, free, cfg, iters, partition=part)
            poses, cost, cost0 = r.poses, r.cost, r.initial_cost
        check(np.isfinite(np.asarray(poses)).all(), "non-finite poses")
        return float(cost0), float(cost)

    with jax.enable_x64(True):
        d64, s64 = solve(jnp.float64, True), solve(jnp.float64, False)
    d32 = solve(jnp.float32, True)
    for i, what in enumerate(("initial cost", f"cost after {iters} iters")):
        check(_rel(d64[i], s64[i]) <= F64_RTOL,
              f"f64 {what}: distributed {d64[i]} vs one device {s64[i]}")
    check(_rel(d32[0], s64[0]) <= COST0_RTOL,
          f"f32 distributed initial cost {d32[0]} vs f64 {s64[0]}")
    check(_rel(d32[1], s64[1]) <= LARGE_F32_RTOL,
          f"f32 distributed cost {d32[1]} vs f64 {s64[1]}")
    check(d32[1] < d32[0], f"no decrease: {d32}")
    return {"nodes": g.num_nodes, "blocks": num_devices, "iters": iters,
            "dist_f64": d64, "single_f64": s64, "dist_f32": d32,
            "dist_cost0": d32[0], "dist_cost": d32[1]}


def run_phase(name: str, fn, clock: _CompileClock, card: str) -> dict:
    c0, t0 = clock.total, time.perf_counter()
    out = fn()
    wall = time.perf_counter() - t0
    print(f"[{name}] ok wall_s={wall:.3f} compile_s={clock.total - c0:.3f} "
          f"card={card!r} {json.dumps(out)}", flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-gpu", action="store_true",
                    help="run only the 4-card distributed Schur phase")
    args = ap.parse_args(argv)

    from slam_tpu.utils.cache import enable_persistent_cache

    dev = require_gpu()
    enable_persistent_cache()
    clock = _CompileClock()
    card = bench.card_info()
    print(f"[device] {dev.platform} {dev.device_kind} "
          f"x{len(jax.devices())}", flush=True)
    for line in card.split("; "):  # as nvidia-smi prints them
        print(line, flush=True)

    if args.four_gpu:
        run_phase("four_gpu_schur_m3500", phase_four_gpu, clock, card)
    else:
        with tempfile.TemporaryDirectory() as tmp:
            run_phase("intel50_cli", lambda: phase_intel(tmp), clock, card)
        run_phase("m10000_schur", phase_m10000, clock, card)
        run_phase("sphere2500_se3", phase_sphere, clock, card)
        run_phase("methods34_fused_intel_slice", phase_methods, clock,
                  card)
    print(json.dumps({"ok": True, "device": bench.device_record()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

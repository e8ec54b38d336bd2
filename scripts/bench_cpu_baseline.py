"""Measure the single-core CPU LM baseline that anchors bench.py's ratio.

The reference's solve is Ceres (SPARSE_NORMAL_CHOLESKY, trust-region LM)
on a single CPU host (``main.cpp:154-163``); Ceres is not installable in
this image (verified r1), so the measured stand-in is THIS repo's own
solver -- f64, dense Cholesky (the configuration whose fixed point is
bit-validated against the golden trajectories) -- on the identical
INTEL+50 workload, pinned to one core.

Writes ``results/cpu_baseline.json`` (consumed by bench.py for the
``vs_measured_cpu`` field) and prints the record.

Run:  python scripts/bench_cpu_baseline.py
Single-core enforcement is via the XLA single-thread flags below
(execution intra-op parallelism = 1).  r5 note: do NOT additionally
``taskset -c 0`` the whole process -- that pins XLA *compilation* (which
is internally parallel) to one core too, and the f64 SE(3) Schur
programs then take >45 min to compile (measured; the run never reached
the measurement).  The r4 committed INTEL number from a taskset run and
this scheme agree (the flags are what bound the timed region).
"""

from __future__ import annotations

import json
import os
import sys
import time

os.environ.setdefault(
    "XLA_FLAGS",
    "--xla_cpu_multi_thread_eigen=false intra_op_parallelism_threads=1",
)
os.environ["JAX_PLATFORMS"] = "cpu"

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

OUT = os.path.join(os.path.dirname(__file__), "..", "results",
                   "cpu_baseline.json")
LM_ITERS = 50


def main() -> None:
    # Workload selection: any of {intel, m10000, sphere}; default all.
    # Results merge into the existing OUT json so workloads can be
    # (re)measured independently (the sphere f64 SE(3) compile is the
    # long pole).
    wanted = set(a for a in sys.argv[1:] if not a.startswith("-")) or {
        "intel", "m10000", "sphere"}

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    from slam_tpu.utils.cache import enable_persistent_cache
    enable_persistent_cache()
    import jax.numpy as jnp
    import numpy as np

    from slam_tpu.config import SolverConfig
    from slam_tpu.io import g2o
    from slam_tpu.solver.lm import lm_fixed_iters
    from slam_tpu.solver.problem import anchor_first_node, edge_set_from_graph

    from slam_tpu.solver.schur import build_partition

    graph = g2o.load_g2o(g2o.find_dataset("INTEL"))
    dirty = graph.add_random_outliers(50, seed=42).canonical_order()
    edges = edge_set_from_graph(dirty, dtype=jnp.float64, incidence=False)
    free = anchor_first_node(dirty.num_nodes, dtype=jnp.float64)
    poses0 = jnp.asarray(dirty.poses, jnp.float64)
    sw0 = jnp.ones((edges.num_edges,), jnp.float64)
    part = build_partition(np.asarray(edges.ij), dirty.num_nodes, 16,
                           dtype=jnp.float64)
    rng = np.random.default_rng(1)

    def measure(solver, partition):
        cfg = SolverConfig(robust="dcs", linear_solver=solver,
                           dtype="float64")

        def run(p):
            return lm_fixed_iters(p, sw0, edges, free, cfg, LM_ITERS,
                                  partition=partition)

        # Warm-up / compile + the quality anchor for this exact config
        # (verify skill: 2.969723 -> ~1.51 at 50 iters).
        r = run(poses0)
        jax.block_until_ready(r.poses)
        assert float(r.initial_cost) > 2.5 and float(r.cost) < 1.8, (
            solver, float(r.initial_cost), float(r.cost))
        best = float("inf")
        for _ in range(3):
            p = poses0 + jnp.asarray(rng.normal(0, 1e-6, poses0.shape))
            t0 = time.perf_counter()
            out = run(p)
            _ = jax.device_get(out.poses)
            best = min(best, time.perf_counter() - t0)
        return round(LM_ITERS / best, 2), float(r.cost)

    dense_ips = schur_ips = None
    if "intel" in wanted:
        dense_ips, dense_cost = measure("dense", None)
        print("intel dense:", dense_ips, flush=True)
        schur_ips, schur_cost = measure("schur", part)
        print("intel schur:", schur_ips, flush=True)

    def oracle_anchor(dataset, outliers, seed, iters):
        """The Ceres-semantics oracle (scipy sparse-LU trust-region LM --
        the reference's exact SPARSE_NORMAL_CHOLESKY algorithm) measured
        on this machine: the most faithful 'single-host Ceres CPU'
        stand-in available (r5, VERDICT task 3)."""
        from slam_tpu.solver import ceres_oracle as co

        g = g2o.load_g2o(g2o.find_dataset(dataset))
        if outliers:
            g = g.add_random_outliers(outliers, seed=seed)
        g = g.canonical_order()
        best = float("inf")
        done = None
        for _ in range(2):
            t0 = time.perf_counter()
            rep = co.ceres_solve(
                np.asarray(g.poses), np.asarray(g.edges_ij),
                np.asarray(g.edges_meas), np.asarray(g.edge_type),
                method=1, max_iterations=iters)
            wall = time.perf_counter() - t0
            if rep.iterations / wall < best or done is None:
                pass
            best = min(best, wall / max(1, rep.iterations))
            done = rep.iterations
        return round(1.0 / best, 2), done

    intel_oracle_ips = m10k_oracle_ips = m10k_iters = None
    if "intel" in wanted:
        intel_oracle_ips, _ = oracle_anchor("INTEL", 50, 42, LM_ITERS)
        print("intel oracle:", intel_oracle_ips, flush=True)
    if "m10000" in wanted:
        m10k_oracle_ips, m10k_iters = oracle_anchor("M10000", 50, 0, 10)
        print("m10000 oracle:", m10k_oracle_ips, flush=True)

    def sphere_anchor():
        """Our solver, f64 tridiag-PCG, one core -- sphere2500 SE(3) has
        no oracle (the reference's residuals are SE(2)-only), and the
        exact Schur anchor is INFEASIBLE at one core: sphere's closure
        topology is not chain-like, so the separator reaches O(1000)
        nodes and its dense (6 ns)^2 factorization alone is ~1e13 flops
        per iteration (measured: >55 CPU-minutes without completing one
        solve).  The PCG anchor is INEXACT (rtol 1e-3), which makes it
        FASTER than an exact CPU solve -- the vs_measured_cpu ratio for
        the sphere row is therefore conservative."""
        import dataclasses

        from slam_tpu.solver.models import SE3Model

        g = g2o.load_g2o("data/sphere2500.g2o").canonical_order()
        meas = g.edges_meas.copy()
        rng0 = np.random.default_rng(5)
        loop_idx = np.where(g.edge_type != 0)[0]
        bad = rng0.choice(loop_idx, size=20, replace=False)
        meas[bad, :3] += rng0.normal(0, 20.0, (20, 3))
        etype = g.edge_type.copy()
        etype[bad] = 2
        dirty = dataclasses.replace(g, edges_meas=meas, edge_type=etype)
        edges_s = edge_set_from_graph(dirty, dtype=jnp.float64)
        free_s = anchor_first_node(dirty.num_nodes, dtype=jnp.float64)
        p0 = jnp.asarray(dirty.poses, jnp.float64)
        sw = jnp.ones((edges_s.num_edges,), jnp.float64)
        cfg = SolverConfig(robust="dcs", linear_solver="pcg",
                           dtype="float64",
                           pcg_rtol=1e-3, pcg_max_iters=100,
                           pcg_preconditioner="tridiag")
        ITERS = 10

        def run(p):
            return lm_fixed_iters(p, sw, edges_s, free_s, cfg, ITERS,
                                  model=SE3Model)

        r = run(p0)
        jax.block_until_ready(r.poses)
        assert float(r.cost) < float(r.initial_cost)
        best = float("inf")
        for _ in range(2):
            p = p0.at[:, :3].add(
                jnp.asarray(rng.normal(0, 1e-6, (p0.shape[0], 3))))
            t0 = time.perf_counter()
            out = run(p)
            _ = jax.device_get(out.poses)
            best = min(best, time.perf_counter() - t0)
        return round(ITERS / best, 2)

    sphere_ips = sphere_anchor() if "sphere" in wanted else None
    if sphere_ips:
        print("sphere:", sphere_ips, flush=True)

    pinning = "XLA single-thread execution flags (see module docstring)"
    rec = {}
    if os.path.exists(OUT):
        with open(OUT) as f:
            rec = json.load(f)
    new = {
        "pinning": pinning,
        "lm_iters": LM_ITERS,
        # r5 multi-workload schema (consumed by bench.py's panel rows).
        "M10000": {
            "iters_per_s": m10k_oracle_ips,
            "engine": "ceres_oracle (scipy sparse-LU LM, the reference's "
                      "exact algorithm), 1 core",
            "iters_measured": m10k_iters,
        },
        "sphere2500": {
            "iters_per_s": sphere_ips,
            "engine": "own solver f64 tridiag-PCG rtol 1e-3, 1 core "
                      "(no oracle: reference residuals are SE(2)-only; "
                      "exact 1-core Schur infeasible -- see "
                      "sphere_anchor docstring; inexact anchor makes "
                      "the device ratio conservative)",
        },
    }
    if "intel" in wanted:
        new.update({
            # Back-compat top-level keys = the INTEL anchor (r4 schema).
            "workload": "INTEL+50outliers seed42, DCS LM, f64, 1 CPU core",
            "dense_iters_per_s": dense_ips,
            "schur_p16_iters_per_s": schur_ips,
            "iters_per_s": max(dense_ips, schur_ips),
            "final_cost": {"dense": dense_cost, "schur": schur_cost},
            "oracle_iters_per_s": intel_oracle_ips,
            "INTEL": {
                "iters_per_s": max(dense_ips, schur_ips),
                "oracle_iters_per_s": intel_oracle_ips,
                "note": "own solver f64 (best of dense/schur) and the "
                        "Ceres-semantics oracle, both 1 core",
            },
        })
    for k, v in new.items():
        if isinstance(v, dict) and not any(x is None for x in v.values()):
            rec[k] = v
        elif not isinstance(v, dict) and v is not None:
            rec[k] = v
    with open(OUT, "w") as f:
        json.dump(rec, f, indent=2)
    print(json.dumps(rec))


if __name__ == "__main__":
    main()

"""Benchmark panel: robust LM optimizer throughput on one GPU, at three
problem scales.

Rows (all DCS robust LM, f32, partitioned-Schur exact solves, quality-gated
before timing):

* **INTEL+50** (1228 nodes) -- the reference's headline experiment
  (``README.md:41-43``), batched over 8 independently-seeded outlier sets
  (the Try1/Try2 Monte-Carlo pattern as one device program).  This is the
  HEADLINE row (``value``).
* **M10000+50** (10k nodes, ``main.cpp:23``) -- single problem,
  spectral-graph partitioned Schur picked by ``choose_partition``.
* **sphere2500 SE(3)** (2500 nodes, 20 corrupted closures) -- the 3D
  family, Schur P=4.

The single-problem rows run in chunks of ``CHUNK`` LM iterations with the
trust-region state threaded through the host: one compiled chunk serves
any iteration count, and ``chip_smoke.py`` compares the first chunk with
an f64 CPU run of the same solver.  A chunk boundary costs one host round
trip.

Timing: best of 3, inputs perturbed per rep, ``jax.device_get`` barrier.
Every row names the device it ran on; any row that fails its gate or raises
makes the exit code non-zero.

Prints ONE JSON line: the INTEL headline fields plus a ``panel`` array with
every row's full record.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from slam_tpu.config import SolverConfig
from slam_tpu.io import g2o
from slam_tpu.solver.lm import lm_fixed_iters
from slam_tpu.solver.models import SE2Model, SE3Model
from slam_tpu.solver.problem import anchor_first_node, edge_set_from_graph
from slam_tpu.solver import schur

CERES_CPU_BASELINE_ITERS_PER_S = 100.0
LM_ITERS = 50
BATCH = 8
# INTEL index-partition block count (the cost model's pick).
NUM_BLOCKS = 16
CHUNK = 10
SPHERE_ITERS = 30
# Every row's interior factorization is the solver's default for its
# interior size (``schur.with_default_interiors``), as the CLI runs it.
INTEL_CFG = SolverConfig(robust="dcs", linear_solver="schur",
                         dtype="float32")

_REPO = os.path.dirname(os.path.abspath(__file__))


def card_info() -> str:
    """The cards' name and power limit as ``nvidia-smi`` reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"
    return "; ".join(ln.strip() for ln in out.splitlines() if ln.strip())


def device_record() -> dict:
    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}


def _cpu_anchor(workload: str):
    path = os.path.join(_REPO, "results", "cpu_baseline.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        rec = json.load(f)
    if workload in rec:
        return rec[workload].get("iters_per_s")
    return None


class Problem(NamedTuple):
    """One single-graph robust LM problem, ready for :func:`solve_chunks`."""

    poses0: jax.Array
    sw0: jax.Array
    edges: object
    free: object
    partition: schur.SchurPartition
    cfg: SolverConfig
    model: object
    nblocks: int
    scheme: str


def _single_problem(dirty, dtype, model, nblocks, node_block) -> Problem:
    edges = edge_set_from_graph(dirty, dtype=dtype, incidence="chain")
    partition = schur.build_partition(dirty.edges_ij, dirty.num_nodes,
                                      nblocks, dtype=dtype,
                                      node_block=node_block)
    cfg = SolverConfig(robust="dcs", linear_solver="schur",
                       dtype=jnp.dtype(dtype).name)
    return Problem(
        poses0=jnp.asarray(dirty.poses, dtype),
        sw0=jnp.ones((edges.num_edges,), dtype),
        edges=edges,
        free=anchor_first_node(dirty.num_nodes, dtype=dtype),
        partition=partition,
        cfg=schur.with_default_interiors(
            cfg, model.tangent_dim * partition.ni_max),
        model=model, nblocks=nblocks,
        scheme="index" if node_block is None else "graph",
    )


def m10000_graph(path=None, num_outliers: int = 50, seed: int = 0):
    graph = g2o.load_g2o(path or os.path.join(_REPO, "data", "M10000.g2o"))
    return graph.add_random_outliers(num_outliers, seed=seed).canonical_order()


def m10000_problem(dirty, dtype=jnp.float32, choice=None) -> Problem:
    """M10000+50 with the cost model's partition (``choice`` overrides it
    with a ``(num_blocks, node_block)`` pair)."""
    nblocks, node_block = choice or schur.choose_partition(
        dirty.edges_ij, dirty.num_nodes)
    return _single_problem(dirty, dtype, SE2Model, nblocks, node_block)


def sphere_graph(num_corrupt: int = 20):
    """sphere2500 with ``num_corrupt`` corrupted closures."""
    g = g2o.load_g2o(os.path.join(_REPO, "data", "sphere2500.g2o"))
    return corrupt_closures(g, num_corrupt)


def corrupt_closures(g, num_corrupt: int):
    """Shift ``num_corrupt`` seeded loop closures by N(0, 20 m) and mark
    them bogus."""
    import dataclasses

    g = g.canonical_order()
    meas = g.edges_meas.copy()
    rng = np.random.default_rng(5)
    loop_idx = np.where(g.edge_type != 0)[0]
    bad = rng.choice(loop_idx, size=num_corrupt, replace=False)
    meas[bad, :3] += rng.normal(0, 20.0, (num_corrupt, 3))
    etype = g.edge_type.copy()
    etype[bad] = 2
    return dataclasses.replace(g, edges_meas=meas, edge_type=etype)


def sphere_problem(dirty, dtype=jnp.float32, nblocks: int = 4) -> Problem:
    return _single_problem(dirty, dtype, SE3Model, nblocks, None)


def solve_chunks(prob: Problem, iters: int, chunk: int = CHUNK,
                 poses0=None, step=None):
    """Run ``iters`` LM iterations as ``iters // chunk`` calls of one
    compiled ``chunk``-iteration program (``step``, e.g. from
    :func:`chunk_compiled`; by default ``lm_fixed_iters``).  Returns
    ``(poses, cost0, [cost after each chunk])``."""
    if step is None:
        def step(p, s, edges, free, **kw):
            return lm_fixed_iters(p, s, edges, free, prob.cfg, chunk,
                                  model=prob.model, **kw)
    p = prob.poses0 if poses0 is None else poses0
    dtype = p.dtype
    s = prob.sw0
    lam = jnp.asarray(prob.cfg.init_lambda, dtype)
    nu = jnp.asarray(2.0, dtype)
    it = jnp.int32(0)
    cost0, costs = None, []
    for _ in range(iters // chunk):
        r = step(p, s, prob.edges, prob.free, partition=prob.partition,
                 lam0=lam, nu0=nu, it0=it)
        p, s, lam, nu, it = (r.poses, r.switches, r.final_lambda,
                             r.final_nu, r.iterations)
        if cost0 is None:
            cost0 = float(r.initial_cost)
        costs.append(float(r.cost))
    return p, cost0, costs


def chunk_compiled(prob: Problem, chunk: int = CHUNK):
    """The compiled ``chunk``-iteration program (for memory analysis)."""
    dtype = prob.poses0.dtype
    return lm_fixed_iters.lower(
        prob.poses0, prob.sw0, prob.edges, prob.free, prob.cfg, chunk,
        model=prob.model, partition=prob.partition,
        lam0=jnp.asarray(prob.cfg.init_lambda, dtype),
        nu0=jnp.asarray(2.0, dtype), it0=jnp.int32(0),
    ).compile()


def _best_of_3(run) -> float:
    best = float("inf")
    for rep in range(3):
        t0 = time.perf_counter()
        run(rep)
        best = min(best, time.perf_counter() - t0)
    return best


def intel_batch(cfg: SolverConfig | None = None, nblocks: int = NUM_BLOCKS,
                batch: int = BATCH):
    """INTEL+50 over ``batch`` outlier seeds as one vmapped program:
    returns ``(solve, args)`` with ``solve(*args) -> (costs, costs0)``.
    ``cfg`` defaults to ``INTEL_CFG`` with the default interiors."""
    graph = g2o.load_g2o(g2o.find_dataset("INTEL"))
    dirties = [graph.add_random_outliers(50, seed=s).canonical_order()
               for s in range(batch)]
    sets = [edge_set_from_graph(g, dtype=jnp.float32, incidence=True)
            for g in dirties]
    # partition_stats gives the shared pad maxima without materialising
    # the selection operators twice per seed.
    stats = [schur.partition_stats(g.edges_ij, g.num_nodes, nblocks)
             for g in dirties]
    pad = tuple(max(s[i] for s in stats) for i in range(len(stats[0])))
    parts = [schur.build_partition(g.edges_ij, g.num_nodes, nblocks,
                                   dtype=jnp.float32, pad_shapes=pad)
             for g in dirties]
    if cfg is None:
        cfg = schur.with_default_interiors(
            INTEL_CFG, SE2Model.tangent_dim * parts[0].ni_max)
    edges_b = jax.tree.map(lambda *xs: jnp.stack(xs), *sets)
    parts_b = jax.tree.map(lambda *xs: jnp.stack(xs), *parts)
    free = anchor_first_node(graph.num_nodes, dtype=jnp.float32)
    poses0 = jnp.asarray(graph.poses, jnp.float32)
    sw0 = jnp.ones((sets[0].num_edges,), jnp.float32)

    @jax.jit
    def solve(p, eb, pb):
        def one(e, part):
            r = lm_fixed_iters(p, sw0, e, free, cfg, LM_ITERS,
                               partition=part)
            return r.cost, r.initial_cost
        return jax.vmap(one)(eb, pb)

    return solve, (poses0, edges_b, parts_b)


def bench_intel() -> dict:
    """INTEL+50 x 8 seeds, 50 iters, batched per-seed partitioned Schur."""
    solve, (poses0, edges_b, parts_b) = intel_batch()
    costs, costs0 = (np.asarray(x) for x in
                     jax.device_get(solve(poses0, edges_b, parts_b)))
    # Quality gate: every seed must converge substantially (dense f64 on
    # seed 42 reaches ~0.5x initial in 50 iters; requiring < 0.6x here).
    if not (np.all(costs0 > 2.0) and np.all(costs < 0.6 * costs0)):
        return {"workload": "INTEL+50 batch8", "gate_failed": True,
                "costs0": costs0.tolist(), "costs": costs.tolist(),
                "iters_per_s": 0.0}

    rng = np.random.default_rng(1)

    def run(_):
        p = poses0 + jnp.asarray(rng.normal(0, 1e-6, poses0.shape),
                                 jnp.float32)
        jax.device_get(solve(p, edges_b, parts_b))

    best = _best_of_3(run)
    row = {
        "workload": (f"INTEL+50outliers DCS robust LM (1 GPU, batch {BATCH},"
                     " per-seed partitioned-Schur exact solve, f32)"),
        "iters_per_s": BATCH * LM_ITERS / best,
        "lm_iters": LM_ITERS, "batch": BATCH,
    }
    anchor = _cpu_anchor("INTEL")
    if anchor:
        row["vs_measured_cpu"] = row["iters_per_s"] / anchor
    return row


def _bench_single(name: str, prob: Problem, iters: int, gate) -> dict:
    _, cost0, costs = solve_chunks(prob, iters)
    cost = costs[-1]
    if not gate(cost, cost0):
        return {"workload": name, "gate_failed": True, "cost0": cost0,
                "cost": cost, "iters_per_s": 0.0}
    rng = np.random.default_rng(1)
    p0 = prob.poses0

    def run(_):
        p = p0.at[:, :3].add(jnp.asarray(
            rng.normal(0, 1e-6, (p0.shape[0], 3)), p0.dtype))
        solve_chunks(prob, iters, poses0=p)

    best = _best_of_3(run)
    return {"workload": name, "iters_per_s": iters / best,
            "lm_iters": iters, "batch": 1, "cost0": cost0, "cost": cost}


def bench_m10000() -> dict:
    prob = m10000_problem(m10000_graph())
    row = _bench_single(
        "M10000+50outliers DCS robust LM (1 GPU, single problem, "
        f"{prob.scheme} Schur P={prob.nblocks} exact solve, f32, chunked "
        f"{LM_ITERS // CHUNK}x{CHUNK})",
        prob, LM_ITERS, lambda c, c0: c < 0.8 * c0)
    anchor = _cpu_anchor("M10000")
    if anchor and row.get("iters_per_s"):
        row["vs_measured_cpu"] = row["iters_per_s"] / anchor
    return row


def bench_sphere() -> dict:
    """sphere2500 SE(3), 20 corrupted closures, Schur P=4, 30 iterations.
    Structured corruption leaves a strong odometry-only stationary point,
    so the gate is cost decrease (results/README.md)."""
    row = _bench_single(
        "sphere2500 SE(3) +20 corrupted closures DCS robust LM (1 GPU, "
        f"Schur P=4 exact solve, f32, chunked {SPHERE_ITERS // CHUNK}x"
        f"{CHUNK})",
        sphere_problem(sphere_graph()), SPHERE_ITERS, lambda c, c0: c < c0)
    anchor = _cpu_anchor("sphere2500")
    if anchor and row.get("iters_per_s"):
        row["vs_measured_cpu"] = row["iters_per_s"] / anchor
    return row


def main() -> int:
    from slam_tpu.utils.cache import enable_persistent_cache

    if jax.devices()[0].platform != "gpu":
        print(f"bench.py needs a GPU; JAX found {jax.devices()[0]}",
              file=sys.stderr)
        return 2
    enable_persistent_cache()

    panel = []
    for fn in (bench_intel, bench_m10000, bench_sphere):
        try:
            panel.append(fn())
        except Exception as e:  # report every row, then fail the exit code
            panel.append({"workload": fn.__name__, "error": repr(e),
                          "iters_per_s": 0.0})
    intel = panel[0]
    record = {
        "metric": (
            "INTEL+50outliers DCS robust LM iterations/s "
            f"(1 GPU, batch {BATCH}, per-seed partitioned-Schur exact "
            "solve, f32)"
        ),
        "value": intel["iters_per_s"],
        "unit": "iters/s",
        "vs_baseline": intel["iters_per_s"] / CERES_CPU_BASELINE_ITERS_PER_S,
        "device": device_record(),
        "card": card_info(),
        "panel": panel,
    }
    if "vs_measured_cpu" in intel:
        record["vs_measured_cpu"] = intel["vs_measured_cpu"]
    print(json.dumps(record))
    failed = any(r.get("gate_failed") or "error" in r for r in panel)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())

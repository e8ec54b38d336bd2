#!/usr/bin/env python
"""Time both sides of the solver's size-dependent choices on one GPU.

    python scripts/measure_choices.py [--reps N] [OUT.json]

One process.  Every variant is compiled ahead of time, then the variants
are timed in ``N`` interleaved rounds (inputs perturbed per round,
``jax.device_get`` barrier), so each reports the min, median and max over
rounds that shared the card's state with every other variant:

* INTEL+50 batch 8 (``bench.intel_batch``), 50 LM iterations, index
  partition P=16: XLA-native interior factorization against the
  panel-128 blocked Cholesky (``schur.with_default_interiors``); and
  P=8.
* M10000+50 (``bench.m10000_problem``), 50 iterations in chunks of 10,
  the cost model's partition: the same two variants; and spectral
  ``graph_partition`` P in {24, 32}.
* Precision: the first M10000 chunk in f32 under XLA's default matmul
  precision and under ``highest``, in f64 on the card, and in f32 and f64
  on the host CPU.
* The linearize stage alone at both sizes, as a share of one LM
  iteration; peak device memory.

Every record carries the card's name and power limit.  Needs a GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import bench  # noqa: E402
from slam_tpu.solver import schur  # noqa: E402
from slam_tpu.solver.linearize import linearize  # noqa: E402
from slam_tpu.solver.partition import graph_partition  # noqa: E402
from slam_tpu.solver.problem import anchor_first_node  # noqa: E402

def _perturbed(p, rng):
    return p + jnp.asarray(rng.normal(0, 1e-6, p.shape), p.dtype)


def _interleaved(variants, reps: int) -> None:
    """Time every variant's ``run`` once per round, ``reps`` rounds;
    store min/median/max wall seconds in its record."""
    walls = {id(v): [] for v in variants}
    rng = np.random.default_rng(1)
    for _ in range(reps):
        for v in variants:
            t0 = time.perf_counter()
            v["run"](rng)
            walls[id(v)].append(time.perf_counter() - t0)
    for v in variants:
        w = np.asarray(walls[id(v)])
        v["rec"].update(wall_min_s=float(w.min()),
                        wall_median_s=float(np.median(w)),
                        wall_max_s=float(w.max()), walls_s=w.tolist())


def intel_variant(cfg, nblocks: int) -> dict:
    solve, (poses0, edges_b, parts_b) = bench.intel_batch(cfg, nblocks)
    t0 = time.perf_counter()
    exe = solve.lower(poses0, edges_b, parts_b).compile()
    compile_s = time.perf_counter() - t0
    costs, costs0 = (np.asarray(x) for x in
                     jax.device_get(exe(poses0, edges_b, parts_b)))
    part = jax.tree.map(lambda x: x[0], parts_b)
    rec = {"blocks": nblocks, "blocked": cfg.schur_blocked,
           "dni": 3 * part.ni_max, "ns": part.ns, "compile_s": compile_s,
           "cost_seed0": float(costs[0]), "cost0_seed0": float(costs0[0])}

    def run(rng):
        jax.device_get(exe(_perturbed(poses0, rng), edges_b, parts_b))
    return {"rec": rec, "run": run}


def m10000_variant(prob: bench.Problem, blocked: bool) -> dict:
    prob = prob._replace(cfg=prob.cfg.replace(schur_blocked=blocked,
                                              schur_panel=128))
    t0 = time.perf_counter()
    exe = bench.chunk_compiled(prob)
    compile_s = time.perf_counter() - t0
    _, cost0, costs = bench.solve_chunks(prob, bench.LM_ITERS, step=exe)
    dni = 3 * prob.partition.ni_max
    rec = {"blocks": prob.nblocks, "scheme": prob.scheme, "blocked": blocked,
           "dni": dni,
           "ns": prob.partition.ns, "compile_s": compile_s,
           "cost0": cost0, "cost": costs[-1]}

    def run(rng):
        bench.solve_chunks(prob, bench.LM_ITERS, step=exe,
                           poses0=_perturbed(prob.poses0, rng))
    return {"rec": rec, "run": run}


def _ips(v, problems: int) -> dict:
    """Rates from the walls of ``problems`` x ``bench.LM_ITERS`` iterations."""
    r = v["rec"]
    n = problems * bench.LM_ITERS
    r["iters_per_s"] = n / r["wall_min_s"]
    r["iters_per_s_median"] = n / r["wall_median_s"]
    r["ms_per_iter"] = 1e3 * r["wall_min_s"] / bench.LM_ITERS
    return r


def precision(dirty, choice) -> dict:
    """First M10000 chunk five ways: f32 default / f32 highest / f64 on the
    card, f32 / f64 on the host CPU."""
    def chunk(dt):
        prob = bench.m10000_problem(dirty, dt, choice)
        _, c0, costs = bench.solve_chunks(prob, bench.CHUNK)
        return {"cost0": c0, "cost": costs[0]}

    out = {"card_f32_default": chunk(jnp.float32)}
    jax.clear_caches()
    with jax.default_matmul_precision("highest"):
        out["card_f32_highest"] = chunk(jnp.float32)
    jax.clear_caches()
    with jax.enable_x64(True):
        out["card_f64"] = chunk(jnp.float64)
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        out["cpu_f32"] = chunk(jnp.float32)
        with jax.enable_x64(True):
            out["cpu_f64"] = chunk(jnp.float64)
    return out


def linearize_ms(edges, free, poses, batched: bool) -> float:
    kw = dict(model=bench.SE2Model, robust="dcs", dcs_phi=0.5,
              huber_delta=0.01, sc_prior_lambda=1.0)

    def one(e, p):
        s = linearize(p, jnp.ones((e.num_edges,), p.dtype), e, free, **kw)
        return s.cost, s.g
    fn = jax.jit(jax.vmap(one, in_axes=(0, None)) if batched else one)
    jax.device_get(fn(edges, poses))
    rng = np.random.default_rng(2)
    best = float("inf")
    for _ in range(5):
        p = _perturbed(poses, rng)
        t0 = time.perf_counter()
        jax.device_get(fn(edges, p))
        best = min(best, time.perf_counter() - t0)
    return 1e3 * best


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("out", nargs="?")
    args = ap.parse_args(argv)
    if jax.devices()[0].platform != "gpu":
        print("measure_choices.py needs a GPU", file=sys.stderr)
        return 2
    from slam_tpu.utils.cache import enable_persistent_cache
    enable_persistent_cache()
    rec = {"card": bench.card_info(), "device": bench.device_record(),
           "reps": args.reps}
    print(json.dumps({"card": rec["card"]}), flush=True)

    native = bench.INTEL_CFG
    blocked = native.replace(schur_blocked=True, schur_panel=128)
    intel = [intel_variant(cfg, P) for cfg, P in (
        (native, 16), (blocked, 16), (native, 8))]
    _interleaved(intel, args.reps)
    rec["intel_batch8"] = [_ips(v, bench.BATCH)
                           for v in intel]
    for r in rec["intel_batch8"]:
        print(json.dumps({"intel": r}), flush=True)

    dirty = bench.m10000_graph()
    t0 = time.perf_counter()
    model_choice = schur.choose_partition(dirty.edges_ij, dirty.num_nodes)
    rec["m10000_choose_partition_s"] = time.perf_counter() - t0
    prob = bench.m10000_problem(dirty, jnp.float32, model_choice)
    m10k = [m10000_variant(prob, blk) for blk in (False, True)]
    for v in m10k:
        v["rec"]["partition"] = "cost model"
    for P in (24, 32):
        sp = bench.m10000_problem(
            dirty, jnp.float32,
            (P, graph_partition(dirty.edges_ij, dirty.num_nodes, P)))
        m10k.append(m10000_variant(sp, False))
        m10k[-1]["rec"]["partition"] = f"spectral P={P}"
    _interleaved(m10k, args.reps)
    rec["m10000"] = [_ips(v, 1) for v in m10k]
    for r in rec["m10000"]:
        print(json.dumps({"m10000": r}), flush=True)
    stats = jax.devices()[0].memory_stats() or {}
    rec["m10000_peak_bytes_in_use"] = stats.get("peak_bytes_in_use")

    rec["precision_m10000_first_chunk"] = precision(dirty, model_choice)
    print(json.dumps({"precision": rec["precision_m10000_first_chunk"]}),
          flush=True)

    _, (poses0, edges_b, _) = bench.intel_batch()
    lin_intel = linearize_ms(edges_b, anchor_first_node(
        poses0.shape[0], dtype=jnp.float32), poses0, batched=True)
    lin_m10k = linearize_ms(prob.edges, prob.free, prob.poses0,
                            batched=False)
    # Shares of the default (blocked) variant's iteration.
    it_intel = rec["intel_batch8"][1]["ms_per_iter"]
    it_m10k = rec["m10000"][1]["ms_per_iter"]
    rec["linearize"] = {
        "intel_batch8_ms": lin_intel, "intel_batch8_iter_ms": it_intel,
        "intel_batch8_share": lin_intel / it_intel,
        "m10000_ms": lin_m10k, "m10000_iter_ms": it_m10k,
        "m10000_share": lin_m10k / it_m10k,
    }
    print(json.dumps({"linearize": rec["linearize"]}), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=1)
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())

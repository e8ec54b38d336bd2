"""Golden-trajectory regression gate.

``results/golden/`` holds committed f64 CPU trajectories (dense, 100 LM
iterations) with their cost records (``meta.json``).  These tests re-solve a
subset with a reduced iteration budget and check convergence toward the
golden fixed point -- the repo-internal stand-in for the BASELINE ATE gate
against Ceres trajectories (Ceres is not installable in this image; the
dirty graphs can be replayed through it externally via
``eval.harness.replay_outliers_to_g2o``).
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest

from slam_tpu.config import SolverConfig
from slam_tpu.eval import metrics
from slam_tpu.io import g2o
from slam_tpu.solver.lm import lm_solve
from slam_tpu.solver.problem import anchor_first_node, edge_set_from_graph

GOLDEN = os.path.join(os.path.dirname(__file__), "..", "results", "golden")
needs_golden = pytest.mark.skipif(
    not os.path.isfile(os.path.join(GOLDEN, "meta.json")),
    reason="golden trajectories not generated",
)


def _solve(name, outliers, seed, max_iterations, robust):
    graph = g2o.load_g2o(g2o.find_dataset(name))
    g = graph.add_random_outliers(outliers, seed=seed)
    edges = edge_set_from_graph(g, dtype=jnp.float64, incidence=False)
    free = anchor_first_node(g.num_nodes, dtype=jnp.float64)
    poses0 = jnp.asarray(g.poses)
    sw0 = jnp.ones((edges.num_edges,), jnp.float64)
    cfg = SolverConfig(robust=robust, linear_solver="dense",
                       dtype="float64", max_iterations=max_iterations)
    return lm_solve(poses0, sw0, edges, free, cfg)


@needs_golden
def test_csail_clean_matches_golden():
    meta = json.load(open(os.path.join(GOLDEN, "meta.json")))
    key = "CSAIL_0out_seed0"
    golden = np.load(os.path.join(GOLDEN, f"{key}.npy"))
    res = _solve("CSAIL", 0, 0, 40, "none")
    ate = metrics.ate(np.asarray(res.poses), golden)
    assert ate < 0.05, ate
    # Cost must be well on its way to the recorded fixed point.
    assert float(res.cost) < 2.0 * meta[key]["final_cost"] + 0.05


@needs_golden
def test_csail_dcs_outliers_matches_golden():
    meta = json.load(open(os.path.join(GOLDEN, "meta.json")))
    key = "CSAIL_50out_seed42"
    golden = np.load(os.path.join(GOLDEN, f"{key}.npy"))
    res = _solve("CSAIL", 50, 42, 40, "dcs")
    ate = metrics.ate(np.asarray(res.poses), golden)
    assert ate < 0.10, ate
    assert float(res.cost) < 1.5 * meta[key]["final_cost"]


@needs_golden
def test_intel_clean_matches_golden():
    meta = json.load(open(os.path.join(GOLDEN, "meta.json")))
    key = "INTEL_0out_seed0"
    golden = np.load(os.path.join(GOLDEN, f"{key}.npy"))
    res = _solve("INTEL", 0, 0, 40, "none")
    ate = metrics.ate(np.asarray(res.poses), golden)
    assert ate < 0.05, ate
    assert float(res.cost) < 2.0 * meta[key]["final_cost"] + 0.05


def _product_gate(dataset, outliers, seed, key, max_ate, max_iterations=30,
                  chains=2, rounds=None):
    """Golden gate through the PRODUCT pipeline (auto init + DCS rescue)
    at a reduced budget -- the pattern of the M3500 gate, extended to the
    r3 INTEL/CSAIL high-outlier envelope."""
    from slam_tpu.config import RunConfig, SolverConfig
    from slam_tpu.io import g2o as g2o_io
    from slam_tpu.methods.global_solve import run_global_solve
    from slam_tpu.utils.logging import RunLogger

    golden = np.load(os.path.join(GOLDEN, f"{key}.npy"))
    graph = g2o_io.load_g2o(g2o_io.find_dataset(dataset))
    dirty = graph.add_random_outliers(outliers, seed=seed)
    out = run_global_solve(
        dirty,
        RunConfig(dataset=dataset, method=1, num_outliers=outliers,
                  seed=seed,
                  solver=SolverConfig(dtype="float64",
                                      max_iterations=max_iterations,
                                      dcs_consensus_chains=chains,
                                      **({"dcs_consensus_rounds": rounds}
                                         if rounds else {}))),
        RunLogger(echo=False))
    ate = metrics.ate(out.poses, golden)
    assert ate < max_ate, (key, ate)
    return out


@needs_golden
@pytest.mark.slow
def test_intel_50out_product_matches_golden():
    """INTEL+50 seed 42: the r1/r2 'healthy' anchor was actually a
    partially-poisoned basin (plain DCS ATE 4.24 m); the r3 rescue takes
    it to ~0.01 m.  Gate the product pipeline against the new golden.
    Bound 0.8: at the reduced 30-iteration budget the rescue lands at
    ~0.50 m (measured) on its way to the 0.007 m fixed point -- the gate
    distinguishes the rescued basin from the 4.24 m poisoned one."""
    _product_gate("INTEL", 50, 42, "INTEL_50out_seed42", 0.8)


@needs_golden
@pytest.mark.slow
def test_csail_200out_product_matches_golden():
    """CSAIL at the reference's maximum published outlier count
    (docs/CSAIL/CSAIL_200_ON_Try1.png)."""
    _product_gate("CSAIL", 200, 42, "CSAIL_200out_seed42", 0.5)


@needs_golden
@pytest.mark.slow
def test_m3500_dcs_outliers_matches_golden():
    """The round-2 headline gate (BASELINE configs[2] / VERDICT r1 #1):
    M3500 + DCS + 50 injected outliers must converge to the committed
    golden (the chordal-basin optimum; r1's anchor at cost 1.33 was a bad
    local minimum).  Runs the PRODUCT pipeline -- auto init (PCM-gated
    chordal) + the f64 solve -- with a reduced iteration budget (measured
    on this harness: 15 iters leaves ATE 2.08, 25 iters reaches 0.085 at
    cost 1.2998 -- the budget must sit past that knee)."""
    from slam_tpu.config import RunConfig, SolverConfig
    from slam_tpu.io import g2o as g2o_io
    from slam_tpu.methods.global_solve import run_global_solve
    from slam_tpu.utils.logging import RunLogger

    meta = json.load(open(os.path.join(GOLDEN, "meta.json")))
    key = "M3500_50out_seed0"
    golden = np.load(os.path.join(GOLDEN, f"{key}.npy"))
    graph = g2o_io.load_g2o(g2o_io.find_dataset("M3500"))
    dirty = graph.add_random_outliers(50, seed=0)
    out = run_global_solve(
        dirty,
        RunConfig(dataset="M3500", method=1, num_outliers=50,
                  solver=SolverConfig(dtype="float64", max_iterations=25)),
        RunLogger(echo=False))
    ate = metrics.ate(out.poses, golden)
    assert ate < 0.5, ate
    assert float(out.result.cost) < 1.5 * meta[key]["final_cost"]


@needs_golden
def test_m3500_auto_init_lands_near_golden_all_counts():
    """Cheap full-grid gate: the auto init alone (PCM-gated chordal, host
    side) lands within a few meters of the golden fixed point at EVERY
    BASELINE outlier count -- the property that makes the nonlinear solve
    converge (final ATE <= 0.03 at 0/10/50/100)."""
    from slam_tpu.config import RunConfig
    from slam_tpu.io import g2o as g2o_io
    from slam_tpu.solver.init import apply_init

    golden = np.load(os.path.join(GOLDEN, "M3500_0out_seed0.npy"))
    graph = g2o_io.load_g2o(g2o_io.find_dataset("M3500"))
    for n in (0, 10, 50, 100):
        dirty = graph.add_random_outliers(n, seed=0)
        ini = apply_init(dirty, RunConfig(init="auto"))
        ate = metrics.ate(np.asarray(ini.poses), golden)
        assert ate < 6.0, (n, ate)


@needs_golden
def test_sphere_se3_pcm_classification_and_init():
    """SE(3) PCM (r3, VERDICT r2 #5): the quaternion cycle test must
    reject every injected bogus loop on sphere2500 and keep every real
    one (measured: 20/20 and 50/50 rejected, 0/2450 reals), the trust
    rule must accept it, and the PCM-gated chordal init must land near
    the clean golden."""
    from slam_tpu.config import RunConfig
    from slam_tpu.graph import BOGUS_EDGE, CLOSURE_EDGE
    from slam_tpu.io import g2o as g2o_io
    from slam_tpu.robust.pcm import pcm_loop_mask
    from slam_tpu.solver.init import apply_init, pcm_trusted

    if not os.path.exists("data/sphere2500.g2o"):
        pytest.skip("sphere2500 not generated")
    graph = g2o_io.load_g2o("data/sphere2500.g2o")
    dirty = graph.add_random_outliers(50, seed=0).canonical_order()
    r = pcm_loop_mask(dirty)
    et = np.asarray(dirty.edge_type)[r.loop_edges]
    assert ((~r.loop_mask) & (et == BOGUS_EDGE)).sum() == 50
    assert ((~r.loop_mask) & (et == CLOSURE_EDGE)).sum() == 0
    assert pcm_trusted(r)

    golden = np.load(os.path.join(GOLDEN, "sphere2500_0out_seed0.npy"))
    ini = apply_init(dirty, RunConfig(init="auto"))
    ate = metrics.ate(np.asarray(ini.poses), golden)
    assert ate < 2.0, ate


@needs_golden
def test_every_outlier_golden_sits_in_its_clean_basin():
    """Blanket gate over EVERY committed golden (VERDICT r2 #4): each
    outlier golden must be finite and within 1 m ATE of its dataset's
    clean golden -- a corrupted or regressed golden fails here without
    any solve (r3 measured: INTEL 0.007-0.027, CSAIL 0.067-0.085,
    M3500 <= 0.03)."""
    meta = json.load(open(os.path.join(GOLDEN, "meta.json")))
    cleans = {}
    for key in meta:
        ds = key.split("_")[0]
        if "_0out_" in key:
            cleans[ds] = np.load(os.path.join(GOLDEN, f"{key}.npy"))
    for key in meta:
        arr = np.load(os.path.join(GOLDEN, f"{key}.npy"))
        assert np.isfinite(arr).all(), key
        ds = key.split("_")[0]
        if "_0out_" in key or ds not in cleans:
            continue
        ate = metrics.ate(arr, cleans[ds])
        assert ate < 1.0, (key, ate)


@needs_golden
def test_replay_graphs_committed_for_every_outlier_golden():
    """VERDICT r1 #4: no golden with outliers without its committed replay
    graph (the exact dirty g2o for external Ceres replay)."""
    meta = json.load(open(os.path.join(GOLDEN, "meta.json")))
    replay = os.path.join(GOLDEN, "..", "replay")
    for key in meta:
        if "_0out_" in key:
            continue
        assert os.path.isfile(os.path.join(replay, f"{key}.g2o")), key
    assert os.path.isfile(os.path.join(replay, "README.md"))

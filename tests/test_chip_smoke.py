"""``chip_smoke.py`` on the CPU at tiny sizes.

The script's numbers only mean something on a GPU; here each phase runs on
a small synthetic graph to check its paths and control flow, with the
"device" run in f32 on the CPU and references computed the same way the
script computes them.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import bench  # noqa: E402
import chip_smoke  # noqa: E402
from slam_tpu.config import RunConfig, SolverConfig  # noqa: E402
from slam_tpu.io import g2o, synthetic  # noqa: E402
from slam_tpu.methods.global_solve import run_global_solve  # noqa: E402
from slam_tpu.utils.logging import RunLogger  # noqa: E402


def test_phase1_refuses_without_gpu():
    with pytest.raises(SystemExit) as exc:
        chip_smoke.require_gpu()
    assert "needs a GPU" in str(exc.value.code)


def test_main_exits_nonzero_without_gpu(capsys):
    with pytest.raises(SystemExit) as exc:
        chip_smoke.main([])
    assert exc.value.code not in (0, None)
    assert capsys.readouterr().out == ""  # no result line


def test_phase_intel_tiny(tmp_path):
    graph, _ = synthetic.circle_se2(n=64, seed=1)
    path = str(tmp_path / "circle.g2o")
    g2o.write_g2o(path, graph)
    dirty = graph.add_random_outliers(6, seed=3)
    product = run_global_solve(dirty, RunConfig(
        dataset=path, method=1, num_outliers=6, seed=3,
        solver=SolverConfig(dtype="float64")), RunLogger(echo=False))
    plain = run_global_solve(dirty, RunConfig(
        dataset=path, method=1, num_outliers=6, seed=3, init="dataset",
        solver=SolverConfig(dtype="float64", linear_solver="dense",
                            max_iterations=20, dcs_consensus=False,
                            dcs_auto_retry=False)),
        RunLogger(echo=False)).result
    fixed = _f64_fixed_iters(dirty.canonical_order())
    out = chip_smoke.phase_intel(
        str(tmp_path / "save"), dataset=path, num_outliers=6, seed=3,
        golden=product.poses,
        plain_anchor=(float(plain.initial_cost), float(plain.cost)),
        plain_iters=20, fixed_anchor=fixed, nblocks=2)
    assert out["ate_m"] < 1e-6
    assert 0 < out["plain_iters"] <= 20
    assert set(out) >= {"dense_cost50", "schur_cost50",
                        "schur_blocked_cost50"}


def _f64_fixed_iters(g):
    """The f64 dense anchor for ``chip_smoke.fixed_iters_vs_anchor``."""
    from slam_tpu.solver.lm import lm_fixed_iters
    from slam_tpu.solver.problem import anchor_first_node, edge_set_from_graph

    edges = edge_set_from_graph(g, dtype=jnp.float64, incidence=True)
    r = lm_fixed_iters(
        jnp.asarray(g.poses, jnp.float64),
        jnp.ones((edges.num_edges,), jnp.float64), edges,
        anchor_first_node(g.num_nodes, dtype=jnp.float64),
        SolverConfig(robust="dcs", linear_solver="dense", dtype="float64"),
        chip_smoke.FIXED_ITERS)
    return float(r.initial_cost), float(r.cost)


def test_fixed_iters_rejects_wrong_anchor():
    graph, _ = synthetic.circle_se2(n=48, seed=2)
    g = graph.add_random_outliers(4, seed=1).canonical_order()
    c0, c = _f64_fixed_iters(g)
    chip_smoke.fixed_iters_vs_anchor(g, (c0, c), nblocks=2)
    with pytest.raises(chip_smoke.SmokeError, match="anchor"):
        chip_smoke.fixed_iters_vs_anchor(g, (c0, 1.01 * c), nblocks=2)


def test_phase_m10000_tiny():
    graph, _ = synthetic.manhattan_se2(n=400, max_closures=120, seed=2)
    dirty = graph.add_random_outliers(8, seed=0).canonical_order()
    # Drift the initial guess so 20 iterations have a gate to clear.
    rng = np.random.default_rng(0)
    dirty = dirty.with_poses(dirty.poses + rng.normal(0, 0.3, dirty.poses.shape))
    out = chip_smoke.phase_m10000(dirty, iters=20)
    assert len(out["costs"]) == 2
    assert out["costs"][-1] < 0.8 * out["cost0"]
    assert out["scheme"] in ("index", "graph")


def test_phase_sphere_tiny():
    graph, _ = synthetic.sphere_se3(n=120, rings=6, radius=10.0, seed=1)
    dirty = bench.corrupt_closures(graph, 4)
    out = chip_smoke.phase_sphere(dirty, nblocks=2, iters=20)
    assert out["blocks"] == 2 and len(out["costs"]) == 2


def test_phase_mcts_tiny():
    graph, _ = synthetic.circle_se2(n=64, seed=1)
    out = chip_smoke.phase_methods(graph, min_layers=1)
    assert out["m3_decisions"] > 0 and out["m4_decisions"] > 0


def test_phase_four_gpu_on_virtual_devices():
    if jax.device_count() < 4:
        pytest.skip("needs 4 virtual devices")
    graph, _ = synthetic.circle_se2(n=96, seed=1)
    out = chip_smoke.phase_four_gpu(graph.add_random_outliers(8, seed=2),
                                    iters=5)
    assert out["blocks"] == 4
    assert out["dist_cost"] < out["dist_cost0"]


def test_solve_chunks_matches_one_call():
    """Chunked LM (state threaded through the host) == one long scan."""
    from slam_tpu.solver.lm import lm_fixed_iters

    graph, _ = synthetic.circle_se2(n=64, seed=1)
    dirty = graph.add_random_outliers(6, seed=3).canonical_order()
    prob = bench._single_problem(dirty, jnp.float64, bench.SE2Model, 2, None)
    poses, cost0, costs = bench.solve_chunks(prob, 20, chunk=10)
    ref = lm_fixed_iters(prob.poses0, prob.sw0, prob.edges, prob.free,
                         prob.cfg, 20, partition=prob.partition)
    np.testing.assert_allclose(costs[-1], float(ref.cost), rtol=1e-12)
    np.testing.assert_allclose(cost0, float(ref.initial_cost), rtol=1e-12)
    np.testing.assert_allclose(np.asarray(poses), np.asarray(ref.poses),
                               atol=1e-12)

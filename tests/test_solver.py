"""Solver integration tests: convergence, solver agreement, robustness
behaviour (the reference's qualitative collapse/converge grid, made
quantitative), and f32-vs-f64 fixed-point proximity."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from slam_tpu.config import SolverConfig
from slam_tpu.geometry import se2
from slam_tpu.solver.lm import lm_fixed_iters, lm_solve
from slam_tpu.solver.linearize import cost_only, linearize
from slam_tpu.solver.models import SE2Model
from slam_tpu.solver.problem import (
    anchor_first_node,
    edge_set_from_graph,
)


def _setup(graph, dtype=jnp.float64):
    edges = edge_set_from_graph(graph, dtype=dtype)
    free = anchor_first_node(graph.num_nodes, dtype=dtype)
    poses0 = jnp.asarray(graph.poses, dtype)
    sw0 = jnp.ones((edges.num_edges,), dtype)
    return edges, free, poses0, sw0


def test_lm_converges_and_reduces_cost(circle):
    graph, gt = circle
    edges, free, poses0, sw0 = _setup(graph)
    cfg = SolverConfig(robust="none", linear_solver="dense", dtype="float64")
    res = lm_solve(poses0, sw0, edges, free, cfg)
    assert bool(res.converged)
    assert float(res.cost) < 0.2 * float(res.initial_cost)
    assert float(se2.ate(res.poses, jnp.asarray(gt))) < float(
        se2.ate(poses0, jnp.asarray(gt))
    )


def test_gnc_schedule_and_fixed_point(circle_outliers):
    """Graduated non-convexity (extension; SolverConfig.gnc_anneal_iters):
    the phi schedule starts at phi*scale, reaches phi at iteration K, and
    the annealed solve lands at the same robust fixed point as plain DCS on
    a well-conditioned problem (annealing must not hurt the easy case)."""
    from slam_tpu.solver.lm import _gnc_phi

    cfg = SolverConfig(robust="dcs", dcs_phi=0.5, gnc_anneal_iters=10,
                       gnc_init_scale=1e4)
    f = lambda it: float(_gnc_phi(cfg, jnp.int32(it), jnp.float64))
    assert f(0) == pytest.approx(0.5 * 1e4)
    assert f(5) == pytest.approx(0.5 * 1e2)
    assert f(10) == pytest.approx(0.5)
    assert f(25) == pytest.approx(0.5)
    off = cfg.replace(gnc_anneal_iters=0)
    assert _gnc_phi(off, jnp.int32(0), jnp.float64) == 0.5

    dirty, _ = circle_outliers
    edges, free, poses0, sw0 = _setup(dirty)
    base = SolverConfig(robust="dcs", linear_solver="dense", dtype="float64",
                        max_iterations=60)
    plain = lm_solve(poses0, sw0, edges, free, base)
    gnc = lm_solve(poses0, sw0, edges, free,
                   base.replace(gnc_anneal_iters=10))
    assert float(gnc.cost) < 1.05 * float(plain.cost)


def test_dense_and_pcg_agree(circle):
    graph, _ = circle
    edges, free, poses0, sw0 = _setup(graph)
    res_d = lm_solve(
        poses0, sw0, edges, free,
        SolverConfig(robust="none", linear_solver="dense", dtype="float64"),
    )
    res_p = lm_solve(
        poses0, sw0, edges, free,
        SolverConfig(robust="none", linear_solver="pcg", dtype="float64",
                     pcg_max_iters=500, pcg_rtol=1e-12),
    )
    np.testing.assert_allclose(
        np.asarray(res_d.poses), np.asarray(res_p.poses), atol=1e-6
    )


def test_outliers_collapse_without_dcs_and_survive_with(circle, circle_outliers):
    """The reference's headline experiment (README.md:41-43): topology
    collapses without DCS at high outlier count, converges with DCS on."""
    graph, gt = circle
    dirty, _ = circle_outliers
    gt = jnp.asarray(gt)
    edges, free, poses0, sw0 = _setup(dirty)

    cfg0 = SolverConfig(robust="none", linear_solver="dense", dtype="float64")
    ate_plain = float(se2.ate(lm_solve(poses0, sw0, edges, free, cfg0).poses, gt))
    cfg1 = cfg0.replace(robust="dcs")
    ate_dcs = float(se2.ate(lm_solve(poses0, sw0, edges, free, cfg1).poses, gt))

    # Clean baseline for comparison.
    edges_c, free_c, poses0_c, sw0_c = _setup(graph)
    ate_clean = float(
        se2.ate(lm_solve(poses0_c, sw0_c, edges_c, free_c, cfg0).poses, gt)
    )

    assert ate_plain > 10 * ate_clean, "outliers should corrupt the plain solve"
    assert ate_dcs < 2 * ate_clean, "DCS should rescue the solve"


def test_sc_runs_and_keeps_inliers_on(circle_outliers):
    dirty, gt = circle_outliers
    edges, free, poses0, sw0 = _setup(dirty)
    cfg = SolverConfig(robust="sc", linear_solver="dense", dtype="float64")
    res = lm_solve(poses0, sw0, edges, free, cfg)
    s = np.asarray(res.switches)
    loop = np.asarray(edges.is_loop)
    etype = dirty.canonical_order().edge_type
    closure_idx = np.where(etype != 0)[0]
    true_closures = s[closure_idx[etype[closure_idx] == 1]]
    # True closures should stay essentially on.
    assert np.all(true_closures > 0.8)
    assert float(res.cost) < float(res.initial_cost)


def test_gauge_anchor_fixed(circle):
    graph, _ = circle
    edges, free, poses0, sw0 = _setup(graph)
    cfg = SolverConfig(robust="none", linear_solver="dense", dtype="float64")
    res = lm_solve(poses0, sw0, edges, free, cfg)
    np.testing.assert_allclose(
        np.asarray(res.poses[0]), np.asarray(poses0[0]), atol=1e-12
    )


def test_fixed_iters_matches_while_loop_prefix(circle):
    graph, _ = circle
    edges, free, poses0, sw0 = _setup(graph)
    cfg = SolverConfig(robust="none", linear_solver="dense", dtype="float64",
                       max_iterations=5, function_tolerance=0.0)
    res_a = lm_solve(poses0, sw0, edges, free, cfg)
    res_b = lm_fixed_iters(poses0, sw0, edges, free, cfg, 5)
    # Different lambda adaptation rules, but both must strictly reduce cost.
    assert float(res_a.cost) < float(res_a.initial_cost)
    assert float(res_b.cost) < float(res_b.initial_cost)


def test_active_mask_matches_subgraph(circle):
    """Masking edges with ``active=0`` must equal removing them -- the
    mechanism behind layer/batched evaluation (methods 3/4)."""
    graph, _ = circle
    edges, free, poses0, sw0 = _setup(graph)
    # Deactivate the last 3 loop edges.
    active = np.asarray(edges.active).copy()
    loop_idx = np.where(np.asarray(edges.is_loop))[0]
    active[loop_idx[-3:]] = 0.0
    edges_masked = edges._replace(active=jnp.asarray(active))

    import dataclasses
    g = graph.canonical_order()
    keep = np.ones(g.num_edges, bool)
    keep[loop_idx[-3:]] = False
    sub = dataclasses.replace(
        g,
        edges_ij=g.edges_ij[keep],
        edges_meas=g.edges_meas[keep],
        edges_info=g.edges_info[keep],
        edge_type=g.edge_type[keep],
    )
    edges_sub, _, _, sw_sub = _setup(sub)

    kw = dict(model=SE2Model, robust="none", dcs_phi=0.5, huber_delta=0.01,
              sc_prior_lambda=1.0)
    c_masked = float(cost_only(poses0, sw0, edges_masked, **kw))
    c_sub = float(cost_only(poses0, sw_sub, edges_sub, **kw))
    assert abs(c_masked - c_sub) < 1e-10

    sys_m = linearize(poses0, sw0, edges_masked, free, **kw)
    sys_s = linearize(poses0, sw_sub, edges_sub, free, **kw)
    np.testing.assert_allclose(
        np.asarray(sys_m.Hdiag), np.asarray(sys_s.Hdiag), atol=1e-10
    )
    np.testing.assert_allclose(
        np.asarray(sys_m.g), np.asarray(sys_s.g), atol=1e-10
    )


def test_f32_fixed_point_close_to_f64(circle):
    graph, gt = circle
    gt = jnp.asarray(gt)
    edges64, free64, poses064, sw064 = _setup(graph, jnp.float64)
    cfg64 = SolverConfig(robust="none", linear_solver="dense", dtype="float64")
    res64 = lm_solve(poses064, sw064, edges64, free64, cfg64)

    edges32, free32, poses032, sw032 = _setup(graph, jnp.float32)
    cfg32 = SolverConfig(robust="none", linear_solver="dense", dtype="float32")
    res32 = lm_solve(poses032, sw032, edges32, free32, cfg32)

    ate_between = float(se2.ate(res32.poses.astype(jnp.float64), res64.poses))
    assert ate_between < 5e-3, f"f32 fixed point drifted: {ate_between}"


def test_sc_varpro_rejects_outliers(circle, circle_outliers):
    """Variable-projection SC (closed-form switch elimination; Geman-McClure
    equivalence) must reject outliers where the reference's Huber-wrapped
    joint SC cannot -- a framework extension beyond reference parity."""
    graph, gt = circle
    dirty, _ = circle_outliers
    gt = jnp.asarray(gt)
    edges, free, poses0, sw0 = _setup(dirty)
    base = SolverConfig(linear_solver="dense", dtype="float64")
    ate_sc = float(se2.ate(
        lm_solve(poses0, sw0, edges, free, base.replace(robust="sc")).poses,
        gt))
    ate_vp = float(se2.ate(
        lm_solve(poses0, sw0, edges, free,
                 base.replace(robust="sc_varpro")).poses, gt))
    edges_c, free_c, poses0_c, sw0_c = _setup(graph)
    ate_clean = float(se2.ate(
        lm_solve(poses0_c, sw0_c, edges_c, free_c,
                 base.replace(robust="none")).poses, gt))
    assert ate_vp < 2 * ate_clean, (ate_vp, ate_clean)
    assert ate_vp < ate_sc / 10


def test_chordal_init_exact_on_noiseless_graph():
    """Chordal initialization (solver/init.py) recovers a noise-free graph
    exactly: rotations from the linear chordal stage, translations from the
    second linear solve -- both to CG tolerance."""
    from slam_tpu.io import synthetic
    from slam_tpu.solver.init import chordal_init
    import dataclasses

    g, gt = synthetic.circle_se2(n=48, odo_noise=(0.0, 0.0),
                                 num_closures=8, seed=0)
    # Corrupt the initial guess badly; measurements stay exact.
    bad = np.asarray(g.poses).copy()
    bad[1:, 2] += np.random.default_rng(1).normal(0, 2.0, 47)
    bad[1:, :2] += 30.0
    ini = chordal_init(dataclasses.replace(g, poses=bad),
                       huber_irls_rounds=0)
    np.testing.assert_allclose(np.asarray(ini.poses)[:, :2], gt[:, :2],
                               atol=1e-6)


def test_chordal_init_robust_to_bogus_loops(circle_outliers):
    """The Huber IRLS rounds keep injected bogus closures from poisoning
    the rotation stage."""
    from slam_tpu.solver.init import chordal_init

    dirty, gt = circle_outliers
    ini = chordal_init(dirty, huber_irls_rounds=2)
    ate = float(se2.ate(jnp.asarray(np.asarray(ini.poses)), jnp.asarray(gt)))
    ate0 = float(se2.ate(jnp.asarray(np.asarray(dirty.poses)),
                         jnp.asarray(gt)))
    assert ate < max(1.0, ate0), (ate, ate0)


def test_chordal_init_survives_orphan_nodes():
    """Regression: a node reachable only through loop edges (orphaned in
    the odometry-only bootstrap, or when the hard gate removes its last
    edge) must not crash the sparse factorization; orphans fall back to
    their current pose."""
    from slam_tpu.graph import PoseGraph
    from slam_tpu.solver.init import chordal_init

    g = PoseGraph(
        poses=np.array([[0.0, 0, 0], [1.0, 0, 0], [5.0, 5, 1.0]]),
        edges_ij=np.array([[0, 1], [1, 2]], np.int32),
        edges_meas=np.array([[1.0, 0, 0], [0.5, 0.5, 0.3]]),
        edges_info=np.tile(np.array([[1.0, 0, 0, 1.0, 0, 1.0]]), (2, 1)),
        edge_type=np.array([0, 1], np.int8),  # odometry, closure
    )
    ini = chordal_init(g, huber_irls_rounds=1)
    p = np.asarray(ini.poses)
    assert np.all(np.isfinite(p))
    # Connected nodes follow the odometry; the closure-only node ends up
    # either at its fallback pose or at the closure-implied position.
    np.testing.assert_allclose(p[1, :2], [1.0, 0.0], atol=1e-6)


@pytest.mark.slow
def test_dcs_auto_retry_escapes_closure_dropout(tmp_path):
    """DCS's pathological fixed point (psi ~ 0 turns every closure off; LM
    converges to the lower-cost odometry-only minimum -- the M3500/MIT
    failure) is detected by the mean final psi probe and escaped by the
    GNC-annealed auto-retry (SolverConfig.dcs_auto_retry)."""
    import jax.numpy as jnp

    from slam_tpu.config import RunConfig, SolverConfig
    from slam_tpu.io import synthetic
    from slam_tpu.methods.global_solve import run_global_solve
    from slam_tpu.solver.linearize import loop_psi_mean
    from slam_tpu.solver.models import SE2Model
    from slam_tpu.solver.problem import edge_set_from_graph
    from slam_tpu.utils.logging import RunLogger

    # Rotation-heavy odometry noise: integrated init is far off, closures
    # start with psi ~ 0 (the chicken-and-egg bad-init regime).
    g, gt = synthetic.manhattan_se2(
        n=300, odo_noise=(0.05, 0.15), seed=3, max_closures=300)
    base = SolverConfig(dtype="float64", linear_solver="dense")
    edges = edge_set_from_graph(g, dtype=jnp.float64)

    off = run_global_solve(
        g, RunConfig(method=1, solver=base.replace(dcs_auto_retry=False)),
        RunLogger(echo=False))
    psi_off = float(loop_psi_mean(
        jnp.asarray(off.poses), edges, SE2Model, 0.5))
    assert psi_off < 0.35, "fixture must exhibit closure dropout"

    logpath = tmp_path / "retry.log"
    logger = RunLogger(str(logpath), echo=False)
    on = run_global_solve(g, RunConfig(method=1, solver=base), logger)
    logger.close()
    psi_on = float(loop_psi_mean(
        jnp.asarray(on.poses), edges, SE2Model, 0.5))
    assert psi_on > 0.9, psi_on  # closures re-explained
    text = logpath.read_text()
    assert "[retry]" in text and "kept=True" in text
    from slam_tpu.eval import metrics
    assert metrics.ate(on.poses, gt) < metrics.ate(off.poses, gt)


def test_dcs_auto_retry_not_triggered_on_healthy_solve(circle, tmp_path):
    """A healthy DCS solve (final psi near 1) must not pay the retry --
    reference-identical behaviour on INTEL-class graphs."""
    from slam_tpu.config import RunConfig, SolverConfig
    from slam_tpu.methods.global_solve import run_global_solve
    from slam_tpu.utils.logging import RunLogger

    graph, _ = circle
    logpath = tmp_path / "noretry.log"
    logger = RunLogger(str(logpath), echo=False)
    run_global_solve(
        graph,
        RunConfig(method=1,
                  solver=SolverConfig(dtype="float64",
                                      linear_solver="dense")),
        logger)
    logger.close()
    assert "[retry]" not in logpath.read_text()


def test_pcm_separates_bogus_on_m3500():
    """Pairwise consistency maximization: on low-drift graphs the bogus
    injected loops (the 'far nodes coincide' adversary, g2o_util.h:151-171)
    are rejected while nearly all real closures survive -- including the
    rotation-INLIER bogus edges that no per-edge residual test can see."""
    import numpy as np

    from slam_tpu.io import g2o
    from slam_tpu.robust.pcm import pcm_loop_mask
    from slam_tpu.solver.init import pcm_trusted

    g = g2o.load_g2o(g2o.find_dataset("M3500")).add_random_outliers(
        50, seed=0)
    r = pcm_loop_mask(g)
    assert pcm_trusted(r)
    et = np.asarray(g.edge_type)[r.loop_edges]
    real_kept = (r.loop_mask & (et == 1)).sum() / (et == 1).sum()
    bogus_kept = (r.loop_mask & (et == 2)).sum()
    assert real_kept > 0.85, real_kept
    assert bogus_kept <= 5, bogus_kept


def test_pcm_untrusted_on_high_drift_graph():
    """On raw-odometry INTEL the self-tuned drift gates balloon and the
    mask keeps everything -- the trust rule must flag it so auto-init
    falls back to the reference's dataset estimates."""
    from slam_tpu.io import g2o
    from slam_tpu.robust.pcm import pcm_loop_mask
    from slam_tpu.solver.init import pcm_trusted

    g = g2o.load_g2o(g2o.find_dataset("INTEL")).add_random_outliers(
        50, seed=0)
    assert not pcm_trusted(pcm_loop_mask(g))


def test_auto_init_fixes_m3500_with_outliers():
    """The round-1 headline gap (VERDICT #1): M3500 + DCS stuck at ATE
    ~10 m.  Under init='auto' (PCM-gated chordal) the f64 init lands
    within a few meters of the optimum at every BASELINE outlier count --
    the nonlinear solve then converges (ATE <= 0.03)."""
    import numpy as np

    from slam_tpu.config import RunConfig
    from slam_tpu.eval import metrics
    from slam_tpu.io import g2o
    from slam_tpu.solver.init import apply_init, chordal_init

    g = g2o.load_g2o(g2o.find_dataset("M3500"))
    anchor = np.asarray(chordal_init(g).poses)  # near the true optimum
    for n in (10, 100):
        d = g.add_random_outliers(n, seed=0)
        out = apply_init(d, RunConfig(init="auto"))
        assert metrics.ate(np.asarray(out.poses), anchor) < 6.0
        assert metrics.ate_rot(np.asarray(out.poses), anchor) < 0.2


def test_switch_elimination_exact_algebra(circle_outliers):
    """eliminate_switches must be the exact Schur complement of the damped
    joint system onto poses: the joint solve's pose block satisfies the
    reduced system and its switch block equals backsub(poses)."""
    import jax.numpy as jnp

    from slam_tpu.solver import linear
    from slam_tpu.solver.linearize import linearize
    from slam_tpu.solver.models import SE2Model
    from slam_tpu.solver.problem import anchor_first_node, edge_set_from_graph

    dirty, _ = circle_outliers
    g = dirty.canonical_order()
    edges = edge_set_from_graph(g, dtype=jnp.float64, incidence=False)
    free = anchor_first_node(g.num_nodes, dtype=jnp.float64)
    poses = jnp.asarray(g.poses)
    sw = jnp.full((edges.num_edges,), 0.9, jnp.float64)
    system = linearize(poses, sw, edges, free, model=SE2Model, robust="sc",
                       dcs_phi=0.5, huber_delta=0.01, sc_prior_lambda=1.0)
    lam = jnp.asarray(3e-3, jnp.float64)

    # Assemble the damped JOINT matrix by probing matvec with unit vectors.
    n, D = g.num_nodes, 3
    E = edges.num_edges
    Hd, Hss_d = linear._damped_diag(system, lam)
    dim = n * D + E

    def mv(z):
        xp = z[: n * D].reshape(n, D)
        xs = z[n * D:]
        out = linear.matvec(system, edges, Hd, Hss_d,
                            linear.Update(poses=xp, switches=xs))
        return np.concatenate([np.asarray(out.poses).ravel(),
                               np.asarray(out.switches)])

    M = np.stack([mv(np.eye(dim)[i]) for i in range(dim)], axis=1)
    rhs = -np.concatenate([np.asarray(system.g).ravel(),
                           np.asarray(system.gs)])
    z = np.linalg.solve(M, rhs)
    xp_joint = z[: n * D].reshape(n, D)
    xs_joint = z[n * D:]

    reduced, backsub = linear.eliminate_switches(system, edges, lam)
    # 1. backsub recovers the joint switch block exactly.
    np.testing.assert_allclose(
        np.asarray(backsub(jnp.asarray(xp_joint))), xs_joint, atol=1e-9)
    # 2. the joint pose block satisfies the reduced system
    #    (reduced_H + lam D_red applied via matvec == -g_reduced)...
    #    using the SAME damped pose diagonal as the joint system, the
    #    reduced operator is H_red = H_joint_pose-part - Hps Hss^-1 Hps^T.
    Hd_red = Hd + (reduced.Hdiag - system.Hdiag)
    out = linear.matvec(reduced, edges, Hd_red, jnp.ones((E,)),
                        linear.Update(poses=jnp.asarray(xp_joint),
                                      switches=jnp.zeros((E,))))
    np.testing.assert_allclose(
        np.asarray(out.poses), -np.asarray(reduced.g), atol=1e-8)


def test_joint_sc_on_schur_solver_matches_dense(circle_outliers):
    """Method 2 with the partitioned Schur solver (switch pre-elimination)
    reaches the dense joint path's fixed point: same final cost, same
    switch classification of the injected bogus loops."""
    import jax.numpy as jnp

    from slam_tpu.config import SolverConfig
    from slam_tpu.solver.lm import lm_solve
    from slam_tpu.solver.problem import anchor_first_node, edge_set_from_graph
    from slam_tpu.solver.schur import build_partition

    dirty, _ = circle_outliers
    g = dirty.canonical_order()
    edges = edge_set_from_graph(g, dtype=jnp.float64, incidence=False)
    free = anchor_first_node(g.num_nodes, dtype=jnp.float64)
    poses0 = jnp.asarray(g.poses)
    sw0 = jnp.ones((edges.num_edges,), jnp.float64)

    dense = lm_solve(poses0, sw0, edges, free,
                     SolverConfig(robust="sc", linear_solver="dense",
                                  dtype="float64"))
    part = build_partition(np.asarray(edges.ij), g.num_nodes, 4,
                           dtype=jnp.float64)
    schur = lm_solve(poses0, sw0, edges, free,
                     SolverConfig(robust="sc", linear_solver="schur",
                                  dtype="float64"),
                     partition=part)
    assert abs(float(schur.cost) - float(dense.cost)) < 5e-3 * max(
        1.0, float(dense.cost))
    loop = np.asarray(g.edge_type) != 0
    sd = np.asarray(dense.switches)[: loop.shape[0]][loop]
    ss = np.asarray(schur.switches)[: loop.shape[0]][loop]
    # Same on/off classification of every loop edge.
    np.testing.assert_array_equal(sd > 0.5, ss > 0.5)

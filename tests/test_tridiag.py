"""Block-tridiagonal cyclic-reduction preconditioner tests."""

import jax.numpy as jnp
import numpy as np
import pytest

from slam_tpu.config import SolverConfig
from slam_tpu.io import synthetic
from slam_tpu.solver import linear
from slam_tpu.solver.lm import lm_solve
from slam_tpu.solver.linearize import linearize
from slam_tpu.solver.models import SE2Model
from slam_tpu.solver.problem import anchor_first_node, edge_set_from_graph
from slam_tpu.solver.tridiag import build_cr_factors, cr_solve, extract_tridiag


@pytest.mark.parametrize("n,B", [(7, 3), (64, 3), (97, 3), (40, 6)])
def test_cyclic_reduction_exact(n, B):
    rng = np.random.default_rng(0)
    U = rng.normal(size=(n - 1, B, B)) * 0.3
    D = np.einsum(
        "nij,nkj->nik",
        rng.normal(size=(n, B, 2 * B)),
        rng.normal(size=(n, B, 2 * B)),
    )
    D = 0.5 * (D + np.swapaxes(D, -1, -2)) + np.eye(B)[None] * (5 + 0.6 * B)

    T = np.zeros((n * B, n * B))
    for i in range(n):
        T[i * B:(i + 1) * B, i * B:(i + 1) * B] = D[i]
    for i in range(n - 1):
        T[i * B:(i + 1) * B, (i + 1) * B:(i + 2) * B] = U[i]
        T[(i + 1) * B:(i + 2) * B, i * B:(i + 1) * B] = U[i].T
    r = rng.normal(size=(n, B))
    z_ref = np.linalg.solve(T, r.reshape(-1)).reshape(n, B)

    factors = build_cr_factors(jnp.asarray(D), jnp.asarray(U))
    z = np.asarray(cr_solve(factors, jnp.asarray(r)))
    np.testing.assert_allclose(z, z_ref, rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("incidence", [False, True])
def test_extract_tridiag_matches_dense(incidence):
    """U blocks extracted from the edge list must equal the (i, i+1) blocks
    of the assembled dense H."""
    graph, _ = synthetic.circle_se2(n=32, seed=3)
    graph = graph.add_random_outliers(4, seed=1)
    edges = edge_set_from_graph(graph, dtype=jnp.float64, incidence=incidence)
    free = anchor_first_node(graph.num_nodes, dtype=jnp.float64)
    poses0 = jnp.asarray(graph.poses)
    sw0 = jnp.ones((edges.num_edges,), jnp.float64)
    kw = dict(model=SE2Model, robust="none", dcs_phi=0.5, huber_delta=0.01,
              sc_prior_lambda=1.0)
    sys = linearize(poses0, sw0, edges, free, **kw)
    Hd, _ = linear._damped_diag(sys, jnp.asarray(0.0))
    D, U = extract_tridiag(sys, edges, Hd)

    # Dense reference via the scatter assembly.
    n = graph.num_nodes
    ij = np.asarray(edges.ij)
    Hoff = np.asarray(sys.Hoff)
    Hdense = np.zeros((n, n, 3, 3))
    for e in range(edges.num_edges):
        a, b = ij[e]
        Hdense[a, b] += Hoff[e]
        Hdense[b, a] += Hoff[e].T
    for i in range(n - 1):
        np.testing.assert_allclose(
            np.asarray(U[i]), Hdense[i, i + 1], atol=1e-12
        )


def test_tridiag_precond_beats_jacobi(circle_outliers):
    """The chain preconditioner must converge CG dramatically faster at
    equal tolerance (the SURVEY §7 'preconditioner quality' risk item)."""
    graph, _ = circle_outliers
    edges = edge_set_from_graph(graph, dtype=jnp.float64, incidence=False)
    free = anchor_first_node(graph.num_nodes, dtype=jnp.float64)
    poses0 = jnp.asarray(graph.poses)
    sw0 = jnp.ones((edges.num_edges,), jnp.float64)
    kw = dict(model=SE2Model, robust="dcs", dcs_phi=0.5, huber_delta=0.01,
              sc_prior_lambda=1.0)
    sys = linearize(poses0, sw0, edges, free, **kw)
    lam = jnp.asarray(1e-4)
    _, it_j = linear.pcg_solve(sys, edges, lam, max_iters=2000, rtol=1e-8,
                               preconditioner="jacobi")
    dx_t, it_t = linear.pcg_solve(sys, edges, lam, max_iters=2000, rtol=1e-8,
                                  preconditioner="tridiag")
    assert int(it_t) < int(it_j) / 2, (int(it_t), int(it_j))
    # And the answer is right.
    dx_d = linear.dense_solve(sys, edges, lam)
    np.testing.assert_allclose(
        np.asarray(dx_t.poses), np.asarray(dx_d.poses), atol=1e-6
    )


def test_lm_with_tridiag_pcg_matches_dense(circle_outliers):
    graph, _ = circle_outliers
    edges = edge_set_from_graph(graph, dtype=jnp.float64, incidence=False)
    free = anchor_first_node(graph.num_nodes, dtype=jnp.float64)
    poses0 = jnp.asarray(graph.poses)
    sw0 = jnp.ones((edges.num_edges,), jnp.float64)
    base = SolverConfig(robust="dcs", dtype="float64")
    res_d = lm_solve(poses0, sw0, edges, free,
                     base.replace(linear_solver="dense"))
    res_p = lm_solve(poses0, sw0, edges, free,
                     base.replace(linear_solver="pcg",
                                  pcg_preconditioner="tridiag",
                                  pcg_max_iters=500, pcg_rtol=1e-10))
    np.testing.assert_allclose(float(res_p.cost), float(res_d.cost),
                               rtol=1e-6)

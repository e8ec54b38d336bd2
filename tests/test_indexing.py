"""One-hot incidence gather/scatter vs native index ops."""

import jax
import jax.numpy as jnp
import numpy as np

from slam_tpu.ops import indexing


def test_gather_matches_indexing(rng):
    n, e = 37, 120
    idx = rng.integers(0, n, size=e)
    x = jnp.asarray(rng.normal(size=(n, 5)))
    inc = indexing.build_incidence(idx, n, jnp.float64)
    np.testing.assert_allclose(
        np.asarray(indexing.gather(inc, x)), np.asarray(x)[idx], atol=0
    )


def test_scatter_matches_segment_sum(rng):
    n, e = 37, 120
    idx = rng.integers(0, n, size=e)
    v = jnp.asarray(rng.normal(size=(e, 3, 3)))
    inc = indexing.build_incidence(idx, n, jnp.float64)
    ref = jax.ops.segment_sum(v, jnp.asarray(idx), num_segments=n)
    np.testing.assert_allclose(
        np.asarray(indexing.scatter_add(inc, v)), np.asarray(ref), atol=1e-12
    )


def test_incidence_is_exact_binary(rng):
    idx = rng.integers(0, 10, size=50)
    inc = np.asarray(indexing.build_incidence(idx, 10, jnp.float32))
    assert set(np.unique(inc)) <= {0.0, 1.0}
    np.testing.assert_array_equal(inc.sum(axis=1), np.ones(50))
    np.testing.assert_array_equal(inc.argmax(axis=1), idx)


def test_bf16_device_incidence_exact(rng):
    """Device-built bfloat16 one-hots give exact gathers/scatters (0/1 is
    exactly representable; consuming matmuls accumulate in f32+)."""
    import jax.numpy as jnp

    from slam_tpu.ops import indexing

    n, e = 5000, 800  # n > 4096: the device/bf16 tier
    idx = rng.integers(0, n, size=e)
    inc = indexing.build_incidence_device(idx, n)
    assert inc.dtype == jnp.bfloat16
    x = jnp.asarray(rng.normal(size=(n, 4)))
    np.testing.assert_allclose(
        np.asarray(indexing.gather(inc, x)), np.asarray(x)[idx], atol=0
    )
    v = jnp.asarray(rng.normal(size=(e, 4)))
    ref = jax.ops.segment_sum(v, jnp.asarray(idx), num_segments=n)
    np.testing.assert_allclose(
        np.asarray(indexing.scatter_add(inc, v)), np.asarray(ref), atol=1e-12
    )


def test_chain_compressed_gather_scatter_match_full():
    """incidence="chain" (implicit (i,i+1) head + incidence tail) produces
    identical gathers/scatters to full incidence and to native indexing."""
    import jax.numpy as jnp
    import numpy as np

    from slam_tpu.io import synthetic
    from slam_tpu.solver.problem import edge_set_from_graph

    graph, _ = synthetic.circle_se2(n=40, seed=3)
    graph = graph.add_random_outliers(5, seed=4)
    full = edge_set_from_graph(graph, dtype=jnp.float64, incidence=True)
    chain = edge_set_from_graph(graph, dtype=jnp.float64, incidence="chain")
    native = edge_set_from_graph(graph, dtype=jnp.float64, incidence=False)
    assert chain.inc_a.shape[0] == full.inc_a.shape[0] - (graph.num_nodes - 1)

    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.normal(size=(graph.num_nodes, 3)))
    v = jnp.asarray(rng.normal(size=(full.num_edges, 3)))
    n = graph.num_nodes
    for name in ("gather_a", "gather_b"):
        ref = np.asarray(getattr(native, name)(x))
        np.testing.assert_allclose(np.asarray(getattr(full, name)(x)), ref,
                                   atol=1e-12)
        np.testing.assert_allclose(np.asarray(getattr(chain, name)(x)), ref,
                                   atol=1e-12)
    for name in ("scatter_a", "scatter_b"):
        ref = np.asarray(getattr(native, name)(v, n))
        np.testing.assert_allclose(np.asarray(getattr(full, name)(v, n)),
                                   ref, atol=1e-12)
        np.testing.assert_allclose(np.asarray(getattr(chain, name)(v, n)),
                                   ref, atol=1e-12)


def test_chain_compressed_solve_matches_full():
    """Full PCG LM solve with chain-compressed incidence == index ops."""
    import jax.numpy as jnp
    import numpy as np

    from slam_tpu.config import SolverConfig
    from slam_tpu.io import synthetic
    from slam_tpu.solver.lm import lm_solve
    from slam_tpu.solver.problem import (
        anchor_first_node,
        edge_set_from_graph,
    )

    graph, _ = synthetic.circle_se2(n=48, seed=5)
    graph = graph.add_random_outliers(4, seed=6)
    cfg = SolverConfig(robust="dcs", linear_solver="pcg", dtype="float64")
    free = anchor_first_node(graph.num_nodes, dtype=jnp.float64)
    poses0 = jnp.asarray(graph.canonical_order().poses)
    outs = []
    for inc in (False, "chain"):
        edges = edge_set_from_graph(graph, dtype=jnp.float64, incidence=inc)
        sw0 = jnp.ones((edges.num_edges,), jnp.float64)
        outs.append(lm_solve(poses0, sw0, edges, free, cfg))
    np.testing.assert_allclose(np.asarray(outs[1].poses),
                               np.asarray(outs[0].poses), atol=1e-10)

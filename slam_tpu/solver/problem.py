"""Device-side problem representation: static-topology edge arrays.

The graph topology is frozen after ingestion, so the entire solve is a pure
function of ``(EdgeSet, poses, hyperparams)`` -- the property that makes the
whole LM loop jittable.  ``active`` is a per-edge multiplicative weight that
subsumes three needs with one array and zero recompilation:

* padding edges to static shapes (inactive tail),
* layer/subset selection for methods 3/4 (mask per layer),
* index-window local optimisation (mask by window membership).

This replaces the reference's dynamic per-problem ``AddResidualBlock`` loops
(``DCS-ceres/main.cpp:95-150``,
``layer_manager.cpp:602-654``) with fixed-shape masked arrays.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from slam_tpu.graph import ODOMETRY_EDGE, PoseGraph


class EdgeSet(NamedTuple):
    """Static-shape edge arrays living on device.

    ``inc_a``/``inc_b`` are optional one-hot incidence matrices
    (see ``slam_tpu/ops/indexing.py``).  When present, gathers/scatters
    route through matmuls.  When ``None``, XLA gather/segment_sum is used
    (the CPU default).

    **Chain compression**: if the incidence matrices have FEWER rows than
    edges (``k = E - inc.shape[0] > 0``), the first ``k`` rows are an
    implicit odometry chain ``(i, i+1)`` and their gathers/scatters are
    static slices/pads -- zero HBM traffic for the chain, incidence
    matmuls only for the loop tail.  On M10000 the full one-hot operators
    are ~265 MB each (bf16) and every PCG matvec reads them; the chain
    covers ~76% of the edges for free.  Built by
    ``edge_set_from_graph(incidence="chain")`` when the canonical edge
    order starts with the dense chain.  Only the DENSE solver requires
    full incidence (it consumes ``inc_a`` directly); the Schur solver
    takes all topology from its precomputed ``SchurPartition`` maps.
    """

    ij: jnp.ndarray        # (E, 2) int32 endpoints
    meas: jnp.ndarray      # (E, 3) measured relative pose
    is_loop: jnp.ndarray   # (E,) bool: closure or bogus (robustified edges)
    active: jnp.ndarray    # (E,) float: 1.0 live, 0.0 padded/masked out
    info: jnp.ndarray      # (E, 6) information entries (Mahalanobis/eval use)
    inc_a: jnp.ndarray | None = None  # (E, N) one-hot of endpoint a
    inc_b: jnp.ndarray | None = None  # (E, N) one-hot of endpoint b

    @property
    def num_edges(self) -> int:
        return self.ij.shape[0]

    def _gather(self, x: jnp.ndarray, inc, col: int) -> jnp.ndarray:
        from slam_tpu.ops import indexing
        if inc is None:
            return x[self.ij[:, col]]
        k = self.num_edges - inc.shape[0]
        if k == 0:
            return indexing.gather(inc, x)
        # Chain head: row i has endpoints (i, i+1) -> pure static slices.
        head = x[:k] if col == 0 else x[1 : k + 1]
        return jnp.concatenate([head, indexing.gather(inc, x)], axis=0)

    def _scatter(self, v: jnp.ndarray, n: int, inc, col: int) -> jnp.ndarray:
        import jax
        from slam_tpu.ops import indexing
        if inc is None:
            return jax.ops.segment_sum(v, self.ij[:, col], num_segments=n)
        k = self.num_edges - inc.shape[0]
        if k == 0:
            return indexing.scatter_add(inc, v)
        tail = indexing.scatter_add(inc, v[k:])
        widths = ((0, n - k),) if col == 0 else ((1, n - k - 1),)
        head = jnp.pad(v[:k], widths + ((0, 0),) * (v.ndim - 1))
        return tail + head

    def gather_a(self, x: jnp.ndarray) -> jnp.ndarray:
        """``x[a]`` -- incidence matmul / Pallas index kernel / XLA gather."""
        return self._gather(x, self.inc_a, 0)

    def gather_b(self, x: jnp.ndarray) -> jnp.ndarray:
        return self._gather(x, self.inc_b, 1)

    def scatter_a(self, v: jnp.ndarray, n: int) -> jnp.ndarray:
        """``segment_sum(v, a, n)`` via the same tier selection."""
        return self._scatter(v, n, self.inc_a, 0)

    def scatter_b(self, v: jnp.ndarray, n: int) -> jnp.ndarray:
        return self._scatter(v, n, self.inc_b, 1)


class FreeMask(NamedTuple):
    """Gauge handling: per-node 1.0 = free, 0.0 = held constant.

    Replaces ``SetParameterBlockConstant`` (``main.cpp:153``) by projecting
    the fixed nodes out of the update (zero rows/cols, identity diagonal).
    """

    node: jnp.ndarray  # (N,) float


def edge_set_from_graph(
    graph: PoseGraph,
    dtype=jnp.float32,
    pad_to: int | None = None,
    incidence: bool | None = None,
) -> EdgeSet:
    """Build an :class:`EdgeSet` (canonical edge order) from a host graph.

    ``incidence=None`` auto-selects by backend: one-hot incidence matmuls
    on accelerators (host-built f32 below ~4k nodes; device-built bfloat16
    beyond, which never moves the (E, N) operators from the host), native
    index ops on CPU.
    """
    import jax

    g = graph.canonical_order()
    e = g.num_edges
    pad = 0 if pad_to is None else max(0, pad_to - e)

    ij = np.concatenate([g.edges_ij, np.zeros((pad, 2), np.int32)])
    # Padded edges point at (0, 0); their active weight is 0 so they
    # contribute nothing, and the self-pair keeps gathers in range.
    meas = np.concatenate(
        [g.edges_meas, np.zeros((pad, g.edges_meas.shape[1]))]
    )
    if pad and g.edges_meas.shape[1] == 7:
        meas[e:, 3] = 1.0  # identity quaternion for padded SE(3) edges
    is_loop = np.concatenate(
        [g.edge_type != ODOMETRY_EDGE, np.zeros(pad, bool)]
    )
    active = np.concatenate([np.ones(e), np.zeros(pad)])
    info = np.concatenate(
        [g.edges_info, np.zeros((pad, g.edges_info.shape[1]))]
    )

    if incidence is None:
        incidence = jax.default_backend() != "cpu"
    inc_a = inc_b = None
    if incidence:
        from slam_tpu.ops import indexing
        n = g.num_nodes
        start = 0
        if incidence == "chain":
            # Detect the dense odometry-chain prefix (canonical order puts
            # the chain first in every shipped dataset): rows 0..n-2 with
            # endpoints exactly (i, i+1) become implicit slices; incidence
            # operators cover only the remaining rows (see EdgeSet).
            k = n - 1
            chain = np.stack([np.arange(k), np.arange(1, k + 1)], axis=1)
            if ij.shape[0] >= k and np.array_equal(ij[:k], chain):
                start = k
        if n <= 4096:
            inc_a = indexing.build_incidence(ij[start:, 0], n, dtype)
            inc_b = indexing.build_incidence(ij[start:, 1], n, dtype)
        else:
            inc_a = indexing.build_incidence_device(ij[start:, 0], n)
            inc_b = indexing.build_incidence_device(ij[start:, 1], n)

    return EdgeSet(
        ij=jnp.asarray(ij, jnp.int32),
        meas=jnp.asarray(meas, dtype),
        is_loop=jnp.asarray(is_loop),
        active=jnp.asarray(active, dtype),
        info=jnp.asarray(info, dtype),
        inc_a=inc_a,
        inc_b=inc_b,
    )


def anchor_first_node(n: int, dtype=jnp.float32) -> FreeMask:
    """Free mask fixing node 0 (the reference's gauge, ``main.cpp:153``)."""
    m = np.ones((n,))
    m[0] = 0.0
    return FreeMask(node=jnp.asarray(m, dtype))


def anchor_node(n: int, anchor: jnp.ndarray, dtype=jnp.float32) -> FreeMask:
    """Free mask fixing a (traced) node index -- windowed local solves pick
    the first in-window node as anchor (``layer_manager.cpp:167-169``)."""
    idx = jnp.arange(n)
    return FreeMask(node=jnp.where(idx == anchor, 0.0, 1.0).astype(dtype))


def num_loop_edges(graph: PoseGraph) -> int:
    return int(np.sum(graph.edge_type != ODOMETRY_EDGE))


def window_mask(
    edges: EdgeSet, lo: jnp.ndarray, hi: jnp.ndarray
) -> jnp.ndarray:
    """Edges whose endpoints both lie in the index window [lo, hi].

    Mirrors the reference's windowed problem construction
    (``layer_manager.cpp:152-165``).
    """
    a, b = edges.ij[:, 0], edges.ij[:, 1]
    inside = (a >= lo) & (a <= hi) & (b >= lo) & (b <= hi)
    return inside.astype(edges.active.dtype)

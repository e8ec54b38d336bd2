"""Partitioned Schur-complement direct solver.

The accelerator replacement for sparse Cholesky at scale, and the numerical
core of the distributed design (SURVEY §5, BASELINE.json): partition the
pose graph into ``P`` contiguous map blocks (odometry edges are index-local,
``g2o_util.h:68``, so contiguous ranges cut few edges), eliminate each
block's *interior* with a batched dense Cholesky, and reduce the coupled
*separator* system:

    H = [[A, F], [F^T, C]],  A = blkdiag(A_1..A_P)
    S = C - sum_k F_k^T A_k^{-1} F_k           (psum over blocks/devices)
    S x_s = b_s - sum_k F_k^T A_k^{-1} b_k
    x_k   = A_k^{-1} (b_k - F_k x_s)

Everything is assembled with incidence/selection matmuls (no gather/scatter
in the compiled program -- see ``ops/indexing.py``) and the per-block work is
a ``vmap`` over the block axis, which is exactly the axis a multi-device
``shard_map`` distributes (``parallel/schur_dist`` analog in
``distributed_lm``'s mesh).  On one device this is simply a much faster exact
solver than full dense: O(P (n/P)^3 + ns^3) instead of O(n^3).

Separator = nodes incident to any cross-block edge.  Node 0 (the gauge
anchor) is forced into the separator so gauge handling lives in one place.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from slam_tpu.solver.linear import Update, _DIAG_MAX, _DIAG_MIN
from slam_tpu.solver.linearize import BlockSystem
from slam_tpu.solver.problem import EdgeSet

Array = jax.Array
# HIGHEST (true f32 products; no bf16 passes, no TF32) is a quality choice:
# a reduced-precision experiment reached a measurably worse cost (INTEL+50
# seed 42, 50 iters: 1.75 vs 1.52) -- faster-but-worse iterations are not
# a win for a quality-gated iterations/s metric.
_PREC = jax.lax.Precision.HIGHEST
#: Largest interior dimension D*ni at which accelerators default to the
#: panel-128 blocked Cholesky: it beat XLA's native factorization on the
#: H100 at D*ni 201 (INTEL, P=16) and 909 (M10000, P=32); larger
#: interiors are unmeasured (PERF.md).
BLOCKED_MAX_DIM = 1024


def with_default_interiors(cfg, interior_dim: int):
    """``cfg`` (a ``SolverConfig``) with the default interior
    factorization for interiors of ``interior_dim`` = D*ni: the panel-128
    blocked Cholesky on accelerators up to ``BLOCKED_MAX_DIM``; otherwise
    ``cfg`` as given (the CPU keeps LAPACK's factorization)."""
    if (cfg.schur_blocked or interior_dim > BLOCKED_MAX_DIM
            or jax.default_backend() == "cpu"):
        return cfg
    return cfg.replace(schur_blocked=True, schur_panel=128)


class SchurPartition(NamedTuple):
    """Partition operators built once per graph on the host.

    A pytree of device arrays (NOT jit-static: at M10000 scale these one-hot
    operators are hundreds of MB and must travel as buffers, not as program
    constants).  All dimensions are recoverable from the shapes:

    * ``int_sel``:  (P, ni_max, N) -- block-k interior node selection
    * ``int_mask``: (P, ni_max)    -- 1 for real interior slots
    * ``sep_sel``:  (ns, N)        -- separator node selection
    * ``edge_sel``: (P, ek_max, E) -- block-k edge gather (edges with an
      interior endpoint in block k)
    * ``sepedge_sel``: (es_max, E) -- gather of edges with >=1 separator
      endpoint; all other edges have identically-zero separator Jacobian
      rows, so the C/b_sep assembly runs over these rows only (on M10000
      that is 15% of the edges -- a 6.5x cut of the dominant C-assembly
      matmul and of the (E*R, D*ns) Jsep intermediate)
    * ``int_a``/``int_b``: (P, ek_max, ni_max) -- block-k edge endpoint ->
      interior-slot one-hots (zero row when that endpoint is a separator)
    * ``sep_a``/``sep_b``: (P, ek_max, nsk_max) -- block-k edge endpoint ->
      LOCAL separator-slot one-hots.  Local = only the separators adjacent
      to block k's edges (nsk_max = max over blocks, padded).  Each block's
      coupling matrix F therefore has D*nsk columns instead of D*ns: the
      interior triangular solves and the G^T G Schur reduction -- the two
      dominant stages at M10000 scale -- shrink by ns/nsk (~4-14x there).
    * ``loc_sel``: (P, nsk_max, ns) -- local separator slot -> global
      separator slot one-hots (zero rows for padding); used to expand each
      block's local S/rhs contributions into the global separator system
      and to gather x_sep back per block, all as matmuls
    * ``se_sep_a``/``se_sep_b``: (es_max, ns) -- sep-edge endpoint ->
      separator-slot one-hots (the C assembly stays global: every edge
      with >=1 separator endpoint contributes to C exactly once)

    The six endpoint->slot maps are what ``schur_solve`` previously derived
    on device every call as ``edge_sel @ inc @ sel.T`` chains -- products of
    the full (E, N) incidence that are pure topology and grow as E*N*ns
    flops per LM iteration (~1.8e12 MACs at M10000).  Host-precomputing
    them removes every E*N-scale matmul from the solve and drops the
    full-incidence requirement (chain-compressed EdgeSets now work).
    """

    int_sel: Array
    int_mask: Array
    sep_sel: Array
    edge_sel: Array
    sepedge_sel: Array
    int_a: Array
    int_b: Array
    sep_a: Array
    sep_b: Array
    loc_sel: Array
    se_sep_a: Array
    se_sep_b: Array

    @property
    def num_blocks(self) -> int:
        return self.int_sel.shape[0]

    @property
    def ni_max(self) -> int:
        return self.int_sel.shape[1]

    @property
    def ns(self) -> int:
        return self.sep_sel.shape[0]

    @property
    def ek_max(self) -> int:
        return self.edge_sel.shape[1]

    @property
    def es_max(self) -> int:
        return self.sepedge_sel.shape[0]

    @property
    def nsk_max(self) -> int:
        return self.loc_sel.shape[1]


def optimize_cut_positions(
    ij: np.ndarray, n: int, num_blocks: int, slack: float = 0.5
) -> np.ndarray:
    """Choose contiguous-block cut positions minimising the number of edges
    that span a cut (dynamic program; the separator is exactly the nodes
    incident to cut-spanning edges, so fewer spans => smaller separator
    system => cheaper C assembly / S reduction / separator Cholesky).

    Block sizes are constrained to ``n/num_blocks * (1 +- slack)`` so the
    batched interior factorisations stay balanced.  Returns the block id of
    every node, shape ``(n,)``.
    """
    ij = np.asarray(ij)
    a = np.minimum(ij[:, 0], ij[:, 1])
    b = np.maximum(ij[:, 0], ij[:, 1])
    # span[c] = #edges with a < c <= b  (edge crosses a cut at c).
    diff = np.zeros(n + 1, np.int64)
    np.add.at(diff, a + 1, 1)
    np.add.at(diff, b + 1, -1)
    span = np.cumsum(diff)[:n]  # span[c] valid for c in 1..n-1

    target = n / num_blocks
    lo = max(1, int(np.floor(target * (1 - slack))))
    hi = max(lo, int(np.ceil(target * (1 + slack))))

    INF = np.iinfo(np.int64).max // 4
    # f[k, c] = min cost of placing first k blocks covering nodes [0, c).
    f = np.full((num_blocks + 1, n + 1), INF, np.int64)
    prev = np.zeros((num_blocks + 1, n + 1), np.int32)
    f[0, 0] = 0
    for k in range(1, num_blocks + 1):
        for c in range(k * lo, min(k * hi, n) + 1):
            if k == num_blocks and c != n:
                continue
            pmin, pmax = max((k - 1) * lo, c - hi), min((k - 1) * hi, c - lo)
            if pmax < pmin:
                continue
            seg = f[k - 1, pmin : pmax + 1]
            j = int(np.argmin(seg))
            best = seg[j]
            if best >= INF:
                continue
            cost = best + (span[c] if c < n else 0)
            if cost < f[k, c]:
                f[k, c] = cost
                prev[k, c] = pmin + j
    assert f[num_blocks, n] < INF, "no feasible cut placement"
    cuts = []
    c = n
    for k in range(num_blocks, 0, -1):
        cuts.append(c)
        c = int(prev[k, c])
    cuts = cuts[::-1]  # block k covers [cuts[k-1]_prev, cuts[k])
    node_block = np.zeros(n, np.int64)
    start = 0
    for k, end in enumerate(cuts):
        node_block[start:end] = k
        start = end
    return node_block


def _assign_blocks(
    ij: np.ndarray, n: int, num_blocks: int, optimize_cuts: bool,
    node_block: np.ndarray | None = None,
):
    """Shared node/edge assignment:
    ``(sep_ids, interior_ids, block_edges, sep_edges)``.

    ``node_block`` (any (n,) block-id array, e.g. from
    ``partition.graph_partition``) overrides the contiguous index-range
    assignment; everything downstream is assignment-agnostic and the
    device solve is exact for any partition."""
    ij = np.asarray(ij)
    E = ij.shape[0]
    if node_block is not None:
        node_block = np.asarray(node_block, np.int64)
        assert node_block.shape == (n,) and node_block.max() < num_blocks
    elif optimize_cuts:
        node_block = optimize_cut_positions(ij, n, num_blocks)
    else:
        block_size = -(-n // num_blocks)
        node_block = np.minimum(np.arange(n) // block_size, num_blocks - 1)

    ba = node_block[ij[:, 0]]
    bb = node_block[ij[:, 1]]
    cross = ba != bb
    sep = np.zeros(n, bool)
    sep[ij[cross, 0]] = True
    sep[ij[cross, 1]] = True
    sep[0] = True  # gauge anchor lives in the separator system

    sep_ids = np.where(sep)[0]
    interior_ids = [
        np.where((node_block == k) & ~sep)[0] for k in range(num_blocks)
    ]

    # Edge ownership: the block of its interior endpoint(s); pure-separator
    # edges are owned by no block (they only touch C, assembled globally).
    owner = np.full(E, -1, np.int64)
    a_int = ~sep[ij[:, 0]]
    b_int = ~sep[ij[:, 1]]
    owner[a_int] = ba[a_int]
    owner[b_int & (owner < 0)] = bb[b_int & (owner < 0)]
    block_edges = [np.where(owner == k)[0] for k in range(num_blocks)]
    # Exclude self-loops: bucket-padded edge lists point pads at (0, 0)
    # and node 0 is always a separator, so without this every pad row
    # would ride through the hot C-assembly matmul as a dead gather.
    sep_edges = np.where(
        (sep[ij[:, 0]] | sep[ij[:, 1]]) & (ij[:, 0] != ij[:, 1])
    )[0]
    return sep_ids, interior_ids, block_edges, sep_edges


def _local_sep_ids(
    ij: np.ndarray,
    n: int,
    sep_ids: list,
    block_edges: list,
) -> list:
    """Per-block sorted lists of GLOBAL separator slots adjacent to the
    block's owned edges (the only separator columns its F can touch)."""
    sep_slot = np.full(n, -1, np.int64)
    sep_slot[np.asarray(sep_ids, np.int64)] = np.arange(len(sep_ids))
    out = []
    for ids in block_edges:
        if len(ids):
            eps = ij[np.asarray(ids, np.int64)].reshape(-1)
            slots = sep_slot[eps]
            out.append(sorted(set(int(s) for s in slots if s >= 0)))
        else:
            out.append([])
    return out


def partition_stats(
    ij: np.ndarray, n: int, num_blocks: int, optimize_cuts: bool = False,
    node_block: np.ndarray | None = None,
) -> tuple[int, int, int, int, int]:
    """``(ni_max, ns, ek_max, es_max, nsk_max)`` of :func:`build_partition`
    without materialising the (potentially hundreds-of-MB) operators."""
    sep_ids, interior_ids, block_edges, sep_edges = _assign_blocks(
        ij, n, num_blocks, optimize_cuts, node_block
    )
    ni_max = max(1, max(len(x) for x in interior_ids))
    ek_max = max(1, max(len(x) for x in block_edges))
    loc = _local_sep_ids(np.asarray(ij), n, sep_ids, block_edges)
    nsk_max = max(1, max(len(x) for x in loc))
    return ni_max, len(sep_ids), ek_max, max(1, len(sep_edges)), nsk_max


def _tile(x: int | float, t: int = 128) -> int:
    """Round ``x`` up to a multiple of a 128-wide tile (the cost model's
    padding unit; fitted before the GPU port, refit is ROADMAP S7)."""
    x = int(x)
    return -(-x // t) * t


def _partition_cost(
    stats: tuple[int, int, int, int, int], P: int, D: int, R: int
) -> float:
    """Tile-padded cost model of one :func:`schur_solve` call for a
    partition with the given ``partition_stats`` (see
    :func:`choose_num_blocks` for the term-by-term rationale and the
    fitted weights)."""
    ni, ns, ek, es, nsk = stats
    dni, dns, ekR = D * ni, D * ns, ek * R
    dnsk = D * nsk
    p = _tile
    return (
        P * p(dni) ** 3 / 3              # interior Cholesky
        + 2 * P * p(dni) * p(dni) * p(dnsk)  # Y triangular solves
        + P * p(dni) * p(dni) * p(ekR)   # A assembly
        + P * p(dni) * p(dnsk) * p(ekR)  # F assembly (local width)
        + P * p(dnsk) * p(dnsk) * p(dni)  # G^T G reduction (local)
        + 0.5 * P * p(dnsk) * p(dns) * (p(dnsk) + p(dns))  # S expansion
        + 0.5 * p(dns) ** 3 / 3          # separator Cholesky
        + 0.3 * p(es * R) * p(dns) * p(dns)  # C assembly (sep rows)
    )


def choose_partition(
    ij: np.ndarray,
    n: int,
    tangent_dim: int = 3,
    residual_dim: int | None = None,
    candidates: tuple[int, ...] = (2, 4, 6, 8, 12, 16, 24, 32),
    scheme: str = "auto",
    cap: bool = True,
) -> tuple[int, np.ndarray | None]:
    """Pick ``(num_blocks, node_block)`` across partition SCHEMES, not just
    block counts.

    ``scheme='index'`` reduces to :func:`choose_num_blocks` (contiguous
    index ranges; ``node_block=None``).  ``scheme='graph'`` picks the best
    power-of-two level of one recursive-spectral-bisection tree
    (``partition.partition_tree``).  ``'auto'`` evaluates both under the
    same tile-padded cost model and keeps the cheaper one: the graph
    scheme shrinks the separator wherever loop closures span many indices
    (M10000 ns 1793 -> 428 at P=24; M3500 ns 931 -> 213 at P=6) and grows
    it on path-ordered graphs (INTEL ns 166 -> 247 at P=16), so the choice
    needs no per-dataset knobs.
    """
    ij = np.asarray(ij)
    D = tangent_dim
    R = residual_dim if residual_dim is not None else tangent_dim
    best: tuple[float, int, np.ndarray | None] | None = None
    if scheme in ("index", "auto"):
        P = choose_num_blocks(ij, n, tangent_dim, residual_dim,
                              candidates, cap)
        f = _partition_cost(partition_stats(ij, n, P), P, D, R)
        best = (f, P, None)
    if scheme in ("graph", "auto") and n // 2 >= 8:
        from slam_tpu.solver.partition import partition_tree

        max_parts = max(p for p in candidates if n // p >= 8)
        levels = partition_tree(ij, n, max_parts=max_parts)
        for P, nb in levels.items():
            stats = partition_stats(ij, n, P, node_block=nb)
            if cap and D >= 6 and stats[1] > n // 8:
                continue  # same SE(3) f32 separator guard as index
            f = _partition_cost(stats, P, D, R)
            if best is None or f < best[0]:
                best = (f, P, nb)
    if best is None:
        # scheme="graph" on a graph too small (or too capped) to yield a
        # tree level: fall back to the contiguous choice rather than fail.
        P = choose_num_blocks(ij, n, tangent_dim, residual_dim,
                              candidates, cap)
        return P, None
    return best[1], best[2]


def choose_num_blocks(
    ij: np.ndarray,
    n: int,
    tangent_dim: int = 3,
    residual_dim: int | None = None,
    candidates: tuple[int, ...] = (2, 4, 6, 8, 12, 16, 24, 32),
    cap: bool = True,
) -> int:
    """Pick the Schur block count minimising a tile-padded cost model.

    Counts the dominant matmul terms of :func:`schur_solve` with every
    dimension rounded up to a 128-wide tile (small per-block matrices
    waste a matrix unit; a raw flop count misses that and picks too few
    blocks at scale).  Separator-side terms (local->global S expansion,
    separator Cholesky, C assembly) are down-weighted (0.5/0.5/0.3): they
    are single large dense matmuls running near peak, while the per-block
    terms are P-batched small matmuls at lower efficiency.  The weights
    were fitted to the winners measured before the GPU port (INTEL+50 ->
    16, M10000+50 -> 24, M3500 -> 8); PERF.md holds the H100 block-count
    sweep, and the refit is ROADMAP S7.

    For SE(3) (``tangent_dim >= 6``) candidates whose separator exceeds
    n/8 poses are rejected outright: sphere2500 converges measurably
    worse in f32 at P=6 (ns=501) than at P=4 (ns=301) -- the separator
    system's conditioning, not speed, binds (advisor r2).  The cap keeps
    the measured quality winner sphere2500 -> 4.
    """
    ij = np.asarray(ij)
    D = tangent_dim
    R = residual_dim if residual_dim is not None else tangent_dim
    best_p, best_f = None, None
    for P in candidates:
        if P < 2 or n // P < 8:
            continue
        stats = partition_stats(ij, n, P)
        if cap and D >= 6 and stats[1] > n // 8:
            continue  # SE(3) f32 quality guard (see docstring)
        f = _partition_cost(stats, P, D, R)
        if best_f is None or f < best_f:
            best_p, best_f = P, f
    if best_p is None:
        # all candidates capped out (tiny or pathologically-connected
        # SE(3) graph): fall back to the uncapped flop-minimal choice,
        # keeping the true tangent/residual dims in the cost model.
        return choose_num_blocks(ij, n, tangent_dim, residual_dim,
                                 candidates, cap=False)
    return best_p


def build_partition(
    ij: np.ndarray,
    n: int,
    num_blocks: int,
    dtype=jnp.float32,
    pad_shapes: tuple[int, ...] | None = None,
    optimize_cuts: bool = False,
    node_block: np.ndarray | None = None,
) -> SchurPartition:
    """Contiguous index-range partition with cross-edge separator.

    ``pad_shapes=(ni_max, ns, ek_max, es_max, nsk_max)`` pads the operators
    to given maxima so partitions of *different* graphs (e.g. per-outlier-
    seed) share one compiled program and can be vmapped/stacked together
    (legacy 3-/4-tuples without ``es_max``/``nsk_max`` are accepted).  ``optimize_cuts`` places the
    block boundaries with :func:`optimize_cut_positions` instead of
    equal-size slicing; ``node_block`` overrides both with an arbitrary
    assignment (see ``partition.graph_partition``).
    """
    ij = np.asarray(ij)
    E = ij.shape[0]
    sep_ids, interior_ids, block_edges, sep_edges = _assign_blocks(
        ij, n, num_blocks, optimize_cuts, node_block
    )
    ns = len(sep_ids)
    ni_max = max(1, max(len(x) for x in interior_ids))
    ek_max = max(1, max(len(x) for x in block_edges))
    es_max = max(1, len(sep_edges))
    loc_ids = _local_sep_ids(ij, n, sep_ids, block_edges)
    nsk_max = max(1, max(len(x) for x in loc_ids))

    if pad_shapes is not None:
        tni, tns, tek = pad_shapes[:3]
        tes = pad_shapes[3] if len(pad_shapes) > 3 else es_max
        tnsk = pad_shapes[4] if len(pad_shapes) > 4 else nsk_max
        assert (tni >= ni_max and tns >= ns and tek >= ek_max
                and tes >= es_max and tnsk >= nsk_max), (
            "pad_shapes smaller than this partition's natural sizes"
        )
        ni_max, ek_max, es_max, nsk_max = tni, tek, tes, tnsk
        ns_pad = tns
    else:
        ns_pad = ns

    int_sel = np.zeros((num_blocks, ni_max, n), np.float32)
    int_mask = np.zeros((num_blocks, ni_max), np.float32)
    for k, ids in enumerate(interior_ids):
        int_sel[k, np.arange(len(ids)), ids] = 1.0
        int_mask[k, : len(ids)] = 1.0

    sep_sel = np.zeros((ns_pad, n), np.float32)
    sep_sel[np.arange(ns), sep_ids] = 1.0

    edge_sel = np.zeros((num_blocks, ek_max, E), np.float32)
    for k, ids in enumerate(block_edges):
        edge_sel[k, np.arange(len(ids)), ids] = 1.0

    sepedge_sel = np.zeros((es_max, E), np.float32)
    sepedge_sel[np.arange(len(sep_edges)), sep_edges] = 1.0

    # Endpoint -> slot maps (pure topology; see SchurPartition docstring).
    num_blocks_ = len(interior_ids)
    sep_slot = np.full(n, -1, np.int64)
    sep_slot[sep_ids] = np.arange(ns)
    int_slot = np.full(n, -1, np.int64)
    node_block_of = np.full(n, -1, np.int64)
    for k, ids in enumerate(interior_ids):
        int_slot[ids] = np.arange(len(ids))
        node_block_of[ids] = k

    # Local separator coordinates per block (see SchurPartition docstring):
    # F columns index only the separators adjacent to the block's edges.
    loc_slot = np.full((num_blocks_, ns), -1, np.int64)
    loc_sel = np.zeros((num_blocks_, nsk_max, ns_pad), np.float32)
    for k, gids in enumerate(loc_ids):
        loc_slot[k, gids] = np.arange(len(gids))
        loc_sel[k, np.arange(len(gids)), gids] = 1.0

    int_a = np.zeros((num_blocks_, ek_max, ni_max), np.float32)
    int_b = np.zeros((num_blocks_, ek_max, ni_max), np.float32)
    sep_a = np.zeros((num_blocks_, ek_max, nsk_max), np.float32)
    sep_b = np.zeros((num_blocks_, ek_max, nsk_max), np.float32)
    for k, ids in enumerate(block_edges):
        for r, e in enumerate(ids):
            for ep, imap, smap in ((ij[e, 0], int_a, sep_a),
                                   (ij[e, 1], int_b, sep_b)):
                if sep_slot[ep] >= 0:
                    smap[k, r, loc_slot[k, sep_slot[ep]]] = 1.0
                elif node_block_of[ep] == k:
                    imap[k, r, int_slot[ep]] = 1.0

    se_sep_a = np.zeros((es_max, ns_pad), np.float32)
    se_sep_b = np.zeros((es_max, ns_pad), np.float32)
    for r, e in enumerate(sep_edges):
        if sep_slot[ij[e, 0]] >= 0:
            se_sep_a[r, sep_slot[ij[e, 0]]] = 1.0
        if sep_slot[ij[e, 1]] >= 0:
            se_sep_b[r, sep_slot[ij[e, 1]]] = 1.0

    return SchurPartition(
        int_sel=jnp.asarray(int_sel, dtype),
        int_mask=jnp.asarray(int_mask, dtype),
        sep_sel=jnp.asarray(sep_sel, dtype),
        edge_sel=jnp.asarray(edge_sel, dtype),
        sepedge_sel=jnp.asarray(sepedge_sel, dtype),
        int_a=jnp.asarray(int_a, dtype),
        int_b=jnp.asarray(int_b, dtype),
        sep_a=jnp.asarray(sep_a, dtype),
        sep_b=jnp.asarray(sep_b, dtype),
        loc_sel=jnp.asarray(loc_sel, dtype),
        se_sep_a=jnp.asarray(se_sep_a, dtype),
        se_sep_b=jnp.asarray(se_sep_b, dtype),
    )


def _mm(a, b):
    return jnp.matmul(a, b, precision=_PREC, preferred_element_type=a.dtype)


from functools import partial as _partial


@_partial(jax.jit, static_argnames=("blocked", "panel", "panel_inner"))
def schur_solve(
    system: BlockSystem,
    edges: EdgeSet,
    part: SchurPartition,
    lam: Array,
    blocked: bool = False,
    panel: int = 16,
    panel_inner: int = 0,
) -> Update:
    """Exact damped-normal-equation solve via two-level Schur elimination.

    Pose-only (switch slots return 0; SC uses the dense path).  All graph
    topology comes from the precomputed ``SchurPartition`` maps -- the
    EdgeSet is only consulted for the padded edge count, so chain-compressed
    (or incidence-free) EdgeSets work.  ``blocked`` selects the
    panel-blocked Cholesky/solves (``blocked_chol.py``) instead of
    XLA's native ops; exact either way.  Callers pick it through
    :func:`with_default_interiors`.
    """
    _panel = panel
    _sep_blocked = blocked
    E, R, D = system.Ja.shape
    n = system.Hdiag.shape[0]
    dtype = system.Ja.dtype
    P_blk = part.num_blocks
    ni, ns, ek = part.ni_max, part.ns, part.ek_max
    nsk = part.nsk_max

    wsqrt = jnp.sqrt(system.w)
    # Damping values per node coordinate: lam * clip(diag(H)).
    dnode = jnp.diagonal(system.Hdiag, axis1=-2, axis2=-1)  # (N, D)
    clipd = jnp.clip(dnode, _DIAG_MIN, _DIAG_MAX)           # (N, D)
    # Gauge / isolated slots: diagonal exactly 0 -> pin with identity.
    pin = (dnode == 0.0).astype(dtype)
    # Jacobi equilibration: solve in the column-scaled space
    # D^-1/2 H D^-1/2 (unit diagonal), which is mathematically identical to
    # the unscaled lam*clip(diag) damped system but conditions the f32
    # Cholesky by the diagonal spread -- SE(3) information matrices mix
    # rotation/translation scales badly enough that the unscaled f32 solve
    # rejects nearly every LM step on sphere2500 (cost stuck at 22.3 vs
    # f64's convergence; CPU f32 reproduces, so it is conditioning, not a
    # device artifact).  dampv = lam * clip(diag) * scale^2 == lam exactly on
    # in-range slots.
    scale = jnp.where(dnode == 0.0, jnp.ones_like(dnode),
                      1.0 / jnp.sqrt(clipd))                # (N, D)
    dampv = lam * clipd * scale * scale                     # (N, D)
    s_sep = _mm(part.sep_sel, scale).T.reshape(-1)          # (D*ns,)

    # ---- separator system -----------------------------------------------
    # Only separator-touching edges have nonzero Jsep rows; gather those
    # rows first (padded selection rows are all-zero and contribute
    # nothing).  This cuts the (rows, D*ns) Jsep intermediate and the
    # C = Asep^T Asep matmul by 1/sep-edge-fraction (6.5x on M10000).
    es = part.es_max
    ssel = part.sepedge_sel
    Ja_s = _mm(ssel, system.Ja.reshape(E, R * D)).reshape(es, R, D)
    Jb_s = _mm(ssel, system.Jb.reshape(E, R * D)).reshape(es, R, D)
    w_s = _mm(ssel, wsqrt[:, None])[:, 0]
    r_s = _mm(ssel, system.r)                     # (es, R)
    sa_s = part.se_sep_a                          # (es, ns)
    sb_s = part.se_sep_b
    # A_sep rows: (es, R, D, ns) -> (es*R, D*ns), coordinate-major.
    Jsep = (
        Ja_s[:, :, :, None] * sa_s[:, None, None, :]
        + Jb_s[:, :, :, None] * sb_s[:, None, None, :]
    ).reshape(es * R, D * ns)
    Wr = jnp.repeat(w_s, R)[:, None]
    Asep = Jsep * Wr * s_sep[None, :]
    C = _mm(Asep.T, Asep)  # (D*ns, D*ns)
    damp_sep = _mm(part.sep_sel, dampv).T.reshape(-1)  # (D*ns,) coord-major
    # Pin gauge-fixed slots AND padded separator slots (all-zero sel rows,
    # present when partitions are padded to shared shapes).
    sep_live = jnp.sum(part.sep_sel, axis=1)           # (ns,)
    pin_sep = jnp.maximum(
        _mm(part.sep_sel, pin).T.reshape(-1),
        jnp.tile(1.0 - sep_live, (D,)),
    )
    C = C + jnp.eye(D * ns, dtype=dtype) * (damp_sep + pin_sep)[None, :]

    rflat = (r_s * w_s[:, None]).reshape(es * R)
    b_sep = -_mm(Asep.T, rflat)  # (D*ns,)

    # ---- per-block interior systems ------------------------------------
    def block_sys(esel, isel, imask, ia_k, ib_k, sa_k, sb_k, lsel):
        # Gather this block's edge rows.
        Ja_k = _mm(esel, system.Ja.reshape(E, R * D)).reshape(ek, R, D)
        Jb_k = _mm(esel, system.Jb.reshape(E, R * D)).reshape(ek, R, D)
        w_k = _mm(esel, wsqrt[:, None])[:, 0]
        r_k = _mm(esel, system.r)          # (ek, R)

        Jint = (
            Ja_k[:, :, :, None] * ia_k[:, None, None, :]
            + Jb_k[:, :, :, None] * ib_k[:, None, None, :]
        ).reshape(ek * R, D * ni)
        # sa_k/sb_k are LOCAL separator one-hots: the block's coupling F
        # carries only its adjacent separators' columns (D*nsk << D*ns).
        Jsep_k = (
            Ja_k[:, :, :, None] * sa_k[:, None, None, :]
            + Jb_k[:, :, :, None] * sb_k[:, None, None, :]
        ).reshape(ek * R, D * nsk)
        wk = jnp.repeat(w_k, R)[:, None]
        s_int = _mm(isel, scale).T.reshape(-1)          # (D*ni,)
        s_loc = _mm(s_sep.reshape(D, ns), lsel.T).reshape(-1)  # (D*nsk,)
        Aint = Jint * wk * s_int[None, :]
        A = _mm(Aint.T, Aint)              # (D*ni, D*ni)
        F = _mm(Aint.T, Jsep_k * wk * s_loc[None, :])   # (D*ni, D*nsk)
        b = -_mm(Aint.T, (r_k * w_k[:, None]).reshape(ek * R))

        damp_int = _mm(isel, dampv).T.reshape(-1)
        # Pin padded / edgeless interior slots (mask==0 or zero diagonal).
        pin_int = jnp.maximum(
            _mm(isel, pin).T.reshape(-1),
            jnp.tile(1.0 - imask, (D,)),
        )
        A = A + jnp.eye(D * ni, dtype=dtype) * (damp_int + pin_int)[None, :]
        return A, F, b, s_int

    A_b, F_b, b_b, s_int_b = jax.vmap(block_sys)(
        part.edge_sel, part.int_sel, part.int_mask,
        part.int_a, part.int_b, part.sep_a, part.sep_b, part.loc_sel,
    )

    def expand_S(S_loc):
        """Sum per-block local (D*nsk, D*nsk) separator contributions into
        the global (D*ns, D*ns) system via the local->global one-hots --
        two batched matmuls, no scatter."""
        S4 = S_loc.reshape(P_blk, D, nsk, D, nsk)
        T1 = jnp.einsum("pambn,pnv->pambv", S4, part.loc_sel,
                        precision=_PREC)
        return jnp.einsum("pambv,pmu->aubv", T1, part.loc_sel,
                          precision=_PREC).reshape(D * ns, D * ns)

    def expand_rhs(g_loc):
        """(P, D*nsk) block contributions -> (D*ns,) global rhs."""
        return jnp.einsum("pam,pmu->au", g_loc.reshape(P_blk, D, nsk),
                          part.loc_sel, precision=_PREC).reshape(-1)

    def gather_sep(x_sep_):
        """(D*ns,) global separator solution -> per-block (P, D*nsk)."""
        return jnp.einsum("pmu,au->pam", part.loc_sel,
                          x_sep_.reshape(D, ns),
                          precision=_PREC).reshape(P_blk, D * nsk)

    # ---- eliminate interiors, reduce separator -------------------------
    # Half-substitution formulation: with A = L L^T and G = L^-1 [F | b],
    #   S     = C - G_F^T G_F          (matmul instead of F^T (A^-1 F))
    #   rhs_s = b_sep - G_F^T g_b
    #   x_int = L^-T (g_b - G_F x_sep)
    # One forward-triangular pass over the (D*ns + 1) RHS instead of
    # cho_solve's forward+backward pair: this halves the triangular-solve
    # volume and turns the F^T Y contraction into the matmul G^T G.  On
    # the H100 it beat an explicit L^-1 at every measured interior size,
    # native and blocked alike (PERF.md).
    if blocked:
        from slam_tpu.solver import blocked_chol as bc
        fac = bc.blocked_cholesky(A_b, panel=_panel, inner=panel_inner)
        forward = _partial(bc.forward_blocked, fac)
        backward = _partial(bc.backward_blocked, fac)
    else:
        chol = jax.vmap(
            lambda A: jax.scipy.linalg.cho_factor(A, lower=True)[0]
        )(A_b)
        forward = _partial(jax.vmap(_partial(
            jax.scipy.linalg.solve_triangular, lower=True)), chol)
        backward = _partial(jax.vmap(_partial(
            jax.scipy.linalg.solve_triangular, lower=True, trans=1)), chol)
    G_ext = forward(jnp.concatenate([F_b, b_b[..., None]], axis=-1))
    G_F, g_b = G_ext[..., :-1], G_ext[..., -1]          # (P, D*ni, D*nsk)
    S = C - expand_S(jnp.einsum("pij,pik->pjk", G_F, G_F, precision=_PREC))
    rhs_s = b_sep - expand_rhs(
        jnp.einsum("pij,pi->pj", G_F, g_b, precision=_PREC))

    if _sep_blocked:
        from slam_tpu.solver import blocked_chol as bc
        sfac = bc.blocked_cholesky(S, panel=_panel, inner=panel_inner)
        x_sep = bc.cho_solve_blocked(sfac, rhs_s)      # (D*ns,)
    else:
        Ls = jax.scipy.linalg.cho_factor(S, lower=True)
        x_sep = jax.scipy.linalg.cho_solve(Ls, rhs_s)  # (D*ns,)

    x_sep_loc = gather_sep(x_sep)                      # (P, D*nsk)
    x_int = backward(g_b - jnp.einsum("pij,pj->pi", G_F, x_sep_loc,
                                      precision=_PREC))
    # Leave the scaled space: x = D^-1/2 x'.
    x_int = x_int * s_int_b
    x_sep = x_sep * s_sep

    # ---- scatter back to (N, D) via selection matmuls -------------------
    x_sep_nd = _mm(part.sep_sel.T, x_sep.reshape(D, ns).T)  # (N, D)
    x_int_nd = jnp.einsum(
        "pmn,pmd->nd",
        part.int_sel,
        x_int.reshape(P_blk, D, ni).transpose(0, 2, 1),
        precision=_PREC,
    )
    dp = x_sep_nd + x_int_nd
    return Update(poses=dp, switches=jnp.zeros((E,), dtype))

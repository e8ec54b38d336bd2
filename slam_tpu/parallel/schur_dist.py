"""Distributed Schur-complement LM over a device mesh.

The full BASELINE.json design: the pose graph is partitioned into contiguous
map blocks, ONE BLOCK PER DEVICE.  Each device owns its block's edges
(interior + its share of pure-separator edges), linearises them locally,
eliminates its interior with a dense Cholesky, and the small separator system
is reduced across the mesh with psum collectives:

    per-device:  A_k = J_int^T W J_int,  F_k = J_int^T W J_sep,
                 C_k, b_k, b_sep_k   (local edges only)
    collective:  S   = psum(C_k - F_k^T A_k^-1 F_k) + damp_sep
                 rhs = psum(b_sep_k - F_k^T A_k^-1 b_k)
    replicated:  solve S x_sep = rhs  (small dense Cholesky, every device)
    per-device:  x_int_k = A_k^-1 (b_k - F_k x_sep)
    collective:  poses update = psum(scatter x_int_k) + scatter x_sep

Every edge lives on exactly one device, so all psums are plain partial-sum
reductions.  The same program runs on a virtual CPU mesh (tests/dryrun) and
on GPUs (``chip_smoke.py --four-gpu``).  Single-device equivalence is
guaranteed by construction: the math is identical to ``solver/schur.py`` (which is tested exact against
dense).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from slam_tpu.config import SolverConfig
from slam_tpu.graph import ODOMETRY_EDGE, PoseGraph
from slam_tpu.parallel.mesh import BLOCK_AXIS
from slam_tpu.solver.linearize import cost_only, linearize
from slam_tpu.solver.models import SE2Model
from slam_tpu.solver.problem import EdgeSet, FreeMask

Array = jax.Array
_PREC = jax.lax.Precision.HIGHEST


class DistSchurProblem(NamedTuple):
    """Host-built per-device problem data (a pytree: the one-hot operators
    are large and must travel as buffers, not as jit-static constants).

    Leading axis P = number of blocks = mesh size.  ``edges`` carries each
    device's padded edge shard (with full-width (ek, N) incidence for pose
    gathers); ``inc_int``/``inc_sep`` map local edges onto the block's
    interior slots and the global separator slots.
    """

    edges: EdgeSet          # arrays with leading (P, ek, ...) axes
    inc_int_a: Array        # (P, ek, ni)
    inc_int_b: Array
    inc_sep_a: Array        # (P, ek, ns)
    inc_sep_b: Array
    int_sel: Array          # (P, ni, N)
    int_mask: Array         # (P, ni) -- 1 for real interior slots
    sep_sel: Array          # (ns, N) -- replicated

    @property
    def num_blocks(self) -> int:
        return self.int_sel.shape[0]

    @property
    def ni(self) -> int:
        return self.int_sel.shape[1]

    @property
    def ns(self) -> int:
        return self.sep_sel.shape[0]

    @property
    def ek(self) -> int:
        return self.inc_int_a.shape[1]


def _assign_dist(g: PoseGraph, num_blocks: int,
                 node_block: np.ndarray | None = None):
    """Shared node/edge assignment for the distributed problem builder:
    ``(node_block, sep_ids, interior_ids, per_block_edges)``.  One source
    of truth so :func:`dist_problem_stats` can never desync from
    :func:`build_dist_problem`.  ``node_block`` overrides the contiguous
    equal-size assignment (e.g. ``solver.partition.graph_partition`` --
    the separator system is all-gathered every iteration, so the spectral
    cut's smaller ns shrinks the dominant collective too)."""
    ij = g.edges_ij
    n = g.num_nodes
    E = g.num_edges
    if node_block is None:
        block_size = -(-n // num_blocks)
        node_block = np.minimum(np.arange(n) // block_size, num_blocks - 1)
    else:
        node_block = np.asarray(node_block, np.int64)
        assert node_block.shape == (n,) and node_block.max() < num_blocks
    ba, bb = node_block[ij[:, 0]], node_block[ij[:, 1]]
    sep = np.zeros(n, bool)
    cross = ba != bb
    sep[ij[cross, 0]] = True
    sep[ij[cross, 1]] = True
    sep[0] = True

    sep_ids = np.where(sep)[0]
    interior_ids = [
        np.where((node_block == k) & ~sep)[0] for k in range(num_blocks)
    ]

    owner = np.full(E, -1)
    a_int = ~sep[ij[:, 0]]
    b_int = ~sep[ij[:, 1]]
    owner[a_int] = ba[a_int]
    sel = b_int & (owner < 0)
    owner[sel] = bb[sel]
    # Pure-separator edges: deal them round-robin across devices.
    pure = np.where(owner < 0)[0]
    owner[pure] = np.arange(len(pure)) % num_blocks
    per_block = [np.where(owner == k)[0] for k in range(num_blocks)]
    return node_block, sep_ids, interior_ids, per_block


def dist_problem_stats(
    graph: PoseGraph, num_blocks: int,
    node_block: np.ndarray | None = None,
) -> tuple[int, int, int]:
    """Natural ``(ni, ns, ek)`` of :func:`build_dist_problem` -- use to
    compute shared ``pad_shapes`` across problems (e.g. outlier seeds)."""
    g = graph.canonical_order()
    _, sep_ids, interior_ids, per_block = _assign_dist(g, num_blocks,
                                                       node_block)
    ni = max(1, max(len(x) for x in interior_ids))
    ek = max(1, max(len(x) for x in per_block))
    return ni, len(sep_ids), ek


def build_dist_problem(
    graph: PoseGraph,
    num_blocks: int,
    dtype=jnp.float32,
    pad_shapes: tuple[int, int, int] | None = None,
    node_block: np.ndarray | None = None,
) -> DistSchurProblem:
    """Partition + per-device edge shards (every edge on exactly one device).

    ``pad_shapes=(ni, ns, ek)`` pads to shared maxima so problems on
    different graphs (same N) can be stacked for the replica-DP batched
    solver (:func:`distributed_batched_schur_lm`); padded separator slots
    are pinned with identity inside the solve.
    """
    g = graph.canonical_order()
    ij = g.edges_ij
    n = g.num_nodes

    node_block, sep_ids, interior_ids, per_block = _assign_dist(
        g, num_blocks, node_block
    )
    ns = len(sep_ids)
    sep_slot = np.full(n, -1)
    sep_slot[sep_ids] = np.arange(ns)

    ni = max(1, max(len(x) for x in interior_ids))
    int_slot = np.full(n, -1)
    for k, ids in enumerate(interior_ids):
        int_slot[ids] = np.arange(len(ids))

    ek = max(1, max(len(x) for x in per_block))

    if pad_shapes is not None:
        tni, tns, tek = pad_shapes
        assert tni >= ni and tns >= ns and tek >= ek, (
            "pad_shapes smaller than this problem's natural sizes"
        )
        ni, ek = tni, tek
        ns_pad = tns
    else:
        ns_pad = ns

    def padded(field, fill=0.0):
        out = np.full((num_blocks, ek) + field.shape[1:], fill, field.dtype)
        for k, ids in enumerate(per_block):
            out[k, : len(ids)] = field[ids]
        return out

    ij_p = padded(ij.astype(np.int32))
    meas_p = padded(g.edges_meas)
    if g.edges_meas.shape[1] == 7:
        # Identity quaternion on padded SE(3) slots: a zero quaternion
        # NaNs under normalization even at weight 0 (NaN * 0 == NaN) --
        # same rule as edge_set_from_graph (problem.py).
        for k, ids in enumerate(per_block):
            meas_p[k, len(ids):, 3] = 1.0
    info_p = padded(g.edges_info)
    loop_p = padded((g.edge_type != ODOMETRY_EDGE).astype(np.float64))
    active_p = np.zeros((num_blocks, ek))
    for k, ids in enumerate(per_block):
        active_p[k, : len(ids)] = 1.0

    # Incidence operators.
    inc_a = np.zeros((num_blocks, ek, n), np.float32)
    inc_b = np.zeros((num_blocks, ek, n), np.float32)
    inc_ia = np.zeros((num_blocks, ek, ni), np.float32)
    inc_ib = np.zeros((num_blocks, ek, ni), np.float32)
    inc_sa = np.zeros((num_blocks, ek, ns_pad), np.float32)
    inc_sb = np.zeros((num_blocks, ek, ns_pad), np.float32)
    # Padded slots gather node 0 (weight 0, so they contribute nothing):
    # an all-zero incidence row would gather a ZERO pose, whose quaternion
    # NaNs the SE(3) residual even at weight 0 (NaN * 0 == NaN).
    inc_a[:, :, 0] = 1.0
    inc_b[:, :, 0] = 1.0
    for k, ids in enumerate(per_block):
        inc_a[k, : len(ids), 0] = 0.0
        inc_b[k, : len(ids), 0] = 0.0
        for r, e in enumerate(ids):
            a, b = ij[e]
            inc_a[k, r, a] = 1.0
            inc_b[k, r, b] = 1.0
            if int_slot[a] >= 0 and node_block[a] == k:
                inc_ia[k, r, int_slot[a]] = 1.0
            if int_slot[b] >= 0 and node_block[b] == k:
                inc_ib[k, r, int_slot[b]] = 1.0
            if sep_slot[a] >= 0:
                inc_sa[k, r, sep_slot[a]] = 1.0
            if sep_slot[b] >= 0:
                inc_sb[k, r, sep_slot[b]] = 1.0

    int_sel = np.zeros((num_blocks, ni, n), np.float32)
    int_mask = np.zeros((num_blocks, ni), np.float32)
    for k, ids in enumerate(interior_ids):
        int_sel[k, np.arange(len(ids)), ids] = 1.0
        int_mask[k, : len(ids)] = 1.0
    sep_sel = np.zeros((ns_pad, n), np.float32)
    sep_sel[np.arange(ns), sep_ids] = 1.0

    edges = EdgeSet(
        ij=jnp.asarray(ij_p),
        meas=jnp.asarray(meas_p, dtype),
        is_loop=jnp.asarray(loop_p.astype(bool)),
        active=jnp.asarray(active_p, dtype),
        info=jnp.asarray(info_p, dtype),
        inc_a=jnp.asarray(inc_a, dtype),
        inc_b=jnp.asarray(inc_b, dtype),
    )
    return DistSchurProblem(
        edges=edges,
        inc_int_a=jnp.asarray(inc_ia, dtype),
        inc_int_b=jnp.asarray(inc_ib, dtype),
        inc_sep_a=jnp.asarray(inc_sa, dtype),
        inc_sep_b=jnp.asarray(inc_sb, dtype),
        int_sel=jnp.asarray(int_sel, dtype),
        int_mask=jnp.asarray(int_mask, dtype),
        sep_sel=jnp.asarray(sep_sel, dtype),
    )


def _mm(a, b):
    return jnp.matmul(a, b, precision=_PREC, preferred_element_type=a.dtype)


def _schur_lm_shard(
    poses, local, iia_, iib_, isa_, isb_, isel_, imask_, ssel, free_node,
    *, cfg, model, kw, num_iters, dtype, D, ni, ns, ek,
):
    """Per-shard LM body: this device's block of the partitioned-Schur LM.

    Runs inside ``shard_map``; the only collectives are psums over
    ``BLOCK_AXIS`` (separator reduction, cost/diag reductions, update
    scatter).  Shared by the single-problem and replica-batched entry
    points.  Returns ``(poses, cost, cost0, switches)`` -- poses/costs
    replicated within the block axis, switches per-device ``(ek,)``.

    Joint switchable constraints (method 2) distribute for free: every
    edge -- hence every switch unknown -- lives on exactly ONE device, so
    the exact diagonal switch pre-elimination of
    ``linear.eliminate_switches`` becomes per-edge local corrections to
    this device's A/F/C/b blocks (zero extra collectives; the separator
    psums are unchanged), and the switch back-substitution and state are
    device-local too."""
    fmask = FreeMask(node=free_node)
    is_sc = kw["robust"] == "sc"

    def lm_step(carry, _):
        poses, sw, lam, nu, cost = carry
        sys_l = linearize(
            poses, sw, local, fmask,
            fixed_identity_scale=0.0, **kw,
        )
        cost_here = jax.lax.psum(sys_l.cost, BLOCK_AXIS)

        wsqrt = jnp.sqrt(sys_l.w)
        R = sys_l.Ja.shape[1]
        wr = jnp.repeat(wsqrt, R)[:, None]

        # Damping diagonals from the (psum'd for separator) H diagonal.
        dnode_l = jnp.diagonal(sys_l.Hdiag, axis1=-2, axis2=-1)  # (N,D)
        dnode = jax.lax.psum(dnode_l, BLOCK_AXIS)
        clipd = jnp.clip(dnode, 1e-6, 1e32)
        pin = (dnode == 0.0).astype(dtype)
        # Jacobi equilibration, identical to solver/schur.py: factor the
        # unit-diagonal D^-1/2 H D^-1/2 system (dampv == lam on live
        # slots), unscale the solution.  Same stationary math, f32-safe.
        scale = jnp.where(dnode == 0.0, jnp.ones_like(dnode),
                          1.0 / jnp.sqrt(clipd))
        dampv = lam * clipd * scale * scale
        s_int = _mm(isel_, scale).T.reshape(-1)   # (D*ni,)
        s_sep = _mm(ssel, scale).T.reshape(-1)    # (D*ns,)

        Jint = (
            sys_l.Ja[:, :, :, None] * iia_[:, None, None, :]
            + sys_l.Jb[:, :, :, None] * iib_[:, None, None, :]
        ).reshape(ek * R, D * ni)
        Jsep = (
            sys_l.Ja[:, :, :, None] * isa_[:, None, None, :]
            + sys_l.Jb[:, :, :, None] * isb_[:, None, None, :]
        ).reshape(ek * R, D * ns)
        Aint = Jint * wr * s_int[None, :]
        Asep = Jsep * wr * s_sep[None, :]
        rw = (sys_l.r * wsqrt[:, None]).reshape(ek * R)

        A = _mm(Aint.T, Aint)
        F = _mm(Aint.T, Asep)
        C_l = _mm(Asep.T, Asep)
        b_i = -_mm(Aint.T, rw)
        b_s_l = -_mm(Asep.T, rw)

        if is_sc:
            # Exact per-edge switch elimination (the distributed port of
            # linear.eliminate_switches): damped switch diagonal, scaled
            # coupling columns in the equilibrated pose coordinates.
            inv_s = 1.0 / (sys_l.Hss
                           + lam * jnp.clip(sys_l.Hss, 1e-6, 1e32))
            Uint = (sys_l.Hps_a[:, :, None] * iia_[:, None, :]
                    + sys_l.Hps_b[:, :, None] * iib_[:, None, :]
                    ).reshape(ek, D * ni) * s_int[None, :]
            Usep = (sys_l.Hps_a[:, :, None] * isa_[:, None, :]
                    + sys_l.Hps_b[:, :, None] * isb_[:, None, :]
                    ).reshape(ek, D * ns) * s_sep[None, :]
            Ui = Uint * inv_s[:, None]
            Us = Usep * inv_s[:, None]
            A = A - _mm(Ui.T, Uint)
            F = F - _mm(Ui.T, Usep)
            C_l = C_l - _mm(Us.T, Usep)
            b_i = b_i + _mm(Ui.T, sys_l.gs)
            b_s_l = b_s_l + _mm(Us.T, sys_l.gs)

        damp_int = _mm(isel_, dampv).T.reshape(-1)
        # Pin gauge/edgeless slots AND padded interior slots (all-zero
        # int_sel rows) so the block Cholesky stays SPD.
        pin_int = jnp.maximum(
            _mm(isel_, pin).T.reshape(-1),
            jnp.tile(1.0 - imask_, (D,)),
        )
        A = A + jnp.eye(D * ni, dtype=dtype) * (damp_int + pin_int)[None, :]

        L = jax.scipy.linalg.cho_factor(A, lower=True)
        Y = jax.scipy.linalg.cho_solve(L, F)
        y = jax.scipy.linalg.cho_solve(L, b_i)

        # Separator reduction across the mesh.
        S = jax.lax.psum(C_l - _mm(F.T, Y), BLOCK_AXIS)
        rhs = jax.lax.psum(b_s_l - _mm(F.T, y), BLOCK_AXIS)
        damp_sep = _mm(ssel, dampv).T.reshape(-1)
        # Pin gauge slots AND padded separator slots (all-zero sel rows,
        # present when problems are padded to shared shapes).
        sep_live = jnp.sum(ssel, axis=1)
        pin_sep = jnp.maximum(
            _mm(ssel, pin).T.reshape(-1),
            jnp.tile(1.0 - sep_live, (D,)),
        )
        S = S + jnp.eye(D * ns, dtype=dtype) * (damp_sep + pin_sep)[None, :]

        Ls = jax.scipy.linalg.cho_factor(S, lower=True)
        x_sep = jax.scipy.linalg.cho_solve(Ls, rhs)
        # precision-pinned like solver/schur.py's back-substitution.
        x_int = (y - _mm(Y, x_sep)) * s_int
        x_sep = x_sep * s_sep

        dx_sep = _mm(ssel.T, x_sep.reshape(D, ns).T)
        dx_int_l = _mm(isel_.T, x_int.reshape(D, ni).T)
        dx = dx_sep + jax.lax.psum(dx_int_l, BLOCK_AXIS)

        new_poses = model.retract(poses, dx)
        if is_sc:
            # Local switch back-substitution + additive update (the
            # single-host convention: new_switches = switches + dx_s).
            dxa = local.gather_a(dx)
            dxb = local.gather_b(dx)
            ds = -(sys_l.gs
                   + jnp.einsum("ei,ei->e", sys_l.Hps_a, dxa)
                   + jnp.einsum("ei,ei->e", sys_l.Hps_b, dxb)) * inv_s
            new_sw = sw + ds
        else:
            new_sw = sw
        new_cost = jax.lax.psum(
            cost_only(new_poses, new_sw, local, **kw), BLOCK_AXIS
        )
        accept = new_cost < cost_here
        poses = jnp.where(accept, new_poses, poses)
        sw = jnp.where(accept, new_sw, sw)
        lam = jnp.where(
            accept,
            jnp.maximum(lam / 3.0, cfg.min_lambda),
            jnp.minimum(lam * nu, cfg.max_lambda),
        )
        nu = jnp.where(accept, jnp.full_like(nu, 2.0), nu * 2.0)
        cost = jnp.where(accept, new_cost, cost_here)
        return (poses, sw, lam, nu, cost), cost

    # ones_like(active) keeps sw0 edge-varying under shard_map (a plain
    # jnp.ones would make the scan carry's manual axes mismatch on update).
    sw0 = jnp.ones_like(local.active)
    cost0 = jax.lax.psum(cost_only(poses, sw0, local, **kw), BLOCK_AXIS)
    # full_like(cost0) gives lam/nu the same varying-manual-axes type as
    # the data (they become replica-varying on a 2-D replica x block mesh);
    # plain scalars would make the scan carry type mismatch its output.
    (poses, sw, _, _, cost), _ = jax.lax.scan(
        lm_step,
        (poses, sw0, jnp.full_like(cost0, cfg.init_lambda),
         jnp.full_like(cost0, 2.0), cost0),
        None, length=num_iters,
    )
    return poses, cost, cost0, sw


@partial(jax.jit, static_argnames=("cfg", "mesh", "num_iters", "model"))
def distributed_schur_lm(
    poses0: Array,
    free: FreeMask,
    prob: DistSchurProblem,
    cfg: SolverConfig,
    mesh: Mesh,
    num_iters: int,
    model=None,
):
    """LM with the distributed Schur linear solver; returns
    ``(poses, cost, cost0, switches)`` with ``switches (P, ek)`` in
    per-device edge order (all-ones unless ``cfg.robust == 'sc'``, whose
    joint switch unknowns are eliminated/updated device-locally -- see
    :func:`_schur_lm_shard`).  Mesh size must equal ``prob.num_blocks``."""
    model = model or SE2Model
    dtype = jnp.dtype(cfg.dtype)
    poses0 = poses0.astype(dtype)
    D = model.tangent_dim
    ni, ns, ek = prob.ni, prob.ns, prob.ek

    kw = dict(
        model=model, robust=cfg.robust, dcs_phi=cfg.dcs_phi,
        huber_delta=cfg.huber_delta, sc_prior_lambda=cfg.sc_prior_lambda,
    )

    edge_specs = EdgeSet(
        ij=P(BLOCK_AXIS), meas=P(BLOCK_AXIS), is_loop=P(BLOCK_AXIS),
        active=P(BLOCK_AXIS), info=P(BLOCK_AXIS),
        inc_a=P(BLOCK_AXIS), inc_b=P(BLOCK_AXIS),
    )

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(
            P(), edge_specs,
            P(BLOCK_AXIS), P(BLOCK_AXIS), P(BLOCK_AXIS), P(BLOCK_AXIS),
            P(BLOCK_AXIS), P(BLOCK_AXIS), P(), P(),
        ),
        out_specs=(P(), P(), P(), P(BLOCK_AXIS)),
    )
    def run(poses, edges_s, iia, iib, isa, isb, isel, imask, ssel, free_node):
        # Shards arrive with a leading axis of length 1; drop it.
        local = jax.tree.map(lambda x: x[0], edges_s)
        poses_r, cost, cost0, sw = _schur_lm_shard(
            poses, local, iia[0], iib[0], isa[0], isb[0], isel[0], imask[0],
            ssel, free_node,
            cfg=cfg, model=model, kw=kw, num_iters=num_iters,
            dtype=dtype, D=D, ni=ni, ns=ns, ek=ek,
        )
        return poses_r, cost, cost0, sw[None]

    return run(
        poses0, prob.edges, prob.inc_int_a, prob.inc_int_b,
        prob.inc_sep_a, prob.inc_sep_b, prob.int_sel, prob.int_mask,
        prob.sep_sel, free.node,
    )


@partial(jax.jit, static_argnames=("cfg", "mesh", "num_iters", "model"))
def distributed_batched_schur_lm(
    poses0: Array,
    free: FreeMask,
    prob: DistSchurProblem,
    cfg: SolverConfig,
    mesh: Mesh,
    num_iters: int,
    model=None,
):
    """Replica-DP batch of distributed Schur LMs over a 2-D mesh.

    ``mesh`` has axes ``(REPLICA_AXIS, BLOCK_AXIS)``; ``prob`` carries a
    leading batch axis B == replica count on every field (stacked
    :func:`build_dist_problem` outputs padded to shared shapes) and
    ``poses0`` is ``(B, N, pose_dim)``.  This is the reference's
    Try1/Try2 Monte-Carlo usage pattern across many devices: independent
    outlier seeds across the replica axis (zero collectives) and the
    partitioned-Schur separator psums within each replica riding the
    block axis.  Returns
    ``(poses, cost, cost0, switches)`` with leading batch axes
    (``switches (B, P, ek)``).
    """
    from slam_tpu.parallel.mesh import REPLICA_AXIS

    model = model or SE2Model
    dtype = jnp.dtype(cfg.dtype)
    poses0 = poses0.astype(dtype)
    D = model.tangent_dim
    # Batched fields: int_sel (B, P, ni, N), sep_sel (B, ns, N),
    # inc_int_a (B, P, ek, ni) -- the unbatched pytree properties do not
    # apply here.
    ni = prob.int_sel.shape[2]
    ns = prob.sep_sel.shape[1]
    ek = prob.inc_int_a.shape[2]
    B = poses0.shape[0]
    assert prob.int_sel.shape[0] == B, "problem batch != poses batch"
    assert mesh.shape[REPLICA_AXIS] == B, (
        f"replica mesh axis ({mesh.shape[REPLICA_AXIS]}) != batch ({B})"
    )

    kw = dict(
        model=model, robust=cfg.robust, dcs_phi=cfg.dcs_phi,
        huber_delta=cfg.huber_delta, sc_prior_lambda=cfg.sc_prior_lambda,
    )

    RB = P(REPLICA_AXIS, BLOCK_AXIS)
    edge_specs = EdgeSet(
        ij=RB, meas=RB, is_loop=RB, active=RB, info=RB, inc_a=RB, inc_b=RB,
    )

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(
            P(REPLICA_AXIS), edge_specs,
            RB, RB, RB, RB, RB, RB, P(REPLICA_AXIS), P(),
        ),
        out_specs=(P(REPLICA_AXIS), P(REPLICA_AXIS), P(REPLICA_AXIS),
                   P(REPLICA_AXIS, BLOCK_AXIS)),
    )
    def run(poses, edges_s, iia, iib, isa, isb, isel, imask, ssel, free_node):
        # Leading axes on this shard: (1, 1, ...) for block-sharded fields,
        # (1, ...) for replica-only fields.
        local = jax.tree.map(lambda x: x[0, 0], edges_s)
        poses_r, cost, cost0, sw = _schur_lm_shard(
            poses[0], local, iia[0, 0], iib[0, 0], isa[0, 0], isb[0, 0],
            isel[0, 0], imask[0, 0], ssel[0], free_node,
            cfg=cfg, model=model, kw=kw, num_iters=num_iters,
            dtype=dtype, D=D, ni=ni, ns=ns, ek=ek,
        )
        return poses_r[None], cost[None], cost0[None], sw[None, None]

    # DistSchurProblem fields with batch axis: (B, P, ...); sep_sel (B, ns, N).
    return run(
        poses0, prob.edges, prob.inc_int_a, prob.inc_int_b,
        prob.inc_sep_a, prob.inc_sep_b, prob.int_sel, prob.int_mask,
        prob.sep_sel, free.node,
    )


def build_dist_problem_batch(
    graphs, num_blocks: int, dtype=jnp.float32
) -> DistSchurProblem:
    """Stack per-seed :func:`build_dist_problem` outputs (padded to shared
    shapes) for :func:`distributed_batched_schur_lm`."""
    stats = [dist_problem_stats(g, num_blocks) for g in graphs]
    pad = tuple(max(s[i] for s in stats) for i in range(3))
    probs = [
        build_dist_problem(g, num_blocks, dtype=dtype, pad_shapes=pad)
        for g in graphs
    ]
    return jax.tree.map(lambda *xs: jnp.stack(xs), *probs)

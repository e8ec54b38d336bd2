"""SPMD-distributed LM: edge-data-parallel linearisation + collective PCG.

The reference has no distributed backend (SURVEY §2); here the scaling
story is SPMD over a device mesh:

* **Edges are the data axis.**  Residual/Jacobian evaluation and H/g block
  assembly -- the per-iteration hot loop -- shard perfectly over edges.  Each
  device linearises its edge shard and the partial node systems are reduced
  with a single ``psum`` across devices (the separator reduction of SURVEY §5's
  distributed design, specialised to full-node granularity).
* **PCG runs replicated-x, sharded-A.**  The matvec's off-diagonal action is
  computed on local edge shards and psum-reduced; the (small, replicated)
  node-diagonal action and the CG scalars are computed redundantly on every
  device -- redundant FLOPs are cheaper than extra collectives at these
  sizes.
* Everything lives in one ``shard_map``-wrapped jitted step: one compile,
  one psum per linearisation + one per CG iteration.

This module is written against a logical mesh, so it runs identically on a
virtual 8-device CPU mesh (tests / dryrun) and on real GPUs.  SC
(method 2) adds sharded switch unknowns and is routed to the single-device
path for now.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from slam_tpu.config import SolverConfig
from slam_tpu.parallel.mesh import EDGE_AXIS, pad_to_multiple
from slam_tpu.solver.linearize import cost_only, linearize
from slam_tpu.solver.models import SE2Model
from slam_tpu.solver.problem import EdgeSet, FreeMask

Array = jax.Array


def pad_edges_for_mesh(edges: EdgeSet, num_devices: int) -> EdgeSet:
    """Pad the edge arrays to a multiple of the mesh size (inactive tail)."""
    E = edges.num_edges
    Epad = pad_to_multiple(E, num_devices)
    if Epad == E:
        return edges
    pad = Epad - E

    def pz(x):
        widths = [(0, pad)] + [(0, 0)] * (x.ndim - 1)
        return jnp.pad(x, widths)

    return EdgeSet(
        ij=pz(edges.ij),
        meas=pz(edges.meas),
        is_loop=pz(edges.is_loop),
        active=pz(edges.active),
        info=pz(edges.info),
        inc_a=None if edges.inc_a is None else pz(edges.inc_a),
        inc_b=None if edges.inc_b is None else pz(edges.inc_b),
    )


def _edge_specs(edges: EdgeSet) -> EdgeSet:
    """PartitionSpecs for an EdgeSet sharded along the edge axis.  Incidence
    matrices shard by their edge (row) axis; node axis stays replicated."""
    has_inc = edges.inc_a is not None
    return EdgeSet(
        ij=P(EDGE_AXIS),
        meas=P(EDGE_AXIS),
        is_loop=P(EDGE_AXIS),
        active=P(EDGE_AXIS),
        info=P(EDGE_AXIS),
        inc_a=P(EDGE_AXIS) if has_inc else None,
        inc_b=P(EDGE_AXIS) if has_inc else None,
    )


@partial(
    jax.jit,
    static_argnames=("cfg", "model", "mesh", "num_iters"),
)
def distributed_lm(
    poses0: Array,
    edges: EdgeSet,
    free: FreeMask,
    cfg: SolverConfig,
    mesh: Mesh,
    num_iters: int,
    model=None,
):
    """``num_iters`` LM iterations, edge-sharded over ``mesh``.

    Returns ``(poses, final_cost, initial_cost, switches)`` with
    ``switches`` in padded global edge order (all-ones unless
    ``cfg.robust == 'sc'``).  ``edges`` must be pre-padded
    (:func:`pad_edges_for_mesh`).

    Joint switchable constraints distribute for free on the edge-sharded
    mesh: each switch unknown belongs to exactly one edge shard, so the
    exact diagonal elimination of ``linear.eliminate_switches`` is applied
    to each shard's PARTIAL node system before the psum (every edge is on
    one device, so the summed corrections equal the global ones), and the
    switch state/back-substitution stay device-local.
    """
    model = model or SE2Model
    # The distributed step always runs collective PCG regardless of the
    # single-device linear_solver setting.
    dtype = jnp.dtype(cfg.dtype)
    poses0 = poses0.astype(dtype)
    nd = mesh.shape[EDGE_AXIS]

    kw = dict(
        model=model,
        robust=cfg.robust,
        dcs_phi=cfg.dcs_phi,
        huber_delta=cfg.huber_delta,
        sc_prior_lambda=cfg.sc_prior_lambda,
    )

    is_sc = cfg.robust == "sc"

    def spmd_step(poses, sw, lam, nu, cost, edges_local, free_local):
        """One LM iteration; runs per-device on an edge shard."""
        sys_local = linearize(
            poses, sw, edges_local, free_local,
            fixed_identity_scale=1.0 / nd, **kw,
        )
        n_ = poses.shape[0]
        Hdiag_l, Hoff_l, g_l = sys_local.Hdiag, sys_local.Hoff, sys_local.g
        if is_sc:
            # Exact local switch elimination (linear.eliminate_switches
            # ported to the edge shard; corrections sum correctly through
            # the psum because every edge lives on one device).
            Hss_d = sys_local.Hss + lam * jnp.clip(sys_local.Hss, 1e-6,
                                                   1e32)
            inv_s = 1.0 / Hss_d
            gs_inv = sys_local.gs * inv_s
            Dd = Hdiag_l.shape[-1]
            El = edges_local.num_edges
            ca = -(sys_local.Hps_a[:, :, None]
                   * sys_local.Hps_a[:, None, :]) * inv_s[:, None, None]
            cb = -(sys_local.Hps_b[:, :, None]
                   * sys_local.Hps_b[:, None, :]) * inv_s[:, None, None]
            Hdiag_l = (
                Hdiag_l
                + edges_local.scatter_a(ca.reshape(El, Dd * Dd),
                                        n_).reshape(n_, Dd, Dd)
                + edges_local.scatter_b(cb.reshape(El, Dd * Dd),
                                        n_).reshape(n_, Dd, Dd)
            )
            Hoff_l = Hoff_l - (
                sys_local.Hps_a[:, :, None] * sys_local.Hps_b[:, None, :]
            ) * inv_s[:, None, None]
            g_l = (
                g_l
                - edges_local.scatter_a(
                    sys_local.Hps_a * gs_inv[:, None], n_)
                - edges_local.scatter_b(
                    sys_local.Hps_b * gs_inv[:, None], n_)
            )
        # Separator reduction: partial node systems -> replicated totals.
        Hdiag = jax.lax.psum(Hdiag_l, EDGE_AXIS)
        g = jax.lax.psum(g_l, EDGE_AXIS)
        cost_here = jax.lax.psum(sys_local.cost, EDGE_AXIS)

        # Damped diagonal + block-Jacobi preconditioner (replicated).
        d = jnp.diagonal(Hdiag, axis1=-2, axis2=-1)
        damp = lam * jnp.clip(d, 1e-6, 1e32)
        D = Hdiag.shape[-1]
        Hd = Hdiag + jnp.eye(D, dtype=dtype)[None] * damp[:, :, None]
        Minv = jnp.linalg.inv(Hd) if D != 3 else _inv3(Hd)

        Hoff = Hoff_l
        n = poses.shape[0]

        def matvec(x):
            y = jnp.einsum("nij,nj->ni", Hd, x)
            ca = jnp.einsum("eij,ej->ei", Hoff, edges_local.gather_b(x))
            cb = jnp.einsum("eji,ej->ei", Hoff, edges_local.gather_a(x))
            off = edges_local.scatter_a(ca, n) + edges_local.scatter_b(cb, n)
            # One collective per CG iteration.
            return y + jax.lax.psum(off, EDGE_AXIS)

        def precond(r):
            return jnp.einsum("nij,nj->ni", Minv, r)

        bvec = -g
        x0 = jnp.zeros_like(bvec)
        r0 = bvec
        z0 = precond(r0)
        rz0 = jnp.sum(r0 * z0)
        tol2 = (cfg.pcg_rtol**2) * jnp.sum(bvec * bvec)

        def cg_cond(s):
            _, r, _, _, k = s
            return (k < cfg.pcg_max_iters) & (jnp.sum(r * r) > tol2)

        def cg_body(s):
            x, r, p, rz, k = s
            Ap = matvec(p)
            alpha = rz / (jnp.sum(p * Ap) + 1e-30)
            x = x + alpha * p
            r = r - alpha * Ap
            z = precond(r)
            rz2 = jnp.sum(r * z)
            p = z + (rz2 / (rz + 1e-30)) * p
            return (x, r, p, rz2, k + 1)

        dx, *_ = jax.lax.while_loop(
            cg_cond, cg_body, (x0, r0, z0, rz0, jnp.int32(0))
        )

        new_poses = model.retract(poses, dx)
        if is_sc:
            dxa = edges_local.gather_a(dx)
            dxb = edges_local.gather_b(dx)
            ds = -(sys_local.gs
                   + jnp.einsum("ei,ei->e", sys_local.Hps_a, dxa)
                   + jnp.einsum("ei,ei->e", sys_local.Hps_b, dxb)) * inv_s
            new_sw = sw + ds
        else:
            new_sw = sw
        new_cost = jax.lax.psum(
            cost_only(new_poses, new_sw, edges_local, **kw), EDGE_AXIS
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
        return poses, sw, lam, nu, cost

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(), _edge_specs(edges), P()),
        out_specs=(P(), P(), P(), P(EDGE_AXIS)),
    )
    def run(poses, edges_sharded, free_node):
        free_local = FreeMask(node=free_node)
        # edge-varying ones (see schur_dist: scan carry manual axes).
        sw0 = jnp.ones_like(edges_sharded.active)
        cost0 = jax.lax.psum(
            cost_only(poses, sw0, edges_sharded, **kw), EDGE_AXIS
        )

        def body(carry, _):
            poses, sw, lam, nu, cost = carry
            poses, sw, lam, nu, cost = spmd_step(
                poses, sw, lam, nu, cost, edges_sharded, free_local
            )
            return (poses, sw, lam, nu, cost), cost

        (poses, sw, _, _, cost), _ = jax.lax.scan(
            body,
            (
                poses,
                sw0,
                jnp.asarray(cfg.init_lambda, dtype),
                jnp.asarray(2.0, dtype),
                cost0,
            ),
            None,
            length=num_iters,
        )
        return poses, cost, cost0, sw

    return run(poses0, edges, free.node)


def _inv3(m: Array) -> Array:
    from slam_tpu.solver.linear import _inv_blocks

    return _inv_blocks(m)


def shard_edges(edges: EdgeSet, mesh: Mesh) -> EdgeSet:
    """Place padded edge arrays with edge-axis sharding on the mesh."""
    spec = _edge_specs(edges)
    return jax.tree.map(
        lambda x, p: jax.device_put(x, NamedSharding(mesh, p)),
        edges,
        spec,
    )

"""Batched short-LM evaluations for the layering/MCTS methods.

The dominant cost of the reference's methods 3/4 is ``evaluate_cost`` /
``evaluate_layer_cost``: a *full fresh Ceres problem* built and solved (1-2
LM iterations) per candidate per edge (``layer_manager.cpp:602-654``,
``simple_layer_manager.cpp:567-622``), fanned out with ``std::async`` over
top-k candidates (``layer_manager.cpp:379-385``).

Accelerator replacement: layers become a *batch axis*.  One jitted ``vmap``
over (poses, edge-activity-mask) pairs evaluates every candidate in a single
device call -- no threads, no problem rebuilding, no recompilation (the mask
changes as data, never the shapes).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from slam_tpu.config import SolverConfig
from slam_tpu.solver.lm import lm_fixed_iters
from slam_tpu.solver.problem import EdgeSet, FreeMask

Array = jax.Array


@partial(jax.jit, static_argnames=("cfg", "num_iters"))
def batched_eval_cost(
    poses_b: Array,      # (B, N, 3) starting poses per candidate
    actives_b: Array,    # (B, E) edge-activity masks per candidate
    edges: EdgeSet,
    free: FreeMask,
    cfg: SolverConfig,
    num_iters: int,
) -> Array:
    """Final cost of a ``num_iters``-iteration LM solve per candidate.

    Matches the reference's ``summary.final_cost`` convention (cost *after*
    the short solve, Huber-robustified, 0.5-scaled).
    """

    def one(poses, active):
        e = edges._replace(active=active)
        sw = jnp.ones((edges.num_edges,), poses.dtype)
        res = lm_fixed_iters(poses, sw, e, free, cfg, num_iters)
        return res.cost

    return jax.vmap(one)(poses_b, actives_b)


@partial(jax.jit, static_argnames=("cfg", "num_iters"))
def masked_solve(
    poses: Array,        # (N, 3)
    active: Array,       # (E,)
    free_node: Array,    # (N,) 1.0 = free
    edges: EdgeSet,
    cfg: SolverConfig,
    num_iters: int,
) -> tuple[Array, Array]:
    """Short LM solve over a masked subproblem; returns (poses, cost).

    Used for the reference's windowed local optimisations
    (``layer_manager.cpp:137-179``, ``simple_layer_manager.cpp:500-565``):
    nodes outside the window are held fixed via the free mask, edges outside
    are deactivated -- the exact semantics of building the sub-problem.
    """
    e = edges._replace(active=active)
    sw = jnp.ones((edges.num_edges,), poses.dtype)
    res = lm_fixed_iters(poses, sw, e, FreeMask(node=free_node), cfg, num_iters)
    return res.poses, res.cost


@partial(jax.jit, static_argnames=("cfg", "num_iters"))
def batched_masked_solve(
    poses_b: Array,       # (B, N, 3)
    actives_b: Array,     # (B, E)
    free_nodes_b: Array,  # (B, N)
    edges: EdgeSet,
    cfg: SolverConfig,
    num_iters: int,
) -> tuple[Array, Array]:
    """Batched :func:`masked_solve` -- B independent windowed solves in one
    device call (the analog of running several local optimisations at once)."""

    def one(poses, active, fn):
        e = edges._replace(active=active)
        sw = jnp.ones((edges.num_edges,), poses.dtype)
        res = lm_fixed_iters(poses, sw, e, FreeMask(node=fn), cfg, num_iters)
        return res.poses, res.cost

    return jax.vmap(one)(poses_b, actives_b, free_nodes_b)

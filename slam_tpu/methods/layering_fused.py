"""Method 3 as ONE compiled device program (fused probabilistic layering).

The host-driven manager in ``layering.py`` mirrors the reference's
sequential loop (``DCS-ceres/src/layer_manager.cpp:343-468``)
with 3-4 blocking device calls per candidate edge, so per-call latency
dominates M3500-scale runs.

This module re-architects the *whole decision loop* as a single
``lax.scan`` over candidate edges:

* Layers are a fixed ``(L, N, 3)`` pose batch plus ``(L, E)`` masks carried
  through the scan -- "create a layer" is writing into slot ``num_layers``.
* Per edge, the reference's candidate evaluations (L_e(0), L_i, L_e(k),
  L_ij for the top-k UCT layers; ``layer_manager.cpp:352-385``) are one
  fixed batch of 12 short-LM solves (inner scan of width-4 vmap chunks --
  width kept at 4 because vmapped solver programs compile superlinearly in
  batch width on this toolchain).
* UCT scoring, conflict deltas, split/assign decisions, the windowed commit
  optimisation (``layer_manager.cpp:137-179``), EMA residuals, and reward
  backprop (``layer_manager.cpp:450-461``) all run on device with one-hot
  selects (no XLA gather/scatter -- see ``ops/indexing.py`` rationale).
* Every logged quantity of the host version is emitted as a scan output and
  the identical ``[uct] [conflict] [split] [assign] [residual] [uct_update]``
  lines are written post-hoc, so logs/artifacts stay reference-shaped.

Decision-sequence equivalence with the host manager is pinned by
``tests/test_methods.py::test_fused_layering_matches_host`` (recomputing
L_i instead of caching it is exact: a layer's poses change only when it is
the assignment target, which is when the host invalidates the cache).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from slam_tpu.config import LayeringConfig, SolverConfig
from slam_tpu.graph import CLOSURE_EDGE, ODOMETRY_EDGE, PoseGraph
from slam_tpu.methods.layering import (
    LayeringOutput,
    _Layer,
    _info_gain_np,
)
from slam_tpu.solver.lm import lm_fixed_iters
from slam_tpu.solver.problem import EdgeSet, FreeMask, edge_set_from_graph
from slam_tpu.utils.logging import RunLogger

Array = jax.Array

#: Candidate-evaluation chunk width (see layering.LayeringManager.EVAL_CHUNK).
#: Width 4 was the earlier measured optimum (a 12-wide batched Schur LM
#: compiled to a far worse schedule); not yet re-measured on the GPU.
EVAL_CHUNK = 4
#: Specs per edge: L_e(0) + 3x L_i + 3x L_e(k) + 3x L_ij, padded to 12.
NUM_SPECS = 12


class _ScanState(NamedTuple):
    poses: Array        # (L, N, 3)
    masks: Array        # (L, E) float 0/1 loop-edge assignment masks
    ema: Array          # (L,)
    visits: Array       # (L,)
    total_reward: Array  # (L,)
    success: Array      # (L,) int32
    last_step: Array    # (L,) int32
    num_layers: Array   # scalar int32
    step: Array         # scalar int32


class _ScanOut(NamedTuple):
    """Per-edge decision record -- everything the host version logs."""

    num_layers_before: Array
    topk: Array          # (3,) int32 layer indices (may exceed num_layers)
    uct: Array           # (3,) scores
    Le0: Array
    Li: Array            # (3,)
    Lek: Array           # (3,)
    Lij: Array           # (3,)
    delta: Array         # (3,) (+inf on invalid candidates)
    target: Array
    did_split: Array
    split_fallback: Array
    child: Array         # slot the child was cloned into (valid if did_split)
    r_new: Array
    ema_prev: Array
    ema_now: Array
    reward: Array
    visits_after: Array
    n_lc: Array


def _onehot(i: Array, n: int, dtype) -> Array:
    return (jnp.arange(n, dtype=jnp.int32) == i).astype(dtype)


def _pick3(v: Array, dtype) -> tuple[Array, Array]:
    """Top-3 by value, first-index tie-breaking (== stable descending sort,
    matching the host's ``_pick_topk``).  3x argmax avoids XLA sort; masking
    uses ``where`` (never ``0 * inf``) since ``v`` contains ``-inf``."""
    idx, val = [], []
    for _ in range(3):
        k = jnp.argmax(v)
        oh = _onehot(k, v.shape[0], dtype)
        idx.append(k.astype(jnp.int32))
        val.append(jnp.sum(jnp.where(oh > 0, v, 0.0)))
        v = jnp.where(oh > 0, -jnp.inf, v)
    return jnp.stack(idx), jnp.stack(val)


def _sel(onehot_k: Array, x: Array) -> Array:
    """Row-select ``x[k]`` as a one-hot contraction (no gather)."""
    flat = x.reshape(x.shape[0], -1)
    out = jnp.matmul(onehot_k[None, :], flat,
                     precision=jax.lax.Precision.HIGHEST,
                     preferred_element_type=flat.dtype)
    return out.reshape(x.shape[1:])


def _edge_residual(pa: Array, pb: Array, meas: Array, theta_w) -> Array:
    """Device twin of ``layering._edge_residual_np``
    (``layer_manager.cpp:181-228``)."""
    ca, sa = jnp.cos(pa[2]), jnp.sin(pa[2])
    dx, dy = pb[0] - pa[0], pb[1] - pa[1]
    vx = ca * dx + sa * dy - meas[0]
    vy = -sa * dx + ca * dy - meas[1]
    cm, sm = jnp.cos(meas[2]), jnp.sin(meas[2])
    ex = cm * vx + sm * vy
    ey = -sm * vx + cm * vy
    et = jnp.arcsin(jnp.clip(jnp.sin(pb[2] - pa[2] - meas[2]), -1.0, 1.0))
    return jnp.sqrt(ex * ex + ey * ey + theta_w * et * et)


@partial(jax.jit, static_argnames=("cfg", "solver"))
def _fused_chunk(
    state: _ScanState,      # carried between chunks; stays on device
    edges: EdgeSet,         # full canonical edge set (active == 1 everywhere)
    odo_mask: Array,        # (E,) float
    closure_mask: Array,    # (E,) float (CLOSURE only, not bogus)
    free_first: FreeMask,
    part,                   # SchurPartition when solver.linear_solver=="schur", else None
    cand_eidx: Array,       # (C,) int32 canonical edge index per candidate
    cand_ab: Array,         # (C, 2) int32
    cand_meas: Array,       # (C, 3)
    cand_info_gain: Array,  # (C,)
    cand_live: Array,       # (C,) 1.0 live candidate, 0.0 pad (no-op step)
    cfg: LayeringConfig,
    solver: SolverConfig,
) -> tuple[_ScanState, _ScanOut]:
    dtype = jnp.dtype(solver.dtype)
    L = cfg.max_layers
    N = state.poses.shape[1]
    E = edges.num_edges
    iota_e = jnp.arange(E, dtype=jnp.int32)
    iota_n = jnp.arange(N, dtype=jnp.int32)
    sw0 = jnp.ones((E,), dtype)
    big = jnp.asarray(jnp.inf, dtype)

    def eval_costs(poses_b: Array, actives_b: Array) -> Array:
        """12 short-LM evaluations as an inner scan of width-4 vmap chunks
        (one compiled chunk subprogram, reused)."""

        def one(poses, active):
            e = edges._replace(active=active)
            return lm_fixed_iters(
                poses, sw0, e, free_first, solver, max(1, cfg.local_iters),
                partition=part,
            ).cost

        def chunk(_, xs):
            pb, ab = xs
            return None, jax.vmap(one)(pb, ab)

        pb = poses_b.reshape(NUM_SPECS // EVAL_CHUNK, EVAL_CHUNK, N, 3)
        ab = actives_b.reshape(NUM_SPECS // EVAL_CHUNK, EVAL_CHUNK, E)
        _, costs = jax.lax.scan(chunk, None, (pb, ab))
        return costs.reshape(NUM_SPECS)

    def body(s: _ScanState, xs):
        eidx, ab, meas, info_gain, live = xs
        a, b = ab[0], ab[1]
        extra = (iota_e == eidx).astype(dtype)
        step = s.step + 1

        # -- UCT top-k (layer_manager.cpp:512-531) ------------------------
        valid = (jnp.arange(L) >= 1) & (jnp.arange(L) < s.num_layers)
        q = s.total_reward / (1.0 + s.visits)
        total = 1.0 + jnp.sum(jnp.where(valid, s.visits, 0.0))
        u = cfg.uct_c * jnp.sqrt(jnp.log(total) / (1.0 + s.visits))
        score = jnp.where(valid, q + u, -big)
        topk, uct = _pick3(score, dtype)
        oh_topk = (topk[:, None] == jnp.arange(L, dtype=jnp.int32)[None, :]
                   ).astype(dtype)                       # (3, L)
        # -inf scores sort last, so invalid slots (incl. layer 0 picked from
        # an all--inf tail) occupy a suffix; exclude them from the decision.
        topk_valid = (topk >= 1) & (topk < s.num_layers)

        # -- candidate evaluation batch (layer_manager.cpp:352-385) -------
        pose_rows = jnp.concatenate([
            _onehot(jnp.int32(0), L, dtype)[None, :],    # L_e(0)
            oh_topk,                                     # L_i(k)
            oh_topk,                                     # L_e(k)
            oh_topk,                                     # L_ij(k)
            jnp.broadcast_to(
                _onehot(jnp.int32(0), L, dtype), (2, L)
            ),                                           # pad rows
        ])                                               # (12, L)
        poses_b = jnp.matmul(
            pose_rows, s.poses.reshape(L, N * 3),
            precision=jax.lax.Precision.HIGHEST,
            preferred_element_type=dtype,
        ).reshape(NUM_SPECS, N, 3)
        masks_topk = jnp.matmul(
            oh_topk, s.masks, precision=jax.lax.Precision.HIGHEST,
            preferred_element_type=dtype,
        )                                                # (3, E)
        odo = odo_mask[None, :]
        actives_b = jnp.concatenate([
            jnp.maximum(odo, extra[None, :]),                      # L_e(0)
            jnp.maximum(odo, masks_topk),                          # L_i
            jnp.maximum(odo, jnp.broadcast_to(extra, (3, E))),     # L_e(k)
            jnp.maximum(odo, jnp.maximum(masks_topk, extra)),      # L_ij
            jnp.maximum(odo, jnp.broadcast_to(extra, (2, E))),     # pads
        ])
        costs = eval_costs(poses_b, actives_b)
        Le0, Li, Lek, Lij = (costs[0], costs[1:4], costs[4:7], costs[7:10])

        # -- conflict decision (layer_manager.cpp:388-431) -----------------
        delta = jnp.where(topk_valid, Lij - jnp.minimum(Li, Lek), big)
        t = jnp.argmin(delta).astype(jnp.int32)          # first-min == host
        oh_t3 = _onehot(t, 3, dtype)
        best_delta = jnp.sum(jnp.where(oh_t3 > 0, delta, 0.0))
        best_Li = jnp.sum(oh_t3 * Li)
        best_Lij = jnp.sum(oh_t3 * Lij)
        target = jnp.sum(oh_t3 * topk.astype(dtype)).astype(jnp.int32)

        request_split = best_delta > cfg.conflict_tau
        can_split = s.num_layers < L
        did_split = request_split & can_split
        child = s.num_layers
        oh_target = _onehot(target, L, dtype)
        oh_child = _onehot(child, L, dtype)
        w = did_split.astype(dtype) * oh_child           # clone weights (L,)
        tgt_poses = _sel(oh_target, s.poses)
        tgt_mask_pre = _sel(oh_target, s.masks)
        poses = s.poses * (1 - w)[:, None, None] + \
            w[:, None, None] * tgt_poses[None, :, :]
        masks = s.masks * (1 - w)[:, None] + w[:, None] * tgt_mask_pre[None, :]
        num_layers = s.num_layers + did_split.astype(jnp.int32)

        # -- assign + windowed commit optimisation (:137-179,432-437) ------
        masks = jnp.maximum(masks, oh_target[:, None] * extra[None, :])
        tgt_mask = jnp.maximum(tgt_mask_pre, extra)
        lo = jnp.maximum(0, jnp.minimum(a, b) - cfg.commit_window_radius)
        hi = jnp.minimum(N - 1, jnp.maximum(a, b) + cfg.commit_window_radius)
        ea, eb = edges.ij[:, 0], edges.ij[:, 1]
        edge_in_w = ((ea >= lo) & (ea <= hi) & (eb >= lo) & (eb <= hi)
                     ).astype(dtype)
        edge_active = jnp.maximum(odo_mask, tgt_mask) * edge_in_w
        free = ((iota_n >= lo) & (iota_n <= hi) & (iota_n != lo)
                ).astype(dtype)
        opt = lm_fixed_iters(
            tgt_poses, sw0, edges._replace(active=edge_active),
            FreeMask(node=free), solver, max(1, cfg.commit_local_iters),
            partition=part,
        )
        new_tgt = opt.poses
        poses = poses * (1 - oh_target)[:, None, None] + \
            oh_target[:, None, None] * new_tgt[None, :, :]

        # -- EMA residual (:440-447) ---------------------------------------
        pa = jnp.einsum("n,nc->c", (iota_n == a).astype(dtype), new_tgt,
                        precision=jax.lax.Precision.HIGHEST)
        pb = jnp.einsum("n,nc->c", (iota_n == b).astype(dtype), new_tgt,
                        precision=jax.lax.Precision.HIGHEST)
        r = _edge_residual(pa, pb, meas, cfg.theta_weight)
        ema_prev = jnp.sum(oh_target * s.ema)
        ema_now = (1 - cfg.ema_alpha) * ema_prev + cfg.ema_alpha * r
        ema = s.ema * (1 - oh_target) + oh_target * ema_now

        # -- reward + UCT backprop (:450-461) -------------------------------
        dcr = (best_Lij - best_Li) / (cfg.epsilon + best_Li)
        n_lc = jnp.sum(tgt_mask * closure_mask)
        reward = jnp.clip(
            -dcr + cfg.alpha_info * info_gain - cfg.beta_sparse * n_lc,
            -1.0, 1.0,
        )
        success = (~did_split) & (best_delta <= cfg.conflict_tau)
        visits = s.visits + oh_target
        total_reward = s.total_reward + oh_target * reward
        success_ct = s.success + (oh_target * success.astype(dtype)
                                  ).astype(jnp.int32)
        last_step = jnp.where(oh_target > 0, step, s.last_step)

        out = _ScanOut(
            num_layers_before=s.num_layers, topk=topk, uct=uct, Le0=Le0,
            Li=Li, Lek=Lek, Lij=Lij, delta=delta, target=target,
            did_split=did_split, split_fallback=request_split & ~can_split,
            child=child, r_new=r, ema_prev=ema_prev, ema_now=ema_now,
            reward=reward, visits_after=jnp.sum(oh_target * visits),
            n_lc=n_lc,
        )
        new = _ScanState(
            poses=poses, masks=masks, ema=ema, visits=visits,
            total_reward=total_reward, success=success_ct,
            last_step=last_step, num_layers=num_layers, step=step,
        )
        # Padding steps are no-ops: keep the old state wholesale.
        keep = live > 0
        new = jax.tree.map(lambda a, o: jnp.where(keep, a, o), new, s)
        return new, out

    return jax.lax.scan(
        body, state,
        (cand_eidx, cand_ab, cand_meas, cand_info_gain, cand_live),
    )


def _init_state(
    poses0: Array, L: int, E: int, dtype
) -> _ScanState:
    N = poses0.shape[0]
    return _ScanState(
        poses=jnp.broadcast_to(poses0.astype(dtype), (L, N, 3)),
        masks=jnp.zeros((L, E), dtype),
        ema=jnp.zeros((L,), dtype),
        visits=jnp.zeros((L,), dtype),
        total_reward=jnp.zeros((L,), dtype),
        success=jnp.zeros((L,), jnp.int32),
        last_step=jnp.zeros((L,), jnp.int32),
        num_layers=jnp.int32(2),
        step=jnp.int32(0),
    )


class FusedLayeringManager:
    """Drop-in twin of :class:`layering.LayeringManager` running the whole
    loop as one device program.  Same constructor, same ``run()`` contract,
    same log lines (written post-hoc from the scan outputs)."""

    def __init__(
        self,
        graph: PoseGraph,
        cfg: LayeringConfig,
        solver: SolverConfig | None = None,
        logger: RunLogger | None = None,
        checkpoint_path: str | None = None,
    ):
        self.graph = graph.canonical_order()
        self.cfg = cfg
        self.log = logger or RunLogger()
        self.checkpoint_path = checkpoint_path

        solver = solver or SolverConfig()
        from slam_tpu.methods._fused_common import setup_eval_solver
        (self.eval_cfg, self.edges, self.partition,
         self.scan_chunk) = setup_eval_solver(self.graph, cfg, solver)
        self.dtype = jnp.dtype(self.eval_cfg.dtype)
        et = self.graph.edge_type
        self.loop_indices = np.where(et != ODOMETRY_EDGE)[0]
        self.ij = self.graph.edges_ij
        self.meas = self.graph.edges_meas

        self.log.log("init", layers=2, candidates=len(self.loop_indices),
                     fused=True)

    def run(self) -> LayeringOutput:
        from slam_tpu.solver.problem import anchor_first_node

        g = self.graph
        cand = self.loop_indices.astype(np.int32)
        C = len(cand)
        info_gain = np.array(
            [_info_gain_np(g.edges_info[e]) for e in cand]
        )
        odo = (g.edge_type == ODOMETRY_EDGE).astype(np.float64)
        clos = (g.edge_type == CLOSURE_EDGE).astype(np.float64)

        # Chunked execution: the scan is sliced into fixed-size chunks
        # (one compilation, reused) that bound each device call's wall
        # time; the layer state stays on device between calls and only
        # the per-edge decision records come back to the host at the end.
        # Optional chunk-boundary checkpointing (see
        # _fused_common.run_chunked).
        from slam_tpu.methods import _fused_common as fc

        # None = adaptive chunking (run_chunked probes and resizes under
        # its per-call bound); an explicit chunk is honored as given.
        chunk = self.scan_chunk
        align = fc.MIN_CHUNK if chunk is None else max(1, min(chunk, C))
        chunk = chunk if chunk is None else align
        pad = (-C) % align
        xs_np = [
            np.concatenate([cand, np.zeros(pad, np.int32)]),
            np.concatenate([g.edges_ij[cand],
                            np.zeros((pad, 2), np.int32)]).astype(np.int32),
            np.concatenate([g.edges_meas[cand],
                            np.zeros((pad, g.edges_meas.shape[1]))]),
            np.concatenate([info_gain, np.zeros(pad)]),
            np.concatenate([np.ones(C), np.zeros(pad)]),
        ]
        dtypes = [jnp.int32, jnp.int32] + [self.dtype] * 3
        consts = (
            self.edges,
            jnp.asarray(odo, self.dtype),
            jnp.asarray(clos, self.dtype),
            anchor_first_node(g.num_nodes, dtype=self.dtype),
            self.partition,
        )
        state = _init_state(
            jnp.asarray(g.poses, self.dtype), self.cfg.max_layers,
            self.edges.num_edges, self.dtype,
        )
        fp = fc.fingerprint(
            g.poses, g.edges_ij, g.edges_meas, cand,
            extra=f"m3|{self.cfg}|{self.eval_cfg}",
        )
        state, merged = fc.run_chunked(
            state, _fused_chunk, consts, xs_np, dtypes, chunk, C,
            self.cfg, self.eval_cfg,
            checkpoint_path=self.checkpoint_path, fp=fp, logger=self.log,
        )
        return self._replay(state, _ScanOut(**merged))

    # -- host-side replay: identical logs + outputs ------------------------
    def _replay(self, state, o) -> LayeringOutput:
        cfg = self.cfg
        num_layers = int(state.num_layers)
        assignments = []
        for i, eidx in enumerate(self.loop_indices):
            nl = int(o.num_layers_before[i])
            topk = [int(k) for k in o.topk[i] if 1 <= int(k) < nl]
            self.log.log("uct", topk=",".join(
                f"L{k}({float(o.uct[i][t]):.4f})" for t, k in enumerate(topk)
            ))
            for t, k in enumerate(topk):
                self.log.log(
                    "conflict", edge_idx=i, try_layer=k,
                    L_i=float(o.Li[i][t]), L_e_k=float(o.Lek[i][t]),
                    L_ij=float(o.Lij[i][t]), Delta=float(o.delta[i][t]),
                )
            target = int(o.target[i])
            best_delta = float(o.delta[i][int(np.argmin(o.delta[i]))])
            if bool(o.did_split[i]):
                self.log.log("layer", created=int(o.child[i]), parent=target)
                self.log.log("split", edge_idx=i, Delta=best_delta,
                             child_layer=int(o.child[i]),
                             parent_assigned_layer=target)
            elif bool(o.split_fallback[i]):
                self.log.log("split-fallback", edge_idx=i, Delta=best_delta,
                             fallback_layer=target)
            a, b = int(self.ij[eidx, 0]), int(self.ij[eidx, 1])
            self.log.log("assign", edge_idx=i, a=a, b=b,
                         type=int(self.graph.edge_type[eidx]),
                         to_layer=target)
            assignments.append((i, target))
            self.log.log("residual", layer=target, r_new=float(o.r_new[i]),
                         ema_prev=float(o.ema_prev[i]),
                         ema_now=float(o.ema_now[i]))
            self.log.log("uct_update", layer=target,
                         visits=float(o.visits_after[i]),
                         reward=float(o.reward[i]))

        layers = [
            _Layer(
                poses=np.asarray(state.poses[k], float),
                mask=np.asarray(state.masks[k] > 0.5),
                ema_residual=float(state.ema[k]),
                num_edges=int(np.sum(state.masks[k] > 0.5)),
                visits=float(state.visits[k]),
                total_reward=float(state.total_reward[k]),
                success=int(state.success[k]),
                last_step=int(state.last_step[k]),
            )
            for k in range(num_layers)
        ]
        best = min(range(1, num_layers),
                   key=lambda k: layers[k].ema_residual)
        most = max(range(1, num_layers),
                   key=lambda k: int(layers[k].mask.sum()))
        self.log.log("finish", best_layer=best,
                     ema=layers[best].ema_residual)
        self._print_summary(layers, most)
        return LayeringOutput(
            poses=layers[best].poses,
            layers=layers,
            assignments=assignments,
            best_layer=best,
            most_selected_layer=most,
        )

    def _print_summary(self, layers, most: int) -> None:
        self.log.log("summary", msg="==== Method3 Summary ====")
        self.log.log("summary", total_layers=len(layers) - 1)
        self.log.log("summary", most_selected_layer=f"L{most}",
                     edges=int(layers[most].mask.sum()))
        for k in range(1, len(layers)):
            lay = layers[k]
            nodes = set()
            for e in np.where(lay.mask)[0]:
                nodes.add(int(self.ij[e, 0]))
                nodes.add(int(self.ij[e, 1]))
            self.log.log(
                "summary", layer=f"L{k}", edges=int(lay.mask.sum()),
                nodes=len(nodes), visits=int(lay.visits),
                success=lay.success, total_reward=lay.total_reward,
                avg_reward=lay.total_reward / (1.0 + lay.visits),
                ema_residual=lay.ema_residual,
            )

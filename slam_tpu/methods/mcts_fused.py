"""Method 4 (MCTS layer tree) as ONE compiled device program.

Same re-architecture as ``layering_fused.py`` applied to
``DCS-ceres/src/simple_layer_manager.cpp``: the whole
sequential edge loop (``:68-130``) runs as a single ``lax.scan``, with the
layer *tree* flattened into fixed-size arrays:

* ``parent (L,)`` int32 pointers (root slot 0, -1 sentinel) -- creation
  order equals slot order, matching the host manager's ``L{k+1}`` ids.
* ``inherited/added (L, E)`` masks, ``poses (L, N, 3)``, ``visits``/
  ``total_reward (L,)``.
* Per edge, three device stages mirror the host's call pattern: the 3-way
  split check (``:173-211``), the commit optimisation (full layer or the
  child's local window, ``:457-498``/``:500-565``), and the 2-solve reward
  (``:293-339``).  Branches are computed uniformly and selected with
  ``where`` -- no recompilation, no host round-trips.
* UCT selection with unvisited-first (``:132-171``), the Mahalanobis gate
  (``:388-455``), and parent-chain backprop (``:624-641``, a ``fori_loop``
  over one-hot pointer chasing) all run on device.

The host twin (``mcts.py``) stays the readable reference implementation;
``tests/test_methods.py::test_fused_mcts_matches_host`` pins decision-
sequence equality, and the replay step writes the identical log lines.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from slam_tpu.config import MctsConfig, SolverConfig
from slam_tpu.graph import CLOSURE_EDGE, ODOMETRY_EDGE, PoseGraph
from slam_tpu.methods.mcts import (
    MctsOutput,
    _TreeLayer,
    _info_gain_np,
)
from slam_tpu.solver.lm import lm_fixed_iters
from slam_tpu.solver.problem import EdgeSet, FreeMask, edge_set_from_graph
from slam_tpu.utils.logging import RunLogger

Array = jax.Array

class _TreeState(NamedTuple):
    poses: Array        # (L, N, 3)
    inherited: Array    # (L, E)
    added: Array        # (L, E)
    visits: Array       # (L,)
    total_reward: Array  # (L,)
    parent: Array       # (L,) int32, -1 = none
    num_layers: Array   # scalar int32
    step: Array


class _TreeOut(NamedTuple):
    num_layers_before: Array
    selected: Array
    residual: Array
    gate: Array          # residual < residual_high
    did_check: Array     # split check evaluated (and logged)
    c_cur: Array
    c_new: Array
    c_comb: Array
    split_value: Array
    did_split: Array
    target: Array
    Li: Array
    Li_prev: Array
    dcr: Array
    n_closure: Array
    reward: Array


def _onehot(i: Array, n: int, dtype) -> Array:
    return (jnp.arange(n, dtype=jnp.int32) == i).astype(dtype)


def _sel(oh: Array, x: Array) -> Array:
    flat = x.reshape(x.shape[0], -1)
    out = jnp.matmul(oh[None, :], flat,
                     precision=jax.lax.Precision.HIGHEST,
                     preferred_element_type=flat.dtype)
    return out.reshape(x.shape[1:])


def _wrap(t: Array) -> Array:
    """Angle wrap to (-pi, pi] (the reference's subtract-2pi loop,
    ``simple_layer_manager.cpp:430-441``, closed form)."""
    two_pi = 2.0 * jnp.pi
    return t - two_pi * jnp.floor((t + jnp.pi) / two_pi)


@partial(jax.jit, static_argnames=("cfg", "solver"))
def _fused_chunk(
    state: _TreeState,      # carried between chunks; stays on device
    edges: EdgeSet,
    odo_mask: Array,        # (E,) float
    closure_mask: Array,    # (E,) float
    free_all: FreeMask,
    part,                   # SchurPartition when solver.linear_solver=="schur", else None
    cand_eidx: Array,       # (C,)
    cand_ab: Array,         # (C, 2)
    cand_meas: Array,       # (C, 3)
    cand_info: Array,       # (C, 6)
    cand_info_gain: Array,  # (C,)
    cand_is_closure: Array,  # (C,)
    cand_live: Array,       # (C,) 1.0 live, 0.0 pad (no-op step)
    cfg: MctsConfig,
    solver: SolverConfig,
) -> tuple[_TreeState, _TreeOut]:
    dtype = jnp.dtype(solver.dtype)
    L = cfg.max_layers
    N = state.poses.shape[1]
    E = edges.num_edges
    iota_n = jnp.arange(N, dtype=jnp.int32)
    iota_l = jnp.arange(L, dtype=jnp.int32)
    iota_e = jnp.arange(E, dtype=jnp.int32)
    sw0 = jnp.ones((E,), dtype)
    ea, eb = edges.ij[:, 0], edges.ij[:, 1]

    def eval3(poses: Array, actives_b: Array) -> Array:
        """Three 1-iteration solve costs from one start point (the host's
        ``_eval_costs`` width-3 batch; ``evaluate_layer_cost`` semantics)."""

        def one(active):
            e = edges._replace(active=active)
            return lm_fixed_iters(poses, sw0, e, free_all, solver, 1,
                                  partition=part).cost

        return jax.vmap(one)(actives_b)

    def body(s: _TreeState, xs):
        (eidx, ab, meas, info6, info_gain, is_closure, live) = xs
        a, b = ab[0], ab[1]
        extra = (iota_e == eidx).astype(dtype)
        step = s.step + 1
        valid = iota_l < s.num_layers

        # -- UCT selection, unvisited-first (:132-171) ----------------------
        unvisited = valid & (s.visits == 0)
        total = jnp.maximum(1.0, jnp.sum(jnp.where(valid, s.visits, 0.0)))
        vsafe = jnp.maximum(s.visits, 1.0)
        val = s.total_reward / vsafe + cfg.exploration_c * jnp.sqrt(
            jnp.log(total) / vsafe
        )
        val = jnp.where(valid & (s.visits > 0), val, -jnp.inf)
        selected = jnp.where(
            jnp.any(unvisited),
            jnp.argmax(unvisited).astype(jnp.int32),
            jnp.argmax(val).astype(jnp.int32),
        )
        oh_sel = _onehot(selected, L, dtype)
        sel_poses = _sel(oh_sel, s.poses)
        sel_inh = _sel(oh_sel, s.inherited)
        sel_add = _sel(oh_sel, s.added)
        sel_all = jnp.maximum(sel_inh, sel_add)

        # -- Mahalanobis gate (:388-455) ------------------------------------
        pa = jnp.einsum("n,nc->c", (iota_n == a).astype(dtype), sel_poses,
                        precision=jax.lax.Precision.HIGHEST)
        pb = jnp.einsum("n,nc->c", (iota_n == b).astype(dtype), sel_poses,
                        precision=jax.lax.Precision.HIGHEST)
        dx, dy = pb[0] - pa[0], pb[1] - pa[1]
        ca, sa = jnp.cos(pa[2]), jnp.sin(pa[2])
        r = jnp.stack([
            ca * dx + sa * dy - meas[0],
            -sa * dx + ca * dy - meas[1],
            _wrap(_wrap(pb[2] - pa[2]) - meas[2]),
        ])
        O = jnp.array(
            [[info6[0], info6[1], info6[2]],
             [info6[1], info6[3], info6[4]],
             [info6[2], info6[4], info6[5]]]
        ).astype(dtype)
        residual = jnp.sqrt(jnp.maximum(0.0, r @ O @ r))
        gate = residual < cfg.residual_high

        # -- split check (:173-211) ------------------------------------------
        has_added = jnp.any(sel_add > 0)
        can_split = s.num_layers < L
        base = jnp.maximum(odo_mask, sel_inh)
        checks = jnp.stack([
            jnp.maximum(base, sel_add),                          # current
            jnp.maximum(base, extra),                            # new only
            jnp.maximum(base, jnp.maximum(sel_add, extra)),      # combined
        ])
        c = eval3(sel_poses, checks)
        c_cur, c_new, c_comb = c[0], c[1], c[2]
        split_value = c_comb - jnp.minimum(c_cur, c_new)
        did_check = gate & can_split & has_added
        did_split = did_check & (split_value > cfg.conflict_tau)

        # -- targets / mask updates ------------------------------------------
        child = s.num_layers
        target = jnp.where(did_split, child, selected)
        oh_tgt = _onehot(target, L, dtype)
        inh_t = jnp.where(did_split, sel_all, sel_inh)           # (E,)
        added_t = jnp.where(did_split, extra,
                            jnp.maximum(sel_add, extra))         # (E,)
        g = gate.astype(dtype)
        upd = g * oh_tgt                                         # (L,)
        inherited = s.inherited * (1 - upd)[:, None] + \
            upd[:, None] * inh_t[None, :]
        added = s.added * (1 - upd)[:, None] + \
            upd[:, None] * added_t[None, :]
        parent = jnp.where(
            (iota_l == child) & did_split & gate,
            selected, s.parent,
        )
        num_layers = s.num_layers + (did_split & gate).astype(jnp.int32)

        # -- commit optimisation: child local window (:500-565) or full
        #    layer (:457-498), selected uniformly ----------------------------
        # Window nodes = within radius of either endpoint of the (single)
        # added edge; an odometry edge is active iff both its endpoints are
        # window nodes (simple_layer_manager.cpp:500-530).
        radius = max(1, cfg.local_window // 2)
        na = (jnp.abs(ea - a) <= radius) | (jnp.abs(ea - b) <= radius)
        nb = (jnp.abs(eb - a) <= radius) | (jnp.abs(eb - b) <= radius)
        odo_in = odo_mask * (na & nb).astype(dtype)
        win_active = jnp.maximum(odo_in, extra)
        used = (edges.scatter_a(win_active, N)
                + edges.scatter_b(win_active, N)) > 0
        anchor = jnp.where(used[0], 0, jnp.argmax(used)).astype(jnp.int32)
        win_free = (used & (iota_n != anchor)).astype(dtype)

        full_active = jnp.maximum(odo_mask, jnp.maximum(inh_t, added_t))
        active_opt = jnp.where(did_split, win_active, full_active)
        free_opt = jnp.where(did_split, win_free, free_all.node)
        opt = lm_fixed_iters(
            sel_poses, sw0, edges._replace(active=active_opt),
            FreeMask(node=free_opt), solver, max(1, cfg.local_iters),
            partition=part,
        )
        poses = s.poses * (1 - upd)[:, None, None] + \
            upd[:, None, None] * opt.poses[None, :, :]

        # -- reward (:293-339) ------------------------------------------------
        base_t = jnp.maximum(odo_mask, inh_t)
        without = added_t * (1 - extra)
        rc = eval3(opt.poses, jnp.stack([
            jnp.maximum(base_t, added_t),
            jnp.maximum(base_t, without),
            jnp.maximum(base_t, added_t),     # pad (host pads with spec 0)
        ]))
        Li, Li_prev = rc[0], rc[1]
        dcr = (Li - Li_prev) / (cfg.epsilon + Li_prev)
        n_closure = jnp.sum(
            jnp.maximum(inh_t, added_t) * closure_mask
        ) + is_closure  # reference double-count (:367-386)
        reward = jnp.clip(
            -dcr + cfg.alpha_info * info_gain - cfg.beta_sparse * n_closure,
            -1.0, 1.0,
        )

        # -- backprop up the parent chain (:624-641) --------------------------
        def bp(_, carry):
            cur, vis, tr = carry
            live = cur >= 0
            oh = _onehot(jnp.maximum(cur, 0), L, dtype) * live.astype(dtype)
            vis = vis + g * oh
            tr = tr + g * oh * reward
            nxt = jnp.sum(
                jnp.where(oh > 0, parent.astype(dtype), 0.0)
            ).astype(jnp.int32)
            cur = jnp.where(live, jnp.where(oh.sum() > 0, nxt, -1), -1)
            return cur, vis, tr

        _, visits, total_reward = jax.lax.fori_loop(
            0, L, bp, (target, s.visits, s.total_reward)
        )

        out = _TreeOut(
            num_layers_before=s.num_layers, selected=selected,
            residual=residual, gate=gate, did_check=did_check,
            c_cur=c_cur, c_new=c_new, c_comb=c_comb,
            split_value=split_value, did_split=did_split & gate,
            target=target, Li=Li, Li_prev=Li_prev, dcr=dcr,
            n_closure=n_closure, reward=reward,
        )
        new = _TreeState(
            poses=poses, inherited=inherited, added=added, visits=visits,
            total_reward=total_reward, parent=parent,
            num_layers=num_layers, step=step,
        )
        keep = live > 0
        new = jax.tree.map(lambda n, o: jnp.where(keep, n, o), new, s)
        return new, out

    return jax.lax.scan(
        body, state,
        (cand_eidx, cand_ab, cand_meas, cand_info, cand_info_gain,
         cand_is_closure, cand_live),
    )


def _init_state(poses0: Array, L: int, E: int, dtype) -> _TreeState:
    N = poses0.shape[0]
    return _TreeState(
        poses=jnp.broadcast_to(poses0.astype(dtype), (L, N, 3)),
        inherited=jnp.zeros((L, E), dtype),
        added=jnp.zeros((L, E), dtype),
        visits=jnp.zeros((L,), dtype),
        total_reward=jnp.zeros((L,), dtype),
        parent=jnp.full((L,), -1, jnp.int32),
        num_layers=jnp.int32(1),
        step=jnp.int32(0),
    )


class FusedMctsManager:
    """Drop-in twin of :class:`mcts.MctsManager` running the whole loop as
    one device program; identical decisions/logs (see module docstring)."""

    def __init__(
        self,
        graph: PoseGraph,
        cfg: MctsConfig,
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
        self.E = self.edges.num_edges
        et = self.graph.edge_type
        self.loop_indices = np.where(et != ODOMETRY_EDGE)[0]
        self.ij = self.graph.edges_ij

        self.log.log("init", msg="MCTS layer manager (method 4)",
                     candidates=len(self.loop_indices),
                     max_layers=cfg.max_layers, fused=True)

    def run(self) -> MctsOutput:
        from slam_tpu.solver.problem import anchor_first_node

        g = self.graph
        cand = self.loop_indices.astype(np.int32)
        info_gain = np.array(
            [_info_gain_np(g.edges_info[e]) for e in cand]
        )
        odo = (g.edge_type == ODOMETRY_EDGE).astype(np.float64)
        clos = (g.edge_type == CLOSURE_EDGE).astype(np.float64)

        from slam_tpu.methods import _fused_common as fc

        C = len(cand)
        # None = adaptive chunking (run_chunked probes and resizes under
        # its per-call bound); an explicit chunk is honored as given.
        chunk = self.scan_chunk
        align = fc.MIN_CHUNK if chunk is None else max(1, min(chunk, C))
        chunk = chunk if chunk is None else align
        pad = (-C) % align
        is_clos = (g.edge_type[cand] == CLOSURE_EDGE).astype(np.float64)
        xs_np = [
            np.concatenate([cand, np.zeros(pad, np.int32)]),
            np.concatenate([g.edges_ij[cand],
                            np.zeros((pad, 2), np.int32)]).astype(np.int32),
            np.concatenate([g.edges_meas[cand],
                            np.zeros((pad, g.edges_meas.shape[1]))]),
            np.concatenate([g.edges_info[cand],
                            np.ones((pad, g.edges_info.shape[1]))]),
            np.concatenate([info_gain, np.zeros(pad)]),
            np.concatenate([is_clos, np.zeros(pad)]),
            np.concatenate([np.ones(C), np.zeros(pad)]),
        ]
        dtypes = [jnp.int32, jnp.int32] + [self.dtype] * 5
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
            extra=f"m4|{self.cfg}|{self.eval_cfg}",
        )
        state, merged = fc.run_chunked(
            state, _fused_chunk, consts, xs_np, dtypes, chunk, C,
            self.cfg, self.eval_cfg,
            checkpoint_path=self.checkpoint_path, fp=fp, logger=self.log,
        )
        return self._replay(state, _TreeOut(**merged))

    def _replay(self, state, o) -> MctsOutput:
        g = self.graph
        num_layers = int(state.num_layers)
        ids = [f"L{k + 1}" for k in range(num_layers)]
        layers: dict[str, _TreeLayer] = {}
        for k in range(num_layers):
            par = int(state.parent[k])
            layers[ids[k]] = _TreeLayer(
                id=ids[k], parent=ids[par] if par >= 0 else "",
                poses=np.asarray(state.poses[k], float),
                inherited=np.asarray(state.inherited[k] > 0.5),
                added=np.asarray(state.added[k] > 0.5),
                visits=int(round(float(state.visits[k]))),
                total_reward=float(state.total_reward[k]),
            )
        for k in range(num_layers):
            par = int(state.parent[k])
            if par >= 0:
                layers[ids[par]].children.append(ids[k])

        assignments = []
        vis = np.zeros(num_layers)
        tr = np.zeros(num_layers)
        for i, eidx in enumerate(self.loop_indices):
            eidx = int(eidx)
            a, b = int(self.ij[eidx, 0]), int(self.ij[eidx, 1])
            self.log.log(f"step {i + 1}",
                         msg=f"edge ({a},{b}) "
                             f"type={int(g.edge_type[eidx])}")
            self.log.log("residual", edge_residual=float(o.residual[i]),
                         low=self.cfg.residual_low,
                         high=self.cfg.residual_high)
            if not bool(o.gate[i]):
                self.log.log("skip", msg="edge residual too high")
                continue
            sel_id = ids[int(o.selected[i])]
            if bool(o.did_check[i]):
                self.log.log(
                    "split_check", layer=sel_id,
                    cost_current=float(o.c_cur[i]),
                    cost_new_only=float(o.c_new[i]),
                    cost_combined=float(o.c_comb[i]),
                    should_split=bool(o.did_split[i]),
                    split_value=float(o.split_value[i]),
                )
            t = int(o.target[i])
            tgt_id = ids[t]
            assignments.append((eidx, tgt_id))
            self.log.log("reward", layer=tgt_id,
                         delta_cost_rel=float(o.dcr[i]),
                         info_gain=float(
                             _info_gain_np(g.edges_info[eidx])),
                         n_closure=int(round(float(o.n_closure[i]))),
                         final_reward=float(o.reward[i]))
            cur = t
            while cur >= 0:
                vis[cur] += 1
                tr[cur] += float(o.reward[i])
                self.log.log("backprop", layer=ids[cur],
                             visits=int(vis[cur]), total_reward=tr[cur])
                cur = int(state.parent[cur])
            if bool(o.did_split[i]):
                self.log.log("expand", created=tgt_id,
                             parent=sel_id, reward=float(o.reward[i]))
            else:
                self.log.log("assign", layer=tgt_id,
                             reward=float(o.reward[i]))

        # result selection (:643-703)
        def normalized(lay):
            return lay.total_reward / np.sqrt(
                1.0 + int(lay.all_edges.sum())
            )

        best, best_val = ids[0], -1e9
        for lid, lay in layers.items():
            if lay.visits > 0 and normalized(lay) > best_val:
                best_val, best = normalized(lay), lid
        most_visited = max(layers.values(), key=lambda l: l.visits).id
        most_edges = max(
            layers.values(), key=lambda l: int(l.all_edges.sum())
        ).id
        self.log.log("summary", msg="===== METHOD 4 SUMMARY =====",
                     total_layers=len(layers), best=best,
                     most_visited=most_visited, most_edges=most_edges)
        return MctsOutput(
            poses=layers[best].poses,
            layers=layers,
            assignments=assignments,
            best_layer=best,
            most_visited_layer=most_visited,
            most_edges_layer=most_edges,
        )

    @property
    def root_id(self) -> str:
        return "L1"

"""Manager-semantics oracle for methods 3/4 (VERDICT r4 missing #1).

The reference's layer managers make every decision (UCT pick, Delta-conflict
split, assignment) from candidate costs computed by *short Ceres LM solves*:
fresh problem, every edge as a plain ``OdometryResidue`` under
``HuberLoss``, anchored at the first pose, <=2 trust-region iterations
(``DCS-ceres/src/layer_manager.cpp:602-654``,
``simple_layer_manager.cpp:567-622``).  The production managers
(``methods/layering.py`` / ``mcts.py``) compute those costs with the jitted
JAX solver instead.  Host==fused is pinned bit-for-bit, but nothing showed
host == what-the-reference-algorithm-would-decide.

This module closes that gap: NumPy twins of BOTH manager loops whose every
candidate evaluation and windowed commit optimisation runs through
``solver.ceres_oracle.ceres_solve`` -- the test-gated Ceres-semantics LM
(stock trust-region bookkeeping, Triggs-corrected Huber, exact sparse
factorization, f64).  They share no solver code with the production
managers; agreement of the decision sequences is therefore evidence.

Replayed procedures (all cited into the reference):

* method 3 -- ``SimpleLayerManager::run`` (``layer_manager.cpp:343-468``):
  dead L_e solve, UCT top-k (``:512-531``), Li cache (``:481-499``),
  per-candidate L_e(k)/L_ij short solves (``:371-385``),
  Delta = L_ij - min(L_i, L_e(k)) conflict split at tau (``:388-425``),
  windowed commit optimisation radius 30 / 1 iter / anchor = first
  in-window node (``:137-179``), EMA residual (``:181-228``, ``:440-447``),
  reward -dcost_rel + 0.1 dH - 0.05 n_lc clipped (``:450-461``).
* method 4 -- ``SimpleLayerManagerV2::run``
  (``simple_layer_manager.cpp:68-130``): UCT select with
  unvisited-first (``:132-171``), Mahalanobis gate at R_high (``:388-455``),
  3-way split check at tau (``:173-211``), expand = child inherits parent
  edges + poses then window-20 optimisation (``:213-291``, ``:500-565``),
  full 2-iter optimisation on assignment (``:457-498``), reward
  -dcost_rel + 1.1 dH - 0.1 n_lc (``:293-339``), parent-chain backprop
  (``:624-641``).

One declared tie-break choice: the reference iterates layers in
``std::unordered_map`` order for the method-4 UCT select
(``simple_layer_manager.cpp:143-168``) -- an *unspecified* order, so
"first unvisited layer" is implementation-defined there.  Both the oracle
and ``mcts.py`` use insertion (creation) order, the only deterministic
reading; divergences behind that tie-break cannot occur between our two
implementations but are possible vs a real libstdc++ run.

Every per-edge decision is recorded as a dict so
``scripts/manager_oracle_check.py`` can diff the stream against the
production managers' logs (``results/manager_oracle.json``).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from slam_tpu.config import LayeringConfig, MctsConfig
from slam_tpu.graph import CLOSURE_EDGE, ODOMETRY_EDGE, PoseGraph
from slam_tpu.solver.ceres_oracle import ceres_solve


# ---------------------------------------------------------------------------
# Short-solve primitives (Ceres semantics, exact sparse factorization)
# ---------------------------------------------------------------------------

def _short_cost(poses, ij, meas, iters, huber_delta) -> float:
    """``evaluate_cost`` / ``evaluate_layer_cost`` semantics: fresh problem
    from copied poses, plain residuals + Huber, anchor pose 0, <=``iters``
    LM iterations, return ``summary.final_cost``
    (``layer_manager.cpp:602-654``; poses are NOT written back)."""
    rep = ceres_solve(
        poses, ij, meas, np.zeros(len(ij), np.int64), method=0,
        huber_delta=huber_delta, max_iterations=max(1, iters))
    return float(rep.final_cost)


def _subgraph_solve(poses, sub_nodes, ij, meas, iters, huber_delta):
    """Windowed in-place optimisation: build the sub-problem over
    ``sub_nodes`` (sorted ascending) with the given (already filtered)
    edges, anchor the FIRST sub-node (= the reference's ``lo`` /
    ``min(used)`` anchor, ``layer_manager.cpp:167-169``,
    ``simple_layer_manager.cpp:550-555``), solve <=``iters`` iterations and
    write the result back into a copy of ``poses``."""
    remap = np.full(poses.shape[0], -1, np.int64)
    remap[sub_nodes] = np.arange(len(sub_nodes))
    rep = ceres_solve(
        poses[sub_nodes], remap[ij], meas, np.zeros(len(ij), np.int64),
        method=0, huber_delta=huber_delta, max_iterations=max(1, iters))
    out = poses.copy()
    out[sub_nodes] = rep.poses
    return out


def _edge_residual_l2(poses, a, b, meas, theta_weight) -> float:
    """``compute_edge_residual_L2`` (``layer_manager.cpp:181-228``)."""
    pa, pb = poses[a], poses[b]
    ca, sa = np.cos(pa[2]), np.sin(pa[2])
    dx, dy = pb[0] - pa[0], pb[1] - pa[1]
    vx = ca * dx + sa * dy - meas[0]
    vy = -sa * dx + ca * dy - meas[1]
    cm, sm = np.cos(meas[2]), np.sin(meas[2])
    ex = cm * vx + sm * vy
    ey = -sm * vx + cm * vy
    et = np.arcsin(np.clip(np.sin(pb[2] - pa[2] - meas[2]), -1.0, 1.0))
    return float(np.sqrt(ex * ex + ey * ey + theta_weight * et * et))


def _info_gain(info6) -> float:
    """0.5 logdet(I + Omega) (``layer_manager.cpp:284-298``)."""
    i = info6
    O = np.array([[i[0], i[1], i[2]], [i[1], i[3], i[4]], [i[2], i[4], i[5]]])
    O = 0.5 * (O + O.T)
    evals = np.clip(np.linalg.eigvalsh(O), 1e-12, None)
    return float(0.5 * np.sum(np.log1p(evals)))


def _wrap(t: float) -> float:
    while t > np.pi:
        t -= 2 * np.pi
    while t < -np.pi:
        t += 2 * np.pi
    return t


# ---------------------------------------------------------------------------
# Method 3 twin
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _M3Layer:
    poses: np.ndarray
    edges: list                      # canonical edge indices (loop edges)
    ema_residual: float = 0.0
    num_edges: int = 0
    visits: float = 0.0
    total_reward: float = 0.0
    success: int = 0


class Method3Oracle:
    """NumPy twin of ``SimpleLayerManager`` driving Ceres-semantics short
    solves.  ``run()`` returns the per-edge decision stream."""

    def __init__(self, graph: PoseGraph, cfg: LayeringConfig | None = None):
        self.g = graph.canonical_order()
        self.cfg = cfg or LayeringConfig()
        et = self.g.edge_type
        self.ij = np.asarray(self.g.edges_ij, np.int64)
        self.meas = np.asarray(self.g.edges_meas, float)
        self.info = np.asarray(self.g.edges_info, float)
        self.odo_idx = np.where(et == ODOMETRY_EDGE)[0]
        self.loop_idx = np.where(et != ODOMETRY_EDGE)[0]
        self.closure_mask = et == CLOSURE_EDGE
        base = np.asarray(self.g.poses, float)
        # Layer 0 = odometry baseline + one working layer
        # (``layer_manager.cpp:33-40``).
        self.layers = [_M3Layer(base.copy(), []), _M3Layer(base.copy(), [])]
        self.Li_cache: dict[int, float] = {}
        self.assignments: list[tuple[int, int]] = []
        self.decisions: list[dict] = []

    # -- solves ------------------------------------------------------------
    def _eval(self, base: int, include_layer_edges: bool,
              extra: list[int], iters: int) -> float:
        lay = self.layers[base]
        loop = (lay.edges if include_layer_edges else []) + extra
        loop = [e for e in loop if self.ij[e, 0] != self.ij[e, 1]]
        sub = np.concatenate([self.odo_idx, np.asarray(loop, np.int64)])
        return _short_cost(lay.poses, self.ij[sub], self.meas[sub],
                           iters, self.cfg.huber_delta)

    def _get_Li(self, k: int) -> float:
        if k not in self.Li_cache:
            self.Li_cache[k] = self._eval(
                k, True, [], max(1, self.cfg.local_iters))
        return self.Li_cache[k]

    # -- UCT ---------------------------------------------------------------
    def _uct(self, k: int) -> float:
        st = self.layers[k]
        q = st.total_reward / (1.0 + st.visits)
        total = 1.0 + sum(l.visits for l in self.layers[1:])
        return q + self.cfg.uct_c * np.sqrt(
            np.log(total) / (1.0 + st.visits))

    def _topk(self) -> list[int]:
        idx = list(range(1, len(self.layers)))
        idx.sort(key=self._uct, reverse=True)      # stable, like stable_sort
        return idx[: self.cfg.uct_top_k]

    # -- windowed commit ---------------------------------------------------
    def _optimize_local(self, k: int, eidx: int) -> None:
        cfg = self.cfg
        a, b = int(self.ij[eidx, 0]), int(self.ij[eidx, 1])
        n = self.g.num_nodes
        lo = max(0, min(a, b) - cfg.commit_window_radius)
        hi = min(n - 1, max(a, b) + cfg.commit_window_radius)
        lay = self.layers[k]
        sub_nodes = np.arange(lo, hi + 1)
        inw = np.zeros(n, bool)
        inw[lo : hi + 1] = True
        cand = np.concatenate(
            [self.odo_idx,
             np.asarray([e for e in lay.edges
                         if self.ij[e, 0] != self.ij[e, 1]], np.int64)])
        keep = cand[inw[self.ij[cand, 0]] & inw[self.ij[cand, 1]]]
        lay.poses = _subgraph_solve(
            lay.poses, sub_nodes, self.ij[keep], self.meas[keep],
            max(1, cfg.commit_local_iters), cfg.huber_delta)

    # -- main loop (``layer_manager.cpp:343-468``) -------------------------
    def run(self) -> list[dict]:
        cfg = self.cfg
        iters = max(1, cfg.local_iters)
        for i, eidx in enumerate(self.loop_idx):
            eidx = int(eidx)
            # L_e on the base layer: computed then never used in the
            # decision -- the reference does exactly this
            # (``layer_manager.cpp:352`` vs ``:394``).  Replayed for
            # faithfulness; costs nothing to correctness.
            L_e = self._eval(0, False, [eidx], iters)

            topk = self._topk()
            uct_scores = [float(self._uct(k)) for k in topk]
            Li_vals = [self._get_Li(k) for k in topk]
            Le_vals = [self._eval(k, False, [eidx], iters) for k in topk]
            Lij_vals = [self._eval(k, True, [eidx], iters) for k in topk]

            best_delta, best_layer, best_Li, best_Lij = 1e100, -1, 0.0, 0.0
            deltas = []
            for t, k in enumerate(topk):
                delta = Lij_vals[t] - min(Li_vals[t], Le_vals[t])
                deltas.append(float(delta))
                if delta < best_delta:
                    best_delta, best_layer = delta, k
                    best_Li, best_Lij = Li_vals[t], Lij_vals[t]

            target = best_layer
            request_split = best_layer < 0 or best_delta > cfg.conflict_tau
            did_split = False
            child = None
            if request_split:
                if len(self.layers) < cfg.max_layers:
                    src = self.layers[best_layer if best_layer >= 1 else 0]
                    self.layers.append(
                        _M3Layer(src.poses.copy(), list(src.edges)))
                    child = len(self.layers) - 1
                    target = best_layer if best_layer >= 1 else child
                    did_split = True
                else:
                    target = best_layer if best_layer >= 1 else 1

            lay = self.layers[target]
            lay.edges.append(eidx)
            self.assignments.append((i, target))

            self._optimize_local(target, eidx)
            self.Li_cache.pop(target, None)

            a, b = int(self.ij[eidx, 0]), int(self.ij[eidx, 1])
            r = _edge_residual_l2(lay.poses, a, b, self.meas[eidx],
                                  cfg.theta_weight)
            lay.ema_residual = ((1 - cfg.ema_alpha) * lay.ema_residual
                                + cfg.ema_alpha * r)
            lay.num_edges += 1

            delta_cost_rel = (best_Lij - best_Li) / (cfg.epsilon + best_Li)
            gain = _info_gain(self.info[eidx])
            n_lc = sum(1 for e in lay.edges if self.closure_mask[e])
            reward = float(np.clip(
                -delta_cost_rel + cfg.alpha_info * gain
                - cfg.beta_sparse * n_lc, -1.0, 1.0))
            success = (not did_split) and best_delta <= cfg.conflict_tau
            lay.visits += 1.0
            lay.total_reward += reward
            lay.success += int(success)

            self.decisions.append(dict(
                edge=i, eidx=eidx, topk=list(topk), uct=uct_scores,
                L_e=float(L_e), Li=[float(v) for v in Li_vals],
                Le_k=[float(v) for v in Le_vals],
                Lij=[float(v) for v in Lij_vals], deltas=deltas,
                best_layer=int(best_layer), best_delta=float(best_delta),
                split=bool(did_split), child=child, target=int(target),
                r_new=float(r), ema=float(lay.ema_residual),
                reward=reward))
        return self.decisions

    def best_layer(self) -> int:
        """min-EMA selection (``layer_manager.cpp:556-562``)."""
        return min(range(1, len(self.layers)),
                   key=lambda k: self.layers[k].ema_residual)


# ---------------------------------------------------------------------------
# Method 4 twin
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _M4Layer:
    id: str
    parent: str
    poses: np.ndarray
    inherited: list
    added: list
    visits: int = 0
    total_reward: float = 0.0

    @property
    def all_edges(self) -> list:
        return self.inherited + self.added


class Method4Oracle:
    """NumPy twin of ``SimpleLayerManagerV2`` on Ceres-semantics solves."""

    def __init__(self, graph: PoseGraph, cfg: MctsConfig | None = None):
        self.g = graph.canonical_order()
        self.cfg = cfg or MctsConfig()
        et = self.g.edge_type
        self.ij = np.asarray(self.g.edges_ij, np.int64)
        self.meas = np.asarray(self.g.edges_meas, float)
        self.info = np.asarray(self.g.edges_info, float)
        self.odo_idx = np.where(et == ODOMETRY_EDGE)[0]
        self.loop_idx = np.where(et != ODOMETRY_EDGE)[0]
        self.closure_mask = et == CLOSURE_EDGE
        base = np.asarray(self.g.poses, float)
        self._counter = 0
        root = _M4Layer(self._gen_id(), "", base.copy(), [], [])
        self.root_id = root.id
        self.layers: dict[str, _M4Layer] = {root.id: root}
        self.assignments: list[tuple[int, str]] = []
        self.decisions: list[dict] = []

    def _gen_id(self) -> str:
        self._counter += 1
        return f"L{self._counter}"

    # -- solves ------------------------------------------------------------
    def _layer_cost(self, lay: _M4Layer, edges: list) -> float:
        loop = [e for e in edges if self.ij[e, 0] != self.ij[e, 1]]
        sub = np.concatenate([self.odo_idx, np.asarray(loop, np.int64)])
        # ``evaluate_layer_cost`` is always 1 iteration
        # (``simple_layer_manager.cpp:606``).
        return _short_cost(lay.poses, self.ij[sub], self.meas[sub], 1,
                           self.cfg.huber_delta)

    def _optimize_layer(self, lay: _M4Layer) -> None:
        loop = [e for e in lay.all_edges
                if self.ij[e, 0] != self.ij[e, 1]]
        sub = np.concatenate([self.odo_idx, np.asarray(loop, np.int64)])
        rep = ceres_solve(
            lay.poses, self.ij[sub], self.meas[sub],
            np.zeros(len(sub), np.int64), method=0,
            huber_delta=self.cfg.huber_delta,
            max_iterations=max(1, self.cfg.local_iters))
        lay.poses = rep.poses

    def _optimize_local_window(self, lay: _M4Layer, window: int) -> None:
        if not lay.added:
            return
        n = self.g.num_nodes
        radius = max(1, window // 2)
        active = np.zeros(n, bool)
        for e in lay.added:
            for endpoint in self.ij[e]:
                active[max(0, int(endpoint) - radius):
                       min(n - 1, int(endpoint) + radius) + 1] = True
        odo_in = self.odo_idx[
            active[self.ij[self.odo_idx, 0]]
            & active[self.ij[self.odo_idx, 1]]]
        added = np.asarray(
            [e for e in lay.added if self.ij[e, 0] != self.ij[e, 1]],
            np.int64)
        keep = np.concatenate([odo_in, added])
        if keep.size == 0:
            return
        used = np.unique(self.ij[keep].ravel())
        # anchor = node 0 if used else smallest used = min(used): the
        # first node after the remap either way
        # (``simple_layer_manager.cpp:550-555``).
        lay.poses = _subgraph_solve(
            lay.poses, used, self.ij[keep], self.meas[keep],
            max(1, self.cfg.local_iters), self.cfg.huber_delta)

    # -- UCT (``simple_layer_manager.cpp:132-171``) ------------------------
    def _select(self) -> str:
        if len(self.layers) == 1:
            return self.root_id
        total = max(1, sum(l.visits for l in self.layers.values()))
        best_id, best_val = self.root_id, -1e9
        for lid, lay in self.layers.items():     # insertion order (see
            if lay.visits == 0:                  # module docstring)
                return lid
            val = lay.total_reward / lay.visits + (
                self.cfg.exploration_c
                * np.sqrt(np.log(total) / lay.visits))
            if val > best_val:
                best_val, best_id = val, lid
        return best_id

    def _mahalanobis(self, lay: _M4Layer, eidx: int) -> float:
        """``calculate_edge_residual`` (``simple_layer_manager.cpp:388-442``):
        exact rotation, wrapped (not asin-folded) angle, sqrt form."""
        a, b = int(self.ij[eidx, 0]), int(self.ij[eidx, 1])
        pa, pb = lay.poses[a], lay.poses[b]
        dx, dy = pb[0] - pa[0], pb[1] - pa[1]
        ca, sa = np.cos(pa[2]), np.sin(pa[2])
        rel_x = ca * dx + sa * dy
        rel_y = -sa * dx + ca * dy
        dtheta = _wrap(pb[2] - pa[2])
        m = self.meas[eidx]
        r = np.array([rel_x - m[0], rel_y - m[1], _wrap(dtheta - m[2])])
        i = self.info[eidx]
        O = np.array([[i[0], i[1], i[2]], [i[1], i[3], i[4]],
                      [i[2], i[4], i[5]]])
        return float(np.sqrt(max(0.0, r @ O @ r)))

    # -- reward ------------------------------------------------------------
    def _reward(self, lay: _M4Layer, eidx: int) -> tuple[float, dict]:
        base = lay.inherited
        Li = self._layer_cost(lay, base + lay.added)
        without = [e for e in lay.added if e != eidx]
        Li_prev = self._layer_cost(lay, base + without)
        delta_rel = (Li - Li_prev) / (self.cfg.epsilon + Li_prev)
        gain = _info_gain(self.info[eidx])
        n_closure = sum(1 for e in lay.all_edges if self.closure_mask[e])
        if self.closure_mask[eidx]:
            n_closure += 1   # reference double-count (``:367-386``)
        reward = float(np.clip(
            -delta_rel + self.cfg.alpha_info * gain
            - self.cfg.beta_sparse * n_closure, -1.0, 1.0))
        return reward, dict(Li=float(Li), Li_prev=float(Li_prev),
                            delta_cost_rel=float(delta_rel),
                            info_gain=float(gain), n_closure=int(n_closure))

    def _backprop(self, lid: str, reward: float) -> None:
        cur = lid
        while cur:
            lay = self.layers.get(cur)
            if lay is None:
                break
            lay.visits += 1
            lay.total_reward += reward
            cur = lay.parent

    # -- main loop (``simple_layer_manager.cpp:68-130``) -------------------
    def run(self) -> list[dict]:
        cfg = self.cfg
        for step, eidx in enumerate(self.loop_idx):
            eidx = int(eidx)
            selected = self._select()
            lay = self.layers[selected]
            residual = self._mahalanobis(lay, eidx)
            dec = dict(edge=step, eidx=eidx, selected=selected,
                       residual=float(residual))
            if residual >= cfg.residual_high:
                dec["action"] = "skip"
                self.decisions.append(dec)
                continue

            split = False
            if len(self.layers) < cfg.max_layers and lay.added:
                cost_current = self._layer_cost(
                    lay, lay.inherited + lay.added)
                cost_new_only = self._layer_cost(lay, lay.inherited + [eidx])
                cost_combined = self._layer_cost(
                    lay, lay.inherited + lay.added + [eidx])
                split_value = cost_combined - min(cost_current,
                                                  cost_new_only)
                split = split_value > cfg.conflict_tau
                dec.update(cost_current=float(cost_current),
                           cost_new_only=float(cost_new_only),
                           cost_combined=float(cost_combined),
                           split_value=float(split_value))

            if split:
                child = _M4Layer(self._gen_id(), selected,
                                 lay.poses.copy(), list(lay.all_edges),
                                 [eidx])
                self.layers[child.id] = child
                self.assignments.append((eidx, child.id))
                self._optimize_local_window(child, cfg.local_window)
                reward, rinfo = self._reward(child, eidx)
                self._backprop(child.id, reward)
                dec.update(action="expand", child=child.id, reward=reward,
                           **rinfo)
            else:
                lay.added.append(eidx)
                self.assignments.append((eidx, selected))
                self._optimize_layer(lay)
                reward, rinfo = self._reward(lay, eidx)
                self._backprop(selected, reward)
                dec.update(action="assign", reward=reward, **rinfo)
            self.decisions.append(dec)
        return self.decisions

    def best_layer(self) -> str:
        """normalized-reward selection (``simple_layer_manager.cpp:649-668``)."""
        best, best_val = self.root_id, -1e9
        for lid, lay in self.layers.items():
            if lay.visits > 0:
                v = lay.total_reward / np.sqrt(1.0 + len(lay.all_edges))
                if v > best_val:
                    best_val, best = v, lid
        return best

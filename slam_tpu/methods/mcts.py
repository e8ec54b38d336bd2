"""Method 4: MCTS layer tree (SimpleLayerManagerV2).

Behavioral port of ``DCS-ceres/src/simple_layer_manager.cpp``:
a tree of pose-replica layers explored with UCT; per candidate edge --
select layer by UCT, Mahalanobis-gate the edge, decide split via a 3-way
cost comparison, expand (child inherits parent edges + poses) or assign,
locally/fully optimise, reward r = -dcost_rel + alpha*dH - beta*n_lc, and
backpropagate up the parent chain.

The accelerator re-architecture mirrors method 3 (see ``layering.py``): layers are pose
arrays + edge masks; every ``evaluate_layer_cost`` group (the split check's 3
solves, the reward's 2 solves) is one batched vmapped device call instead of
serial fresh Ceres problems.
"""

from __future__ import annotations

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np

from slam_tpu.config import MctsConfig, RunConfig, SolverConfig
from slam_tpu.graph import CLOSURE_EDGE, ODOMETRY_EDGE, PoseGraph
from slam_tpu.io import g2o
from slam_tpu.methods import batched
from slam_tpu.solver.problem import anchor_first_node, edge_set_from_graph
from slam_tpu.utils.logging import RunLogger


@dataclasses.dataclass
class _TreeLayer:
    id: str
    parent: str              # "" for root
    poses: np.ndarray        # (N, 3)
    inherited: np.ndarray    # (E,) bool
    added: np.ndarray        # (E,) bool
    visits: int = 0
    total_reward: float = 0.0
    children: list = dataclasses.field(default_factory=list)

    @property
    def all_edges(self) -> np.ndarray:
        return self.inherited | self.added


@dataclasses.dataclass
class MctsOutput:
    poses: np.ndarray
    layers: dict
    assignments: list
    best_layer: str
    most_visited_layer: str
    most_edges_layer: str


class MctsManager:
    def __init__(
        self,
        graph: PoseGraph,
        cfg: MctsConfig,
        solver: SolverConfig | None = None,
        logger: RunLogger | None = None,
    ):
        self.graph = graph.canonical_order()
        self.cfg = cfg
        self.log = logger or RunLogger()

        solver = solver or SolverConfig()
        linear = solver.linear_solver
        if linear in ("auto", "schur"):
            # See layering.py: PCG on accelerators, dense on CPU for small
            # graphs.
            import jax as _jax
            if _jax.default_backend() != "cpu":
                linear = "pcg"
            else:
                linear = "dense" if graph.num_nodes <= 2048 else "pcg"
        extra = {}
        if linear == "pcg":
            extra = dict(pcg_rtol=cfg.eval_pcg_rtol,
                         pcg_max_iters=cfg.eval_pcg_max_iters)
        self.eval_cfg = solver.replace(
            robust="none", huber_delta=cfg.huber_delta,
            linear_solver=linear,
            trust_region=cfg.eval_trust_region, **extra,
        )
        self.dtype = jnp.dtype(self.eval_cfg.dtype)
        self.edges = edge_set_from_graph(self.graph, dtype=self.dtype)
        self.E = self.edges.num_edges
        et = self.graph.edge_type
        self.odo_mask = et == ODOMETRY_EDGE
        self.loop_indices = np.where(et != ODOMETRY_EDGE)[0]
        self.ij = self.graph.edges_ij
        self.meas = self.graph.edges_meas
        self.info = self.graph.edges_info
        self.free_all = anchor_first_node(self.graph.num_nodes, self.dtype)

        self._id_counter = 0
        base = np.asarray(self.graph.poses, float)
        root = _TreeLayer(
            id=self._gen_id(), parent="",
            poses=base.copy(),
            inherited=np.zeros(self.E, bool),
            added=np.zeros(self.E, bool),
        )
        self.root_id = root.id
        self.layers: dict[str, _TreeLayer] = {root.id: root}
        self.assignments: list[tuple[int, str]] = []
        self.step = 0

        self.log.log("init", msg="MCTS layer manager (method 4)",
                     candidates=len(self.loop_indices),
                     max_layers=cfg.max_layers)

    def _gen_id(self) -> str:
        self._id_counter += 1
        return f"L{self._id_counter}"

    # -- UCT selection (``simple_layer_manager.cpp:132-171``) --------------
    def _select_layer(self) -> str:
        if len(self.layers) == 1:
            return self.root_id
        total = max(1, sum(l.visits for l in self.layers.values()))
        best_id, best_val = self.root_id, -1e9
        for lid, lay in self.layers.items():
            if lay.visits == 0:
                return lid  # unvisited layers first
            val = lay.total_reward / lay.visits + (
                self.cfg.exploration_c
                * np.sqrt(np.log(total) / lay.visits)
            )
            if val > best_val:
                best_val, best_id = val, lid
        return best_id

    # -- residual gate (``simple_layer_manager.cpp:388-442``) --------------
    def _edge_mahalanobis(self, lid: str, eidx: int) -> float:
        lay = self.layers[lid]
        a, b = int(self.ij[eidx, 0]), int(self.ij[eidx, 1])
        pa, pb = lay.poses[a], lay.poses[b]
        # The reference computes the relative pose with the small-angle-free
        # exact rotation but wraps the angle (not asin-fold) -- reproduce.
        dx, dy = pb[0] - pa[0], pb[1] - pa[1]
        ca, sa = np.cos(pa[2]), np.sin(pa[2])
        rel_x = ca * dx + sa * dy
        rel_y = -sa * dx + ca * dy
        dtheta = _wrap(pb[2] - pa[2])
        m = self.meas[eidx]
        r = np.array([rel_x - m[0], rel_y - m[1], _wrap(dtheta - m[2])])
        i = self.info[eidx]
        O = np.array([[i[0], i[1], i[2]], [i[1], i[3], i[4]], [i[2], i[4], i[5]]])
        return float(np.sqrt(max(0.0, r @ O @ r)))

    # -- batched layer-cost evaluation ------------------------------------
    def _eval_costs(self, specs) -> np.ndarray:
        """Evaluate 1-iteration solve costs for (poses, mask) specs in one
        padded batched call (``evaluate_layer_cost`` semantics)."""
        B = 3  # fixed batch width (split check = 3; reward = 2, padded)
        specs = list(specs)
        pad = B - len(specs)
        pb = np.stack([s[0] for s in specs] + [specs[0][0]] * pad)
        ab = np.stack([s[1] for s in specs] + [specs[0][1]] * pad)
        costs = batched.batched_eval_cost(
            jnp.asarray(pb, self.dtype),
            jnp.asarray(ab.astype(np.float64), self.dtype),
            self.edges, self.free_all, self.eval_cfg, 1,
        )
        return np.asarray(jax.device_get(costs))[: len(specs)]

    # -- optimisations -----------------------------------------------------
    def _optimize_layer(self, lid: str) -> None:
        """Full-problem short solve (``simple_layer_manager.cpp:457-498``)."""
        lay = self.layers[lid]
        active = self.odo_mask | lay.all_edges
        poses, _ = batched.masked_solve(
            jnp.asarray(lay.poses, self.dtype),
            jnp.asarray(active.astype(np.float64), self.dtype),
            self.free_all.node,
            self.edges, self.eval_cfg, max(1, self.cfg.local_iters),
        )
        lay.poses = np.asarray(jax.device_get(poses), float)

    def _optimize_local_window(self, lid: str, window: int) -> None:
        """Window solve around added edges
        (``simple_layer_manager.cpp:500-565``)."""
        lay = self.layers[lid]
        added = np.where(lay.added)[0]
        if added.size == 0:
            return
        n = self.graph.num_nodes
        radius = max(1, window // 2)
        active_nodes = np.zeros(n, bool)
        for e in added:
            for endpoint in self.ij[e]:
                lo = max(0, int(endpoint) - radius)
                hi = min(n - 1, int(endpoint) + radius)
                active_nodes[lo : hi + 1] = True

        odo_in = self.odo_mask & (
            active_nodes[self.ij[:, 0]] & active_nodes[self.ij[:, 1]]
        )
        edge_active = odo_in | lay.added
        used = np.zeros(n, bool)
        used[self.ij[edge_active][:, 0]] = True
        used[self.ij[edge_active][:, 1]] = True
        if not used.any():
            return
        anchor = 0 if used[0] else int(np.argmax(used))
        free = used.astype(np.float64)
        free[anchor] = 0.0

        poses, _ = batched.masked_solve(
            jnp.asarray(lay.poses, self.dtype),
            jnp.asarray(edge_active.astype(np.float64), self.dtype),
            jnp.asarray(free, self.dtype),
            self.edges, self.eval_cfg, max(1, self.cfg.local_iters),
        )
        lay.poses = np.asarray(jax.device_get(poses), float)

    # -- split / expand ----------------------------------------------------
    def _should_split(self, lid: str, eidx: int) -> bool:
        lay = self.layers[lid]
        if not lay.added.any():
            return False
        new = np.zeros(self.E, bool)
        new[eidx] = True
        base = self.odo_mask | lay.inherited
        cost_current, cost_new_only, cost_combined = self._eval_costs([
            (lay.poses, base | lay.added),
            (lay.poses, base | new),
            (lay.poses, base | lay.added | new),
        ])
        split_value = cost_combined - min(cost_current, cost_new_only)
        should = split_value > self.cfg.conflict_tau
        self.log.log("split_check", layer=lid, cost_current=cost_current,
                     cost_new_only=cost_new_only, cost_combined=cost_combined,
                     should_split=should, split_value=split_value)
        return bool(should)

    def _expand(self, parent_id: str, eidx: int) -> None:
        parent = self.layers[parent_id]
        child = _TreeLayer(
            id=self._gen_id(), parent=parent_id,
            poses=parent.poses.copy(),
            inherited=parent.all_edges.copy(),
            added=np.zeros(self.E, bool),
        )
        child.added[eidx] = True
        self.layers[child.id] = child
        parent.children.append(child.id)
        self.assignments.append((eidx, child.id))
        self._optimize_local_window(child.id, self.cfg.local_window)
        reward = self._calculate_reward(child.id, eidx)
        self._backpropagate(child.id, reward)
        self.log.log("expand", created=child.id, parent=parent_id,
                     reward=reward)

    # -- reward (``simple_layer_manager.cpp:293-339``) ---------------------
    def _calculate_reward(self, lid: str, eidx: int) -> float:
        lay = self.layers[lid]
        base = self.odo_mask | lay.inherited
        without = lay.added.copy()
        without[eidx] = False
        Li, Li_prev = self._eval_costs([
            (lay.poses, base | lay.added),
            (lay.poses, base | without),
        ])
        delta_cost_rel = (Li - Li_prev) / (self.cfg.epsilon + Li_prev)
        info_gain = _info_gain_np(self.info[eidx])
        # Reference double-counts the new closure (already in added_edges
        # when counted, plus the additional_edge bump,
        # ``simple_layer_manager.cpp:367-386``) -- reproduced faithfully.
        n_closure = int(
            np.sum(lay.all_edges & (self.graph.edge_type == CLOSURE_EDGE))
        )
        if self.graph.edge_type[eidx] == CLOSURE_EDGE:
            n_closure += 1
        reward = float(np.clip(
            -delta_cost_rel + self.cfg.alpha_info * info_gain
            - self.cfg.beta_sparse * n_closure,
            -1.0, 1.0,
        ))
        self.log.log("reward", layer=lid, delta_cost_rel=float(delta_cost_rel),
                     info_gain=info_gain, n_closure=n_closure,
                     final_reward=reward)
        return reward

    def _backpropagate(self, lid: str, reward: float) -> None:
        cur = lid
        while cur:
            lay = self.layers.get(cur)
            if lay is None:
                break
            lay.visits += 1
            lay.total_reward += reward
            self.log.log("backprop", layer=cur, visits=lay.visits,
                         total_reward=lay.total_reward)
            cur = lay.parent

    # -- main loop (``simple_layer_manager.cpp:68-130``) -------------------
    def run(self) -> MctsOutput:
        for eidx in self.loop_indices:
            self.step += 1
            eidx = int(eidx)
            a, b = int(self.ij[eidx, 0]), int(self.ij[eidx, 1])
            self.log.log(f"step {self.step}",
                         msg=f"edge ({a},{b}) type={int(self.graph.edge_type[eidx])}")

            selected = self._select_layer()
            residual = self._edge_mahalanobis(selected, eidx)
            self.log.log("residual", edge_residual=residual,
                         low=self.cfg.residual_low, high=self.cfg.residual_high)
            if residual >= self.cfg.residual_high:
                self.log.log("skip", msg="edge residual too high")
                continue

            if (
                len(self.layers) < self.cfg.max_layers
                and self._should_split(selected, eidx)
            ):
                self._expand(selected, eidx)
            else:
                lay = self.layers[selected]
                lay.added[eidx] = True
                self.assignments.append((eidx, selected))
                self._optimize_layer(selected)
                reward = self._calculate_reward(selected, eidx)
                self._backpropagate(selected, reward)
                self.log.log("assign", layer=selected, reward=reward)

        return self._finish()

    # -- result selection (``simple_layer_manager.cpp:643-703``) -----------
    def _normalized(self, lay: _TreeLayer) -> float:
        return lay.total_reward / np.sqrt(1.0 + int(lay.all_edges.sum()))

    def _finish(self) -> MctsOutput:
        best = self.root_id
        best_val = -1e9
        for lid, lay in self.layers.items():
            if lay.visits > 0 and self._normalized(lay) > best_val:
                best_val, best = self._normalized(lay), lid
        most_visited = max(self.layers.values(), key=lambda l: l.visits).id
        most_edges = max(
            self.layers.values(), key=lambda l: int(l.all_edges.sum())
        ).id
        self.log.log("summary", msg="===== METHOD 4 SUMMARY =====",
                     total_layers=len(self.layers), best=best,
                     most_visited=most_visited, most_edges=most_edges)
        return MctsOutput(
            poses=self.layers[best].poses,
            layers=self.layers,
            assignments=self.assignments,
            best_layer=best,
            most_visited_layer=most_visited,
            most_edges_layer=most_edges,
        )


def make_manager(graph, cfg: RunConfig, logger, fused: str = "auto",
                 checkpoint: str | None = None):
    """Pick the method-4 engine (see ``layering.make_manager``): host loop
    on CPU, fused single-program scan on accelerators.  Identical decisions
    (``test_fused_mcts_matches_host``)."""
    use_fused = (fused == "on") or (
        fused == "auto" and jax.default_backend() != "cpu"
    ) or (checkpoint is not None)
    if use_fused:
        from slam_tpu.methods.mcts_fused import FusedMctsManager
        return FusedMctsManager(graph, cfg.mcts, cfg.solver, logger,
                                checkpoint_path=checkpoint)
    return MctsManager(graph, cfg.mcts, cfg.solver, logger)


def run_from_config(cfg: RunConfig, fused: str = "auto",
                    checkpoint: str | None = None) -> MctsOutput:
    """Reference-equivalent method-4 pipeline with ``save/`` artifacts
    (``simple_layer_manager.cpp:705-787``)."""
    os.makedirs(cfg.save_path, exist_ok=True)
    logger = RunLogger(os.path.join(cfg.save_path, "method4.log"))
    graph = g2o.load_g2o(g2o.find_dataset(cfg.dataset))
    graph = graph.add_random_outliers(cfg.num_outliers, seed=cfg.seed)
    from slam_tpu.solver.init import apply_init
    graph = apply_init(graph, cfg, logger)

    g2o.write_nodes(os.path.join(cfg.save_path, "init_nodes.txt"), graph.poses)
    g2o.write_edges(os.path.join(cfg.save_path, "init_edges.txt"), graph)

    mgr = make_manager(graph, cfg, logger, fused, checkpoint)
    out = mgr.run()

    g2o.write_nodes(os.path.join(cfg.save_path, "opt_nodes.txt"), out.poses)
    g2o.write_nodes(
        os.path.join(cfg.save_path, "opt_nodes_most_visited.txt"),
        out.layers[out.most_visited_layer].poses,
    )
    g2o.write_nodes(
        os.path.join(cfg.save_path, "opt_nodes_most_edges.txt"),
        out.layers[out.most_edges_layer].poses,
    )

    # method4_stats.txt with the reference's exact header
    # (``simple_layer_manager.cpp:766``).
    with open(os.path.join(cfg.save_path, "method4_stats.txt"), "w") as f:
        f.write(
            "# layer_id visits total_reward avg_reward normalized_reward "
            "total_edges inherited_edges added_edges\n"
        )
        for lid, lay in out.layers.items():
            avg = lay.total_reward / lay.visits if lay.visits else 0.0
            norm = lay.total_reward / np.sqrt(1.0 + int(lay.all_edges.sum()))
            f.write(
                f"{lid} {lay.visits} {lay.total_reward} {avg} {norm} "
                f"{int(lay.all_edges.sum())} {int(lay.inherited.sum())} "
                f"{int(lay.added.sum())}\n"
            )

    from slam_tpu.viz import plot
    plot.plot_method4_dashboard(cfg.save_path)
    logger.close()
    return out


def _wrap(t: float) -> float:
    while t > np.pi:
        t -= 2 * np.pi
    while t < -np.pi:
        t += 2 * np.pi
    return t


def _info_gain_np(info6) -> float:
    i = info6
    O = np.array([[i[0], i[1], i[2]], [i[1], i[3], i[4]], [i[2], i[4], i[5]]])
    O = 0.5 * (O + O.T)
    evals = np.clip(np.linalg.eigvalsh(O), 1e-12, None)
    return float(0.5 * np.sum(np.log1p(evals)))

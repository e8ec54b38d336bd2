"""Method 3: probabilistic layering with UCT selection (SimpleLayerManager).

Behavioral port of ``DCS-ceres/src/layer_manager.cpp`` --
same decision procedure, same logged quantities, same outputs -- with the
compute re-architected for accelerators:

* Layers are pose *batches* plus boolean edge masks over the canonical edge
  arrays; "building a Ceres problem per candidate" becomes flipping mask
  bits (zero recompilation).
* The per-edge candidate evaluations (L_e, L_i, L_e(k), L_ij for the top-k
  UCT layers; ``layer_manager.cpp:352-385``) are fused into ONE batched
  vmapped short-LM device call, replacing the reference's ``std::async``
  thread fan-out.
* Windowed commit optimisation (``optimize_layer_local``, radius 30, 1 iter,
  anchor = first in-window node; ``layer_manager.cpp:137-179``) is a masked
  solve with a restricted free mask.

The sequential decision loop itself (UCT bookkeeping, split logic, EMA) is
host-side NumPy -- it is O(closures * k) scalar work.
"""

from __future__ import annotations

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np

from slam_tpu.config import LayeringConfig, RunConfig, SolverConfig
from slam_tpu.graph import CLOSURE_EDGE, ODOMETRY_EDGE, PoseGraph
from slam_tpu.io import g2o
from slam_tpu.methods import batched
from slam_tpu.solver.problem import edge_set_from_graph
from slam_tpu.utils.logging import RunLogger


@dataclasses.dataclass
class _Layer:
    poses: np.ndarray        # (N, 3)
    mask: np.ndarray         # (E,) bool -- loop edges assigned to this layer
    ema_residual: float = 0.0
    num_edges: int = 0
    visits: float = 0.0
    total_reward: float = 0.0
    success: int = 0
    last_step: int = 0


@dataclasses.dataclass
class LayeringOutput:
    poses: np.ndarray              # best layer's poses
    layers: list                   # final layer states
    assignments: list              # (edge_idx, layer_idx)
    best_layer: int
    most_selected_layer: int


def _edge_residual_np(poses, a, b, meas, theta_weight=1.0) -> float:
    """Host-side scalar L2 edge residual (``layer_manager.cpp:181-228``)."""
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


def _info_gain_np(info6) -> float:
    """0.5 * logdet(I + Omega) (``layer_manager.cpp:284-298``)."""
    i = info6
    O = np.array(
        [[i[0], i[1], i[2]], [i[1], i[3], i[4]], [i[2], i[4], i[5]]]
    )
    O = 0.5 * (O + O.T)
    evals = np.clip(np.linalg.eigvalsh(O), 1e-12, None)
    return float(0.5 * np.sum(np.log1p(evals)))


class LayeringManager:
    """Sequential probabilistic layering (see module docstring)."""

    def __init__(
        self,
        graph: PoseGraph,
        cfg: LayeringConfig,
        solver: SolverConfig | None = None,
        logger: RunLogger | None = None,
    ):
        self.graph = graph.canonical_order()
        self.cfg = cfg
        self.log = logger or RunLogger()
        n = self.graph.num_nodes

        solver = solver or SolverConfig()
        # Layer evaluation solves are plain (OdometryResidue for every edge,
        # Huber only -- ``layer_manager.cpp:114-122``).
        linear = solver.linear_solver
        if linear in ("auto", "schur"):
            # The masked sub-problems keep full static shape.  On
            # accelerators the batched short solves use tridiag-
            # preconditioned PCG (the reference's own inner solves are 1-2
            # *inexact* Ceres iterations anyway); whether vmapped dense
            # beats it on the GPU is unmeasured (ROADMAP D1).  On CPU
            # (tests), dense keeps small-graph evaluations exact.
            import jax as _jax
            if _jax.default_backend() != "cpu":
                linear = "pcg"
            else:
                linear = "dense" if self.graph.num_nodes <= 2048 else "pcg"
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
        self.edge_info = self.graph.edges_info
        self.ij = self.graph.edges_ij
        self.meas = self.graph.edges_meas

        # Layer 0: odometry baseline poses (``layer_manager.cpp:33-37``);
        # one initial working layer (``layer_manager.cpp:40``).
        base = np.asarray(self.graph.poses, float)
        self.layers: list[_Layer] = [
            _Layer(poses=base.copy(), mask=np.zeros(self.E, bool)),
            _Layer(poses=base.copy(), mask=np.zeros(self.E, bool)),
        ]
        self.Li_cache: dict[int, float] = {}
        self.assignments: list[tuple[int, int]] = []
        self.step = 0

        self.log.log("init", layers=len(self.layers),
                     candidates=len(self.loop_indices))

    # -- UCT ---------------------------------------------------------------
    def _uct_score(self, k: int) -> float:
        st = self.layers[k]
        q = st.total_reward / (1.0 + st.visits)
        total = 1.0 + sum(l.visits for l in self.layers[1:])
        u = self.cfg.uct_c * np.sqrt(np.log(total) / (1.0 + st.visits))
        return q + u

    def _pick_topk(self) -> list[int]:
        idx = list(range(1, len(self.layers)))
        idx.sort(key=self._uct_score, reverse=True)
        return idx[: self.cfg.uct_top_k]

    # -- batched cost evaluation ------------------------------------------
    #: Fixed device-batch width for candidate evaluations: one compiled
    #: program is reused for every chunk.  Kept small to bound the vmapped
    #: solver program's compile time; not yet re-measured on the GPU.
    EVAL_CHUNK = 4

    def _eval_costs(self, specs) -> np.ndarray:
        """specs: list of (poses(N,3), active(E,) bool).  Evaluated in
        fixed-width padded chunks -- one compiled program total."""
        specs = list(specs)
        out = []
        C = self.EVAL_CHUNK
        for i in range(0, len(specs), C):
            chunk = specs[i : i + C]
            pad = C - len(chunk)
            pb = np.stack([s[0] for s in chunk] + [chunk[0][0]] * pad)
            ab = np.stack([s[1] for s in chunk] + [chunk[0][1]] * pad)
            costs = batched.batched_eval_cost(
                jnp.asarray(pb, self.dtype),
                jnp.asarray(ab.astype(np.float64), self.dtype),
                self.edges,
                _free_first(self.graph.num_nodes, self.dtype),
                self.eval_cfg,
                max(1, self.cfg.local_iters),
            )
            out.append(np.asarray(jax.device_get(costs))[: len(chunk)])
        return np.concatenate(out)

    def _get_Li(self, k: int) -> float | None:
        return self.Li_cache.get(k)

    # -- layer ops ---------------------------------------------------------
    def _create_layer_from(self, base: int) -> int | None:
        if len(self.layers) >= self.cfg.max_layers:
            return None
        src = self.layers[base]
        self.layers.append(
            _Layer(poses=src.poses.copy(), mask=src.mask.copy())
        )
        self.log.log("layer", created=len(self.layers) - 1, parent=base)
        return len(self.layers) - 1

    def _optimize_local(self, k: int, eidx: int) -> None:
        """Window-local commit optimisation (``layer_manager.cpp:137-179``)."""
        a, b = int(self.ij[eidx, 0]), int(self.ij[eidx, 1])
        n = self.graph.num_nodes
        lo = max(0, min(a, b) - self.cfg.commit_window_radius)
        hi = min(n - 1, max(a, b) + self.cfg.commit_window_radius)
        in_window = np.zeros(n, bool)
        in_window[lo : hi + 1] = True

        lay = self.layers[k]
        edge_active = (self.odo_mask | lay.mask) & (
            in_window[self.ij[:, 0]] & in_window[self.ij[:, 1]]
        )
        free = in_window.astype(np.float64)
        free[lo] = 0.0  # anchor = first in-window node (:167-169)

        poses, _ = batched.masked_solve(
            jnp.asarray(lay.poses, self.dtype),
            jnp.asarray(edge_active.astype(np.float64), self.dtype),
            jnp.asarray(free, self.dtype),
            self.edges,
            self.eval_cfg,
            max(1, self.cfg.commit_local_iters),
        )
        lay.poses = np.asarray(jax.device_get(poses), float)

    # -- main loop ---------------------------------------------------------
    def run(self) -> LayeringOutput:
        cfg = self.cfg
        for i, eidx in enumerate(self.loop_indices):
            self.step += 1
            eidx = int(eidx)
            extra = np.zeros(self.E, bool)
            extra[eidx] = True

            topk = self._pick_topk()
            self.log.log(
                "uct",
                topk=",".join(
                    f"L{k}({self._uct_score(k):.4f})" for k in topk
                ),
            )

            # Build one batch: [L_e(base 0)] + [L_i(k) misses] + [L_e(k)] +
            # [L_ij(k)].
            specs = [(self.layers[0].poses, self.odo_mask | extra)]
            li_miss = [k for k in topk if self._get_Li(k) is None]
            for k in li_miss:
                specs.append(
                    (self.layers[k].poses, self.odo_mask | self.layers[k].mask)
                )
            for k in topk:
                specs.append((self.layers[k].poses, self.odo_mask | extra))
            for k in topk:
                specs.append(
                    (
                        self.layers[k].poses,
                        self.odo_mask | self.layers[k].mask | extra,
                    )
                )
            costs = self._eval_costs(specs)

            pos = 1
            for k in li_miss:
                self.Li_cache[k] = float(costs[pos])
                pos += 1
            Le_k = {k: float(costs[pos + t]) for t, k in enumerate(topk)}
            pos += len(topk)
            Lij = {k: float(costs[pos + t]) for t, k in enumerate(topk)}

            best_delta, best_layer, best_Li, best_Lij = 1e100, -1, 0.0, 0.0
            for k in topk:
                L_i = self.Li_cache[k]
                delta = Lij[k] - min(L_i, Le_k[k])
                self.log.log(
                    "conflict", edge_idx=i, try_layer=k, L_i=L_i,
                    L_e_k=Le_k[k], L_ij=Lij[k], Delta=delta,
                )
                if delta < best_delta:
                    best_delta, best_layer = delta, k
                    best_Li, best_Lij = L_i, Lij[k]

            target = best_layer
            request_split = best_layer < 0 or best_delta > cfg.conflict_tau
            did_split = False
            if request_split:
                created = (
                    self._create_layer_from(best_layer)
                    if best_layer >= 1
                    else self._create_layer_from(0)
                )
                if created is not None:
                    # Child cloned; the edge goes to the *parent*
                    # (``layer_manager.cpp:407-418``).
                    target = best_layer if best_layer >= 1 else created
                    did_split = True
                    self.log.log("split", edge_idx=i, Delta=best_delta,
                                 child_layer=created,
                                 parent_assigned_layer=target)
                else:
                    target = best_layer if best_layer >= 1 else 1
                    self.log.log("split-fallback", edge_idx=i,
                                 Delta=best_delta, fallback_layer=target)

            a, b = int(self.ij[eidx, 0]), int(self.ij[eidx, 1])
            self.log.log("assign", edge_idx=i, a=a, b=b,
                         type=int(self.graph.edge_type[eidx]),
                         to_layer=target)
            self.layers[target].mask[eidx] = True
            self.assignments.append((i, target))

            ema_prev = self.layers[target].ema_residual
            self._optimize_local(target, eidx)
            self.Li_cache.pop(target, None)

            r = _edge_residual_np(
                self.layers[target].poses, a, b, self.meas[eidx],
                cfg.theta_weight,
            )
            lay = self.layers[target]
            lay.ema_residual = (1 - cfg.ema_alpha) * lay.ema_residual + cfg.ema_alpha * r
            lay.num_edges += 1
            self.log.log("residual", layer=target, r_new=r,
                         ema_prev=ema_prev, ema_now=lay.ema_residual)

            # Reward shaping (``layer_manager.cpp:450-461``).
            delta_cost_rel = (best_Lij - best_Li) / (cfg.epsilon + best_Li)
            info_gain = _info_gain_np(self.edge_info[eidx])
            n_lc = int(
                np.sum(
                    lay.mask
                    & (self.graph.edge_type == CLOSURE_EDGE)
                )
            )
            reward = float(
                np.clip(
                    -delta_cost_rel + cfg.alpha_info * info_gain
                    - cfg.beta_sparse * n_lc,
                    -1.0, 1.0,
                )
            )
            success = (not did_split) and best_delta <= cfg.conflict_tau
            lay.visits += 1.0
            lay.total_reward += reward
            lay.success += int(success)
            lay.last_step = self.step
            self.log.log("uct_update", layer=target, visits=lay.visits,
                         reward=reward)

        return self._finish()

    def _finish(self) -> LayeringOutput:
        # Best = min EMA residual among non-odometry layers
        # (``layer_manager.cpp:556-562``).
        best = min(
            range(1, len(self.layers)),
            key=lambda k: self.layers[k].ema_residual,
        )
        most = max(
            range(1, len(self.layers)),
            key=lambda k: int(self.layers[k].mask.sum()),
        )
        self.log.log("finish", best_layer=best,
                     ema=self.layers[best].ema_residual)
        self._print_summary(most)
        return LayeringOutput(
            poses=self.layers[best].poses,
            layers=self.layers,
            assignments=self.assignments,
            best_layer=best,
            most_selected_layer=most,
        )

    def _print_summary(self, most: int) -> None:
        self.log.log("summary", msg="==== Method3 Summary ====")
        self.log.log("summary", total_layers=len(self.layers) - 1)
        self.log.log("summary",
                     most_selected_layer=f"L{most}",
                     edges=int(self.layers[most].mask.sum()))
        for k in range(1, len(self.layers)):
            lay = self.layers[k]
            nodes = set()
            for e in np.where(lay.mask)[0]:
                nodes.add(int(self.ij[e, 0]))
                nodes.add(int(self.ij[e, 1]))
            self.log.log(
                "summary",
                layer=f"L{k}",
                edges=int(lay.mask.sum()),
                nodes=len(nodes),
                visits=int(lay.visits),
                success=lay.success,
                total_reward=lay.total_reward,
                avg_reward=lay.total_reward / (1.0 + lay.visits),
                ema_residual=lay.ema_residual,
            )


def make_manager(graph, cfg: RunConfig, logger, fused: str = "auto",
                 checkpoint: str | None = None):
    """Pick the method-3 engine: the host-driven manager (reference-shaped
    loop; exact CPU baseline) or the fused single-program scan
    (``layering_fused.py``; default on accelerators where per-edge device
    round-trips dominate).  Both produce identical decisions/logs
    (``test_fused_layering_matches_host``).  ``checkpoint`` enables
    chunk-boundary resume (fused engine only)."""
    use_fused = (fused == "on") or (
        fused == "auto" and jax.default_backend() != "cpu"
    ) or (checkpoint is not None)
    if use_fused:
        from slam_tpu.methods.layering_fused import FusedLayeringManager
        return FusedLayeringManager(graph, cfg.layering, cfg.solver, logger,
                                    checkpoint_path=checkpoint)
    return LayeringManager(graph, cfg.layering, cfg.solver, logger)


def run_from_config(cfg: RunConfig, fused: str = "auto",
                    checkpoint: str | None = None) -> LayeringOutput:
    """Reference-equivalent method-3 pipeline with ``save/`` artifacts
    (``layer_manager.cpp:546-600``)."""
    os.makedirs(cfg.save_path, exist_ok=True)
    logger = RunLogger(os.path.join(cfg.save_path, "method3.log"))
    graph = g2o.load_g2o(g2o.find_dataset(cfg.dataset))
    graph = graph.add_random_outliers(cfg.num_outliers, seed=cfg.seed)
    from slam_tpu.solver.init import apply_init
    graph = apply_init(graph, cfg, logger)

    g2o.write_nodes(os.path.join(cfg.save_path, "init_nodes.txt"), graph.poses)
    g2o.write_edges(os.path.join(cfg.save_path, "init_edges.txt"), graph)

    mgr = make_manager(graph, cfg, logger, fused, checkpoint)
    out = mgr.run()

    with open(os.path.join(cfg.save_path, "layers.txt"), "w") as f:
        for i, k in out.assignments:
            f.write(f"{i} {k}\n")
    g2o.write_nodes(
        os.path.join(cfg.save_path, "opt_nodes_method3.txt"), out.poses
    )
    g2o.write_nodes(os.path.join(cfg.save_path, "opt_nodes.txt"), out.poses)
    g2o.write_nodes(
        os.path.join(cfg.save_path, "opt_nodes_most_selected.txt"),
        out.layers[out.most_selected_layer].poses,
    )

    from slam_tpu.viz import plot
    plot.plot_trajectories(
        os.path.join(cfg.save_path, "init_nodes.txt"),
        os.path.join(cfg.save_path, "opt_nodes.txt"),
        os.path.join(cfg.save_path, "plot_best.png"),
    )
    plot.plot_trajectories(
        os.path.join(cfg.save_path, "init_nodes.txt"),
        os.path.join(cfg.save_path, "opt_nodes_most_selected.txt"),
        os.path.join(cfg.save_path, "plot_most_selected.png"),
    )
    logger.close()
    return out


def _free_first(n: int, dtype):
    from slam_tpu.solver.problem import anchor_first_node

    return anchor_first_node(n, dtype=dtype)

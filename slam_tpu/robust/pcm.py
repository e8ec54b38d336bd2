"""Pairwise consistency maximization (PCM) for loop-closure vetting.

Why this exists: the injected adversary (``g2o_util.h:151-171``) creates
edges between uniformly random node pairs with measurement ~ identity --
the lie "these far-apart nodes coincide".  Per-edge reweighting (Huber /
Geman-McClure / GNC annealing) is structurally blind to this on
chain-dominated graphs: the Laplacian's soft long-wavelength modes absorb a
false 90-degree constraint by spreading it over thousands of edges, so at
the poisoned solution EVERY per-edge residual is tiny (measured on
M3500+10: field bent 1.08 rad while the bogus edges' own residuals sat
below the inlier noise).  The remedy, following Mangelson et al. (ICRA
2018), is *pairwise* consistency: two loop closures e, f are checked
through the odometry cycle

    i_e --T_e--> j_e --odom--> j_f --T_f^-1--> i_f --odom--> i_e

whose drift grows only with the index gap between the two closures'
endpoints -- it cancels the global drift that poisons per-edge tests.
Real closures are mutually consistent (they all describe the same true
map); a random bogus edge is consistent with almost nothing.  The largest
mutually-consistent core (approximated by an iterated degree filter; exact
max-clique is NP-hard and unnecessary at these densities) is returned as
the trusted loop set.

All-pairs checks are O(L^2) outer-product arithmetic over the (L,) loop
summaries -- numpy on the host at ingestion scale (L ~ 2-3k: a few MB),
and trivially a batched matmul if ever needed on device.

SE(3) (r3): the same cycle test with quaternion innovation summaries.
Rotations are no longer abelian, so the exact cycle error is replaced by
its first-order surrogate: per-loop GLOBAL-frame innovation rotation
``q_e = q(O_a) * q(T_e) * conj(q(O_b))`` and translation innovation
``v_e = (O_a . T_e).t - O_b.t``; the pair (e, f) error is the geodesic
angle of ``q_e * conj(q_f)`` (equivalent to the chordal distance of the
relative rotations for small angles) and ``|v_e - v_f|``.  Drift between
the two closures' endpoints enters at first order exactly as in 2D, so
the same index-gap random-walk gate model (self-tuned) applies.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from slam_tpu.graph import ODOMETRY_EDGE, PoseGraph


@dataclasses.dataclass
class PcmResult:
    loop_mask: np.ndarray     # (L,) bool -- PCM-consistent loops
    loop_edges: np.ndarray    # (L,) indices into the graph's edge arrays
    consistency: np.ndarray   # (L,) fraction of the final core each loop
                              # is consistent with
    rounds: int
    # Self-tuned random-walk drift rates (variance per odometry step).
    # High rates mean the odometry is too drifty for cycle tests to
    # discriminate -- callers should treat the mask as low-confidence
    # (see solver/init.py's trust rule).
    s_rot2_per_step: float = 0.0
    s_trans2_per_step: float = 0.0


def _quat_mul(q1, q2):
    w1, x1, y1, z1 = np.moveaxis(q1, -1, 0)
    w2, x2, y2, z2 = np.moveaxis(q2, -1, 0)
    return np.stack([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ], axis=-1)


def _quat_conj(q):
    return q * np.array([1.0, -1.0, -1.0, -1.0])


def _quat_rotate(q, v):
    qv = np.concatenate([np.zeros(v.shape[:-1] + (1,)), v], axis=-1)
    return _quat_mul(_quat_mul(q, qv), _quat_conj(q))[..., 1:]


def _integrate_chain(graph: PoseGraph) -> np.ndarray:
    """Integrate the odometry chain into global-frame poses ``O`` --
    ``(N, 3)`` for SE(2), ``(N, 7)`` (xyz + wxyz quaternion) for SE(3).

    Uses the odometry EDGES (measurements), not the file's vertex
    estimates, so the cycle test is anchored to the same evidence the
    odometry terms contribute to the solve.  Nodes not reached by the
    chain keep the dataset estimate (multi-segment graphs: cross-segment
    pairs get a loose covariance via the index-gap model anyway).
    """
    O = np.asarray(graph.poses, np.float64).copy()
    ij = np.asarray(graph.edges_ij)
    meas = np.asarray(graph.edges_meas, np.float64)
    odo = np.asarray(graph.edge_type) == ODOMETRY_EDGE
    # Chain in index order (canonical graphs: (i, i+1)).
    order = np.argsort(ij[odo][:, 0], kind="stable")
    if graph.dim == 7:
        for a, b, m in zip(ij[odo][order][:, 0], ij[odo][order][:, 1],
                           meas[odo][order]):
            O[b, :3] = O[a, :3] + _quat_rotate(O[a, 3:7], m[:3])
            q = _quat_mul(O[a, 3:7], m[3:7])
            O[b, 3:7] = q / np.linalg.norm(q)
        return O
    for a, b, m in zip(ij[odo][order][:, 0], ij[odo][order][:, 1],
                       meas[odo][order]):
        c, s = np.cos(O[a, 2]), np.sin(O[a, 2])
        O[b, 0] = O[a, 0] + c * m[0] - s * m[1]
        O[b, 1] = O[a, 1] + s * m[0] + c * m[1]
        O[b, 2] = O[a, 2] + m[2]
    return O


def pcm_loop_mask(
    graph: PoseGraph,
    sigma_rot_per_step: float = 0.01,
    sigma_trans_per_step: float = 0.05,
    sigma_floor_rot: float = 0.05,
    sigma_floor_trans: float = 0.5,
    gate: float = 3.0,
    core_frac: float = 0.35,
    max_rounds: int = 32,
) -> PcmResult:
    """Classify loop edges by pairwise odometry-cycle consistency.

    Per-loop summary (odometry frame O): the *innovation* of closure e,

        theta_e = O_theta[i_e] + theta(T_e) - O_theta[j_e]
        v_e     = (O[i_e] * T_e).xy - O[j_e].xy

    For SE(2) rotations are abelian, so the cycle rotation error is EXACTLY
    ``theta_e - theta_f``; the translation error is ``|v_e - v_f|`` to first
    order in the drift.  Pair (e, f) is consistent when both sit within
    ``gate`` sigmas of the random-walk drift model
    ``sigma^2 = floor^2 + per_step^2 * (|i_e - i_f| + |j_e - j_f|)``.

    Core selection: iteratively drop loops consistent with fewer than
    ``core_frac`` of the surviving set (an iterated degree core -- the
    greedy PCM approximation).
    """
    ij = np.asarray(graph.edges_ij)
    loop_idx = np.where(np.asarray(graph.edge_type) != ODOMETRY_EDGE)[0]
    L = loop_idx.shape[0]
    if L == 0 or graph.dim not in (3, 7):
        return PcmResult(np.ones(L, bool), loop_idx, np.ones(L), 0)

    O = _integrate_chain(graph)
    meas = np.asarray(graph.edges_meas, np.float64)[loop_idx]
    a = ij[loop_idx, 0]
    b = ij[loop_idx, 1]

    if graph.dim == 7:
        # SE(3) innovation summaries (see module docstring).
        q_e = _quat_mul(_quat_mul(O[a, 3:7], meas[:, 3:7]),
                        _quat_conj(O[b, 3:7]))
        q_e /= np.linalg.norm(q_e, axis=-1, keepdims=True)
        v = O[a, :3] + _quat_rotate(O[a, 3:7], meas[:, :3]) - O[b, :3]
        # Pairwise geodesic rotation error: angle(q_e * conj(q_f)) =
        # 2*acos(|<q_e, q_f>|) -- one (L, L) Gram matrix.
        dots = np.clip(np.abs(q_e @ q_e.T), 0.0, 1.0)
        dth = 2.0 * np.arccos(dots)
        dv2 = np.sum(
            (v[:, None, :] - v[None, :, :]) ** 2, axis=-1)
    else:
        ca, sa = np.cos(O[a, 2]), np.sin(O[a, 2])
        theta = O[a, 2] + meas[:, 2] - O[b, 2]
        theta = np.arctan2(np.sin(theta), np.cos(theta))
        vx = O[a, 0] + ca * meas[:, 0] - sa * meas[:, 1] - O[b, 0]
        vy = O[a, 1] + sa * meas[:, 0] + ca * meas[:, 1] - O[b, 1]

        # Pairwise errors + drift-scaled gates (L x L; tens of MB at L~3k).
        dth = theta[:, None] - theta[None, :]
        dth = np.abs(np.arctan2(np.sin(dth), np.cos(dth)))
        dv2 = ((vx[:, None] - vx[None, :]) ** 2
               + (vy[:, None] - vy[None, :]) ** 2)
    steps = (np.abs(a[:, None] - a[None, :])
             + np.abs(b[:, None] - b[None, :])).astype(np.float64)
    # Self-tune the per-step drift variance from the data: under the
    # random-walk model E[dth^2] ~ floor + s^2 * steps, so the median of
    # dth^2/steps over pairs estimates s^2 robustly.  This is what lets one
    # parameterisation cover both low-drift (M3500: ~1e-4 rad^2/step) and
    # high-drift (INTEL raw odometry: ~100x that) graphs; bogus-involved
    # pairs are a minority and their ratios are ~pi^2/N -- the median
    # shrugs them off.  The configured per-step sigmas act as floors.
    off = steps > 0
    # q20 x 2.5 rather than the median: with a majority of bogus loops
    # (CSAIL+200: real-real pairs are only ~15% of all pairs) the median
    # ratio IS an outlier pair and the gates balloon; the low quantile
    # stays inside the real-real cluster and the x2.5 restores an unbiased
    # scale for a half-normal-ish ratio distribution.
    s_r2_step = max(2.5 * float(np.quantile(dth[off] ** 2 / steps[off],
                                            0.20)),
                    sigma_rot_per_step**2)
    s_t2_step = max(2.5 * float(np.quantile(dv2[off] / steps[off], 0.20)),
                    sigma_trans_per_step**2)
    s_r2 = sigma_floor_rot**2 + s_r2_step * steps
    s_t2 = sigma_floor_trans**2 + s_t2_step * steps
    consistent = (dth**2 <= gate**2 * s_r2) & (dv2 <= gate**2 * s_t2)
    np.fill_diagonal(consistent, True)

    keep = np.ones(L, bool)
    rounds = 0
    for rounds in range(1, max_rounds + 1):
        deg = consistent[np.ix_(keep, keep)].mean(axis=1)
        drop = deg < core_frac
        if not drop.any():
            break
        idx = np.where(keep)[0]
        keep[idx[drop]] = False
        if not keep.any():
            break
    consistency = np.zeros(L)
    if keep.any():
        consistency = consistent[:, keep].mean(axis=1)
    return PcmResult(keep, loop_idx, consistency, rounds,
                     s_rot2_per_step=s_r2_step,
                     s_trans2_per_step=s_t2_step)

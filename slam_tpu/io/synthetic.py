"""Synthetic pose-graph generators.

The reference ships only curated 2D ``.g2o`` files and *names* datasets it
does not include (M10000 stripped, sphere2500 absent -- see
``DCS-ceres/main.cpp:23`` and ``.MISSING_LARGE_BLOBS``).
These generators provide reproducible stand-ins with known ground truth:

* :func:`circle_se2` -- a loop trajectory with noisy odometry and exact-ish
  loop closures; the smallest useful end-to-end fixture.
* :func:`manhattan_se2` -- Olson-style Manhattan-world random walk with
  proximity loop closures (M3500-class structure, any size).
* :func:`sphere_se3` -- the classic sphere dataset recipe (poses on a sphere
  spiral, odometry along the spiral, closures between adjacent rings) for
  the SE(3) solver path.

All randomness flows through an explicit ``numpy`` Generator seed -- the
framework-level answer to the reference's ``srand(time(0))``
(``main.cpp:43``).
"""

from __future__ import annotations

import numpy as np

from slam_tpu.graph import CLOSURE_EDGE, ODOMETRY_EDGE, PoseGraph
from slam_tpu.geometry import se3 as se3_np  # numpy-compatible helpers


def _se2_rel(pa: np.ndarray, pb: np.ndarray) -> np.ndarray:
    dx = pb[..., 0] - pa[..., 0]
    dy = pb[..., 1] - pa[..., 1]
    c, s = np.cos(pa[..., 2]), np.sin(pa[..., 2])
    return np.stack(
        [c * dx + s * dy, -s * dx + c * dy, pb[..., 2] - pa[..., 2]], -1
    )


def _build_se2(
    gt: np.ndarray,
    odo_pairs: np.ndarray,
    loop_pairs: np.ndarray,
    odo_noise: tuple[float, float],
    rng: np.random.Generator,
    info_odo=(44.7, 44.7, 44.7),
    info_loop=(44.7, 44.7, 44.7),
):
    def edges_for(pairs, noise_t, noise_r):
        if len(pairs) == 0:
            return np.zeros((0, 3))
        meas = _se2_rel(gt[pairs[:, 0]], gt[pairs[:, 1]])
        meas[:, :2] += rng.normal(0, noise_t, meas[:, :2].shape)
        meas[:, 2] += rng.normal(0, noise_r, meas[:, 2].shape)
        return meas

    nt, nr = odo_noise
    odo_meas = edges_for(odo_pairs, nt, nr)
    loop_meas = edges_for(loop_pairs, nt * 0.5, nr * 0.5)

    # Integrate noisy odometry for the initial guess (standard practice; the
    # reference instead starts from the file's vertex estimates).
    init = np.zeros_like(gt)
    init[0] = gt[0]
    for k in range(len(odo_pairs)):
        a, b = odo_pairs[k]
        c, s = np.cos(init[a, 2]), np.sin(init[a, 2])
        m = odo_meas[k]
        init[b, 0] = init[a, 0] + c * m[0] - s * m[1]
        init[b, 1] = init[a, 1] + s * m[0] + c * m[1]
        init[b, 2] = init[a, 2] + m[2]

    ij = np.concatenate([odo_pairs, loop_pairs]).astype(np.int32)
    meas = np.concatenate([odo_meas, loop_meas])
    i_o = np.array([info_odo[0], 0, 0, info_odo[1], 0, info_odo[2]])
    i_l = np.array([info_loop[0], 0, 0, info_loop[1], 0, info_loop[2]])
    info = np.concatenate(
        [
            np.tile(i_o, (len(odo_pairs), 1)),
            np.tile(i_l, (len(loop_pairs), 1)),
        ]
    )
    etype = np.concatenate(
        [
            np.full(len(odo_pairs), ODOMETRY_EDGE, np.int8),
            np.full(len(loop_pairs), CLOSURE_EDGE, np.int8),
        ]
    )
    graph = PoseGraph(
        poses=init, edges_ij=ij, edges_meas=meas, edges_info=info,
        edge_type=etype,
    )
    return graph, gt


def circle_se2(
    n: int = 64,
    radius: float = 10.0,
    odo_noise: tuple[float, float] = (0.05, 0.01),
    num_closures: int = 6,
    seed: int = 0,
):
    """Loop trajectory on a circle, closures between opposite-ish nodes.

    Returns ``(graph, ground_truth)``.
    """
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 2 * np.pi, n, endpoint=False)
    gt = np.stack(
        [radius * np.cos(t), radius * np.sin(t), t + np.pi / 2], axis=-1
    )
    odo = np.stack([np.arange(n - 1), np.arange(1, n)], -1)
    # Close the loop and add a few long-range closures.
    loops = [[n - 1, 0]]
    for _ in range(num_closures - 1):
        a = int(rng.integers(0, n))
        b = (a + n // 2 + int(rng.integers(-n // 8, n // 8))) % n
        if a != b and abs(a - b) >= 5:
            loops.append([a, b])
    return _build_se2(gt, odo, np.array(loops), odo_noise, rng)


def manhattan_se2(
    n: int = 3500,
    step: float = 1.0,
    block: int = 10,
    odo_noise: tuple[float, float] = (0.05, 0.02),
    closure_radius: float = 1.5,
    max_closures: int = 2000,
    seed: int = 0,
):
    """Olson-style Manhattan world random walk (M3500-class structure)."""
    rng = np.random.default_rng(seed)
    gt = np.zeros((n, 3))
    heading = 0.0
    pos = np.zeros(2)
    for i in range(1, n):
        if i % block == 0:
            turn = rng.choice([-1, 0, 0, 1])
            heading = heading + turn * np.pi / 2
        pos = pos + step * np.array([np.cos(heading), np.sin(heading)])
        gt[i] = [pos[0], pos[1], heading]
    odo = np.stack([np.arange(n - 1), np.arange(1, n)], -1)

    # Proximity closures: grid-hash ground-truth positions.
    cell = np.floor(gt[:, :2] / closure_radius).astype(np.int64)
    key = cell[:, 0] * 1_000_003 + cell[:, 1]
    order = np.argsort(key, kind="stable")
    loops = []
    sorted_key = key[order]
    start = 0
    for end in range(1, n + 1):
        if end == n or sorted_key[end] != sorted_key[start]:
            idxs = order[start:end]
            if len(idxs) > 1:
                idxs = np.sort(idxs)
                for u in range(len(idxs)):
                    for v in range(u + 1, len(idxs)):
                        a, b = int(idxs[u]), int(idxs[v])
                        if b - a >= 5:
                            loops.append([a, b])
            start = end
    rng.shuffle(loops)
    loops = np.array(loops[:max_closures]) if loops else np.zeros((0, 2), int)
    return _build_se2(gt, odo, loops, odo_noise, rng)


def sphere_se3(
    n: int = 2500,
    rings: int = 50,
    radius: float = 50.0,
    trans_noise: float = 0.05,
    rot_noise: float = 0.01,
    seed: int = 0,
):
    """Sphere dataset recipe: a spiral of poses over a sphere with odometry
    along the spiral and closures linking vertically adjacent rings.

    Returns ``(graph, ground_truth)`` with poses ``[x y z qw qx qy qz]``.
    """
    rng = np.random.default_rng(seed)
    per_ring = n // rings
    idx = np.arange(n)
    ring = idx // per_ring
    ang = 2 * np.pi * (idx % per_ring) / per_ring
    elev = np.pi * (ring + 0.5) / rings - np.pi / 2

    x = radius * np.cos(elev) * np.cos(ang)
    y = radius * np.cos(elev) * np.sin(ang)
    z = radius * np.sin(elev)
    pos = np.stack([x, y, z], -1)

    # Orientation: yaw follows the ring tangent, pitch follows elevation.
    yaw = ang + np.pi / 2
    pitch = np.zeros_like(yaw)
    roll = elev
    quat = se3_np.quat_from_euler_np(roll, pitch, yaw)
    gt = np.concatenate([pos, quat], axis=-1)

    odo = np.stack([np.arange(n - 1), np.arange(1, n)], -1)
    loops = []
    for i in range(n):
        j = i + per_ring  # same azimuth, next ring up
        if j < n:
            loops.append([i, j])
    loops = np.array(loops)

    def rel(a, b):
        return se3_np.relative_np(gt[a], gt[b])

    odo_meas = rel(odo[:, 0], odo[:, 1])
    loop_meas = rel(loops[:, 0], loops[:, 1])
    for m in (odo_meas, loop_meas):
        m[:, :3] += rng.normal(0, trans_noise, m[:, :3].shape)
        m[:, 3:] = se3_np.quat_perturb_np(m[:, 3:], rot_noise, rng)

    # Integrate odometry for the initial guess.
    init = gt.copy()
    init[0] = gt[0]
    for k in range(n - 1):
        init[k + 1] = se3_np.compose_np(init[k], odo_meas[k])

    ij = np.concatenate([odo, loops]).astype(np.int32)
    meas = np.concatenate([odo_meas, loop_meas])
    # 21 upper-tri entries of a 6x6 information; use scaled identity.
    info_row = np.zeros(21)
    info_row[[0, 6, 11, 15, 18, 20]] = 100.0  # diagonal positions
    info = np.tile(info_row, (len(ij), 1))
    etype = np.concatenate(
        [
            np.full(len(odo), ODOMETRY_EDGE, np.int8),
            np.full(len(loops), CLOSURE_EDGE, np.int8),
        ]
    )
    graph = PoseGraph(
        poses=init, edges_ij=ij, edges_meas=meas, edges_info=info,
        edge_type=etype,
    )
    return graph, gt

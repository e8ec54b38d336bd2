#!/usr/bin/env python
"""Write every dataset in ``data/``.

* INTEL, CSAIL and M3500 (the reference's own graphs) are recovered from
  the replay files in ``results/replay/``: each replay is the dataset in
  canonical edge order with its N seeded bogus loops appended last, so
  dropping the last N edges gives the dataset back exactly
  (``tests/test_g2o.py`` re-injects and checks bit equality).
* M10000 (named by the reference's ``main.cpp:23`` but not shipped) and
  sphere2500-class SE(3) graphs are synthetic with known ground truth
  (slam_tpu/io/synthetic.py).
* M3500b/c are rotation-corrupted M3500 variants.

Usage: python scripts/generate_datasets.py [outdir]
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402

from slam_tpu.io import g2o, synthetic  # noqa: E402

_REPLAY = os.path.join(os.path.dirname(__file__), "..", "results", "replay")

#: dataset -> (replay file, number of bogus edges appended to it)
RECOVERED = {
    "INTEL": ("INTEL_50out_seed42.g2o", 50),
    "CSAIL": ("CSAIL_50out_seed42.g2o", 50),
    "M3500": ("M3500_50out_seed0.g2o", 50),
}


def recover_from_replay(replay_path: str, num_outliers: int) -> str:
    """The g2o text of the dataset a replay file was made from: the file
    minus its last ``num_outliers`` edge lines (the appended bogus loops).
    Works on the text because loading re-classifies a bogus edge with
    close endpoints as odometry and would move it out of the tail."""
    with open(replay_path) as f:
        lines = f.read().splitlines()
    if not all(ln.startswith("EDGE") for ln in lines[-num_outliers:]):
        raise ValueError(f"{replay_path}: last {num_outliers} lines are "
                         "not all edges")
    return "\n".join(lines[:-num_outliers]) + "\n"


def m3500_variant(noise_std: float, seed: int):
    """Corrupted M3500 variant (reference ``main.cpp:23`` names M3500b and
    M3500c but ships neither): extra zero-mean Gaussian noise on the
    *rotation* of every odometry measurement -- the standard "M3500a/b/c"
    corruption (Carlone et al.) -- with the initial guess re-integrated from
    the corrupted odometry chain so the vertex estimates are consistent
    with the measurements, as in the originals.
    """
    base = g2o.load_g2o(g2o.find_dataset("M3500"))
    rng = np.random.default_rng(seed)
    meas = base.edges_meas.copy()
    odo = base.edge_type == 0
    noise = rng.normal(0.0, noise_std, int(odo.sum()))
    th = meas[odo, 2] + noise
    meas[odo, 2] = np.arctan2(np.sin(th), np.cos(th))

    # Re-integrate the chain edges (a, a+1) for the initial guess.
    poses = base.poses.copy()
    chain = {}
    for (a, b), m in zip(base.edges_ij[odo], meas[odo]):
        if b == a + 1:
            chain[int(a)] = m

    def rel_from_poses(pa, pb):
        # Original relative motion for chain gaps, so accumulated drift
        # carries across the gap instead of snapping back to the original
        # absolute estimate.
        c, s = np.cos(pa[2]), np.sin(pa[2])
        dx, dy = pb[0] - pa[0], pb[1] - pa[1]
        return np.array([c * dx + s * dy, -s * dx + c * dy, pb[2] - pa[2]])

    for a in range(base.num_nodes - 1):
        m = chain.get(a)
        if m is None:  # gap: compose the original relative motion
            m = rel_from_poses(base.poses[a], base.poses[a + 1])
        x, y, t = poses[a]
        c, s = np.cos(t), np.sin(t)
        poses[a + 1, 0] = x + c * m[0] - s * m[1]
        poses[a + 1, 1] = y + s * m[0] + c * m[1]
        tn = t + m[2]
        poses[a + 1, 2] = np.arctan2(np.sin(tn), np.cos(tn))

    return type(base)(
        poses=poses, edges_ij=base.edges_ij, edges_meas=meas,
        edges_info=base.edges_info, edge_type=base.edge_type,
    )


def main():
    outdir = sys.argv[1] if len(sys.argv) > 1 else os.path.join(
        os.path.dirname(__file__), "..", "data"
    )
    os.makedirs(outdir, exist_ok=True)

    for name, (replay, n) in RECOVERED.items():
        print(f"recovering {name} from results/replay/{replay}...")
        with open(os.path.join(outdir, name + ".g2o"), "w") as f:
            f.write(recover_from_replay(os.path.join(_REPLAY, replay), n))

    print("generating sphere2500 (SE3)...")
    graph, gt = synthetic.sphere_se3(n=2500, rings=50, seed=0)
    g2o.write_g2o(os.path.join(outdir, "sphere2500.g2o"), graph)
    np.save(os.path.join(outdir, "sphere2500_gt.npy"), gt)

    print("generating M10000 (Manhattan SE2)...")
    # Rotational noise scaled down vs the small-graph default: over 10k
    # integration steps 0.02 rad/step produces a useless initial guess
    # (hundreds of meters of drift) that no robust method could recover --
    # real M3500-class datasets start from moderately drifted but sane
    # odometry.
    graph, gt = synthetic.manhattan_se2(
        n=10000, max_closures=6000, odo_noise=(0.03, 0.003), seed=0
    )
    g2o.write_g2o(os.path.join(outdir, "M10000.g2o"), graph)
    np.save(os.path.join(outdir, "M10000_gt.npy"), gt)

    for name, std in (("M3500b", 0.1), ("M3500c", 0.2)):
        print(f"generating {name} (M3500 + {std} rad odometry noise)...")
        g2o.write_g2o(os.path.join(outdir, name + ".g2o"),
                      m3500_variant(std, seed=0))

    print("done:", sorted(os.listdir(outdir)))


if __name__ == "__main__":
    main()

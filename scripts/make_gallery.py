"""Render the reference's qualitative experiment grid, quantitatively.

The reference publishes a gallery of trajectory images per
(dataset, #outliers, DCS on/off) cell (`README.md:38-44`,
`docs/INTEL/*.png`, `docs/CSAIL/*.png`) -- converged vs collapsed
topology by eyeball.  This script reproduces that artifact as ONE grid
figure per dataset with the ATE stamped on every cell:

    results/gallery/<DATASET>_grid.png

Rows: method 0 (baseline) / method 1 (DCS).  Columns: outlier counts.
Runs on whatever backend is active.

Usage: python scripts/make_gallery.py [DATASET ...]  (default: INTEL CSAIL M3500)
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

OUT = os.path.join(os.path.dirname(__file__), "..", "results", "gallery")
# Columns mirror the reference's published envelope per dataset
# (docs/INTEL/INTEL_{5,50,100,200}_ON_*.png; M3500 rides the BASELINE grid).
COUNTS_BY_DS = {
    "INTEL": [0, 50, 100, 200],
    "CSAIL": [0, 50, 100, 200],
    "M3500": [0, 10, 50, 100],
}
DEFAULT_COUNTS = [0, 50, 100]


def main(datasets: list[str]) -> None:
    from slam_tpu.utils.cache import enable_persistent_cache
    enable_persistent_cache()

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import numpy as np

    from slam_tpu.config import RunConfig, SolverConfig
    from slam_tpu.eval import metrics
    from slam_tpu.io import g2o
    from slam_tpu.methods.global_solve import run_global_solve
    from slam_tpu.utils.logging import RunLogger

    os.makedirs(OUT, exist_ok=True)
    log = RunLogger(echo=False)
    solver = SolverConfig()

    for ds in datasets:
        counts = COUNTS_BY_DS.get(ds, DEFAULT_COUNTS)
        graph = g2o.load_g2o(g2o.find_dataset(ds))
        clean = run_global_solve(
            graph, RunConfig(dataset=ds, method=0, solver=solver), log)
        fig, axes = plt.subplots(
            2, len(counts), figsize=(4.2 * len(counts), 8.2))
        for col, n in enumerate(counts):
            dirty = graph.add_random_outliers(n, seed=0)
            for row, method in enumerate((0, 1)):
                out = run_global_solve(
                    dirty,
                    RunConfig(dataset=ds, method=method, num_outliers=n,
                              solver=solver),
                    log)
                ate = metrics.ate(out.poses, clean.poses)
                ax = axes[row, col]
                p = np.asarray(out.poses)
                ax.plot(p[:, 0], p[:, 1], "-", lw=0.6,
                        color="tab:red" if method == 0 else "tab:blue")
                name = "baseline" if method == 0 else "DCS"
                ax.set_title(f"{ds} +{n} bogus, {name}\n"
                             f"ATE {ate:.3f} m", fontsize=10)
                ax.set_aspect("equal")
                ax.tick_params(labelsize=7)
                print(f"{ds} n={n} m={method}: ate {ate:.3f}", flush=True)
        fig.suptitle(
            f"{ds}: reference experiment grid (README.md:38-44) -- "
            "collapse without DCS, convergence with", fontsize=12)
        fig.tight_layout()
        path = os.path.join(OUT, f"{ds}_grid.png")
        fig.savefig(path, dpi=110)
        plt.close(fig)
        print("wrote", path, flush=True)


if __name__ == "__main__":
    main(sys.argv[1:] or ["INTEL", "CSAIL", "M3500"])

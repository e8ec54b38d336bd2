"""DCS psi-consensus rescue gates (r3).

Covers the two measured regimes of the rescue
(``methods/global_solve.py``, config ``dcs_consensus``):

* the partially-poisoned basin on raw-odometry graphs at the reference's
  headline outlier counts (INTEL 100-200, ``README.md:41-42``) -- the
  rescue must recover the real-loop consensus;
* the bogus-COALITION trap on small floppy maps where "explains more
  loops" / "higher mean psi" acceptance would pick an adversarial
  solution -- the full-objective ranking must refuse it.
"""

import numpy as np
import pytest

from slam_tpu.config import RunConfig, SolverConfig
from slam_tpu.eval import metrics
from slam_tpu.graph import CLOSURE_EDGE, ODOMETRY_EDGE, PoseGraph
from slam_tpu.methods.global_solve import run_global_solve
from slam_tpu.utils.logging import RunLogger


class _Capture(RunLogger):
    def __init__(self):
        super().__init__(echo=False)
        self.records = []

    def log(self, tag, msg="", **fields):
        self.records.append((tag, fields))


def two_lap_circle(n_per_lap=60, laps=2, r=10.0, drift=0.012,
                   n_closures=12):
    """Robot circles a ring twice; odometry has a heading-rate bias so
    the integrated init spirals; real closures tie matching angles
    across laps.  Small and floppy enough that a mutually-consistent
    bogus coalition is cost-competitive -- the adversarial fixture for
    the rescue's acceptance rule."""
    n = n_per_lap * laps
    dth = 2 * np.pi / n_per_lap
    step = 2 * r * np.sin(dth / 2)
    ang = dth * np.arange(n)
    truth = np.stack([r * np.cos(ang), r * np.sin(ang),
                      ang + np.pi / 2 + dth / 2], axis=1)
    ij, meas, info, etype = [], [], [], []
    for i in range(n - 1):
        ij.append((i, i + 1))
        meas.append((step, 0.0, dth + drift))
        info.append((100.0, 0, 0, 100.0, 0, 400.0))
        etype.append(ODOMETRY_EDGE)
    rng = np.random.default_rng(0)
    for _ in range(n_closures):
        i = int(rng.integers(0, n_per_lap))
        ij.append((i, i + n_per_lap))
        meas.append((0.0, 0.0, 0.0))
        info.append((50.0, 0, 0, 50.0, 0, 100.0))
        etype.append(CLOSURE_EDGE)
    init = np.zeros((n, 3))
    init[0] = truth[0]
    for i in range(n - 1):
        x, y, t = init[i]
        dx, dy, dt = meas[i]
        init[i + 1] = (x + np.cos(t) * dx - np.sin(t) * dy,
                       y + np.sin(t) * dx + np.cos(t) * dy, t + dt)
    g = PoseGraph(
        poses=init,
        edges_ij=np.array(ij, np.int32),
        edges_meas=np.array(meas, np.float64),
        edges_info=np.array(info, np.float64),
        edge_type=np.array(etype, np.int8),
    )
    return g, truth


def _solve(dirty, solver, n_out, seed):
    log = _Capture()
    out = run_global_solve(
        dirty,
        RunConfig(dataset="synth", method=1, num_outliers=n_out, seed=seed,
                  init="dataset", solver=solver),
        log)
    return out, log


@pytest.mark.slow
def test_circle_coalition_rejected_by_full_objective():
    """On the coalition fixture the rescue candidates (GNC retry and any
    coalition chain) must NOT replace the plain solve: with 24 bogus vs
    12 real loops a coalition raises loop-count and mean-psi scores while
    tripling the ATE (the measured failure of those acceptance rules).
    The full-objective ranking keeps plain behaviour."""
    g, truth = two_lap_circle()
    dirty = g.add_random_outliers(24, seed=3)
    base = SolverConfig(dtype="float64", linear_solver="dense")

    plain, _ = _solve(dirty, base.replace(dcs_consensus=False,
                                          dcs_auto_retry=False), 24, 3)
    ate_plain = metrics.ate(plain.poses, truth)

    rescued, log = _solve(dirty, base, 24, 3)
    ate_rescued = metrics.ate(rescued.poses, truth)

    retries = [f for t, f in log.records if t == "retry"]
    assert retries, "rescue should trigger on this fixture"
    # Whatever the ranking decided, quality must not regress vs plain.
    assert ate_rescued <= ate_plain * 1.05 + 0.05, (ate_rescued, ate_plain)


@pytest.mark.slow
def test_intel100_consensus_rescue_matches_golden():
    """The r3 headline gate: INTEL + DCS + 100 injected outliers (the
    reference's own published regime, docs/INTEL/INTEL_100_ON_Try2.png)
    through the PRODUCT pipeline must land on the committed golden
    (f64 ATE 0.017-0.025 across seeds).  Reduced budget:
    2 chains (the trim-from-full chain alone rescues this seed) and 30
    LM iterations per solve."""
    import json
    import os

    from slam_tpu.io import g2o

    golden_dir = os.path.join(os.path.dirname(__file__), "..", "results",
                              "golden")
    key = "INTEL_100out_seed42"
    path = os.path.join(golden_dir, f"{key}.npy")
    if not os.path.isfile(path):
        pytest.skip("golden not generated")
    meta = json.load(open(os.path.join(golden_dir, "meta.json")))
    golden = np.load(path)

    graph = g2o.load_g2o(g2o.find_dataset("INTEL"))
    dirty = graph.add_random_outliers(100, seed=42)
    solver = SolverConfig(dtype="float64", max_iterations=30,
                          dcs_consensus_chains=2)
    out, log = _solve(dirty, solver, 100, 42)
    ate = metrics.ate(out.poses, golden)
    assert ate < 0.5, ate
    retries = [f for t, f in log.records if t == "retry"]
    assert any(f.get("kept") for f in retries), retries
    # Cost comparable to the recorded fixed point (same masked-objective
    # family; generous bound -- the gate is the ATE above).
    assert float(out.result.cost) < 3.0 * meta[key]["final_cost"] + 0.1

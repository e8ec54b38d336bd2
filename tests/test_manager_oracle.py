"""Decision-sequence parity gates: production managers vs the
Ceres-semantics manager oracle (VERDICT r4 missing #1).

``solver/manager_oracle.py`` replays the reference's method-3/4 manager
algorithms (``layer_manager.cpp:343-468``,
``simple_layer_manager.cpp:68-130``) with short Ceres-semantics LM solves
sharing no code with the production solver.  These gates require the
production host managers (whose fused twins are pinned equal in
tests/test_methods.py and by chip_smoke.py on the GPU) to make
IDENTICAL decisions.

The full INTEL-slice and INTEL+50 diffs are recorded by
``scripts/manager_oracle_check.py`` in ``results/manager_oracle.json``.
"""

import numpy as np
import pytest

from slam_tpu.config import LayeringConfig, MctsConfig, SolverConfig
from slam_tpu.io import synthetic
from slam_tpu.solver.manager_oracle import Method3Oracle, Method4Oracle
from slam_tpu.utils.logging import RunLogger

_SOLVER = SolverConfig(linear_solver="dense", dtype="float64")


class _Recorder(RunLogger):
    def __init__(self):
        super().__init__(echo=False)
        self.entries = []

    def log(self, tag, msg="", **fields):
        self.entries.append((tag, fields))


@pytest.fixture(scope="module")
def dirty_circle():
    graph, _ = synthetic.circle_se2(n=64, seed=1)
    return graph.add_random_outliers(6, seed=9)


def _host_m3_decisions(entries):
    out, cur = [], None
    for tag, f in entries:
        if tag == "uct":
            cur = dict(topk=[int(s.split("(")[0][1:])
                             for s in f["topk"].split(",")],
                       deltas=[], split=False)
        elif tag == "conflict":
            cur["deltas"].append(float(f["Delta"]))
        elif tag == "split":
            cur["split"] = True
        elif tag == "assign":
            cur["target"] = int(f["to_layer"])
        elif tag == "uct_update":
            out.append(cur)
            cur = None
    return out


def _host_m4_decisions(entries):
    out, cur = [], None
    for tag, f in entries:
        if tag.startswith("step"):
            if cur is not None:
                out.append(cur)
            cur = dict(action=None)
        elif cur is None:
            continue
        elif tag == "residual":
            cur["residual"] = float(f["edge_residual"])
        elif tag == "skip":
            cur["action"] = "skip"
        elif tag == "split_check":
            cur["split_value"] = float(f["split_value"])
        elif tag == "expand":
            cur["action"] = "expand"
            cur["selected"] = f["created"]
        elif tag == "assign":
            cur["action"] = "assign"
            cur["selected"] = f["layer"]
    if cur is not None:
        out.append(cur)
    return out


def test_method3_oracle_matches_host(dirty_circle):
    from slam_tpu.methods.layering import LayeringManager

    cfg = LayeringConfig(local_iters=2, max_layers=8)
    rec = _Recorder()
    host_out = LayeringManager(dirty_circle, cfg, _SOLVER, rec).run()
    host = _host_m3_decisions(rec.entries)

    oracle = Method3Oracle(dirty_circle, cfg)
    dec = oracle.run()

    assert len(host) == len(dec)
    for h, o in zip(host, dec):
        assert h["topk"] == o["topk"]
        assert h["split"] == o["split"]
        assert h["target"] == o["target"]
        # Candidate costs from two UNRELATED solvers (jitted JAX LM vs
        # NumPy Ceres-semantics trust region) at 2 iterations.
        np.testing.assert_allclose(h["deltas"], o["deltas"], atol=2e-4)
    assert host_out.best_layer == oracle.best_layer()
    assert host_out.assignments == oracle.assignments


def test_method4_oracle_matches_host(dirty_circle):
    from slam_tpu.methods.mcts import MctsManager

    cfg = MctsConfig(max_layers=8)
    rec = _Recorder()
    host_out = MctsManager(dirty_circle, cfg, _SOLVER, rec).run()
    host = _host_m4_decisions(rec.entries)

    oracle = Method4Oracle(dirty_circle, cfg)
    dec = oracle.run()

    assert len(host) == len(dec)
    for h, o in zip(host, dec):
        assert h["action"] == o["action"]
        if h["action"] != "skip":
            assert h["selected"] in (o["selected"], o.get("child"))
        np.testing.assert_allclose(
            h["residual"], o["residual"], atol=2e-3)
        if "split_value" in h:
            np.testing.assert_allclose(
                h["split_value"], o["split_value"], atol=2e-4)
    assert host_out.best_layer == oracle.best_layer()


@pytest.mark.slow
def test_manager_oracle_intel_slice():
    """The gate slice (~300 nodes, 40 closures + 4 bogus): zero decision
    divergence, recorded margins (results/manager_oracle.json carries the
    committed record)."""
    import importlib.util
    import os

    spec = importlib.util.spec_from_file_location(
        "manager_oracle_check",
        os.path.join(os.path.dirname(__file__), "..", "scripts",
                     "manager_oracle_check.py"))
    chk = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chk)

    graph = chk.intel_slice()
    import tempfile
    m3_log, m4_log = chk.run_host_managers(graph, tempfile.mkdtemp())
    (m3, d3, _), (m4, d4, _) = chk.run_oracles(graph)
    with open(m3_log) as f:
        r3 = chk.diff_m3(chk.parse_m3_log(f), d3,
                         LayeringConfig().conflict_tau)
    with open(m4_log) as f:
        r4 = chk.diff_m4(chk.parse_m4_log(f), d4, MctsConfig().conflict_tau)
    assert r3["divergences"] == 0 and not r3["count_mismatch"]
    assert r4["divergences"] == 0 and not r4["count_mismatch"]
    # Decisions are robust: numeric solver diff is orders of magnitude
    # below the closest decision margin.
    assert r3["max_delta_diff"] < 1e-4 < r3["min_split_margin"]
    assert r4["max_split_value_diff"] < 1e-4 < r4["min_split_margin"]


def test_method3_ceres_trust_region_eval_tracks_oracle(dirty_circle):
    """The r5 opt-in `eval_trust_region="ceres"` aligns the production
    short-solve bookkeeping with stock Ceres; decisions AND Delta values
    must track the oracle (measured at INTEL+50 production scale:
    306/306 decisions, max Delta diff 1.5e-4 --
    results/manager_oracle.json `intel50_ceres_tr`)."""
    from slam_tpu.methods.layering import LayeringManager

    cfg = LayeringConfig(local_iters=2, max_layers=8,
                         eval_trust_region="ceres")
    rec = _Recorder()
    out = LayeringManager(dirty_circle, cfg, _SOLVER, rec).run()
    host = _host_m3_decisions(rec.entries)
    oracle = Method3Oracle(
        dirty_circle, LayeringConfig(local_iters=2, max_layers=8))
    dec = oracle.run()
    assert len(host) == len(dec)
    for h, o in zip(host, dec):
        assert (h["topk"], h["split"], h["target"]) == (
            o["topk"], o["split"], o["target"])
        np.testing.assert_allclose(h["deltas"], o["deltas"], atol=5e-5)
    assert out.best_layer == oracle.best_layer()

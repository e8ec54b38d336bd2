"""Config mapping and logger formatting tests."""

import re

from slam_tpu.config import (
    METHOD_BASELINE,
    METHOD_DCS,
    METHOD_LAYERING,
    METHOD_MCTS,
    METHOD_SC,
    SolverConfig,
    solver_config_for_method,
)
from slam_tpu.utils.logging import RunLogger


def test_method_to_robust_mapping():
    """CLI method ids map to robust modes exactly as ``main.cpp:54-56``."""
    assert solver_config_for_method(METHOD_BASELINE).robust == "none"
    assert solver_config_for_method(METHOD_DCS).robust == "dcs"
    assert solver_config_for_method(METHOD_SC).robust == "sc"
    # Methods 3/4 drive their own managers; the global config stays plain.
    assert solver_config_for_method(METHOD_LAYERING).robust == "none"
    assert solver_config_for_method(METHOD_MCTS).robust == "none"


def test_reference_constants_as_defaults():
    cfg = SolverConfig()
    assert cfg.dcs_phi == 0.5            # ceres_error.cpp:185
    assert cfg.huber_delta == 0.01       # main.cpp:68
    assert cfg.sc_prior_lambda == 1.0    # main.cpp:107
    assert cfg.max_iterations == 50      # Ceres default


def test_solver_config_hashable_and_replace():
    cfg = SolverConfig()
    assert hash(cfg) == hash(SolverConfig())
    cfg2 = cfg.replace(dcs_phi=1.0)
    assert cfg2.dcs_phi == 1.0 and cfg.dcs_phi == 0.5
    assert hash(cfg2) != hash(cfg)


def test_run_logger_dual_sink(tmp_path, capsys):
    path = tmp_path / "run.log"
    with RunLogger(str(path)) as log:
        log.log("solve", cost=1.23456789, iters=7)
        log.log("note", "free text", flag=True)
    out = capsys.readouterr().out
    text = path.read_text()
    for sink in (out, text):
        assert "[solve] cost=1.234568 iters=7" in sink
        assert "[note] free text flag=True" in sink
    # Tagged-line format is grep-able: every line starts with [tag].
    assert all(re.match(r"^\[\w+\]", line) for line in text.splitlines())


def test_solve_report_fields_and_termination(tmp_path):
    """FullReport analog (main.cpp:164): every CLI/global solve ends with a
    [report] line carrying termination type, step accounting and (opted-in)
    per-stage timings."""
    import numpy as np

    from slam_tpu.config import RunConfig, SolverConfig
    from slam_tpu.io import g2o
    from slam_tpu.methods.global_solve import run_global_solve
    from slam_tpu.utils.logging import RunLogger

    g = g2o.load_g2o(g2o.find_dataset("CSAIL"))
    cfg = RunConfig(
        dataset="CSAIL", method=1, report_stages=True,
        solver=SolverConfig(max_iterations=8),
    )
    logpath = tmp_path / "run.log"
    logger = RunLogger(str(logpath), echo=False)
    run_global_solve(g, cfg, logger)
    logger.close()
    report_lines = [
        line for line in logpath.read_text().splitlines()
        if line.startswith("[report]")
    ]
    assert len(report_lines) == 1
    line = report_lines[0]
    for field in ("termination=", "accepted_steps=", "rejected_steps=",
                  "final_trust_lambda=", "t_linearize_s=",
                  "t_linear_solve_s=", "t_retract_cost_s="):
        assert field in line, (field, line)
    assert "NO_CONVERGENCE" in line or "termination=CONVERGENCE" in line


def test_report_termination_classification():
    from slam_tpu.config import SolverConfig
    from slam_tpu.solver.lm import LMResult
    from slam_tpu.solver.report import build_report

    import numpy as np

    def mk(converged, iters, lam):
        return LMResult(
            poses=np.zeros((2, 3)), switches=np.zeros((1,)),
            cost=np.float64(1.0), initial_cost=np.float64(2.0),
            iterations=np.int32(iters), accepted=np.int32(iters - 1),
            converged=np.asarray(converged), lin_iters=np.int32(0),
            final_lambda=np.float64(lam), final_nu=np.float64(2.0),
        )

    cfg = SolverConfig(max_iterations=50)
    assert build_report(mk(True, 12, 1e-6), cfg, 1.0).termination == \
        "CONVERGENCE"
    r = build_report(mk(False, 50, 1e-6), cfg, 1.0)
    assert r.termination == "NO_CONVERGENCE"
    assert "max_iterations" in r.termination_detail
    stall = build_report(mk(False, 50, cfg.max_lambda), cfg, 1.0)
    assert "stalled" in stall.termination_detail
    assert stall.rejected_steps == 1
    assert "Termination:" in stall.text()

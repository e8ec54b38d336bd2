"""Decision-sequence parity check: production method-3/4 managers vs the
Ceres-semantics manager oracle (VERDICT r4 missing #1).

For each target graph this script replays the reference's exact manager
algorithms with short Ceres-semantics LM solves
(``slam_tpu/solver/manager_oracle.py``) and diffs the per-edge decision
stream -- UCT top-k picks, Delta values, split decisions, assignment
targets (method 3); UCT selection, Mahalanobis gate, 3-way split values,
expand/assign actions (method 4) -- against the production managers'
tagged logs (host or fused engines; host==fused is pinned separately in
tests/ and in ``chip_smoke.py``'s method-4 phase).

Targets:
  slice    -- the INTEL prefix slice used by the CPU and GPU method gates
              (~300 nodes, 40 closures + 4 injected): runs the HOST
              managers here (f64 dense on CPU, exact), then diffs.
  intel50  -- INTEL + 50 outliers seed 42 (the canonical round config):
              runs the oracle twins here; production decisions are parsed
              from method3.log/method4.log files produced by CLI runs
              (pass --m3-log/--m4-log, e.g. from the fused engine).

Writes ``results/manager_oracle.json``.

Usage:
  python scripts/manager_oracle_check.py slice
  python scripts/manager_oracle_check.py intel50 --m3-log /tmp/m3/method3.log \
      --m4-log /tmp/m4/method4.log
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

OUT = os.path.join(os.path.dirname(__file__), "..", "results",
                   "manager_oracle.json")


# ---------------------------------------------------------------------------
# Log parsing (RunLogger text format: "[tag] k=v k=v ...")
# ---------------------------------------------------------------------------

def _parse_line(line):
    line = line.strip()
    if not line.startswith("["):
        return None, {}
    tag, _, rest = line[1:].partition("]")
    fields = {}
    for tok in rest.split():
        if "=" in tok:
            k, _, v = tok.partition("=")
            fields[k.rstrip(",")] = v.rstrip(",")
    return tag, fields


def parse_m3_log(lines):
    """Per-edge decision records from a method-3 log (host or fused)."""
    records, cur = [], None
    for line in lines:
        tag, f = _parse_line(line)
        if tag == "uct":
            cur = dict(topk=[int(s.split("(")[0][1:])
                             for s in f["topk"].split(",")],
                       deltas=[], split=False)
        elif tag == "conflict" and cur is not None:
            cur["deltas"].append(float(f["Delta"]))
        elif tag == "split" and cur is not None:
            cur["split"] = True
            cur["child"] = int(f["child_layer"])
        elif tag == "assign" and cur is not None:
            cur["target"] = int(f["to_layer"])
        elif tag == "residual" and cur is not None and "layer" in f:
            cur["ema"] = float(f["ema_now"])
        elif tag == "uct_update" and cur is not None:
            cur["reward"] = float(f["reward"])
            records.append(cur)
            cur = None
    return records


def parse_m4_log(lines):
    """Per-edge decision records from a method-4 log (host or fused)."""
    records, cur = [], None
    for line in lines:
        tag, f = _parse_line(line)
        if tag is not None and tag.startswith("step"):
            if cur is not None:
                records.append(cur)
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
        records.append(cur)
    return records


# ---------------------------------------------------------------------------
# Decision diffs
# ---------------------------------------------------------------------------

def diff_m3(prod, oracle_dec, tau):
    """Compare production records vs Method3Oracle decisions.

    Once ONE decision flips, both managers carry different layer trees, so
    later records are no longer comparable 1:1 -- the pre-divergence
    prefix (``identical_prefix``) plus the margin analysis of the FIRST
    flip is the meaningful parity statement; ``divergences`` counts the
    raw post-cascade record mismatches for completeness."""
    n = min(len(prod), len(oracle_dec))
    divergences = []
    max_ddiff = max_ddiff_pre = 0.0
    min_margin = min_margin_pre = 1e100
    for i in range(n):
        p, o = prod[i], oracle_dec[i]
        same = (p["topk"] == o["topk"] and p["split"] == o["split"]
                and p["target"] == o["target"])
        ddiff = 0.0
        if len(p["deltas"]) == len(o["deltas"]):
            ddiff = max((abs(a - b)
                         for a, b in zip(p["deltas"], o["deltas"])),
                        default=0.0)
            max_ddiff = max(max_ddiff, ddiff)
        margin = abs(o["best_delta"] - tau)
        min_margin = min(min_margin, margin)
        if not divergences:
            max_ddiff_pre = max(max_ddiff_pre, ddiff)
            if same:
                min_margin_pre = min(min_margin_pre, margin)
        if not same:
            divergences.append(dict(
                edge=i, delta_diff=ddiff, split_margin=margin,
                prod={k: p.get(k) for k in
                      ("topk", "split", "target", "deltas")},
                oracle={k: o.get(k) for k in
                        ("topk", "split", "target", "deltas")}))
    return dict(
        edges=n, count_mismatch=len(prod) != len(oracle_dec),
        identical_prefix=(divergences[0]["edge"] if divergences else n),
        divergences=len(divergences),
        first_divergence=divergences[0] if divergences else None,
        max_delta_diff=max_ddiff,
        max_delta_diff_pre_divergence=max_ddiff_pre,
        min_split_margin=min_margin,
        min_survived_margin_pre_divergence=min_margin_pre,
    )


def diff_m4(prod, oracle_dec, tau):
    """See ``diff_m3`` on cascade semantics."""
    n = min(len(prod), len(oracle_dec))
    divergences = []
    max_rdiff = max_svdiff = 0.0
    min_gate_margin = min_split_margin = 1e100
    for i in range(n):
        p, o = prod[i], oracle_dec[i]
        same = p["action"] == o["action"] and (
            p["action"] == "skip"
            or p.get("selected") in (o.get("selected"), o.get("child")))
        max_rdiff = max(max_rdiff, abs(p.get("residual", 0.0)
                                       - o.get("residual", 0.0)))
        if "split_value" in p and "split_value" in o:
            max_svdiff = max(max_svdiff, abs(p["split_value"]
                                             - o["split_value"]))
            min_split_margin = min(min_split_margin,
                                   abs(o["split_value"] - tau))
        min_gate_margin = min(min_gate_margin,
                              abs(o.get("residual", 1e9) - 50.0))
        if not same:
            divergences.append(dict(
                edge=i,
                prod={k: p.get(k) for k in
                      ("action", "selected", "residual", "split_value")},
                oracle={k: o.get(k) for k in
                        ("action", "selected", "child", "residual",
                         "split_value")}))
    return dict(
        edges=n, count_mismatch=len(prod) != len(oracle_dec),
        identical_prefix=(divergences[0]["edge"] if divergences else n),
        divergences=len(divergences),
        first_divergence=divergences[0] if divergences else None,
        max_residual_diff=max_rdiff, max_split_value_diff=max_svdiff,
        min_gate_margin=min_gate_margin,
        min_split_margin=min_split_margin,
    )


# ---------------------------------------------------------------------------
# Graphs
# ---------------------------------------------------------------------------

def intel_slice():
    """Same construction as chip_smoke.intel_prefix_slice."""
    from slam_tpu.graph import PoseGraph
    from slam_tpu.io import g2o

    g = g2o.load_g2o(g2o.find_dataset("INTEL"))
    ij, et = np.asarray(g.edges_ij), np.asarray(g.edge_type)
    closures = np.where(et != 0)[0]
    maxn = int(ij[closures[:40]].max()) + 1
    keep = (ij[:, 0] < maxn) & (ij[:, 1] < maxn)
    sub = PoseGraph(
        poses=np.asarray(g.poses)[:maxn],
        edges_ij=ij[keep],
        edges_meas=np.asarray(g.edges_meas)[keep],
        edges_info=np.asarray(g.edges_info)[keep],
        edge_type=et[keep],
    )
    return sub.add_random_outliers(4, seed=7)


def intel50():
    from slam_tpu.io import g2o
    g = g2o.load_g2o(g2o.find_dataset("INTEL"))
    return g.add_random_outliers(50, seed=42)


def csail50():
    """CSAIL+50 seed 0.  The CLI's `--init auto` picks the PCM-gated
    chordal init on this draw (pcm_trusted=True), so the oracle twins
    must replay from the SAME initialized poses -- the manager algorithm
    is defined relative to its starting map."""
    from slam_tpu.config import RunConfig
    from slam_tpu.io import g2o
    from slam_tpu.solver.init import apply_init
    from slam_tpu.utils.logging import RunLogger

    g = g2o.load_g2o(g2o.find_dataset("CSAIL")).add_random_outliers(
        50, seed=0)
    return apply_init(g, RunConfig(dataset="CSAIL"), RunLogger(echo=False))


# ---------------------------------------------------------------------------
# Runners
# ---------------------------------------------------------------------------

def run_host_managers(graph, tmpdir):
    """Host managers, f64 dense CPU (the exact engine), logs to files."""
    from slam_tpu.config import LayeringConfig, MctsConfig, SolverConfig
    from slam_tpu.methods.layering import LayeringManager
    from slam_tpu.methods.mcts import MctsManager
    from slam_tpu.utils.logging import RunLogger

    solver = SolverConfig(linear_solver="dense", dtype="float64")
    m3_log = os.path.join(tmpdir, "method3.log")
    m4_log = os.path.join(tmpdir, "method4.log")
    LayeringManager(graph, LayeringConfig(), solver,
                    RunLogger(m3_log, echo=False)).run()
    MctsManager(graph, MctsConfig(), solver,
                RunLogger(m4_log, echo=False)).run()
    return m3_log, m4_log


def run_oracles(graph):
    from slam_tpu.config import LayeringConfig, MctsConfig
    from slam_tpu.solver.manager_oracle import Method3Oracle, Method4Oracle

    t0 = time.time()
    m3 = Method3Oracle(graph, LayeringConfig())
    d3 = m3.run()
    t3 = time.time() - t0
    t0 = time.time()
    m4 = Method4Oracle(graph, MctsConfig())
    d4 = m4.run()
    t4 = time.time() - t0
    return (m3, d3, t3), (m4, d4, t4)


def main() -> int:
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

    args = sys.argv[1:]
    targets = [a for a in args if not a.startswith("--")] or ["slice"]
    opts = {a.split("=")[0][2:]: a.split("=", 1)[1]
            for a in args if a.startswith("--") and "=" in a}

    results = {}
    if os.path.exists(OUT):
        with open(OUT) as f:
            results = json.load(f)

    from slam_tpu.config import LayeringConfig, MctsConfig

    tau3 = LayeringConfig().conflict_tau
    tau4 = MctsConfig().conflict_tau

    for target in targets:
        if target == "slice":
            graph = intel_slice()
            import tempfile
            tmpdir = tempfile.mkdtemp()
            m3_log, m4_log = run_host_managers(graph, tmpdir)
            engine = "host-dense-f64-cpu"
        elif target in ("intel50", "csail50"):
            graph = intel50() if target == "intel50" else csail50()
            m3_log = opts.get("m3-log")
            m4_log = opts.get("m4-log")
            engine = "fused-f32 (CLI logs)"
        else:
            raise SystemExit(f"unknown target {target}")

        # --label= stores the cell under a custom key (e.g. the same graph
        # diffed against a --eval-trust-region ceres production run).
        key = opts.get("label", target)
        (m3, d3, t3), (m4, d4, t4) = run_oracles(graph)
        cell = dict(
            graph=target,
            nodes=int(graph.num_nodes),
            candidates=len(d3),
            production_engine=engine,
            oracle_wall_s=dict(m3=round(t3, 1), m4=round(t4, 1)),
            m3_oracle=dict(layers=len(m3.layers),
                           best_layer=m3.best_layer(),
                           assignments=m3.assignments),
            m4_oracle=dict(layers=len(m4.layers),
                           best_layer=m4.best_layer()),
        )
        if m3_log and os.path.exists(m3_log):
            with open(m3_log) as f:
                prod3 = parse_m3_log(f)
            cell["m3_diff"] = diff_m3(prod3, d3, tau3)
        if m4_log and os.path.exists(m4_log):
            with open(m4_log) as f:
                prod4 = parse_m4_log(f)
            cell["m4_diff"] = diff_m4(prod4, d4, tau4)
        results[key] = cell
        print(json.dumps(cell, indent=1, default=str)[:2000])

    with open(OUT, "w") as f:
        json.dump(results, f, indent=1, default=str)
    print("wrote", OUT)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

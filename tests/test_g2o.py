"""Ingestion tests: dataset stats match the reference's published counts,
round-trips, outlier injection, writer formats."""

import os

import numpy as np
import pytest

from slam_tpu.graph import BOGUS_EDGE, CLOSURE_EDGE, ODOMETRY_EDGE
from slam_tpu.io import g2o

_REPO = os.path.join(os.path.dirname(__file__), "..")
_REPLAY = os.path.join(_REPO, "results", "replay")


def test_intel_counts():
    """``docs/INTEL/info.txt``: 1228 nodes, 1227 odometry, 256 closures."""
    g = g2o.load_g2o(g2o.find_dataset("INTEL"))
    assert g.num_nodes == 1228
    assert g.num_odometry == 1227
    assert g.num_closure == 256
    assert g.num_bogus == 0


def test_csail_vertex2_dialect():
    """CSAIL (the reference ships it in the older VERTEX2/EDGE2 dialect,
    ``g2o_util.h:37,50``; recovered here as VERTEX_SE2):
    ``docs/CSAIL/info.txt``: 1045 nodes, 1044 odometry, 128 closures."""
    g = g2o.load_g2o(g2o.find_dataset("CSAIL"))
    assert g.num_nodes == 1045
    assert g.num_odometry == 1044
    assert g.num_closure == 128


def test_m3500_counts():
    g = g2o.load_g2o(g2o.find_dataset("M3500"))
    assert g.num_nodes == 3500
    assert g.num_edges == 5453


def test_m3500_variants():
    """M3500b/M3500c (named by ``main.cpp:23`` but not shipped): same
    topology as M3500, extra odometry-rotation noise, initial guess
    re-integrated from the corrupted chain (so it drifts from M3500's)."""
    base = g2o.load_g2o(g2o.find_dataset("M3500"))
    for name in ("M3500b", "M3500c"):
        v = g2o.load_g2o(g2o.find_dataset(name))
        assert v.num_nodes == base.num_nodes
        assert v.num_edges == base.num_edges
        np.testing.assert_array_equal(v.edges_ij, base.edges_ij)
        odo = v.edge_type == ODOMETRY_EDGE
        # Rotations perturbed, translations untouched.
        assert np.abs(v.edges_meas[odo, 2] - base.edges_meas[odo, 2]).max() > 0.01
        np.testing.assert_allclose(
            v.edges_meas[odo, :2], base.edges_meas[odo, :2], atol=1e-12
        )
        assert np.abs(v.poses - base.poses).max() > 1.0


@pytest.mark.parametrize("replay", sorted(
    f for f in os.listdir(_REPLAY) if f.endswith(".g2o")
    and not f.startswith("sphere")))
def test_recovered_dataset_reinjects_to_replay(tmp_path, replay):
    """data/{INTEL,CSAIL,M3500}.g2o are the replay files minus their bogus
    tail: re-injecting with the replay's count and seed must give the
    replay file back bit for bit."""
    name, count, seed = replay[:-len(".g2o")].split("_")
    g = g2o.load_g2o(g2o.find_dataset(name))
    out = tmp_path / replay
    g2o.write_g2o(str(out), g.add_random_outliers(
        int(count[:-len("out")]), seed=int(seed[len("seed"):])))
    with open(os.path.join(_REPLAY, replay), "rb") as f:
        assert out.read_bytes() == f.read()


@pytest.mark.parametrize("name", ["INTEL", "CSAIL", "M3500"])
def test_generate_datasets_recovers_committed_file(name):
    """scripts/generate_datasets.py reproduces the committed data file."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "generate_datasets",
        os.path.join(_REPO, "scripts", "generate_datasets.py"))
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    replay, n = gen.RECOVERED[name]
    text = gen.recover_from_replay(os.path.join(_REPLAY, replay), n)
    with open(g2o.find_dataset(name)) as f:
        assert f.read() == text


def test_odometry_classification_rule():
    """|a-b| < 5 => odometry (``g2o_util.h:68``)."""
    g = g2o.load_g2o(g2o.find_dataset("INTEL"))
    gap = np.abs(g.edges_ij[:, 0] - g.edges_ij[:, 1])
    assert np.all(gap[g.edge_type == ODOMETRY_EDGE] < 5)
    assert np.all(gap[g.edge_type == CLOSURE_EDGE] >= 5)


def test_outlier_injection(circle):
    graph, _ = circle
    g = graph.add_random_outliers(25, seed=3)
    assert g.num_bogus == 25
    assert g.num_edges == graph.num_edges + 25
    bogus = g.edge_type == BOGUS_EDGE
    a, b = g.edges_ij[bogus, 0], g.edges_ij[bogus, 1]
    assert np.all(a != b), "no self loops (g2o_util.h:160-163)"
    # Fixed info diag(2, 300, 300) (g2o_util.h:168).
    np.testing.assert_allclose(
        g.edges_info[bogus],
        np.tile([2.0, 0, 0, 300.0, 0, 300.0], (25, 1)),
    )
    # Determinism under the same seed.
    g2 = graph.add_random_outliers(25, seed=3)
    np.testing.assert_array_equal(g.edges_ij, g2.edges_ij)
    # Different under another seed.
    g3 = graph.add_random_outliers(25, seed=4)
    assert not np.array_equal(g.edges_ij, g3.edges_ij)


def test_g2o_roundtrip(tmp_path, circle):
    graph, _ = circle
    graph = graph.add_random_outliers(5, seed=1)
    path = tmp_path / "round.g2o"
    g2o.write_g2o(str(path), graph)
    back = g2o.load_g2o(str(path))
    ref = graph.canonical_order()
    assert back.num_nodes == ref.num_nodes
    np.testing.assert_allclose(back.poses, ref.poses, atol=1e-12)
    np.testing.assert_array_equal(back.edges_ij, ref.edges_ij)
    np.testing.assert_allclose(back.edges_meas, ref.edges_meas, atol=1e-12)
    # Bogus edges come back classified closure vs bogus -- the distinction
    # is injection metadata, not part of the g2o format.
    assert back.num_odometry == ref.num_odometry


def test_writers_reference_format(tmp_path, circle):
    graph, _ = circle
    nodes = tmp_path / "init_nodes.txt"
    edges = tmp_path / "init_edges.txt"
    g2o.write_nodes(str(nodes), graph.poses)
    g2o.write_edges(str(edges), graph)

    arr = np.loadtxt(nodes)
    assert arr.shape == (graph.num_nodes, 4)  # index x y theta
    np.testing.assert_allclose(arr[:, 0], np.arange(graph.num_nodes))
    np.testing.assert_allclose(arr[:, 1:], graph.poses, atol=1e-15)

    earr = np.loadtxt(edges, dtype=int)
    assert earr.shape == (graph.num_edges, 3)  # a b type
    # Canonical order: odometry first (matching write_edges order,
    # g2o_util.h:109-111).
    assert list(earr[:, 2]) == sorted(earr[:, 2])

    back = g2o.load_nodes(str(nodes))
    np.testing.assert_allclose(back, graph.poses, atol=1e-15)


def test_switches_writer(tmp_path, circle):
    graph, _ = circle
    g = graph.add_random_outliers(3, seed=0)
    n_loop = g.num_closure + g.num_bogus
    priors = np.ones(n_loop)
    opt = np.linspace(0.0, 1.0, n_loop)
    path = tmp_path / "switches.txt"
    g2o.write_switches(str(path), g, priors, opt)
    text = path.read_text().splitlines()
    assert text[0] == "Odometry EDGES AHEAD"
    assert "Closure EDGES AHEAD" in text
    assert "BOGUS EDGES AHEAD" in text
    assert len(text) == 3 + g.num_edges


def test_whitespace_tolerant_parsing(tmp_path):
    """The reference tokenises with boost token_compress_on
    (``g2o_util.h:36``): runs of spaces collapse.  Both our parsers must
    accept double-spaced and tab-ish formatting."""
    path = tmp_path / "ws.g2o"
    path.write_text(
        "VERTEX_SE2 0  0.0 0.0  0.0\n"
        "VERTEX_SE2  1 1.0  0.0 0.1\n"
        "EDGE_SE2 0 1  1.0 0.0  0.1  1 0 0  1 0 1\n"
    )
    for use_native in (False, True):
        from slam_tpu.io import native
        if use_native and not native.available():
            continue
        g = g2o.load_g2o(str(path), use_native=use_native)
        assert g.num_nodes == 2 and g.num_edges == 1
        np.testing.assert_allclose(g.poses[1], [1.0, 0.0, 0.1])
        np.testing.assert_allclose(g.edges_meas[0], [1.0, 0.0, 0.1])


def test_unknown_records_ignored(tmp_path):
    """Unknown g2o record types are skipped (the reference's if-chain simply
    never matches them)."""
    path = tmp_path / "mixed.g2o"
    path.write_text(
        "# a comment line\n"
        "VERTEX_SE2 0 0 0 0\n"
        "FIXED 0\n"
        "VERTEX_SE2 1 1 0 0\n"
        "EDGE_SE2 0 1 1 0 0 1 0 0 1 0 1\n"
        "EQUIV 0 1\n"
    )
    for use_native in (False, True):
        from slam_tpu.io import native
        if use_native and not native.available():
            continue
        g = g2o.load_g2o(str(path), use_native=use_native)
        assert g.num_nodes == 2 and g.num_edges == 1

"""g2o text-format ingestion and the reference-compatible ``save/`` writers.

Replaces ``ReadG2O`` (``DCS-ceres/include/g2o_util.h:23-89``)
and its writers (``g2o_util.h:93-148``).  The parser handles both dialects the
reference accepts: ``VERTEX_SE2``/``EDGE_SE2`` and the older
``VERTEX2``/``EDGE2`` (CSAIL), plus ``VERTEX_SE3:QUAT``/``EDGE_SE3:QUAT`` for
3D graphs (sphere2500 class), which the reference names but cannot parse.

Fast path: the C++ tokenizer (``native/g2o_io.cpp``, bound in
``io/native.py``) is the default when built -- single pass, strtod in place,
M3500 in ~10 ms.  The NumPy tokenizer here is the portable fallback with
identical output (tested equal).

Writers emit the exact ``save/*.txt`` formats of the reference so its plotting
and evaluation sidecars work unchanged.
"""

from __future__ import annotations

import io
import os
import pathlib

import numpy as np

from slam_tpu.graph import (
    BOGUS_EDGE,
    CLOSURE_EDGE,
    ODOMETRY_EDGE,
    ODOMETRY_INDEX_GAP,
    PoseGraph,
)

_VERTEX2_TAGS = ("VERTEX_SE2", "VERTEX2")
_EDGE2_TAGS = ("EDGE_SE2", "EDGE2")
_VERTEX3_TAG = "VERTEX_SE3:QUAT"
_EDGE3_TAG = "EDGE_SE3:QUAT"

#: Search path for named datasets: ``$SLAM_TPU_DATA`` if set, then the
#: repo's ``data/`` (written by ``scripts/generate_datasets.py``).
DATA_SEARCH_PATHS = [
    os.environ.get("SLAM_TPU_DATA", ""),
    str(pathlib.Path(__file__).resolve().parents[2] / "data"),
]


def find_dataset(name: str) -> str:
    """Resolve a dataset name (e.g. ``INTEL``) to a ``.g2o`` path."""
    if os.path.isfile(name):
        return name
    fname = name if name.endswith(".g2o") else name + ".g2o"
    for base in DATA_SEARCH_PATHS:
        if not base:
            continue
        cand = os.path.join(base, fname)
        if os.path.isfile(cand):
            return cand
    raise FileNotFoundError(
        f"dataset {name!r} not found in {[p for p in DATA_SEARCH_PATHS if p]}"
    )


def _parse_records(text: str, tag: str, ncols: int) -> np.ndarray:
    """Extract all lines starting with ``tag`` into an (R, ncols) float array."""
    rows = []
    tag_sp = tag + " "
    for line in text.splitlines():
        if line.startswith(tag_sp) or line.rstrip() == tag:
            rows.append(line[len(tag):])
    if not rows:
        return np.empty((0, ncols))
    return np.loadtxt(
        io.StringIO("\n".join(rows)), dtype=np.float64, ndmin=2
    )[:, :ncols]


def load_g2o(path: str, use_native: bool | None = None) -> PoseGraph:
    """Parse a 2D or 3D g2o file into a :class:`PoseGraph`.

    2D edges are classified odometry vs closure with the reference's
    ``|a-b| < 5`` rule (``g2o_util.h:68``); vertices are assumed densely
    indexed from 0 (as the reference assumes via ``nNodes[a_indx]``).

    ``use_native`` selects the C++ tokenizer (``native/g2o_io.cpp``); the
    default tries native and falls back to the NumPy parser (identical
    output, tested equal).
    """
    if use_native is not False:
        from slam_tpu.io import native as _native

        arrays = None
        try:
            arrays = _native.parse_g2o_arrays(path)
        except FileNotFoundError:
            raise
        except Exception:
            if use_native:  # explicitly requested
                raise
        if arrays is not None:
            return _graph_from_native(arrays, path)
        if use_native:
            raise RuntimeError("native g2o parser unavailable")

    with open(path) as f:
        text = f.read()

    if _VERTEX3_TAG in text:
        return _load_g2o_se3(text)

    verts = np.concatenate(
        [_parse_records(text, tag, 4) for tag in _VERTEX2_TAGS], axis=0
    )
    edges = np.concatenate(
        [_parse_records(text, tag, 11) for tag in _EDGE2_TAGS], axis=0
    )
    if verts.shape[0] == 0:
        raise ValueError(f"no 2D vertices found in {path}")

    order = np.argsort(verts[:, 0], kind="stable")
    verts = verts[order]
    poses = verts[:, 1:4]

    ij = edges[:, 0:2].astype(np.int32)
    meas = edges[:, 2:5]
    info = edges[:, 5:11]
    etype = np.where(
        np.abs(ij[:, 0] - ij[:, 1]) < ODOMETRY_INDEX_GAP,
        ODOMETRY_EDGE,
        CLOSURE_EDGE,
    ).astype(np.int8)

    return PoseGraph(
        poses=poses,
        edges_ij=ij,
        edges_meas=meas,
        edges_info=info,
        edge_type=etype,
    ).canonical_order()


def _graph_from_native(arrays, path: str) -> PoseGraph:
    """Assemble a PoseGraph from native-parsed record arrays."""
    v2, e2, v3, e3 = (arrays[k] for k in ("v2", "e2", "v3", "e3"))
    if v3.shape[0] > 0:
        order = np.argsort(v3[:, 0], kind="stable")
        v3 = v3[order]
        poses = np.concatenate([v3[:, 1:4], v3[:, 7:8], v3[:, 4:7]], 1)
        ij = e3[:, 0:2].astype(np.int32)
        meas = np.concatenate([e3[:, 2:5], e3[:, 8:9], e3[:, 5:8]], 1)
        info = e3[:, 9:30]
    elif v2.shape[0] > 0:
        order = np.argsort(v2[:, 0], kind="stable")
        v2 = v2[order]
        poses = v2[:, 1:4]
        ij = e2[:, 0:2].astype(np.int32)
        meas = e2[:, 2:5]
        info = e2[:, 5:11]
    else:
        raise ValueError(f"no vertices found in {path}")
    etype = np.where(
        np.abs(ij[:, 0] - ij[:, 1]) < ODOMETRY_INDEX_GAP,
        ODOMETRY_EDGE,
        CLOSURE_EDGE,
    ).astype(np.int8)
    return PoseGraph(
        poses=poses, edges_ij=ij, edges_meas=meas, edges_info=info,
        edge_type=etype,
    ).canonical_order()


def _load_g2o_se3(text: str) -> PoseGraph:
    """Parse a 3D ``VERTEX_SE3:QUAT`` graph (sphere2500 class)."""
    verts = _parse_records(text, _VERTEX3_TAG, 8)
    # EDGE_SE3:QUAT: a b x y z qx qy qz qw + 21 upper-tri info entries
    edges = _parse_records(text, _EDGE3_TAG, 30)
    order = np.argsort(verts[:, 0], kind="stable")
    verts = verts[order]
    # store as [x y z qw qx qy qz]
    poses = np.concatenate([verts[:, 1:4], verts[:, 7:8], verts[:, 4:7]], 1)
    ij = edges[:, 0:2].astype(np.int32)
    meas = np.concatenate([edges[:, 2:5], edges[:, 8:9], edges[:, 5:8]], 1)
    info = edges[:, 9:30]
    etype = np.where(
        np.abs(ij[:, 0] - ij[:, 1]) < ODOMETRY_INDEX_GAP,
        ODOMETRY_EDGE,
        CLOSURE_EDGE,
    ).astype(np.int8)
    return PoseGraph(
        poses=poses,
        edges_ij=ij,
        edges_meas=meas,
        edges_info=info,
        edge_type=etype,
    ).canonical_order()


# ---------------------------------------------------------------------------
# save/*.txt writers (format-compatible with the reference's outputs so that
# drawer/plot_results.py and external eval tooling work on either system).
# ---------------------------------------------------------------------------

def write_nodes(path: str, poses: np.ndarray) -> None:
    """``init_nodes.txt`` / ``opt_nodes.txt`` format: ``index x y theta``.

    Matches ``writePoseGraph_nodes`` (``g2o_util.h:93-102``).  For SE(3)
    poses, all components are written after the index.  Uses the native C++
    writer when built; NumPy fallback otherwise.
    """
    poses = np.asarray(poses, np.float64)
    from slam_tpu.io import native as _native
    if _native.write_nodes_native(path, poses):
        return
    idx = np.arange(poses.shape[0])[:, None]
    np.savetxt(path, np.concatenate([idx, poses], axis=1), fmt="%.18g")


def write_edges(path: str, graph: PoseGraph) -> None:
    """``init_edges.txt`` format: ``a b edge_type`` per line.

    Matches ``writePoseGraph_edges`` (``g2o_util.h:104-112``); the canonical
    edge order already reproduces the odometry/closure/bogus grouping.
    """
    g = graph.canonical_order()
    arr = np.concatenate(
        [g.edges_ij, g.edge_type[:, None].astype(np.int32)], axis=1
    )
    np.savetxt(path, arr, fmt="%d")


def write_switches(
    path: str, graph: PoseGraph, priors: np.ndarray, optimized: np.ndarray
) -> None:
    """``switches.txt`` with the reference's three sections
    (``g2o_util.h:114-148``): odometry rows carry (1.0, 1.0); closure and
    bogus rows carry (prior, optimized switch value)."""
    g = graph.canonical_order()
    lines = ["Odometry EDGES AHEAD"]
    k = 0
    for sec, title in (
        (ODOMETRY_EDGE, None),
        (CLOSURE_EDGE, "Closure EDGES AHEAD"),
        (BOGUS_EDGE, "BOGUS EDGES AHEAD"),
    ):
        if title is not None:
            lines.append(title)
        mask = g.edge_type == sec
        for a, b, t in zip(
            g.edges_ij[mask, 0], g.edges_ij[mask, 1], g.edge_type[mask]
        ):
            if sec == ODOMETRY_EDGE:
                lines.append(f"{a} {b} {t} 1 1")
            else:
                lines.append(f"{a} {b} {t} {priors[k]:.17g} {optimized[k]:.17g}")
                k += 1
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def load_nodes(path: str) -> np.ndarray:
    """Read a ``*_nodes.txt`` file back into an ``(N, D)`` pose array."""
    arr = np.loadtxt(path, ndmin=2)
    order = np.argsort(arr[:, 0], kind="stable")
    return arr[order, 1:]


def write_g2o(path: str, graph: PoseGraph) -> None:
    """Serialise a PoseGraph back to g2o (2D SE2 or 3D SE3:QUAT) -- for
    replaying injected outlier sets through other systems (SURVEY §7
    'Nondeterministic reference') and for generating datasets."""
    g = graph.canonical_order()
    with open(path, "w") as f:
        if g.dim == 7:
            # storage [x y z qw qx qy qz] -> file order x y z qx qy qz qw
            for i, p in enumerate(g.poses):
                f.write(
                    "VERTEX_SE3:QUAT "
                    f"{i} {p[0]:.17g} {p[1]:.17g} {p[2]:.17g} "
                    f"{p[4]:.17g} {p[5]:.17g} {p[6]:.17g} {p[3]:.17g}\n"
                )
            for (a, b), m, info in zip(g.edges_ij, g.edges_meas, g.edges_info):
                vals = " ".join(
                    f"{v:.17g}"
                    for v in (m[0], m[1], m[2], m[4], m[5], m[6], m[3], *info)
                )
                f.write(f"EDGE_SE3:QUAT {a} {b} {vals}\n")
            return
        for i, p in enumerate(g.poses):
            f.write(f"VERTEX_SE2 {i} {p[0]:.17g} {p[1]:.17g} {p[2]:.17g}\n")
        for (a, b), m, info in zip(g.edges_ij, g.edges_meas, g.edges_info):
            vals = " ".join(f"{v:.17g}" for v in (*m, *info))
            f.write(f"EDGE_SE2 {a} {b} {vals}\n")

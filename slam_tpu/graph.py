"""Array-based pose-graph data model.

The reference stores the graph as heap-allocated ``Node``/``Edge`` objects
with raw ``double[3]`` parameter blocks that Ceres mutates in place
(``DCS-ceres/include/graph.h:4-56``).  An accelerator solver
wants the opposite: a fixed-topology, structure-of-arrays graph whose solve is
a pure function of ``(static arrays, pose array, hyperparams)``.  This module
is the host-side (NumPy) container; device code receives plain arrays.

Edge ordering is canonical: all odometry edges, then closure edges, then
bogus edges -- the same order the reference writes them
(``g2o_util.h:104-112``), so indices line up across systems.

Edge types follow ``g2o_util.h:14-16``: 0=odometry, 1=closure, 2=bogus.
"""

from __future__ import annotations

import dataclasses

import numpy as np

ODOMETRY_EDGE = 0
CLOSURE_EDGE = 1
BOGUS_EDGE = 2

#: An edge (i, j) is odometry iff |i - j| < ODOMETRY_INDEX_GAP, else closure
#: (``g2o_util.h:68``).
ODOMETRY_INDEX_GAP = 5


@dataclasses.dataclass
class PoseGraph:
    """SE(2) (or SE(3)) pose graph as structure-of-arrays.

    Attributes
    ----------
    poses:  ``(N, D)`` float64 initial/current poses.  D=3 for SE(2)
            ``[x, y, theta]``; D=7 for SE(3) ``[x, y, z, qw, qx, qy, qz]``.
    edges_ij:  ``(E, 2)`` int32 endpoint indices ``(a, b)``.
    edges_meas:  ``(E, M)`` float64 measured relative pose (M=D for SE(2),
            M=7 for SE(3)).
    edges_info:  ``(E, K)`` float64 upper-triangular information entries
            (K=6: I11 I12 I13 I22 I23 I33 for SE(2); K=21 for SE(3)).
    edge_type:  ``(E,)`` int8 with values {0, 1, 2}.
    """

    poses: np.ndarray
    edges_ij: np.ndarray
    edges_meas: np.ndarray
    edges_info: np.ndarray
    edge_type: np.ndarray

    def __post_init__(self) -> None:
        self.poses = np.asarray(self.poses, dtype=np.float64)
        self.edges_ij = np.asarray(self.edges_ij, dtype=np.int32)
        self.edges_meas = np.asarray(self.edges_meas, dtype=np.float64)
        self.edges_info = np.asarray(self.edges_info, dtype=np.float64)
        self.edge_type = np.asarray(self.edge_type, dtype=np.int8)

    # -- basic counts ------------------------------------------------------
    @property
    def num_nodes(self) -> int:
        return int(self.poses.shape[0])

    @property
    def num_edges(self) -> int:
        return int(self.edges_ij.shape[0])

    @property
    def dim(self) -> int:
        """Pose dimensionality (3 for SE(2), 7 for SE(3))."""
        return int(self.poses.shape[1])

    @property
    def num_odometry(self) -> int:
        return int(np.sum(self.edge_type == ODOMETRY_EDGE))

    @property
    def num_closure(self) -> int:
        return int(np.sum(self.edge_type == CLOSURE_EDGE))

    @property
    def num_bogus(self) -> int:
        return int(np.sum(self.edge_type == BOGUS_EDGE))

    # -- mutation ----------------------------------------------------------
    def canonical_order(self) -> "PoseGraph":
        """Return a copy with edges sorted [odometry, closure, bogus].

        Stable within each class, matching the reference's storage split into
        three vectors (``g2o_util.h:174-177``).
        """
        order = np.argsort(self.edge_type, kind="stable")
        return PoseGraph(
            poses=self.poses.copy(),
            edges_ij=self.edges_ij[order],
            edges_meas=self.edges_meas[order],
            edges_info=self.edges_info[order],
            edge_type=self.edge_type[order],
        )

    def with_poses(self, poses: np.ndarray) -> "PoseGraph":
        return dataclasses.replace(self, poses=np.asarray(poses))

    def add_random_outliers(
        self,
        count: int,
        seed: int = 0,
        zero_measurement: bool = False,
    ) -> "PoseGraph":
        """Inject ``count`` bogus loop edges ("Vertigo-style").

        Mirrors ``ReadG2O::add_random_C`` (``g2o_util.h:151-171``): endpoints
        uniform over nodes with self-loops bumped to the next index, fixed
        information diag(2, 300, 300).  The reference seeds with
        ``time(0)`` (``main.cpp:43``); here the PRNG key is explicit so runs
        are reproducible and outlier sets can be replayed across systems.

        The reference's measurement ``rand()/RAND_MAX`` is *integer* division
        and therefore almost surely exactly 0 (see SURVEY §3.2).
        ``zero_measurement=True`` replicates that quirk; the default draws
        uniform [0, 1) as the Vertigo recipe intended.  Either way the edges
        are gross outliers.
        """
        if count <= 0:
            return self
        rng = np.random.default_rng(seed)
        n = self.num_nodes
        a = rng.integers(0, n, size=count)
        b = rng.integers(0, n, size=count)
        collide = a == b
        b = np.where(collide, (b + 1) % n, b)
        if self.dim == 7:
            # SE(3) extension of the recipe: uniform small translation plus
            # a random unit-quaternion rotation; diag information matrix.
            t = (
                np.zeros((count, 3))
                if zero_measurement
                else rng.uniform(0.0, 1.0, size=(count, 3))
            )
            q = rng.normal(size=(count, 4))
            q /= np.linalg.norm(q, axis=1, keepdims=True)
            q[:, 0] = np.abs(q[:, 0])
            meas = np.concatenate([t, q], axis=1)
            info_row = np.zeros(21)
            info_row[[0, 6, 11, 15, 18, 20]] = [2.0, 2.0, 2.0, 300.0, 300.0, 300.0]
            info = np.tile(info_row, (count, 1))
        else:
            if zero_measurement:
                meas = np.zeros((count, 3))
            else:
                meas = rng.uniform(0.0, 1.0, size=(count, 3))
            info = np.tile(
                np.array([2.0, 0.0, 0.0, 300.0, 0.0, 300.0]), (count, 1)
            )
        return PoseGraph(
            poses=self.poses.copy(),
            edges_ij=np.concatenate(
                [self.edges_ij, np.stack([a, b], axis=1).astype(np.int32)]
            ),
            edges_meas=np.concatenate([self.edges_meas, meas]),
            edges_info=np.concatenate([self.edges_info, info]),
            edge_type=np.concatenate(
                [self.edge_type, np.full(count, BOGUS_EDGE, dtype=np.int8)]
            ),
        )

    # -- derived views -----------------------------------------------------
    def info_matrices(self) -> np.ndarray:
        """Dense ``(E, 3, 3)`` symmetric information matrices (SE(2))."""
        i = self.edges_info
        out = np.empty((self.num_edges, 3, 3))
        out[:, 0, 0] = i[:, 0]
        out[:, 0, 1] = out[:, 1, 0] = i[:, 1]
        out[:, 0, 2] = out[:, 2, 0] = i[:, 2]
        out[:, 1, 1] = i[:, 3]
        out[:, 1, 2] = out[:, 2, 1] = i[:, 4]
        out[:, 2, 2] = i[:, 5]
        return out

    def summary(self) -> str:
        return (
            f"PoseGraph(nodes={self.num_nodes}, odometry={self.num_odometry},"
            f" closure={self.num_closure}, bogus={self.num_bogus})"
        )


def classify_edge(a: int, b: int) -> int:
    """Reference's odometry/closure split rule (``g2o_util.h:68``)."""
    return ODOMETRY_EDGE if abs(a - b) < ODOMETRY_INDEX_GAP else CLOSURE_EDGE

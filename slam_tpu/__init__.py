"""slam_tpu: a robust pose-graph SLAM backend in JAX/XLA.

Brand-new implementation of the capabilities of wei-ght/toy-robust-backend-slam
(a Ceres-based 2D robust pose-graph optimizer), redesigned for accelerators:
array-based graphs, batched closed-form residuals/Jacobians, a jitted LM
trust-region loop, dense-Cholesky / block-Jacobi-PCG / partitioned-Schur
linear solvers, and shard_map-distributed execution over device meshes.
"""

__version__ = "0.1.0"

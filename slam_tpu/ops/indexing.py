"""Incidence-matrix (one-hot) gather/scatter -- graph ops as matmuls.

The solver was first built for an accelerator whose general gather/scatter
lowered to slow, serial scalar code.  For pose graphs the index pattern is
static -- the edge list never changes after ingestion -- so every
gather/scatter in the solve can be a multiplication by a constant 0/1
*incidence matrix*:

    gather:   poses[a]            ==  A @ poses        A = onehot(a) (E, N)
    scatter:  segsum(v, a, N)     ==  A.T @ v

These are (E,N)@(N,K) / (N,E)@(E,K) matmuls that fuse with the surrounding
element-wise work.  On the GPU, gather and scatter-add are native XLA ops,
so whether the one-hot form still earns its FLOPs there is open (ROADMAP
D2).

The incidence matrices are built once per graph on the host and carried in
the :class:`~slam_tpu.solver.problem.EdgeSet`.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

Array = jax.Array


def build_incidence(
    idx: np.ndarray, n: int, dtype=jnp.float32
) -> Array:
    """One-hot rows: ``out[e, idx[e]] = 1`` with shape ``(len(idx), n)``."""
    idx = np.asarray(idx)
    out = np.zeros((idx.shape[0], n), dtype=np.float32)
    out[np.arange(idx.shape[0]), idx] = 1.0
    return jnp.asarray(out, dtype)


@jax.jit
def _build_incidence_device(idx: Array, iota_n: Array) -> Array:
    # compare-iota: builds the (E, N) operator on device, so it never
    # crosses the host->device link.
    return (idx[:, None] == iota_n[None, :]).astype(jnp.bfloat16)


def build_incidence_device(idx, n: int) -> Array:
    """Device-side one-hot build, bfloat16 storage.

    For large graphs the host-built f32 one-hots are hundreds of MB and the
    host->device transfer dominates (M10000: ~0.5 GB per operator).  0/1 is
    exactly representable in bfloat16, and the consuming matmuls run at
    ``precision=HIGHEST`` with f32 accumulation, so results are identical
    while storage and bandwidth halve and the transfer disappears.
    """
    idx = jnp.asarray(idx, jnp.int32)
    iota_n = jnp.arange(n, dtype=jnp.int32)
    return _build_incidence_device(idx, iota_n)


def gather(inc: Array, x: Array) -> Array:
    """``x[idx]`` as ``inc @ x`` for ``x (N, ...)`` -> ``(E, ...)``.

    precision='highest' is load-bearing: a reduced-precision f32 matmul
    (bf16 passes, or TF32 on the GPU) would round the gathered values
    themselves.
    """
    flat = x.reshape(x.shape[0], -1)
    out = jnp.matmul(
        inc, flat, precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=flat.dtype,
    )
    return out.reshape((inc.shape[0],) + x.shape[1:])


def scatter_add(inc: Array, v: Array, *_unused) -> Array:
    """``segment_sum(v, idx, N)`` as ``inc.T @ v`` for ``v (E, ...)``."""
    flat = v.reshape(v.shape[0], -1)
    out = jnp.matmul(
        inc.T, flat, precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=flat.dtype,
    )
    return out.reshape((inc.shape[1],) + v.shape[1:])

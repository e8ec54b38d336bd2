"""Shared chunk-loop driver for the fused method-3/4 scan engines.

Runs the per-edge decision scan in fixed-size device calls (each bounded in
wall time, see ``run_chunked``), carrying the layer state on
device between chunks, and optionally checkpointing at every chunk boundary
-- the state is a small pytree, so resume-after-preemption costs one npz
read (the reference has no mid-solve persistence at all, SURVEY §5).
"""

from __future__ import annotations

import hashlib
import os

import jax
import numpy as np


def fingerprint(*arrays, extra: str = "") -> str:
    """Cheap content hash tying a checkpoint to (graph, candidates, config)."""
    h = hashlib.sha256()
    for a in arrays:
        a = np.ascontiguousarray(a)
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    h.update(extra.encode())
    return h.hexdigest()[:16]


# Adaptive chunking (scan_chunk=None): probe at MIN_CHUNK candidates,
# measure the per-candidate device time, then size subsequent chunks to
# fill (but never exceed) a per-call wall-time bound.  Chunk sizes are
# powers of two times MIN_CHUNK so the whole run compiles at most a
# handful of distinct programs (each cached persistently).  Whether the
# bound earns its place on the GPU is open (ROADMAP D4).
MIN_CHUNK = 8
MAX_CHUNK = 128
DEFAULT_DEADLINE_S = 35.0


def _pick_chunk(per_cand_s: float, deadline_s: float) -> int:
    """Largest power-of-two chunk whose predicted wall stays under 80% of
    the deadline (the 20% headroom absorbs state-dependent cost growth,
    e.g. more live layers later in the run)."""
    size = MIN_CHUNK
    while size * 2 <= MAX_CHUNK and per_cand_s * size * 2 <= 0.8 * deadline_s:
        size *= 2
    return size


def run_chunked(
    state,                 # initial scan-state NamedTuple (device arrays)
    chunk_fn,              # _fused_chunk(state, *consts, *xs_chunk, cfg, solver)
    consts: tuple,
    xs_np: list[np.ndarray],   # per-candidate arrays, ALREADY padded
    xs_dtypes: list,
    chunk: int | None,     # None = adaptive (measured, deadline-driven)
    n_live: int,           # true candidate count (pre-padding)
    cfg,
    solver,
    checkpoint_path: str | None = None,
    fp: str = "",
    deadline_s: float | None = None,
    logger=None,
):
    """Returns ``(final_state, outs)`` with ``outs`` host-side, concatenated
    across chunks and truncated to ``n_live``.

    ``chunk=None`` enables the adaptive policy: the first MIN_CHUNK
    candidates are a timed probe (compile excluded via an explicit AOT
    ``lower().compile()`` warm-up), the measured per-candidate time picks
    the steady-state chunk, and any chunk that still runs past 80% of the
    deadline halves the size for the remainder.  An explicit integer chunk
    is honored exactly as given (no halving, no resizing)."""
    import time

    import jax.numpy as jnp

    from slam_tpu.utils.checkpoint import load_checkpoint, save_checkpoint

    total = xs_np[0].shape[0]
    adaptive = chunk is None
    if adaptive:
        if deadline_s is None:
            deadline_s = float(os.environ.get(
                "SLAM_TPU_CHUNK_DEADLINE_S", DEFAULT_DEADLINE_S))
        chunk = MIN_CHUNK
        assert total % MIN_CHUNK == 0
    else:
        assert total % chunk == 0
    done = 0
    outs: list = []

    if checkpoint_path and os.path.exists(checkpoint_path):
        saved, meta = load_checkpoint(checkpoint_path)
        resumable = meta.get("fingerprint") == fp and (
            adaptive or meta.get("done", -1) % chunk == 0
        )
        if resumable:
            done = int(meta.get("done", 0))
            state = type(state)(
                **{k: jnp.asarray(saved[f"s_{k}"])
                   for k in state._fields}
            )
            if done > 0:
                prev = {
                    k[2:]: saved[k] for k in saved if k.startswith("o_")
                }
                outs = [prev] if prev else []

    warmed: set[int] = set()
    probed = not adaptive
    warmup_done = False

    while done < total:
        remaining = total - done
        size = min(chunk, remaining)
        if adaptive and remaining < chunk:
            # Tail: reuse the already-compiled MIN_CHUNK program instead
            # of compiling a one-off remainder size.
            size = MIN_CHUNK
        sl = slice(done, done + size)
        args = (
            state, *consts,
            *[jnp.asarray(x[sl], dt) for x, dt in zip(xs_np, xs_dtypes)],
        )
        if adaptive and size not in warmed and hasattr(chunk_fn, "lower"):
            # Compile outside the timed region so the probe measures
            # execution, not compilation.
            chunk_fn.lower(*args, cfg, solver).compile()
            warmed.add(size)
        t0 = time.perf_counter()
        state, o = chunk_fn(*args, cfg, solver)
        outs.append(jax.device_get(o._asdict()))  # honest barrier
        wall = time.perf_counter() - t0
        done += size

        if adaptive:
            per_cand = wall / size
            if not probed:
                # The FIRST execution can pay one-time costs on top of the
                # (AOT-excluded) compile; sizing from it would pin the
                # whole run at MIN_CHUNK.  Size from the SECOND call
                # instead (the first is treated as warm-up work).
                if warmup_done:
                    probed = True
                    chunk = _pick_chunk(per_cand, deadline_s)
                    if logger is not None:
                        logger.log("chunk", probe_s=round(wall, 3),
                                   per_candidate_s=round(per_cand, 4),
                                   chunk=chunk, deadline_s=deadline_s)
                else:
                    warmup_done = True
                    if logger is not None:
                        logger.log("chunk", warmup_s=round(wall, 3),
                                   note="first-exec device load excluded")
            elif wall > 0.8 * deadline_s and chunk > MIN_CHUNK:
                chunk = max(MIN_CHUNK, chunk // 2)
                if logger is not None:
                    logger.log("chunk", resized=chunk,
                               wall_s=round(wall, 3),
                               deadline_s=deadline_s)

        if checkpoint_path:
            merged = _concat(outs)
            save_checkpoint(
                checkpoint_path,
                {**{f"s_{k}": np.asarray(v)
                    for k, v in jax.device_get(state)._asdict().items()},
                 **{f"o_{k}": v for k, v in merged.items()}},
                meta={"fingerprint": fp, "done": done},
            )
            outs = [merged]

    state = jax.device_get(state)
    merged = _concat(outs)
    merged = {k: v[:n_live] for k, v in merged.items()}
    return state, merged


def _concat(outs: list[dict]) -> dict:
    if len(outs) == 1:
        return outs[0]
    return {
        k: np.concatenate([o[k] for o in outs]) for k in outs[0]
    }


def setup_eval_solver(graph, cfg, solver):
    """Shared fused-engine eval-solver setup (methods 3 and 4).

    Resolves the candidate-eval linear solver, builds the EdgeSet with the
    right incidence tier, the shared Schur partition when applicable, and
    the effective scan chunk.  Returns
    ``(eval_cfg, edges, partition, scan_chunk)``.

    Selection rules:
    * accelerator "auto": exact partitioned Schur (same decisions as the
      PCG eval on INTEL).  With a STATIC scan chunk above ~2k nodes, loose
      PCG keeps each chunk's wall time bounded; under adaptive chunking
      (scan_chunk=None, the default) the chunk runner probes and sizes
      chunks, so the exact eval is used at every graph size.
    * CPU "auto": dense up to ~2k nodes, PCG above.
    * scan_chunk None (the default): adaptive on accelerators -- the chunk
      runner probes, measures, and sizes chunks to the per-call bound
      (run_chunked); static 64 on CPU.  An explicit chunk is honored
      exactly as given.
    """
    import jax
    import jax.numpy as jnp

    from slam_tpu.solver.problem import edge_set_from_graph

    linear = solver.linear_solver
    if linear in ("auto", "schur"):
        if jax.default_backend() != "cpu":
            adaptive = cfg.scan_chunk is None
            linear = ("schur" if graph.num_nodes <= 2048 or adaptive
                      else "pcg")
        else:
            linear = "dense" if graph.num_nodes <= 2048 else "pcg"
    if cfg.eval_linear in ("schur", "pcg", "dense"):
        linear = cfg.eval_linear
    extra = {}
    if linear == "pcg":
        extra = dict(pcg_rtol=cfg.eval_pcg_rtol,
                     pcg_max_iters=cfg.eval_pcg_max_iters)
    scan_chunk = cfg.scan_chunk
    if scan_chunk is None and jax.default_backend() == "cpu":
        scan_chunk = 64
    eval_cfg = solver.replace(
        robust="none", huber_delta=cfg.huber_delta,
        linear_solver=linear,
        trust_region=getattr(cfg, "eval_trust_region", "nielsen"), **extra,
    )
    dtype = jnp.dtype(eval_cfg.dtype)
    # Eval solves are incidence-bandwidth-bound: use the chain-compressed
    # representation on accelerators (see EdgeSet).  The Schur eval takes
    # all topology from the precomputed SchurPartition maps, so it rides
    # the compressed incidence too (global_solve.py does the same); only
    # the dense eval consumes inc_a directly (backend auto handles it).
    if linear == "dense":
        inc = None
    elif jax.default_backend() != "cpu":
        inc = "chain"
    else:
        inc = None
    edges = edge_set_from_graph(graph, dtype=dtype, incidence=inc)
    partition = None
    if linear == "schur":
        from slam_tpu.solver.schur import build_partition, choose_partition
        # Scheme choice (index vs spectral-graph cuts) follows the solver
        # config like global_solve; the BLOCK COUNT stays the explicit
        # eval_schur_blocks knob unless the graph scheme wins, in which
        # case the cost model picks its level too (M3500 candidate evals
        # are separator-bound under index cuts: ns=979 at P=8 vs 298
        # graph -- the measured source of the r4 method-3 wall).
        node_block = None
        nblocks = cfg.eval_schur_blocks
        if getattr(solver, "schur_partition", "index") in ("auto", "graph"):
            nblocks, node_block = choose_partition(
                graph.edges_ij, graph.num_nodes,
                scheme=solver.schur_partition,
            )
            if node_block is None:
                nblocks = cfg.eval_schur_blocks
        partition = build_partition(
            graph.edges_ij, graph.num_nodes, nblocks,
            dtype=dtype, node_block=node_block,
        )
    return eval_cfg, edges, partition, scan_chunk

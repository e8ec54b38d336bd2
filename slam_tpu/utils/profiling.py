"""Profiling / timing utilities.

The reference's only timing artifact is Ceres' ``FullReport()``
(``main.cpp:164``).  Here:

* :class:`Timer` -- wall-clock section timing with device synchronisation
  (``block_until_ready``) so async dispatch doesn't lie.
* :func:`trace` -- context manager around ``jax.profiler`` emitting a
  TensorBoard-loadable trace directory for kernel-level analysis (use the
  traces for structure/attribution, the synced timers for wall numbers).
* :func:`iteration_rate` -- the north-star metric helper: timed steady-state
  LM iterations/s for a solve closure.
"""

from __future__ import annotations

import contextlib
import time

import jax


class Timer:
    def __init__(self):
        self.sections: dict[str, float] = {}

    @contextlib.contextmanager
    def section(self, name: str, sync=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None:
                jax.block_until_ready(sync)
            self.sections[name] = (
                self.sections.get(name, 0.0) + time.perf_counter() - t0
            )

    def report(self) -> str:
        total = sum(self.sections.values()) or 1.0
        lines = ["[timing]"]
        for name, dt in sorted(
            self.sections.items(), key=lambda kv: -kv[1]
        ):
            lines.append(f"  {name:<30s} {dt:8.3f}s  {100*dt/total:5.1f}%")
        return "\n".join(lines)


@contextlib.contextmanager
def trace(logdir: str):
    """``jax.profiler`` trace of everything inside the block."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def iteration_rate(fn, *args, reps: int = 3, iters_per_call: int = 1):
    """Best-of-``reps`` steady-state call rate; ``fn`` must return device
    values (synchronised here).  Returns (iters_per_second, best_wall_s)."""
    out = fn(*args)
    jax.block_until_ready(out)  # compile + warm-up
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn(*args)
        jax.block_until_ready(out)
        best = min(best, time.perf_counter() - t0)
    return iters_per_call / best, best

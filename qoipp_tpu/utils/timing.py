"""Timing & profiling helpers (SURVEY.md §5 "tracing/profiling" analog).

The reference ships steady-clock lambda timers (example/source/timer.hpp:
17-82) and derives MPix/s in its bench (04_bench.cpp:232-233).  Device
work is asynchronous, so device timings wait on the results with
jax.block_until_ready inside the timed region.
"""

from __future__ import annotations

import contextlib
import os
import time
from pathlib import Path
from typing import Callable

# The checkout's own cache directory (listed in .gitignore); a fixed path,
# because the path is part of the cache key.
CHECKOUT_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def compile_cache_dir() -> str:
    """JAX_COMPILATION_CACHE_DIR when set, else the checkout's .jax_cache."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or str(
        CHECKOUT_CACHE_DIR
    )


def enable_compile_cache() -> None:
    """Turn on JAX's persistent compilation cache for the codec programs.

    Honours JAX_COMPILATION_CACHE_DIR (JAX reads it itself, so no path is
    set here then); otherwise the cache lives in the checkout's
    .jax_cache.  Every entry point that may compile (tests, bench, CLI
    tools) calls this so shapes compile once."""
    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", compile_cache_dir())
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)


def time_ms(fn: Callable, runs: int = 5, warmup: int = 1) -> float:
    """Host-side wall-clock of fn() in milliseconds (averaged)."""
    for _ in range(warmup):
        fn()
    t0 = time.perf_counter()
    for _ in range(runs):
        fn()
    return (time.perf_counter() - t0) / runs * 1e3


def device_time_ms(fn: Callable, *args, runs: int = 10) -> float:
    """Warm time of fn(*args) in milliseconds: one untimed call (compile),
    then `runs` dispatches timed on the host clock up to
    jax.block_until_ready of the last result, averaged."""
    import jax

    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(runs):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / runs * 1e3


def mpix_per_s(n_pixels: int, ms: float) -> float:
    """The bench harness's headline unit (04_bench.cpp:232-233)."""
    return n_pixels / (ms * 1e-3) / 1e6 if ms > 0 else float("inf")


@contextlib.contextmanager
def trace(log_dir: str = str(CHECKOUT_CACHE_DIR.parent / "chiprun_out"
                             / "trace")):
    """jax.profiler trace context — open the result with TensorBoard or
    Perfetto to see per-op device timelines."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()

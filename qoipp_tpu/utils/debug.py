"""Debugging & observability helpers (SURVEY.md §5 "sanitizers" analog).

The reference compiles ASan/LSan/UBSan into every test binary
(test/CMakeLists.txt:36-38).  The device-side equivalents collected here:
strict numerics flags and stream introspection (op histograms, chunk statistics) for diagnosing
malformed or adversarial inputs.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Dict

import numpy as np

from ..common import Desc


@contextlib.contextmanager
def strict_numerics():
    """Enable jax_debug_nans/infs for the scope (cheap canary for kernels
    that mix float paths in, e.g. downstream ML consumers)."""
    import jax

    old_nan = jax.config.read("jax_debug_nans")
    old_inf = jax.config.read("jax_debug_infs")
    jax.config.update("jax_debug_nans", True)
    jax.config.update("jax_debug_infs", True)
    try:
        yield
    finally:
        jax.config.update("jax_debug_nans", old_nan)
        jax.config.update("jax_debug_infs", old_inf)


@dataclass
class StreamStats:
    """Per-op chunk census of a QOI stream."""

    desc: Desc
    chunks: int
    pixels: int
    ops: Dict[str, int]
    bytes_total: int

    def __str__(self) -> str:
        parts = ", ".join(f"{k}={v}" for k, v in self.ops.items())
        return (
            f"{self.desc.width}x{self.desc.height}x{int(self.desc.channels)}: "
            f"{self.chunks} chunks -> {self.pixels} px "
            f"({self.bytes_total} B; {parts})"
        )


def inspect_stream(data) -> StreamStats:
    """Decode-free structural census of a QOI stream: chunk count, op
    histogram, pixel total — the observability hook for ingest pipelines
    (detects pathological streams before they hit the batch)."""
    import jax.numpy as jnp

    from ..common import read_header
    from ..ops import boundary

    arr = np.asarray(
        np.frombuffer(bytes(data), np.uint8) if not isinstance(data, np.ndarray)
        else data
    ).reshape(-1)
    desc = read_header(arr).value()
    n_px = desc.width * desc.height
    qb = -(-(arr.size - 14) // boundary.BLOCK) * boundary.BLOCK
    region = np.zeros(qb + 8, np.uint8)
    region[: arr.size - 14] = arr[14:]
    info = boundary.analyze_region(
        jnp.asarray(region[:qb]), jnp.int32(arr.size - 22), jnp.int32(n_px)
    )
    real = np.asarray(info["real"])
    tags = region[:qb][real]
    named_rgb = tags == 0xFE
    named_rgba = tags == 0xFF
    top = tags & 0xC0
    ops = {
        "RGB": int(named_rgb.sum()),
        "RGBA": int(named_rgba.sum()),
        "INDEX": int(((top == 0x00) & ~named_rgb & ~named_rgba).sum()),
        "DIFF": int(((top == 0x40) & ~named_rgb & ~named_rgba).sum()),
        "LUMA": int(((top == 0x80) & ~named_rgb & ~named_rgba).sum()),
        "RUN": int(((top == 0xC0) & ~named_rgb & ~named_rgba).sum()),
    }
    return StreamStats(
        desc=desc,
        chunks=int(info["total_chunks"]),
        pixels=int(info["total_pixels"]),
        ops=ops,
        bytes_total=int(arr.size),
    )

"""Configurable host-to-device staging granularity.

Every engine's big staging upload goes through stage_h2d(), which can
split it into several mid-size transfers plus one device-side
concatenate.  Default is OFF (one-shot jnp.asarray): no measurement has
shown chunking to win.  Configure with set_h2d_chunk_bytes(n) or the
QOIPP_TPU_H2D_CHUNK_BYTES env var.  Whether anything needs this on a
GPU host is ROADMAP C4.

Reference analog: none (the reference reads from host RAM).
"""

from __future__ import annotations

import os

import numpy as np

_chunk_bytes = int(os.environ.get("QOIPP_TPU_H2D_CHUNK_BYTES", "0") or 0)


def set_h2d_chunk_bytes(n: int) -> None:
    """0 disables chunking (one-shot upload, the default)."""
    global _chunk_bytes
    _chunk_bytes = int(n)


def get_h2d_chunk_bytes() -> int:
    return _chunk_bytes


def stage_h2d(arr):
    """Upload a host array to the default device.

    With chunking configured and the array at least 2 chunks big, uploads
    axis-0 slices of ~chunk size and concatenates ON DEVICE (pays one
    dispatch); otherwise a plain one-shot jnp.asarray.  Bit-identical
    either way — only the transport granularity changes."""
    import jax
    import jax.numpy as jnp

    a = np.asarray(arr)
    cb = _chunk_bytes
    if cb <= 0 or a.nbytes < 2 * cb or a.ndim == 0 or a.shape[0] < 2:
        return jnp.asarray(a)
    row_bytes = max(a.nbytes // a.shape[0], 1)
    rows = max(cb // row_bytes, 1)
    pieces = [
        jax.device_put(a[i : i + rows])
        for i in range(0, a.shape[0], rows)
    ]
    if len(pieces) == 1:
        return pieces[0]
    return jnp.concatenate(pieces, axis=0)

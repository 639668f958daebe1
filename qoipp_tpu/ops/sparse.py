"""Sparse data movement for the codec in plain XLA: stream compaction,
encode byte emission and decode pixel placement.

All three are one exclusive prefix sum (or a precomputed offset) plus one
scatter into a flat, row-major index space: per-row offsets lift to
``row * width + offset``, so a whole batch scatters in ONE operation
instead of a vmapped one.  Rows that must not write are sent out of
bounds and dropped.  Every kept element has a distinct target, so the
result is deterministic.

Reference semantics: the encoder's sequential byte emission
(source/simple.cpp:36-95) and the decoder's pixel write-out with OP_RUN
repetition (source/simple.cpp:111-170).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

# Shape buckets.  WIN: output granularity (decode pixel caps and encode
# byte caps round up to it).  BLK: compaction slack (chunk caps keep
# BLK + 128 rows of headroom above the kept count).
WIN = 8192
BLK = 2048


def _flat_targets(offsets, write, width: int):
    """(B, N) per-row offsets -> flat int32 targets into a (B * width,)
    buffer; rows with ~write or an offset outside [0, width) get an
    out-of-bounds target (dropped by mode="drop")."""
    b = offsets.shape[0]
    ok = write & (offsets >= 0) & (offsets < width)
    base = (jnp.arange(b, dtype=jnp.int32) * width)[:, None]
    return jnp.where(ok, base + offsets, b * width)


@partial(jax.jit, static_argnames=("cap",))
def compact_rows(planes, keep, cap: int):
    """Compact kept rows of one or more (B, N) planes to the front.

    planes: tuple of (B, N) arrays sharing one keep mask.
    keep:   (B, N) bool — which rows survive.
    cap:    static output width; kept rows past it are dropped (callers
            detect overflow from counts).

    Returns (tuple of (B, cap) arrays, counts (B,) int32).  Rows at or
    beyond counts[b] are zero.
    """
    b, _ = keep.shape
    keep_i = keep.astype(jnp.int32)
    incl = jnp.cumsum(keep_i, axis=1)
    counts = incl[:, -1]
    flat = _flat_targets(incl - keep_i, keep, cap).reshape(-1)
    outs = tuple(
        jnp.zeros(b * cap, p.dtype)
        .at[flat].set(p.reshape(-1), mode="drop")
        .reshape(b, cap)
        for p in planes
    )
    return outs, counts


@partial(jax.jit, static_argnames=("out_cap",))
def emit_bytes(off, tlo, thn, out_cap: int):
    """Materialize encoded byte streams from compacted chunk rows.

    off: (B, C) int32 — byte offset of each chunk row.
    tlo: (B, C) uint32 — template bytes 0..3, little-endian.
    thn: (B, C) uint32 — template bytes 4..5 in bits 0..15, the row's
         byte count (0..6) in bits 16..18.

    Returns (B, out_cap) uint8: byte k < count of row r lands at
    off[r] + k; positions no row covers read 0.
    """
    b, c = off.shape
    nbytes = (thn >> 16).astype(jnp.int32)
    k = jnp.arange(6, dtype=jnp.int32)
    tlo = tlo[..., None]
    thn = thn[..., None]
    shift = (8 * (k % 4)).astype(jnp.uint32)
    byte = jnp.where(k < 4, tlo >> shift, thn >> shift) & 0xFF
    pos = off[..., None] + k
    flat = _flat_targets(
        pos.reshape(b, c * 6), (k < nbytes[..., None]).reshape(b, c * 6),
        out_cap,
    ).reshape(-1)
    return (
        jnp.zeros(b * out_cap, jnp.uint8)
        .at[flat].set(byte.astype(jnp.uint8).reshape(-1), mode="drop")
        .reshape(b, out_cap)
    )


@partial(jax.jit, static_argnames=("n_cap",))
def place_pixels(pb, emits, n_cap: int):
    """Place chunk emits at their pixel offsets and fill runs.

    pb:    (B, Q) int32 — pixel offset of each row (exclusive prefix sum
           of produced pixels), nondecreasing.  Row r starts a chunk that
           writes iff pb[r + 1] > pb[r] (the last row compares with
           n_cap); rows that must never write carry pb >= n_cap.
    emits: (B, Q) uint32 — the value each row emits (replay output).

    Returns (B, n_cap) uint32: pixel p holds the emit of the last writing
    row with pb <= p (a RUN repeats its chunk's value); pixels before the
    first write read 0.
    """
    b, q = pb.shape
    nxt = jnp.concatenate(
        [pb[:, 1:], jnp.full((b, 1), n_cap, pb.dtype)], axis=1
    )
    rows = jnp.broadcast_to(jnp.arange(q, dtype=jnp.int32), (b, q))
    flat = _flat_targets(pb, nxt > pb, n_cap).reshape(-1)
    src = (
        jnp.full(b * n_cap, -1, jnp.int32)
        .at[flat].set(rows.reshape(-1), mode="drop")
        .reshape(b, n_cap)
    )
    # writing rows have increasing pb, so the last writer at or before p
    # is the running max of the written row index
    src = jax.lax.cummax(src, axis=1)
    got = jnp.take_along_axis(emits, jnp.maximum(src, 0), axis=1)
    return jnp.where(src >= 0, got, jnp.uint32(0))

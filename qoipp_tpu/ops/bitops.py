"""Packed-pixel bit manipulation helpers for the device codec.

Pixels travel through the device pipelines as uint32 words (r | g<<8 |
b<<16 | a<<24) so the 64-entry running index (SURVEY.md §0) is a dense
(lanes, 64) uint32 array — 4x fewer VPU element-ops than a (lanes, 64, 4)
u8 layout — and comparisons/hashes are single-word operations.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

START_PIXEL_PACKED = np.uint32(0xFF000000)  # (0, 0, 0, 255)


def pack_rgba(r, g, b, a):
    """Pack channel bytes (any uint dtype) into uint32 words."""
    r = r.astype(jnp.uint32)
    g = g.astype(jnp.uint32)
    b = b.astype(jnp.uint32)
    a = a.astype(jnp.uint32)
    return r | (g << 8) | (b << 16) | (a << 24)


def unpack_channel(p, c: int):
    """Extract channel c (0=r,1=g,2=b,3=a) as uint32 in [0,255]."""
    return (p >> (8 * c)) & 0xFF


def unpack_rgba(p):
    return tuple(unpack_channel(p, c) for c in range(4))


def hash6(p):
    """QOI running-index hash (3r+5g+7b+11a) % 64 on packed pixels
    (SURVEY.md §0; reference: source/util.hpp:347-351)."""
    r, g, b, a = unpack_rgba(p)
    return (r * 3 + g * 5 + b * 7 + a * 11) & 63


def swar_add_bytes(x, y):
    """Per-byte wraparound addition of two packed uint32 pixel words."""
    lo = ((x & 0x00FF00FF) + (y & 0x00FF00FF)) & 0x00FF00FF
    hi = (((x >> 8) & 0x00FF00FF) + ((y >> 8) & 0x00FF00FF)) & 0x00FF00FF
    return lo | (hi << 8)


def to_int8(x):
    """Reinterpret a uint32 holding a byte value as a signed int32 in
    [-128, 127] (the reference's i8 narrowing casts)."""
    x = x.astype(jnp.int32) & 0xFF
    return ((x + 128) & 0xFF) - 128


def pixels_to_packed(raw, channels: int):
    """(N*channels,) u8 raw buffer -> (N,) packed uint32 (RGB gets a=255)."""
    px = raw.reshape(-1, channels)
    if channels == 4:
        return pack_rgba(px[:, 0], px[:, 1], px[:, 2], px[:, 3])
    a = jnp.full(px.shape[0], 255, dtype=jnp.uint32)
    return pack_rgba(px[:, 0], px[:, 1], px[:, 2], a)


def packed_to_pixels(packed, channels: int):
    """(N,) packed uint32 -> (N*channels,) u8 raw buffer."""
    chans = [unpack_channel(packed, c).astype(jnp.uint8) for c in range(channels)]
    return jnp.stack(chans, axis=-1).reshape(-1)

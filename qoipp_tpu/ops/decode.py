"""Parallel QOI decoder.

Three-pass pipeline (SURVEY.md §7 design stance):

1. *Boundary pass* (ops/boundary.py): tag-length classification + the
   5-phase composed scan locate every chunk start, its pixel output offset
   (prefix sum over per-chunk pixel counts), and the reference's tolerant
   loop bound — exact and fully parallel.

2. *Replay pass* (ops/replay_kernel.py, the production engine): chunk
   fields (class / payload / delta / index-arg) are computed densely at
   EVERY byte position via shifted slices (classify_dense /
   fields_dense_batch — no compaction; non-start positions become NOPs),
   then ONE kernel replays the whole batch, one lane per stream, exact
   for every stream including adversarial ones.

3. *Placement* (ops/sparse.place_pixels): one scatter of each chunk's row
   index at its pixel offset, a running max to fill RUN interiors, and a
   gather of the emitted values.

This module also keeps the scan-engine alternative `decode_bytes`: S
speculative tiles replayed by a T-step lax.scan with transfer-summary
fixpoint reconciliation (bit-exact by induction from tile 0's true
state).  It needs no kernel and powers the sequence-parallel sharded path
(parallel/sharded.py); its fixpoint can take O(S) rounds on INDEX-heavy
data, so the kernel engine is the default.  (A third engine, the Jacobi
dataflow solve, is retired to examples/wave_engine.py.)

The reference decodes all of this with one sequential per-pixel loop
(source/simple.cpp:111-170).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..common import Channels, Desc
from . import boundary
from .bitops import (
    START_PIXEL_PACKED,
    hash6,
    packed_to_pixels,
    swar_add_bytes,
)

# Chunk behavior classes for the replay scan.
NOP, SET, ADD, INDEX, RUN = 0, 1, 2, 3, 4

_START_HASH = (11 * 255) % 64  # hash of the start pixel (0,0,0,255) = 53


def classify_dense(region, qb: int, real):
    """Per-byte-position chunk fields via shifted slices — no gathers.

    region: (qb + 8,) uint8; real: (qb,) bool (non-starts become NOP).
    Returns cls, val, nmask, arg — all (qb,):
      SET:   new = (prev & nmask) | val   (RGB keeps prev alpha)
      ADD:   new = prev +_swar val        (DIFF/LUMA deltas, alpha delta 0)
      INDEX: new = seen[arg]
      RUN:   new = prev, no state update
    """
    tag = region[:qb].astype(jnp.int32)
    b1 = region[1 : qb + 1].astype(jnp.uint32)
    b2 = region[2 : qb + 2].astype(jnp.uint32)
    b3 = region[3 : qb + 3].astype(jnp.uint32)
    b4 = region[4 : qb + 4].astype(jnp.uint32)

    is_rgb = tag == 0xFE
    is_rgba = tag == 0xFF
    top = tag & 0xC0
    named = is_rgb | is_rgba
    is_index = (~named) & (top == 0x00)
    is_diff = (~named) & (top == 0x40)
    is_luma = (~named) & (top == 0x80)

    cls = jnp.where(
        named, SET, jnp.where(is_diff | is_luma, ADD, jnp.where(is_index, INDEX, RUN))
    )
    cls = jnp.where(real, cls, NOP).astype(jnp.int32)

    # SET value/mask: RGBA replaces all four bytes, RGB keeps prev alpha
    # (reference: simple.cpp:119-129 — curr starts as prev).
    set_val = b1 | (b2 << 8) | (b3 << 16) | jnp.where(is_rgba, b4 << 24, 0)
    nmask = jnp.where(is_rgba, jnp.uint32(0), jnp.uint32(0xFF000000))

    # ADD deltas, per-byte mod 256 (reference: simple.cpp:137-155).
    dr_d = ((((tag >> 4) & 3) - 2) & 0xFF).astype(jnp.uint32)
    dg_d = ((((tag >> 2) & 3) - 2) & 0xFF).astype(jnp.uint32)
    db_d = (((tag & 3) - 2) & 0xFF).astype(jnp.uint32)
    diff_delta = dr_d | (dg_d << 8) | (db_d << 16)

    vg = (tag & 0x3F) - 32
    lr = (((vg + ((b1.astype(jnp.int32) >> 4) & 0xF) - 8) & 0xFF)).astype(jnp.uint32)
    lg = (vg & 0xFF).astype(jnp.uint32)
    lb = (((vg + (b1.astype(jnp.int32) & 0xF) - 8) & 0xFF)).astype(jnp.uint32)
    luma_delta = lr | (lg << 8) | (lb << 16)

    val = jnp.where(is_diff, diff_delta, jnp.where(is_luma, luma_delta, set_val))
    arg = jnp.where(is_index, tag & 0x3F, 0).astype(jnp.int32)
    return cls, val.astype(jnp.uint32), nmask, arg


def _replay_step(carry, xs):
    """One chunk step across all tile lanes.  Carry also tracks which state
    components each tile has overwritten (for transfer-summary
    propagation)."""
    prev, seen, pupd, swr = carry  # (S,), (S,64), (S,), (S,64)
    cls, val, nmask, arg = xs

    idx_val = jnp.take_along_axis(seen, arg[:, None], axis=1)[:, 0]
    set_val = (prev & nmask) | val
    add_val = swar_add_bytes(prev, val)

    v = jnp.where(
        cls == SET,
        set_val,
        jnp.where(cls == ADD, add_val, jnp.where(cls == INDEX, idx_val, prev)),
    )
    upd = (cls == SET) | (cls == ADD) | (cls == INDEX)
    prev2 = jnp.where(upd, v, prev)
    h = hash6(v)
    slots = jnp.arange(64, dtype=jnp.int32)
    hot = (slots[None, :] == h[:, None]) & upd[:, None]
    seen2 = jnp.where(hot, v[:, None], seen)
    # ys: the emitted value AND the pre-step prev (= previous chunk's emit,
    # since RUN emits prev) — expansion reconstructs pixels from their
    # difference via a telescoping cumsum.
    return (prev2, seen2, pupd | upd, swr | hot), (v, prev)


def _true_init_row():
    """The decoder's initial state: prev = start pixel; table zero except the
    seeded slot (reference quirk: simple.cpp:108, stream.cpp:306)."""
    prev0 = jnp.uint32(START_PIXEL_PACKED)
    seen0 = (
        jnp.zeros(64, jnp.uint32).at[_START_HASH].set(START_PIXEL_PACKED)
    )
    return prev0, seen0


def _propagate(out_p, out_s, out_pu, out_sw, base_p=None, base_s=None):
    """Exclusive associative overwrite-scan of per-tile transfer summaries:
    returns the bit-exact in-state each tile should have started from,
    assuming the summaries are exact (the fixpoint loop verifies that).
    base_p/base_s: the state entering tile 0 (default: codec initial
    state); pass-through slots read from it."""
    def comb(a, b):
        ap, apu, as_, asw = a
        bp, bpu, bs, bsw = b
        return (
            jnp.where(bpu, bp, ap),
            apu | bpu,
            jnp.where(bsw, bs, as_),
            asw | bsw,
        )

    sp_, spu, ss, ssw = jax.lax.associative_scan(
        comb, (out_p, out_pu, out_s, out_sw), axis=0
    )
    # shift to exclusive (identity = "wrote nothing")
    z1 = jnp.zeros((1,), jnp.uint32)
    zb1 = jnp.zeros((1,), bool)
    z64 = jnp.zeros((1, 64), jnp.uint32)
    zb64 = jnp.zeros((1, 64), bool)
    ep = jnp.concatenate([z1, sp_[:-1]])
    epu = jnp.concatenate([zb1, spu[:-1]])
    es = jnp.concatenate([z64, ss[:-1]])
    esw = jnp.concatenate([zb64, ssw[:-1]])

    if base_p is None:
        base_p, base_s = _true_init_row()
        base_s = base_s[None, :]
    in_p = jnp.where(epu, ep, base_p)
    in_s = jnp.where(esw, es, base_s)
    return in_p, in_s


@partial(jax.jit, static_argnames=("s_tiles", "n_cap"))
def decode_bytes(region, real, produced, pix_before, n_px,
                 s_tiles: int, n_cap: int):
    """Reconstruct pixels from boundary analysis, byte-domain.

    region: (qb + 8,) uint8; real/produced/pix_before: (qb,) from
    boundary.analyze_region; qb % s_tiles == 0.
    Returns (packed_pixels (n_cap,) uint32, filled scalar).
    """
    qb = real.shape[0]
    t_len = qb // s_tiles

    cls, val, nmask, arg = classify_dense(region, qb, real)
    to_tiles = lambda x: x.reshape(s_tiles, t_len).T  # (T, S)
    xs = (to_tiles(cls), to_tiles(val), to_tiles(nmask), to_tiles(arg))

    prev0, seen0 = _true_init_row()

    def replay(in_p, in_s):
        zero_pu = jnp.zeros((s_tiles,), bool)
        zero_sw = jnp.zeros((s_tiles, 64), bool)
        (p, s, pu, sw), ys = jax.lax.scan(
            _replay_step, (in_p, in_s, zero_pu, zero_sw), xs
        )
        return p, s, pu, sw, ys

    def cond(st):
        _, _, done, it = st
        return (~done) & (it < s_tiles + 2)

    def body(st):
        in_p, in_s, _, it = st
        out_p, out_s, out_pu, out_sw, _ = replay(in_p, in_s)
        want_p, want_s = _propagate(out_p, out_s, out_pu, out_sw)
        done = jnp.all(want_p == in_p) & jnp.all(want_s == in_s)
        return want_p, want_s, done, it + 1

    init_p = jnp.full((s_tiles,), START_PIXEL_PACKED, jnp.uint32)
    init_s = jnp.where(
        (jnp.arange(s_tiles) == 0)[:, None], seen0[None, :],
        jnp.zeros((s_tiles, 64), jnp.uint32),
    )
    fin_p, fin_s, _, _ = jax.lax.while_loop(
        cond, body, (init_p, init_s, jnp.array(False), jnp.int32(0))
    )
    _, _, _, _, (emits, prevs) = replay(fin_p, fin_s)  # (T, S) each
    emits_q = emits.T.reshape(-1)  # byte order
    prevs_q = prevs.T.reshape(-1)

    packed = expand_pixels(emits_q, prevs_q, real, produced, pix_before, n_cap)
    filled = jnp.minimum(jnp.sum(produced), n_px)
    return packed, filled


def expand_pixels(emits_q, prevs_q, real, produced, pix_before, n_cap: int):
    """Broadcast per-chunk emitted values onto pixels.

    Each chunk contributes delta = emit - prev_emit (uint32 wraparound) at
    its pixel offset; a mod-2^32 cumsum telescopes back to the absolute
    values, and pixels inside RUN ranges (no chunk start -> delta 0)
    naturally repeat the previous value.  pix_before is nondecreasing over
    byte positions, so the single scatter-add hits XLA's sorted fast path;
    cumsum is a native primitive — no gathers, no O(n) associative_scan
    graphs.
    """
    covers = real & (produced > 0) & (pix_before < n_cap)
    idx = jnp.minimum(pix_before, n_cap)  # keeps monotonicity; slot n_cap = bin
    delta = emits_q - prevs_q  # uint32 wrap; telescopes from START
    vals = jnp.where(covers, delta, 0)
    out0 = (
        jnp.zeros(n_cap + 1, jnp.uint32)
        .at[idx].add(vals, indices_are_sorted=True)[:n_cap]
    )
    return jnp.cumsum(out0) + START_PIXEL_PACKED


# --------------------------------------------------------------------------
# Byte-domain fields for the replay kernel
# --------------------------------------------------------------------------


def fields_dense_batch(regions, real):
    """Byte-domain (uncompacted) kernel fields for a batch: every byte
    position carries its (meta, val); non-chunk positions are NOPs.  No
    scatters at all — for compressed streams the chunk count is close to
    the byte count, so the replay takes the NOP rows instead of a
    compaction pass."""
    from . import classify as cls_ops

    b, qb = real.shape
    kind, (r_abs, g_abs, b_abs, a_abs), (dr, dg, db), arg = jax.vmap(
        lambda reg, re: cls_ops.classify_kinds(reg, qb, re)
    )(regions, real)
    meta = (kind | (arg << 3)).astype(jnp.uint32)
    is_seta = kind == cls_ops.SETA
    is_setc = kind == cls_ops.SETC
    val = jnp.where(
        is_seta,
        r_abs | (g_abs << 8) | (b_abs << 16) | (a_abs << 24),
        jnp.where(
            is_setc,
            r_abs | (g_abs << 8) | (b_abs << 16),
            dr | (dg << 8) | (db << 16),
        ),
    ).astype(jnp.uint32)
    return meta, val


# --------------------------------------------------------------------------
# Host-facing single-image wrapper
# --------------------------------------------------------------------------


def _bucket(n: int, lo: int = 128) -> int:
    n = max(n, lo)
    b = lo
    while b < n:
        b *= 2
    for frac in (3 * b // 4, 7 * b // 8):
        if frac >= n and frac % lo == 0:
            return frac
    return b


def pick_tiles(qb: int) -> int:
    """Tile count for the replay: one tile per ~1KiB of stream, capped at
    512 tiles; must divide qb."""
    s = 1
    while s < 512 and s * 1024 < qb:
        s *= 2
    while qb % s:
        s //= 2
    return max(s, 1)


@partial(jax.jit, static_argnames=("n_cap",))
def _decode_region_kernel(region, real, pix_before, n_cap: int):
    """Single-stream decode through the replay kernel (one lane),
    byte-domain."""
    from . import replay_kernel as rk
    from .sparse import place_pixels

    meta, val = fields_dense_batch(region[None], real[None])
    emits = rk.replay_batch(meta.T, val.T).T
    return place_pixels(pix_before[None], emits, n_cap)[0]


def decode_single(data, desc: Desc, dst_channels: Channels) -> np.ndarray:
    """Decode one QOI stream -> raw bytes, bit-exact incl. the reference's
    tolerant truncated-input behavior (simple.cpp:106-113).

    Runs the replay kernel, which models the chunk state machine
    literally and is exact for every stream (no well-formedness caveats).
    """
    data = np.asarray(data, dtype=np.uint8).reshape(-1)
    size = int(data.size)
    n_px = desc.width * desc.height
    chunks_size = size - 14 - 8

    def run_analysis(qb: int):
        reg = np.zeros(qb + 8, dtype=np.uint8)
        reg[: size - 14] = data[14:]
        reg_j = jnp.asarray(reg)
        info = boundary.analyze_region(
            reg_j[:qb], jnp.int32(chunks_size), jnp.int32(n_px)
        )
        return reg_j, info, qb

    region, info, qb = run_analysis(_bucket(size - 14, boundary.BLOCK))
    total_px = int(info["total_pixels"])
    while total_px < n_px:
        # Tolerant path: zero-fill reads continue producing chunks until the
        # pixel count is satisfied; widen the analysis window until the
        # deficit is covered (each zero byte yields one INDEX chunk = one
        # pixel, so growing by the deficit always terminates).
        region, info, qb = run_analysis(
            _bucket(qb + (n_px - total_px) + 8, boundary.BLOCK)
        )
        total_px = int(info["total_pixels"])

    n_cap = _bucket(n_px, 128)
    packed = _decode_region_kernel(
        region,
        info["real"],
        info["pix_before"],
        n_cap=n_cap,
    )
    raw = packed_to_pixels(packed[:n_px], int(dst_channels))
    return np.asarray(raw)

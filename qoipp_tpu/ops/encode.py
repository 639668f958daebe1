"""Parallel QOI encoder.

The reference encodes with a sequential per-pixel loop carrying (prev pixel,
run counter, 64-entry index table) — reference: source/simple.cpp:36-89.
This module reformulates that loop as dense data-parallel passes with NO
speculation, based on one structural fact about QOI:

  After the encoder processes a differing pixel p, the table slot hash(p)
  ALWAYS holds p — whether the op emitted was INDEX (slot already held p) or
  RGBA/DIFF/LUMA/RGB (slot written at simple.cpp:57).  Run pixels never touch
  the table.  Hence the table contents at any position are a pure function of
  the raw pixel sequence, independent of op decisions — and every op decision
  becomes independently computable:

  * run membership / run-chunk emission: comparisons with the left neighbor
    plus a cummax-based streak count (62-flush arithmetic is closed-form);
  * OP_INDEX: pixel i emits INDEX iff the most recent preceding differing
    pixel with the same hash equals pixel i ("last same-hash predecessor" —
    a 64-slot overwrite scan, computed hierarchically: 64-pixel micro-tile
    pairwise max + an associative scan over micro-tile table summaries);
  * OP_RGBA/DIFF/LUMA/RGB: pure wraparound-int8 arithmetic on (p_i, p_{i-1});
  * byte placement: per-pixel emitted-byte counts -> exclusive prefix sum ->
    one scatter of every emitted byte (no serial emitter).

Output is bit-exact with the reference for every input.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from . import sparse
from .bitops import (
    START_PIXEL_PACKED,
    hash6,
    pack_rgba,
    to_int8,
    unpack_channel,
)

TILE = 64  # micro-tile size for the same-hash-predecessor computation

TAG_RGB = 0xFE
TAG_RGBA = 0xFF
TAG_INDEX = 0x00
TAG_DIFF = 0x40
TAG_LUMA = 0x80
TAG_RUN = 0xC0


def _last_same_hash_value(packed, h, noneq, incoming=None):
    """For each position i: packed value of the most recent j < i with
    noneq[j] and h[j] == h[i]; falls back to `incoming` (the carried
    64-entry table for windowed encoding; default: the zero-initialized
    table) when no such j exists.

    packed/h/noneq: (Nb,) with Nb % TILE == 0.
    """
    nb = packed.shape[0]
    s = nb // TILE
    ph = packed.reshape(s, TILE)
    hh = h.reshape(s, TILE).astype(jnp.int32)
    ne = noneq.reshape(s, TILE)

    j_ids = jnp.arange(TILE, dtype=jnp.int32)

    # Within-tile: last same-hash predecessor via a pairwise masked max —
    # O(TILE) work per pixel, fully parallel (XLA fuses mask into the reduce).
    pair = (
        (hh[:, None, :] == hh[:, :, None])
        & (j_ids[None, None, :] < j_ids[None, :, None])
        & ne[:, None, :]
    )
    lastj = jnp.max(jnp.where(pair, j_ids[None, None, :], -1), axis=2)  # (s, TILE)
    local_found = lastj >= 0
    # value select via one-hot mask-sum (dense compare + masked sum)
    local_hot = lastj[:, :, None] == j_ids[None, None, :]  # (s, TILE, TILE)
    local_val = jnp.sum(
        jnp.where(local_hot, ph[:, None, :], jnp.uint32(0)), axis=2
    )

    # Micro-tile summary: per hash slot, the last differing pixel in the tile.
    slot_ids = jnp.arange(64, dtype=jnp.int32)
    covers = (hh[:, None, :] == slot_ids[None, :, None]) & ne[:, None, :]  # (s,64,TILE)
    tj = jnp.max(jnp.where(covers, j_ids[None, None, :], -1), axis=2)  # (s, 64)
    t_written = tj >= 0
    t_hot = tj[:, :, None] == j_ids[None, None, :]  # (s, 64, TILE)
    t_val = jnp.sum(jnp.where(t_hot, ph[:, None, :], jnp.uint32(0)), axis=2)

    # Cross-tile exclusive overwrite-scan of (value, written) summaries —
    # hand-rolled log-shift forward fill over plain padded slices.
    sv, sw = t_val, t_written
    k = 1
    while k < s:
        zv = jnp.zeros((k, 64), sv.dtype)
        zw = jnp.zeros((k, 64), bool)
        pv = jnp.concatenate([zv, sv[:-k]], axis=0)
        pw = jnp.concatenate([zw, sw[:-k]], axis=0)
        sv = jnp.where(sw, sv, pv)
        sw = sw | pw
        k *= 2
    if incoming is None:
        incoming = jnp.zeros(64, jnp.uint32)  # fresh table reads as packed 0
    inc_v = jnp.concatenate([incoming[None, :], sv[:-1]], axis=0)
    inc_w = jnp.concatenate([jnp.ones((1, 64), bool), sw[:-1]], axis=0)
    incoming = jnp.where(inc_w, inc_v, incoming[None, :])

    # slot lookup per pixel, again as a one-hot mask-sum over the 64 slots
    slot_hot = hh[:, :, None] == slot_ids[None, None, :]  # (s, TILE, 64)
    inc_at_px = jnp.sum(
        jnp.where(slot_hot, incoming[:, None, :], jnp.uint32(0)), axis=2
    )
    return jnp.where(local_found, local_val, inc_at_px).reshape(-1)


def _last_same_hash_value_seg(packed, h, noneq, seg):
    """Segment-aware variant of _last_same_hash_value for PACKED encode
    lanes (many independent streams concatenated in one row domain).

    An entry j is visible to pixel i iff j < i, noneq[j], h[j] == h[i]
    AND seg[j] == seg[i]: a new segment resets the 64-entry table, and
    because seg ids are nondecreasing along the lane, the most recent
    same-hash entry either belongs to i's own segment (visible) or to an
    earlier one (reset -> the fresh table reads packed 0, which is a REAL
    value: pixel {0,0,0,0} INDEX-hits a fresh table, as in the reference's
    zero-initialized seen array).  No reset absorption is needed in the
    cross-tile scan — carrying each entry's seg id and comparing at lookup
    is equivalent, precisely because ids are monotone.
    """
    nb = packed.shape[0]
    s = nb // TILE
    ph = packed.reshape(s, TILE)
    hh = h.reshape(s, TILE).astype(jnp.int32)
    ne = noneq.reshape(s, TILE)
    sg = seg.reshape(s, TILE).astype(jnp.int32)

    j_ids = jnp.arange(TILE, dtype=jnp.int32)

    pair = (
        (hh[:, None, :] == hh[:, :, None])
        & (j_ids[None, None, :] < j_ids[None, :, None])
        & ne[:, None, :]
        & (sg[:, None, :] == sg[:, :, None])
    )
    lastj = jnp.max(jnp.where(pair, j_ids[None, None, :], -1), axis=2)
    local_found = lastj >= 0
    local_hot = lastj[:, :, None] == j_ids[None, None, :]
    local_val = jnp.sum(
        jnp.where(local_hot, ph[:, None, :], jnp.uint32(0)), axis=2
    )

    # per-tile, per-slot summary: last noneq entry (value + its seg id)
    slot_ids = jnp.arange(64, dtype=jnp.int32)
    covers = (hh[:, None, :] == slot_ids[None, :, None]) & ne[:, None, :]
    tj = jnp.max(jnp.where(covers, j_ids[None, None, :], -1), axis=2)
    t_written = tj >= 0
    t_hot = tj[:, :, None] == j_ids[None, None, :]
    t_val = jnp.sum(jnp.where(t_hot, ph[:, None, :], jnp.uint32(0)), axis=2)
    t_seg = jnp.sum(jnp.where(t_hot, sg[:, None, :], 0), axis=2)

    # cross-tile exclusive overwrite fill of (value, seg, written)
    sv, sd, sw = t_val, t_seg, t_written
    k = 1
    while k < s:
        pv = jnp.concatenate([jnp.zeros((k, 64), sv.dtype), sv[:-k]], axis=0)
        pd = jnp.concatenate([jnp.zeros((k, 64), sd.dtype), sd[:-k]], axis=0)
        pw = jnp.concatenate([jnp.zeros((k, 64), bool), sw[:-k]], axis=0)
        sv = jnp.where(sw, sv, pv)
        sd = jnp.where(sw, sd, pd)
        sw = sw | pw
        k *= 2
    inc_v = jnp.concatenate([jnp.zeros((1, 64), sv.dtype), sv[:-1]], axis=0)
    inc_d = jnp.concatenate([jnp.zeros((1, 64), sd.dtype), sd[:-1]], axis=0)
    inc_w = jnp.concatenate([jnp.zeros((1, 64), bool), sw[:-1]], axis=0)

    slot_hot = hh[:, :, None] == slot_ids[None, None, :]
    px_v = jnp.sum(jnp.where(slot_hot, inc_v[:, None, :], jnp.uint32(0)), axis=2)
    px_d = jnp.sum(jnp.where(slot_hot, inc_d[:, None, :], 0), axis=2)
    px_w = jnp.sum(jnp.where(slot_hot, inc_w[:, None, :].astype(jnp.int32), 0),
                   axis=2) > 0
    # incoming entry applies only if it came from THIS pixel's segment;
    # otherwise the table was reset -> fresh slots read packed 0
    fallback = jnp.where(px_w & (px_d == sg), px_v, jnp.uint32(0))
    return jnp.where(local_found, local_val, fallback).reshape(-1)


def _encode_fields(packed, n_px, channels: int,
                   carry_prev=None, carry_run=None, carry_seen=None):
    """Per-pixel op selection + byte templates (vmap-safe: no scatters).

    Optional carried state (windowed streaming encode): carry_prev = prev
    pixel entering the window, carry_run = pending run counter (0..61),
    carry_seen = (64,) table entering the window.  Defaults reproduce the
    start-of-image state.

    Returns (template (Nb,6) u8, nbytes (Nb,) i32, tail (9,) u8,
    has_trail bool) — everything emission needs.
    """
    nb = packed.shape[0]
    idx = jnp.arange(nb, dtype=jnp.int32)
    valid = idx < n_px

    if carry_prev is None:
        carry_prev = jnp.uint32(START_PIXEL_PACKED)
    if carry_run is None:
        carry_run = jnp.uint32(0)
    run0 = carry_run.astype(jnp.int32)

    prev = jnp.concatenate([carry_prev[None].astype(jnp.uint32), packed[:-1]])
    eq_raw = packed == prev
    noneq = valid & ~eq_raw

    # ---- run streaks (reference: simple.cpp:39-49) -----------------------
    # cnt[i] = run-counter value after pixel i; a carried run extends the
    # streak virtually before position 0.
    last_noneq = jax.lax.cummax(
        jnp.where(~(eq_raw | ~valid), idx, -(run0 + 1))
    )
    cnt = idx - last_noneq
    hit62 = eq_raw & valid & (cnt % 62 == 0)  # counter reached the run limit

    cnt_prev = jnp.concatenate([run0[None], cnt[:-1]])
    eq_prev = jnp.concatenate([(run0 > 0)[None], eq_raw[:-1]])
    pend = jnp.where(eq_prev, cnt_prev % 62, 0)  # pending run before pixel i
    flush = noneq & (pend > 0)

    # ---- op selection (reference: simple.cpp:51-79) ----------------------
    h = hash6(packed)
    table_val = _last_same_hash_value(packed, h, noneq, incoming=carry_seen)
    is_index = noneq & (table_val == packed)

    a_cur = unpack_channel(packed, 3)
    a_prev = unpack_channel(prev, 3)
    alpha_changed = a_cur != a_prev
    is_rgba = noneq & ~is_index & alpha_changed if channels == 4 else jnp.zeros(nb, bool)

    dr = to_int8(unpack_channel(packed, 0) - unpack_channel(prev, 0))
    dg = to_int8(unpack_channel(packed, 1) - unpack_channel(prev, 1))
    db = to_int8(unpack_channel(packed, 2) - unpack_channel(prev, 2))
    dr_dg = to_int8((dr - dg).astype(jnp.uint32))
    db_dg = to_int8((db - dg).astype(jnp.uint32))

    in_diff = (
        (dr >= -2) & (dr <= 1) & (dg >= -2) & (dg <= 1) & (db >= -2) & (db <= 1)
    )
    in_luma = (
        (dg >= -32)
        & (dg <= 31)
        & (dr_dg >= -8)
        & (dr_dg <= 7)
        & (db_dg >= -8)
        & (db_dg <= 7)
    )

    rest = noneq & ~is_index & ~is_rgba
    is_diff = rest & in_diff
    is_luma = rest & ~in_diff & in_luma
    is_rgb = rest & ~in_diff & ~in_luma

    own_len = jnp.where(
        is_index,
        1,
        jnp.where(
            is_rgba, 5, jnp.where(is_diff, 1, jnp.where(is_luma, 2, jnp.where(is_rgb, 4, 0)))
        ),
    ).astype(jnp.int32)

    # ---- per-pixel byte templates ---------------------------------------
    r8 = unpack_channel(packed, 0).astype(jnp.uint8)
    g8 = unpack_channel(packed, 1).astype(jnp.uint8)
    b8 = unpack_channel(packed, 2).astype(jnp.uint8)
    a8 = a_cur.astype(jnp.uint8)

    diff_byte = (
        TAG_DIFF | ((dr + 2) << 4) | ((dg + 2) << 2) | (db + 2)
    ).astype(jnp.uint8)
    luma0 = (TAG_LUMA | (dg + 32)).astype(jnp.uint8)
    luma1 = (((dr_dg + 8) << 4) | (db_dg + 8)).astype(jnp.uint8)
    index_byte = (TAG_INDEX | h).astype(jnp.uint8)

    z = jnp.zeros(nb, jnp.uint8)
    first = jnp.select(
        [is_index, is_rgba, is_diff, is_luma, is_rgb],
        [index_byte, jnp.full(nb, TAG_RGBA, jnp.uint8), diff_byte, luma0,
         jnp.full(nb, TAG_RGB, jnp.uint8)],
        z,
    )
    second = jnp.select([is_rgba, is_luma, is_rgb], [r8, luma1, r8], z)
    third = jnp.select([is_rgba, is_rgb], [g8, g8], z)
    fourth = jnp.select([is_rgba, is_rgb], [b8, b8], z)
    fifth = jnp.where(is_rgba, a8, z)
    own = jnp.stack([first, second, third, fourth, fifth], axis=1)  # (Nb, 5)

    run_byte = jnp.where(
        hit62, TAG_RUN | 61, TAG_RUN | ((pend - 1) & 0x3F)
    ).astype(jnp.uint8)
    has_run = hit62 | flush

    shifted = jnp.concatenate([run_byte[:, None], own], axis=1)  # run first
    plain = jnp.concatenate([own, z[:, None]], axis=1)
    template = jnp.where(has_run[:, None], shifted, plain)  # (Nb, 6)

    nbytes = own_len + has_run.astype(jnp.int32)

    # trailing run + end marker bytes (reference: simple.cpp:91-95)
    last = n_px - 1
    trailing = jnp.where(eq_raw[last], cnt[last] % 62, 0)
    has_trail = trailing > 0
    trail_byte = (TAG_RUN | ((trailing - 1) & 0x3F)).astype(jnp.uint8)
    marker = jnp.array([0, 0, 0, 0, 0, 0, 0, 1, 0], dtype=jnp.uint8)
    tail = jnp.where(
        has_trail,
        jnp.concatenate([trail_byte[None], marker[:8]]),
        marker,
    )
    return template, nbytes, tail, has_trail


@partial(jax.jit, static_argnames=("channels",))
def encode_core_scatter(packed, n_px, header, channels: int):
    """Per-pixel scatter emission (single image) — kept as the differential
    oracle for the compact-first path; production is encode_core.

    packed:  (Nb,) uint32 RGBA words, Nb % TILE == 0 (padding arbitrary).
    n_px:    real pixel count (traced scalar), 1 <= n_px <= Nb.
    header:  (14,) uint8 serialized QOI header.
    channels: 3 or 4 (static) — RGBA ops are only emitted for 4-channel
              input (reference: simple.cpp:59-63).

    Returns (out_bytes, total_len): out_bytes is worst-size padded; the
    stream occupies out_bytes[:total_len].
    """
    nb = packed.shape[0]
    template, nbytes, tail, has_trail = _encode_fields(packed, n_px, channels)

    # ---- placement: prefix sum + sorted scatter-add materialization ------
    # Each pixel's k-th byte lands at offsets[i]+k.  For fixed k the index
    # stream is nondecreasing (offsets are), and every output byte has
    # exactly one unmasked contributor (masked rows add 0), so the six
    # scatter-adds all hit XLA's sorted fast path — no serial gathers.
    offsets = 14 + jnp.cumsum(nbytes) - nbytes  # exclusive
    chunks_end = 14 + jnp.sum(nbytes)

    w_cap = (channels + 1) * nb + 14 + 8 + 9
    out = jnp.zeros(w_cap + 1, jnp.uint8)
    for k in range(6):
        contrib = jnp.where(k < nbytes, template[:, k], 0)
        idx_k = jnp.minimum(offsets + k, w_cap)
        out = out.at[idx_k].add(contrib, indices_are_sorted=True)
    out = out[:w_cap].at[:14].set(header)
    out = jax.lax.dynamic_update_slice(out, tail, (chunks_end,))

    total_len = chunks_end + has_trail.astype(jnp.int32) + 8
    out = jnp.where(jnp.arange(w_cap) < total_len, out, 0)
    return out, total_len


@partial(jax.jit, static_argnames=("channels",))
def encode_batch_scatter(packed, n_px, header, channels: int):
    """Per-pixel scatter emission (batched) — differential oracle for the
    compact-first path; production is encode_batch.

    Per-image offsets are lifted into ONE flat index space (row-major, so
    b*(w_cap+1) + offset stays globally sorted) and each of the six
    byte-lane scatters plus the tail scatter runs once for the whole
    batch instead of vmapped.
    """
    b, nb = packed.shape
    template, nbytes, tail, has_trail = jax.vmap(
        lambda p: _encode_fields(p, n_px, channels)
    )(packed)

    offsets = 14 + jnp.cumsum(nbytes, axis=1) - nbytes  # (B, Nb)
    chunks_end = 14 + jnp.sum(nbytes, axis=1)  # (B,)

    w_cap = (channels + 1) * nb + 14 + 8 + 9
    row = w_cap + 1
    base = (jnp.arange(b, dtype=jnp.int32) * row)[:, None]

    out = jnp.zeros(b * row, jnp.uint8)
    for k in range(6):
        contrib = jnp.where(k < nbytes, template[:, :, k], 0)
        idx_k = base + jnp.minimum(offsets + k, w_cap)
        out = out.at[idx_k.reshape(-1)].add(
            contrib.reshape(-1), indices_are_sorted=True
        )

    # tails: 9 bytes per image at chunks_end (row-major => globally sorted)
    tail_idx = base + jnp.minimum(
        chunks_end[:, None] + jnp.arange(9, dtype=jnp.int32)[None, :], w_cap
    )
    out = out.at[tail_idx.reshape(-1)].add(
        tail.reshape(-1), indices_are_sorted=True
    )

    out = out.reshape(b, row)[:, :w_cap]
    out = out.at[:, :14].set(header[None, :])
    total_len = chunks_end + has_trail.astype(jnp.int32) + 8
    out = jnp.where(
        jnp.arange(w_cap, dtype=jnp.int32)[None, :] < total_len[:, None], out, 0
    )
    return out, total_len


# ---------------------------------------------------------------------------
# Production emission: compact-first.  Emitting pixels compact into dense
# chunk rows (ops/sparse.compact_rows), the table scan and op selection run
# on those rows, and one scatter materializes the bytes
# (ops/sparse.emit_bytes).  Bit-exact with the reference's sequential
# emitter (source/simple.cpp:36-95).
# ---------------------------------------------------------------------------

def _pack_template_planes(template, nbytes):
    """(..., 6) u8 templates + byte counts -> two u32 planes.

    tlo: template bytes 0..3 little-endian; thn: bytes 4..5 in the low
    halfword, the per-pixel emitted byte count in the high halfword.
    """
    t = template.astype(jnp.uint32)
    tlo = t[..., 0] | (t[..., 1] << 8) | (t[..., 2] << 16) | (t[..., 3] << 24)
    thn = t[..., 4] | (t[..., 5] << 8) | (nbytes.astype(jnp.uint32) << 16)
    return tlo, thn


@partial(jax.jit, static_argnames=("channels", "chunk_cap", "out_cap"))
def _encode_kernel_impl(packed, n_px, header, channels: int,
                        chunk_cap: int, out_cap: int):
    """Compact-first sparse pipeline.

    Run-interior pixels never touch the table and their RUN bytes are a
    pure function of the gap between chunk positions, so the expensive
    table scan runs on the COMPACTED chunk domain (5-10x fewer rows on
    real content), not per pixel:

    1. dense pass: chunk positions (noneq pixels + 62-flush points) — a
       handful of elementwise ops and one cummax over (B, Nb);
    2. compaction of (pixel, position|flag) at those rows;
    3. table scan + op selection + byte templates on the chunk rows
       (prev pixel = previous row's pixel; pending run = position gap);
    4. byte emission.
    """
    b, nb = packed.shape

    # ---- 1. dense chunk-position pass -----------------------------------
    idx = jnp.broadcast_to(jnp.arange(nb, dtype=jnp.int32)[None, :], (b, nb))
    valid = idx < n_px
    prev = jnp.concatenate(
        [jnp.full((b, 1), START_PIXEL_PACKED, jnp.uint32), packed[:, :-1]],
        axis=1,
    )
    eq_raw = packed == prev
    noneq = valid & ~eq_raw
    last_noneq = jax.lax.cummax(jnp.where(noneq, idx, -1), axis=1)
    cnt = idx - last_noneq
    hit62 = eq_raw & valid & (cnt % 62 == 0)  # run-limit flush (RUN 62)
    keep = noneq | hit62
    fb = 30
    posflag = (idx | jnp.where(noneq, 1 << fb, 0)).astype(jnp.uint32)

    # ---- 2. compact to the chunk domain ---------------------------------
    (pk_c, pf_c), counts = sparse.compact_rows(
        (packed, posflag), keep, cap=chunk_cap
    )
    rows = jnp.arange(chunk_cap, dtype=jnp.int32)[None, :]
    valid_c = rows < counts[:, None]
    pk_c = jnp.where(valid_c, pk_c, 0)
    pf_c = jnp.where(valid_c, pf_c, 0)
    pos = (pf_c & ((1 << fb) - 1)).astype(jnp.int32)
    nq_c = valid_c & (((pf_c >> fb) & 1) == 1)

    # prev pixel of a chunk = previous chunk row's pixel (run interiors
    # repeat it); pending run length = the position gap
    prev_c = jnp.concatenate(
        [jnp.full((b, 1), START_PIXEL_PACKED, jnp.uint32), pk_c[:, :-1]],
        axis=1,
    )
    pos_prev = jnp.concatenate(
        [jnp.full((b, 1), -1, jnp.int32), pos[:, :-1]], axis=1
    )
    gap = jnp.where(valid_c, pos - pos_prev - 1, 0)

    # ---- 3. sparse fields on chunk rows ---------------------------------
    h = hash6(pk_c)
    table_val = jax.vmap(_last_same_hash_value)(pk_c, h, nq_c)
    is_index = nq_c & (table_val == pk_c)

    a_cur = unpack_channel(pk_c, 3)
    a_prev = unpack_channel(prev_c, 3)
    if channels == 4:
        is_rgba = nq_c & ~is_index & (a_cur != a_prev)
    else:
        is_rgba = jnp.zeros((b, chunk_cap), bool)

    dr = to_int8(unpack_channel(pk_c, 0) - unpack_channel(prev_c, 0))
    dg = to_int8(unpack_channel(pk_c, 1) - unpack_channel(prev_c, 1))
    db = to_int8(unpack_channel(pk_c, 2) - unpack_channel(prev_c, 2))
    dr_dg = to_int8((dr - dg).astype(jnp.uint32))
    db_dg = to_int8((db - dg).astype(jnp.uint32))
    in_diff = (
        (dr >= -2) & (dr <= 1) & (dg >= -2) & (dg <= 1) & (db >= -2) & (db <= 1)
    )
    in_luma = (
        (dg >= -32) & (dg <= 31)
        & (dr_dg >= -8) & (dr_dg <= 7)
        & (db_dg >= -8) & (db_dg <= 7)
    )
    rest = nq_c & ~is_index & ~is_rgba
    is_diff = rest & in_diff
    is_luma = rest & ~in_diff & in_luma
    is_rgb = rest & ~in_diff & ~in_luma
    own_len = jnp.where(
        is_index, 1,
        jnp.where(is_rgba, 5,
                  jnp.where(is_diff, 1,
                            jnp.where(is_luma, 2,
                                      jnp.where(is_rgb, 4, 0)))),
    ).astype(jnp.uint32)

    r8 = unpack_channel(pk_c, 0)
    g8 = unpack_channel(pk_c, 1)
    b8 = unpack_channel(pk_c, 2)
    diff_byte = (TAG_DIFF | ((dr + 2) << 4) | ((dg + 2) << 2) | (db + 2)
                 ).astype(jnp.uint32)
    luma0 = (TAG_LUMA | (dg + 32)).astype(jnp.uint32)
    luma1 = (((dr_dg + 8) << 4) | (db_dg + 8)).astype(jnp.uint32)
    z = jnp.zeros((b, chunk_cap), jnp.uint32)
    o0 = jnp.where(is_index, h.astype(jnp.uint32),
                   jnp.where(is_rgba, jnp.uint32(TAG_RGBA),
                             jnp.where(is_diff, diff_byte,
                                       jnp.where(is_luma, luma0,
                                                 jnp.where(is_rgb,
                                                           jnp.uint32(TAG_RGB),
                                                           z)))))
    o1 = jnp.where(is_rgba | is_rgb, r8, jnp.where(is_luma, luma1, z))
    o2 = jnp.where(is_rgba | is_rgb, g8, z)
    o3 = jnp.where(is_rgba | is_rgb, b8, z)
    o4 = jnp.where(is_rgba, a_cur, z)

    # a noneq chunk flushes its pending run first (gap in [1, 61]); a
    # hit62 row IS the flush (RUN 62, gap == 61 eq pixels strictly before)
    run_byte = jnp.where(
        nq_c, jnp.uint32(TAG_RUN) | ((gap - 1).astype(jnp.uint32) & 0x3F),
        jnp.uint32(TAG_RUN | 61),
    )
    has_run = jnp.where(nq_c, gap > 0, valid_c)
    b0 = jnp.where(has_run, run_byte, o0)
    b1 = jnp.where(has_run, o0, o1)
    b2 = jnp.where(has_run, o1, o2)
    b3 = jnp.where(has_run, o2, o3)
    b4 = jnp.where(has_run, o3, o4)
    b5 = jnp.where(has_run, o4, z)
    nbytes_c = own_len + has_run.astype(jnp.uint32)
    tlo_c = b0 | (b1 << 8) | (b2 << 16) | (b3 << 24)
    thn_c = b4 | (b5 << 8) | (nbytes_c << 16)

    # ---- trailing run + end marker --------------------------------------
    last_pos = jnp.max(jnp.where(valid_c, pos, -1), axis=1)  # (B,)
    trailing = jnp.maximum(n_px - 1 - last_pos, 0)
    has_trail = trailing > 0
    trail_byte = (TAG_RUN | ((trailing - 1) & 0x3F)).astype(jnp.uint8)
    marker = jnp.array([0, 0, 0, 0, 0, 0, 0, 1, 0], dtype=jnp.uint8)
    tail = jnp.where(
        has_trail[:, None],
        jnp.concatenate(
            [trail_byte[:, None], jnp.broadcast_to(marker[:8], (b, 8))],
            axis=1,
        ),
        jnp.broadcast_to(marker, (b, 9)),
    )

    # Trailing run + end marker ride in as two appended template rows.
    t32 = tail.astype(jnp.uint32)  # (B, 9)
    row1_tlo = t32[:, 0] | (t32[:, 1] << 8) | (t32[:, 2] << 16) | (t32[:, 3] << 24)
    row1_thn = t32[:, 4] | (t32[:, 5] << 8) | (jnp.uint32(6) << 16)
    row2_tlo = t32[:, 6] | (t32[:, 7] << 8) | (t32[:, 8] << 16)
    row2_thn = (2 + has_trail.astype(jnp.uint32)) << 16
    app_tlo = jnp.stack([row1_tlo, row2_tlo], axis=1)
    app_thn = jnp.stack([row1_thn, row2_thn], axis=1)
    upd = jax.vmap(
        lambda p, v, c: jax.lax.dynamic_update_slice(p, v, (c,))
    )
    tlo_c = upd(tlo_c, app_tlo, counts)
    thn_c = upd(thn_c, app_thn, counts)

    nb_c = (thn_c >> 16).astype(jnp.int32)
    off = 14 + jnp.cumsum(nb_c, axis=1) - nb_c
    total_len = 14 + jnp.sum(nb_c, axis=1)

    out = sparse.emit_bytes(off, tlo_c, thn_c, out_cap)
    out = out.at[:, :14].set(header[None, :].astype(jnp.uint8))
    ok = (counts + sparse.BLK + 128 <= chunk_cap) & (total_len <= out_cap)
    return out, total_len, ok


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def encode_batch_checked(packed, n_px, header, channels: int, *,
                         chunk_cap: int | None = None,
                         out_cap: int | None = None):
    """Batched kernel-path encode -> ((B, out_cap) u8, (B,) i32 lengths,
    (B,) bool ok).

    chunk_cap bounds per-image emitting-pixel count (default: safe for any
    input).  out_cap bounds the stream length (default: worst size).  With
    both defaults `ok` is always True; callers passing tighter caps (e.g.
    a round-trip pipeline that knows its corpus) must re-encode images
    whose flag is False through a safe path.
    """
    b, nb = packed.shape
    if chunk_cap is None:
        chunk_cap = nb + sparse.BLK + 256
    chunk_cap = _round_up(max(chunk_cap, sparse.BLK + 256), 128)
    if out_cap is None:
        out_cap = (channels + 1) * nb + 14 + 8 + 9
    out_cap = _round_up(out_cap, sparse.WIN)
    return _encode_kernel_impl(
        packed, n_px, header, channels, chunk_cap, out_cap
    )


# ---------------------------------------------------------------------------
# Packed-lane encode: many whole streams per compaction/emission lane, the
# encode-side analog of models/packed.py decode lanes.  Total work tracks
# sum(pixels) instead of B * max(pixels): streams of ANY geometry/channels
# concatenate back-to-back in the pixel domain, with TWO reserved "tail
# slots" between streams whose compacted rows carry each stream's trailing
# run + end marker (reference: source/simple.cpp:91-95), and segment resets
# ride in a dense flag plane.  The reference has no analog — it encodes
# images one at a time (simple.cpp:36-95).
# ---------------------------------------------------------------------------

FLAG_SEG_START = 1  # first pixel of a stream
FLAG_TAIL0 = 2      # reserved slot: trailing-run byte + marker bytes 0..4
FLAG_TAIL1 = 4      # reserved slot: marker bytes 5..7
FLAG_VALID = 8      # real pixel


@partial(jax.jit, static_argnames=("chunk_cap", "out_cap", "ends_cap"))
def _encode_lanes_impl(packed, flags, chunk_cap: int, out_cap: int,
                       ends_cap: int):
    """Segmented compact-first encode over packed pixel lanes.

    packed: (L, Np) uint32 pixel words (tail slots / padding arbitrary).
    flags:  (L, Np) uint8 FLAG_* bits (host-built at pack time).
    Returns (out (L, out_cap) u8 bodies, ends (L, ends_cap) i32 per-stream
    exclusive byte ends in pack order, nseg (L,), ok (L,)).  Stream s of a
    lane occupies out[ends[s-1]:ends[s]] (headers are NOT emitted — the
    caller prepends the 14-byte header it already knows).
    """
    l, np_ = packed.shape
    idx = jnp.broadcast_to(jnp.arange(np_, dtype=jnp.int32)[None, :], (l, np_))

    seg_start = (flags & FLAG_SEG_START) != 0
    t0_d = (flags & FLAG_TAIL0) != 0
    t1_d = (flags & FLAG_TAIL1) != 0
    valid = (flags & FLAG_VALID) != 0

    # ---- dense per-pixel pass (segment-reset aware) ----------------------
    prev = jnp.concatenate(
        [jnp.full((l, 1), START_PIXEL_PACKED, jnp.uint32), packed[:, :-1]],
        axis=1,
    )
    prev = jnp.where(seg_start, START_PIXEL_PACKED, prev)
    eq_raw = (packed == prev) & valid
    noneq = valid & ~eq_raw

    seg_base = jax.lax.cummax(jnp.where(seg_start, idx, 0), axis=1)
    last_brk = jnp.maximum(
        jax.lax.cummax(jnp.where(noneq, idx, -1), axis=1), seg_base - 1
    )
    cnt = idx - last_brk
    hit62 = eq_raw & (cnt % 62 == 0)

    # trailing run pending at each stream's end, read at its tail0 slot
    trail_expr = jnp.where(eq_raw, cnt % 62, 0)
    trail_at = jnp.concatenate(
        [jnp.zeros((l, 1), jnp.int32), trail_expr[:, :-1]], axis=1
    )
    trail_at2 = jnp.concatenate(
        [jnp.zeros((l, 2), jnp.int32), trail_expr[:, :-2]], axis=1
    )
    # tail0 sits 1 past the stream's last pixel, tail1 sits 2 past — both
    # rows need has_trail (tail1's marker split depends on it)
    trailing = jnp.where(t0_d, trail_at, jnp.where(t1_d, trail_at2, 0))
    has_trail_d = trailing > 0
    trail_byte_d = (TAG_RUN | ((trailing - 1) & 0x3F)).astype(jnp.uint32)

    packed_aug = jnp.where(
        t0_d, trail_byte_d | (has_trail_d.astype(jnp.uint32) << 8),
        jnp.where(t1_d, has_trail_d.astype(jnp.uint32) << 8, packed),
    )
    b_t0, b_t1, b_nq = 26, 27, 30
    posflag = (
        idx.astype(jnp.uint32)
        | (t0_d.astype(jnp.uint32) << b_t0)
        | (t1_d.astype(jnp.uint32) << b_t1)
        | (noneq.astype(jnp.uint32) << b_nq)
    )
    keep = noneq | hit62 | t0_d | t1_d

    # ---- compact to the chunk domain ------------------------------------
    (pk_c, pf_c), counts = sparse.compact_rows(
        (packed_aug, posflag), keep, cap=chunk_cap
    )
    rows = jnp.arange(chunk_cap, dtype=jnp.int32)[None, :]
    valid_c = rows < counts[:, None]
    pk_c = jnp.where(valid_c, pk_c, 0)
    pf_c = jnp.where(valid_c, pf_c, 0)
    pos = (pf_c & ((1 << b_t0) - 1)).astype(jnp.int32)
    t0 = valid_c & (((pf_c >> b_t0) & 1) == 1)
    t1 = valid_c & (((pf_c >> b_t1) & 1) == 1)
    nq_c = valid_c & (((pf_c >> b_nq) & 1) == 1)
    is_tail = t0 | t1
    run_row = valid_c & ~nq_c & ~is_tail  # 62-flush rows

    # segment id per chunk row = count of tail1 rows strictly before
    t1_i = t1.astype(jnp.int32)
    seg_c = jnp.cumsum(t1_i, axis=1) - t1_i

    # prev pixel: previous chunk row's pixel, reset to START at each
    # segment's first row (= the row after a tail1, or row 0)
    after_t1 = jnp.concatenate(
        [jnp.ones((l, 1), bool), t1[:, :-1]], axis=1
    )
    prev_c = jnp.concatenate(
        [jnp.full((l, 1), START_PIXEL_PACKED, jnp.uint32), pk_c[:, :-1]],
        axis=1,
    )
    prev_c = jnp.where(after_t1, START_PIXEL_PACKED, prev_c)
    pos_prev = jnp.concatenate(
        [jnp.full((l, 1), -1, jnp.int32), pos[:, :-1]], axis=1
    )
    gap = jnp.where(valid_c, pos - pos_prev - 1, 0)

    # ---- sparse fields on chunk rows (segment-aware table) ---------------
    h = hash6(pk_c)
    table_val = jax.vmap(_last_same_hash_value_seg)(pk_c, h, nq_c, seg_c)
    is_index = nq_c & (table_val == pk_c)

    a_cur = unpack_channel(pk_c, 3)
    a_prev = unpack_channel(prev_c, 3)
    # RGB streams pack alpha=0xFF everywhere, so alpha_changed is
    # intrinsically False for them — no per-stream channels gate needed
    # (reference guard simple.cpp:59-63 is unreachable for RGB anyway)
    is_rgba = nq_c & ~is_index & (a_cur != a_prev)

    dr = to_int8(unpack_channel(pk_c, 0) - unpack_channel(prev_c, 0))
    dg = to_int8(unpack_channel(pk_c, 1) - unpack_channel(prev_c, 1))
    db = to_int8(unpack_channel(pk_c, 2) - unpack_channel(prev_c, 2))
    dr_dg = to_int8((dr - dg).astype(jnp.uint32))
    db_dg = to_int8((db - dg).astype(jnp.uint32))
    in_diff = (
        (dr >= -2) & (dr <= 1) & (dg >= -2) & (dg <= 1) & (db >= -2) & (db <= 1)
    )
    in_luma = (
        (dg >= -32) & (dg <= 31)
        & (dr_dg >= -8) & (dr_dg <= 7)
        & (db_dg >= -8) & (db_dg <= 7)
    )
    rest = nq_c & ~is_index & ~is_rgba
    is_diff = rest & in_diff
    is_luma = rest & ~in_diff & in_luma
    is_rgb = rest & ~in_diff & ~in_luma
    own_len = jnp.where(
        is_index, 1,
        jnp.where(is_rgba, 5,
                  jnp.where(is_diff, 1,
                            jnp.where(is_luma, 2,
                                      jnp.where(is_rgb, 4, 0)))),
    ).astype(jnp.uint32)

    r8 = unpack_channel(pk_c, 0)
    g8 = unpack_channel(pk_c, 1)
    b8 = unpack_channel(pk_c, 2)
    diff_byte = (TAG_DIFF | ((dr + 2) << 4) | ((dg + 2) << 2) | (db + 2)
                 ).astype(jnp.uint32)
    luma0 = (TAG_LUMA | (dg + 32)).astype(jnp.uint32)
    luma1 = (((dr_dg + 8) << 4) | (db_dg + 8)).astype(jnp.uint32)
    z = jnp.zeros((l, chunk_cap), jnp.uint32)
    o0 = jnp.where(is_index, h.astype(jnp.uint32),
                   jnp.where(is_rgba, jnp.uint32(TAG_RGBA),
                             jnp.where(is_diff, diff_byte,
                                       jnp.where(is_luma, luma0,
                                                 jnp.where(is_rgb,
                                                           jnp.uint32(TAG_RGB),
                                                           z)))))
    o1 = jnp.where(is_rgba | is_rgb, r8, jnp.where(is_luma, luma1, z))
    o2 = jnp.where(is_rgba | is_rgb, g8, z)
    o3 = jnp.where(is_rgba | is_rgb, b8, z)
    o4 = jnp.where(is_rgba, a_cur, z)

    run_byte = jnp.where(
        nq_c, jnp.uint32(TAG_RUN) | ((gap - 1).astype(jnp.uint32) & 0x3F),
        jnp.uint32(TAG_RUN | 61),
    )
    has_run = jnp.where(nq_c, gap > 0, run_row)
    b0 = jnp.where(has_run, run_byte, o0)
    b1 = jnp.where(has_run, o0, o1)
    b2 = jnp.where(has_run, o1, o2)
    b3 = jnp.where(has_run, o2, o3)
    b4 = jnp.where(has_run, o3, o4)
    b5 = jnp.where(has_run, o4, z)
    nbytes_c = own_len + has_run.astype(jnp.uint32)

    # tail rows: trailing-run byte + 8-byte end marker split 6 + (2|3)
    ht = ((pk_c >> 8) & 1).astype(jnp.uint32)  # has_trail (tail rows)
    tb = pk_c & 0xFF                           # trail byte (tail0 rows)
    b0 = jnp.where(is_tail, jnp.where(t0, ht * tb, 0), b0)
    b1 = jnp.where(is_tail, jnp.where(t1, 1 - ht, 0), b1)
    b2 = jnp.where(is_tail, jnp.where(t1, ht, 0), b2)
    b3 = jnp.where(is_tail, 0, b3)
    b4 = jnp.where(is_tail, 0, b4)
    b5 = jnp.where(is_tail, 0, b5)
    nbytes_c = jnp.where(t0, 6, jnp.where(t1, 2 + ht, nbytes_c))

    tlo_c = b0 | (b1 << 8) | (b2 << 16) | (b3 << 24)
    thn_c = b4 | (b5 << 8) | (nbytes_c << 16)

    nb_c = nbytes_c.astype(jnp.int32)
    off = jnp.cumsum(nb_c, axis=1) - nb_c
    total_len = jnp.sum(nb_c, axis=1)

    # per-stream exclusive byte ends = (off + nbytes) at tail1 rows,
    # extracted by a second (chunk-domain, 1-plane) compaction
    (ends,), nseg = sparse.compact_rows((off + nb_c,), t1, cap=ends_cap)

    out = sparse.emit_bytes(off, tlo_c, thn_c, out_cap)
    ok = (counts + sparse.BLK + 128 <= chunk_cap) & (total_len <= out_cap)
    return out, ends, nseg, ok


def encode_lanes_checked(packed, flags, *, chunk_cap: int | None = None,
                         out_cap: int | None = None,
                         ends_cap: int | None = None):
    """Packed-lane encode -> (bodies (L, out_cap) u8, ends (L, ends_cap)
    i32, nseg (L,) i32, ok (L,) bool).  See _encode_lanes_impl; callers
    build `flags` at pack time (models/packed.PackedEncoder)."""
    l, np_ = packed.shape
    if chunk_cap is None:
        chunk_cap = np_ + sparse.BLK + 256
    chunk_cap = _round_up(max(chunk_cap, sparse.BLK + 256), 2048)
    if out_cap is None:
        out_cap = 5 * np_ + 32
    out_cap = _round_up(out_cap, sparse.WIN)
    if ends_cap is None:
        ends_cap = sparse.BLK + 256
    ends_cap = _round_up(max(ends_cap, sparse.BLK + 256), 128)
    return _encode_lanes_impl(packed, flags, chunk_cap, out_cap, ends_cap)


def encode_batch(packed, n_px, header, channels: int, *,
                 chunk_cap: int | None = None, out_cap: int | None = None):
    """Batched encode: (B, Nb) packed pixels -> ((B, out_cap) u8, (B,) i32).

    Production path: compact-first emission (see the section comment
    above).  Bit-exact with the reference for every input when the
    caps are left at their safe defaults.
    """
    out, total_len, _ = encode_batch_checked(
        packed, n_px, header, channels, chunk_cap=chunk_cap, out_cap=out_cap
    )
    return out, total_len


def encode_core(packed, n_px, header, channels: int):
    """Encode one image's packed pixels into a QOI byte stream (see
    encode_batch).  Returns (out_bytes, total_len)."""
    out, total_len = encode_batch(
        packed[None, :], n_px, header, channels
    )
    return out[0], total_len[0]


def pad_to_tile(n: int) -> int:
    return -(-n // TILE) * TILE


def bucket_size(n: int) -> int:
    """Round a pixel count up to a compile-size bucket (limits retraces)."""
    n = max(n, TILE)
    b = TILE
    while b < n:
        b *= 2
    # refine: allow 1.25x steps between powers of two to cut padding waste
    for frac in (b // 2 + b // 8, b // 2 + b // 4, b // 2 + 3 * b // 8, 3 * b // 4, 7 * b // 8):
        if frac >= n and frac % TILE == 0:
            return frac
    return b

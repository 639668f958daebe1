"""Device-resident windowed streaming codec.

The reference streams with byte-granular resumability and a ~260-byte
bounded state (SURVEY.md §5: channels + run counter + prev pixel + 64-entry
table; reference: include/qoipp/stream.hpp:109-116).  The device analog
streams WINDOW-granular: each call processes a large window on-device with
the same carry — (prev, seen) device arrays plus a run counter and at most
4 leftover bytes of a split chunk on the host — so multi-MB images decode/
encode in bounded device memory, bit-exact with the one-shot codec on the
concatenated stream.  Byte-granular resumability (partial output buffers,
transactional rollback) remains the native StreamEncoder/StreamDecoder's
job (qoipp_tpu.stream).

Decode windows split across replay lanes with seam-fixpoint
reconciliation (models/split._decode_window_lanes — the carried state
enters the window's first lane as its chain base); encode windows run
the parallel encoder with carried (prev, run, table) seeds.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..common import (
    Channels,
    Desc,
    Error,
    Result,
    read_header,
)
from . import boundary
from . import encode as enc_ops
from . import sparse
from .bitops import (
    START_PIXEL_PACKED,
    hash6,
    packed_to_pixels,
    pixels_to_packed,
    to_int8,
    unpack_channel,
)

_START_HASH = (11 * 255) % 64


def _round_up(n, m):
    return -(-n // m) * m


def _unpack_pixels_np(packed: np.ndarray, channels: int) -> np.ndarray:
    """Host-side (N,) u32 -> (N*ch,) u8 (numpy analog of
    bitops.packed_to_pixels) — a per-window device unpack would add an
    eager dispatch per window."""
    n = packed.shape[0]
    out = np.empty((n, channels), np.uint8)
    out[:, 0] = packed & 0xFF
    out[:, 1] = (packed >> 8) & 0xFF
    out[:, 2] = (packed >> 16) & 0xFF
    if channels == 4:
        out[:, 3] = packed >> 24
    return out.reshape(-1)


# --------------------------------------------------------------------------
# Decoder
# --------------------------------------------------------------------------


class DeviceStreamDecoder:
    """Window-granular streaming QOI decoder with device-resident state.

    Each window's chunk bytes are split across up to
    ``split_lanes`` replay lanes (cost-balanced, anchored cuts from the
    native walker) and reconciled with the seam fixpoint
    (models/split._decode_window_lanes) — the window's sequential replay
    depth drops from window-bytes to ~2 * window-bytes / lanes.  The
    carried state is the same ~260-byte codec carry (prev + 64-entry
    table; SURVEY.md §5), entering the window's first lane as its chain
    base.  Bit-exact with the one-shot codec on the concatenated stream.
    """

    def __init__(self, window_cap: int = 1 << 20,
                 pixel_cap: Optional[int] = None, split_lanes: int = 96):
        # fixpoint rounds grow ~linearly with lane count (the seam
        # dependency is a content-bound INDEX-of-INDEX chain, ~1-2
        # lanes/round front), so per-round depth x rounds is flat-ish in
        # the lane count; 96 is the default (benchmarks/device_stream_bench.py
        # sweeps it)
        self.window_cap = _round_up(window_cap, boundary.BLOCK)
        self.pixel_cap = _round_up(
            pixel_cap or 8 * self.window_cap, sparse.WIN
        )
        self.split_lanes = min(max(split_lanes, 1), 128)
        self._desc: Optional[Desc] = None
        self._target: Optional[Channels] = None
        self._leftover = b""
        self._prev = None
        self._seen = None

    def is_initialized(self) -> bool:
        return self._desc is not None

    def initialize(self, header_bytes, target: Optional[Channels] = None) -> Result[Desc]:
        if self._desc is not None:
            return Result.err(Error.ALREADY_INITIALIZED)
        hdr = read_header(header_bytes)
        if not hdr:
            return Result.err(hdr.error())
        self._desc = hdr.value()
        self._target = target or self._desc.channels
        self._prev = jnp.full((1,), START_PIXEL_PACKED, jnp.uint32)
        self._seen = (
            jnp.zeros(64, jnp.uint32)
            .at[_START_HASH].set(jnp.uint32(START_PIXEL_PACKED))
        )
        self._leftover = b""
        return Result.ok(self._desc.replace(channels=self._target))

    def _decode_one_window(self, win: bytes):
        """Split one byte window across lanes and decode it; returns
        (pixel parts list, consumed bytes) and advances the carry."""
        from .. import oracle
        from ..models.split import _compact_cap, _decode_window_lanes
        from .decode import _bucket

        warr = np.frombuffer(win, np.uint8)
        # at least ~512 B per segment: tiny windows take few/one lane
        k = min(self.split_lanes, max(len(win) // 512, 1))
        byte_w, px_w = 46.0 + 2.45 * k, 0.27 * k
        offs, poffs, cis = oracle.split_points(
            warr, 1 << 60, k, byte_w, px_w,
            lookahead=max(len(win) // k // 4, 64),
            prefer_rgba=int(self._desc.channels) == 4,
        )
        nseg = len(offs) - 1
        if int(poffs[-1]) > self.pixel_cap:
            return None, 0  # caller maps to NOT_ENOUGH_SPACE
        # byte+px-balanced cuts (see SplitDecoder.plan_and_pack)
        qseg = _bucket(int(np.diff(offs).max()), 8 * boundary.BLOCK)
        qc = _compact_cap(int(np.diff(cis).max()), qseg)
        l = _round_up(nseg, 8)
        n_cap = _round_up(max(int(np.diff(poffs).max()), 1), sparse.WIN)
        n_cap = _bucket(n_cap, sparse.WIN)
        regions = np.zeros((l, qseg + 8), np.uint8)
        seg_lens = np.zeros(l, np.int32)
        for s in range(nseg):
            b0, b1 = int(offs[s]), int(offs[s + 1])
            regions[s, : b1 - b0] = warr[b0:b1]
            seg_lens[s] = b1 - b0
        from ..utils.transport import stage_h2d

        packed, n_pix, consumed, prev, seen, _rounds = _decode_window_lanes(
            stage_h2d(regions), jnp.asarray(seg_lens),
            self._prev, self._seen, jnp.int32(l), qb=qseg, n_cap=n_cap,
            qc=qc,
        )
        n_pix_h = np.asarray(n_pix)
        cons_h = np.asarray(consumed)
        total_consumed = int(offs[nseg - 1]) + int(cons_h[nseg - 1])
        if total_consumed == 0:
            return [], 0
        self._prev, self._seen = prev, seen
        # ONE bulk fetch of the live pixel span, bucket-rounded (an
        # exact-length eager slice compiles once per distinct length);
        # per-lane slicing happens on host
        m = min(_bucket(max(int(n_pix_h.max()), 1), 8192), n_cap)
        host = np.asarray(packed[:, :m])
        parts = [
            _unpack_pixels_np(host[s, : n_pix_h[s]], int(self._target))
            for s in range(nseg) if n_pix_h[s]
        ]
        return parts, total_consumed

    def decode_window(self, data) -> Result[np.ndarray]:
        """Consume a byte window (chunks only, no header/end marker); returns
        the raw pixel bytes its complete chunks produce (target channels).
        Split chunks at the tail are carried into the next call."""
        if self._desc is None:
            return Result.err(Error.NOT_INITIALIZED)
        buf = self._leftover + bytes(
            data.tobytes() if isinstance(data, np.ndarray) else data
        )
        if len(buf) == 0:
            return Result.err(Error.EMPTY)
        out_parts = []
        pos = 0
        while pos < len(buf):
            win = buf[pos : pos + self.window_cap]
            parts, consumed = self._decode_one_window(win)
            if parts is None:
                return Result.err(Error.NOT_ENOUGH_SPACE)
            if consumed == 0:
                break  # only a split chunk left
            out_parts.extend(parts)
            pos += consumed
        self._leftover = buf[pos:]
        if out_parts:
            return Result.ok(np.concatenate(out_parts))
        return Result.ok(np.zeros(0, np.uint8))

    def reset(self) -> None:
        self._desc = None
        self._target = None
        self._leftover = b""
        self._prev = None
        self._seen = None


# --------------------------------------------------------------------------
# Encoder
# --------------------------------------------------------------------------


@partial(jax.jit, static_argnames=("channels", "nb"))
def _encode_window(raw_u8, n_px, prev_c, run_c, seen_c, channels: int, nb: int):
    """Encode one pixel window with carried state — the compact-first path
    of the batch encoder (ops/encode._encode_kernel_impl).

    raw_u8: (nb*channels,) u8 raw pixels (padding arbitrary) — packing
    happens INSIDE the jit (eager packing would add dispatches); n_px:
    pixels in window; prev_c/run_c: carried prev
    pixel / run counter (0..61); seen_c: (64,) carried table.
    Returns (bytes (out_cap,), length, prev_out, run_out, seen_out).
    """
    TAG_RUN = enc_ops.TAG_RUN
    packed = pixels_to_packed(raw_u8, channels)

    # ---- dense pass with carried (prev, run) ------------------------------
    idx = jnp.arange(nb, dtype=jnp.int32)
    valid = idx < n_px
    run0 = run_c.astype(jnp.int32)
    prev = jnp.concatenate([prev_c[None].astype(jnp.uint32), packed[:-1]])
    eq_raw = packed == prev
    noneq = valid & ~eq_raw
    # a carried run extends the streak virtually before position 0
    last_noneq = jax.lax.cummax(jnp.where(noneq, idx, -(run0 + 1)))
    cnt = idx - last_noneq
    hit62 = eq_raw & valid & (cnt % 62 == 0)
    keep = noneq | hit62
    fb = 30
    posflag = (idx | jnp.where(noneq, 1 << fb, 0)).astype(jnp.uint32)

    chunk_cap = _round_up(nb + nb // 62 + sparse.BLK + 256, 128)
    out_cap = _round_up((channels + 1) * nb + 64, sparse.WIN)

    (pk_c, pf_c), counts = sparse.compact_rows(
        (packed[None], posflag[None]), keep[None], cap=chunk_cap
    )
    rows = jnp.arange(chunk_cap, dtype=jnp.int32)[None, :]
    valid_c = rows < counts[:, None]
    pk_c = jnp.where(valid_c, pk_c, 0)
    pf_c = jnp.where(valid_c, pf_c, 0)
    pos = (pf_c & ((1 << fb) - 1)).astype(jnp.int32)
    nq_c = valid_c & (((pf_c >> fb) & 1) == 1)

    prev_cr = jnp.concatenate(
        [prev_c[None, None].astype(jnp.uint32), pk_c[:, :-1]], axis=1
    )
    # pos_prev init -1 - run0 makes the first flush gap include the carry:
    # any 62-overflow before the first noneq produced a hit62 row, so the
    # remaining gap is < 62 and the RUN byte arithmetic stays exact
    pos_prev = jnp.concatenate(
        [jnp.full((1, 1), -1 - run0, jnp.int32), pos[:, :-1]], axis=1
    )
    gap = jnp.where(valid_c, pos - pos_prev - 1, 0)

    # ---- sparse fields on chunk rows (carried table) ----------------------
    h = hash6(pk_c)
    table_val = enc_ops._last_same_hash_value(
        pk_c[0], h[0], nq_c[0], incoming=seen_c
    )[None]
    is_index = nq_c & (table_val == pk_c)
    a_cur = unpack_channel(pk_c, 3)
    a_prev = unpack_channel(prev_cr, 3)
    if channels == 4:
        is_rgba = nq_c & ~is_index & (a_cur != a_prev)
    else:
        is_rgba = jnp.zeros((1, chunk_cap), bool)

    dr = to_int8(unpack_channel(pk_c, 0) - unpack_channel(prev_cr, 0))
    dg = to_int8(unpack_channel(pk_c, 1) - unpack_channel(prev_cr, 1))
    db = to_int8(unpack_channel(pk_c, 2) - unpack_channel(prev_cr, 2))
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
    diff_byte = (enc_ops.TAG_DIFF | ((dr + 2) << 4) | ((dg + 2) << 2)
                 | (db + 2)).astype(jnp.uint32)
    luma0 = (enc_ops.TAG_LUMA | (dg + 32)).astype(jnp.uint32)
    luma1 = (((dr_dg + 8) << 4) | (db_dg + 8)).astype(jnp.uint32)
    z = jnp.zeros((1, chunk_cap), jnp.uint32)
    o0 = jnp.where(is_index, h.astype(jnp.uint32),
                   jnp.where(is_rgba, jnp.uint32(enc_ops.TAG_RGBA),
                             jnp.where(is_diff, diff_byte,
                                       jnp.where(is_luma, luma0,
                                                 jnp.where(is_rgb,
                                                           jnp.uint32(
                                                               enc_ops.TAG_RGB),
                                                           z)))))
    o1 = jnp.where(is_rgba | is_rgb, r8, jnp.where(is_luma, luma1, z))
    o2 = jnp.where(is_rgba | is_rgb, g8, z)
    o3 = jnp.where(is_rgba | is_rgb, b8, z)
    o4 = jnp.where(is_rgba, a_cur, z)

    run_byte = jnp.where(
        nq_c, jnp.uint32(TAG_RUN) | ((gap - 1).astype(jnp.uint32) & 0x3F),
        jnp.uint32(TAG_RUN | 61),
    )
    has_run = jnp.where(nq_c, gap > 0, valid_c)  # non-noneq rows are hit62
    b0 = jnp.where(has_run, run_byte, o0)
    b1 = jnp.where(has_run, o0, o1)
    b2 = jnp.where(has_run, o1, o2)
    b3 = jnp.where(has_run, o2, o3)
    b4 = jnp.where(has_run, o3, o4)
    b5 = jnp.where(has_run, o4, z)
    nbytes_c = own_len + has_run.astype(jnp.uint32)
    tlo_c = b0 | (b1 << 8) | (b2 << 16) | (b3 << 24)
    thn_c = b4 | (b5 << 8) | (nbytes_c << 16)

    nb_c = nbytes_c.astype(jnp.int32)
    off = jnp.cumsum(nb_c, axis=1) - nb_c
    total_len = jnp.sum(nb_c, axis=1)[0]
    out = sparse.emit_bytes(off, tlo_c, thn_c, out_cap)[0]

    # ---- carry out ---------------------------------------------------------
    last = n_px - 1
    prev_out = jax.lax.dynamic_slice(packed, (last,), (1,))[0]
    eq_last = jax.lax.dynamic_slice(
        eq_raw.astype(jnp.int32), (last,), (1,))[0]
    cnt_last = jax.lax.dynamic_slice(cnt, (last,), (1,))[0]
    run_out = jnp.where(eq_last == 1, cnt_last % 62, 0).astype(jnp.uint32)

    # table out from chunk rows only (run interiors never touch the table)
    slot_ids = jnp.arange(64, dtype=jnp.int32)
    crow = jnp.arange(chunk_cap, dtype=jnp.int32)
    m = (h[0][None, :] == slot_ids[:, None]) & nq_c[0][None, :]  # (64, C)
    jbest = jnp.max(jnp.where(m, crow[None, :] + 1, 0), axis=1)
    sel = (crow[None, :] + 1) == jbest[:, None]
    vals = jnp.sum(jnp.where(sel, pk_c[0][None, :], 0), axis=1)
    seen_out = jnp.where(jbest > 0, vals, seen_c)

    return out, total_len, prev_out, run_out, seen_out


@partial(jax.jit, static_argnames=("channels", "nb", "lanes"))
def _encode_window_lanes(raw_u8, n_px, prev_c, run_c, seen_c,
                         channels: int, nb: int, lanes: int):
    """Multi-lane window encode with CLOSED-FORM carries — the encode
    analog of the decode windows' split-replay treatment (round-5).

    The window's nb pixel slots split into `lanes` contiguous sub-windows
    of nb/lanes pixels; unlike decode there is NO fixpoint, because the
    encoder's carried state is a pure function of the pixel prefix (the
    table-is-pure-function theorem, ops/encode.py; the same algebra as
    parallel/sharded.make_sp_encode, here on one chip as a batch axis):

      * entering prev  = the previous lane's last pixel (lane 0: carry);
      * entering run   = a mod-62 recurrence over per-lane
        (whole-lane-equal, trailing-streak) summaries;
      * entering table = an exclusive overwrite-combine of per-lane
        64-slot (last differing pixel per slot) summaries.

    Each lane then runs the dense pass + compaction + emission at batch
    width L instead of B=1.

    raw_u8: (nb*channels,) u8 raw pixels (padding arbitrary), nb a multiple
    of lanes*TILE; n_px: valid pixels; prev_c/run_c/seen_c: carried state.
    Returns (out (L, lane_out_cap) u8, lens (L,) i32, prev_out, run_out,
    seen_out).  The window's chunk bytes are concat(out[l][:lens[l]]).

    Reference analog: bounded-state streaming encode
    (include/qoipp/stream.hpp:23-116, source/stream.cpp:152-236) — the
    reference streams byte-granular and strictly sequentially; this is the
    device window form.
    """
    TAG_RUN = enc_ops.TAG_RUN
    L = lanes
    n_loc = nb // L
    packed_flat = pixels_to_packed(raw_u8, channels)  # (nb,)
    packed = packed_flat.reshape(L, n_loc)

    idx = jnp.arange(n_loc, dtype=jnp.int32)[None, :]
    lane_ids = jnp.arange(L, dtype=jnp.int32)
    v = jnp.clip(n_px - lane_ids * n_loc, 0, n_loc)  # (L,) valid pixels
    valid = idx < v[:, None]

    # ---- closed-form carry 1: entering prev pixel -------------------------
    # lanes with v > 0 only follow FULL lanes, so the previous lane's last
    # slot is its last valid pixel; v == 0 lanes' results are discarded
    prev_in = jnp.concatenate(
        [jnp.asarray(prev_c, jnp.uint32)[None], packed[:-1, -1]]
    )  # (L,)

    prev_rows = jnp.concatenate([prev_in[:, None], packed[:, :-1]], axis=1)
    eq_raw = packed == prev_rows
    noneq = valid & ~eq_raw

    # ---- closed-form carry 2: entering run counter ------------------------
    # per-lane summaries: first break position, trailing streak length,
    # whole-lane-extends-incoming-streak.  v == 0 lanes read full=True,
    # v=0 — the recurrence passes the run through them unchanged.
    brk = jnp.max(jnp.where(noneq, idx + 1, 0), axis=1)  # (L,)
    t_tail = jnp.maximum(v - brk, 0)
    full = brk == 0

    def rstep(r, x):
        f, tl, vl = x
        return jnp.where(f, (r + vl) % 62, tl % 62), r

    run_out, run_ins = jax.lax.scan(
        rstep, run_c.astype(jnp.int32), (full, t_tail, v)
    )  # run_ins (L,): entering run per lane; run_out: window carry-out

    # ---- closed-form carry 3: entering table ------------------------------
    # per-lane 64-slot summary (last differing pixel per slot), then an
    # exclusive overwrite-combine over lanes (log-shift, as the cross-tile
    # scan in ops/encode._last_same_hash_value)
    h_px = hash6(packed)
    slot_ids = jnp.arange(64, dtype=jnp.int32)
    m = (h_px[:, None, :] == slot_ids[None, :, None]) & noneq[:, None, :]
    jb = jnp.max(jnp.where(m, idx[None, :, :] + 1, 0), axis=2)  # (L, 64)
    sel = (idx[None, :, :] + 1) == jb[:, :, None]
    vals = jnp.sum(jnp.where(sel, packed[:, None, :], jnp.uint32(0)), axis=2)
    written = jb > 0
    sv, sw = vals, written
    k = 1
    while k < L:
        pv = jnp.concatenate([jnp.zeros((k, 64), sv.dtype), sv[:-k]], axis=0)
        pw = jnp.concatenate([jnp.zeros((k, 64), bool), sw[:-k]], axis=0)
        sv = jnp.where(sw, sv, pv)
        sw = sw | pw
        k *= 2
    seen_cb = jnp.broadcast_to(seen_c[None, :], (L, 64))
    seen_in = jnp.concatenate(
        [seen_c[None, :],
         jnp.where(sw[:-1], sv[:-1], seen_cb[:-1])], axis=0
    )  # (L, 64)
    seen_out = jnp.where(sw[-1], sv[-1], seen_c)

    # ---- dense pass with per-lane entering (prev, run) --------------------
    run0 = run_ins.astype(jnp.int32)[:, None]
    last_noneq = jax.lax.cummax(
        jnp.where(noneq, idx, -(run0 + 1)), axis=1
    )
    cnt = idx - last_noneq
    hit62 = eq_raw & valid & (cnt % 62 == 0)
    keep = noneq | hit62
    fb = 30
    posflag = (
        jnp.broadcast_to(idx, (L, n_loc))
        | jnp.where(noneq, 1 << fb, 0)
    ).astype(jnp.uint32)

    chunk_cap = _round_up(n_loc + n_loc // 62 + sparse.BLK + 256, 128)
    out_cap = _round_up((channels + 1) * n_loc + 64, sparse.WIN)

    (pk_c, pf_c), counts = sparse.compact_rows(
        (packed, posflag), keep, cap=chunk_cap
    )
    rows = jnp.arange(chunk_cap, dtype=jnp.int32)[None, :]
    valid_c = rows < counts[:, None]
    pk_c = jnp.where(valid_c, pk_c, 0)
    pf_c = jnp.where(valid_c, pf_c, 0)
    pos = (pf_c & ((1 << fb) - 1)).astype(jnp.int32)
    nq_c = valid_c & (((pf_c >> fb) & 1) == 1)

    prev_cr = jnp.concatenate([prev_in[:, None], pk_c[:, :-1]], axis=1)
    pos_prev = jnp.concatenate(
        [(-1 - run_ins.astype(jnp.int32))[:, None], pos[:, :-1]], axis=1
    )
    gap = jnp.where(valid_c, pos - pos_prev - 1, 0)

    # ---- sparse fields on chunk rows (per-lane carried table) -------------
    h = hash6(pk_c)
    table_val = jax.vmap(enc_ops._last_same_hash_value)(
        pk_c, h, nq_c, seen_in
    )
    is_index = nq_c & (table_val == pk_c)
    a_cur = unpack_channel(pk_c, 3)
    a_prev = unpack_channel(prev_cr, 3)
    if channels == 4:
        is_rgba = nq_c & ~is_index & (a_cur != a_prev)
    else:
        is_rgba = jnp.zeros((L, chunk_cap), bool)

    dr = to_int8(unpack_channel(pk_c, 0) - unpack_channel(prev_cr, 0))
    dg = to_int8(unpack_channel(pk_c, 1) - unpack_channel(prev_cr, 1))
    db = to_int8(unpack_channel(pk_c, 2) - unpack_channel(prev_cr, 2))
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
    diff_byte = (enc_ops.TAG_DIFF | ((dr + 2) << 4) | ((dg + 2) << 2)
                 | (db + 2)).astype(jnp.uint32)
    luma0 = (enc_ops.TAG_LUMA | (dg + 32)).astype(jnp.uint32)
    luma1 = (((dr_dg + 8) << 4) | (db_dg + 8)).astype(jnp.uint32)
    z = jnp.zeros((L, chunk_cap), jnp.uint32)
    o0 = jnp.where(is_index, h.astype(jnp.uint32),
                   jnp.where(is_rgba, jnp.uint32(enc_ops.TAG_RGBA),
                             jnp.where(is_diff, diff_byte,
                                       jnp.where(is_luma, luma0,
                                                 jnp.where(is_rgb,
                                                           jnp.uint32(
                                                               enc_ops.TAG_RGB),
                                                           z)))))
    o1 = jnp.where(is_rgba | is_rgb, r8, jnp.where(is_luma, luma1, z))
    o2 = jnp.where(is_rgba | is_rgb, g8, z)
    o3 = jnp.where(is_rgba | is_rgb, b8, z)
    o4 = jnp.where(is_rgba, a_cur, z)

    run_byte = jnp.where(
        nq_c, jnp.uint32(TAG_RUN) | ((gap - 1).astype(jnp.uint32) & 0x3F),
        jnp.uint32(TAG_RUN | 61),
    )
    has_run = jnp.where(nq_c, gap > 0, valid_c)  # non-noneq rows are hit62
    b0 = jnp.where(has_run, run_byte, o0)
    b1 = jnp.where(has_run, o0, o1)
    b2 = jnp.where(has_run, o1, o2)
    b3 = jnp.where(has_run, o2, o3)
    b4 = jnp.where(has_run, o3, o4)
    b5 = jnp.where(has_run, o4, z)
    nbytes_c = own_len + has_run.astype(jnp.uint32)
    tlo_c = b0 | (b1 << 8) | (b2 << 16) | (b3 << 24)
    thn_c = b4 | (b5 << 8) | (nbytes_c << 16)

    nb_c = nbytes_c.astype(jnp.int32)
    off = jnp.cumsum(nb_c, axis=1) - nb_c
    total_len = jnp.sum(nb_c, axis=1)
    out = sparse.emit_bytes(off, tlo_c, thn_c, out_cap)

    last = n_px - 1
    prev_out = jax.lax.dynamic_slice(packed_flat, (last,), (1,))[0]
    return out, total_len, prev_out, run_out.astype(jnp.uint32), seen_out


class DeviceStreamEncoder:
    """Window-granular streaming QOI encoder with device-resident state.

    Feed whole-pixel windows; receive each window's chunk bytes.  finalize()
    returns the pending-run byte (if any) plus the end marker — matching
    the reference's finalize contract (stream.cpp:241-267) at window
    granularity.

    split_lanes > 1 routes each window through _encode_window_lanes (the
    window splits into that many sub-windows with closed-form carries —
    no fixpoint; the sp-encode algebra on one device).  split_lanes=1
    keeps the single-lane path.  Default stays 1 until the lanes path
    has a measured timing win on the device."""

    def __init__(self, window_px: int = 1 << 18, split_lanes: int = 1):
        self.split_lanes = max(int(split_lanes), 1)
        self.window_px = window_px
        if self.split_lanes > 1:
            # each lane's sub-window must tile for the table scan
            self.nb = _round_up(
                window_px, self.split_lanes * enc_ops.TILE
            )
        else:
            self.nb = enc_ops.pad_to_tile(window_px)
        self._desc: Optional[Desc] = None
        self._prev = None
        self._run = None
        self._seen = None

    def is_initialized(self) -> bool:
        return self._desc is not None

    def initialize(self, desc: Desc) -> Result[bytes]:
        """Returns the 14-byte header."""
        from ..common import count_bytes, write_header

        if self._desc is not None:
            return Result.err(Error.ALREADY_INITIALIZED)
        bc = count_bytes(desc)
        if not bc:
            return Result.err(bc.error())
        self._desc = desc
        self._prev = jnp.uint32(START_PIXEL_PACKED)
        self._run = jnp.uint32(0)
        self._seen = jnp.zeros(64, jnp.uint32)
        return Result.ok(write_header(desc))

    def encode_window(self, raw) -> Result[np.ndarray]:
        """Encode a whole-pixel raw window; returns its chunk bytes."""
        if self._desc is None:
            return Result.err(Error.NOT_INITIALIZED)
        ch = int(self._desc.channels)
        raw = np.asarray(raw, np.uint8).reshape(-1)
        if raw.size % ch:
            return Result.err(Error.MISMATCHED_DESC)
        n = raw.size // ch
        out_parts = []
        for s in range(0, n, self.window_px):
            cnt = min(self.window_px, n - s)
            buf = np.zeros(self.nb * ch, np.uint8)
            buf[: cnt * ch] = raw[s * ch : (s + cnt) * ch]
            if self.split_lanes > 1:
                out, lens, prev, run, seen = _encode_window_lanes(
                    jnp.asarray(buf), jnp.int32(cnt), self._prev,
                    self._run, self._seen, channels=ch, nb=self.nb,
                    lanes=self.split_lanes,
                )
                self._prev, self._run, self._seen = prev, run, seen
                lens_h = np.asarray(lens)
                # ONE bulk fetch of the live byte span, bucket-rounded
                # (an exact-length eager slice compiles once per distinct
                # length); per-lane trim on host
                m = min(
                    _round_up(max(int(lens_h.max(initial=1)), 1), 8192),
                    out.shape[1],
                )
                host = np.asarray(out[:, :m])
                out_parts.extend(
                    host[l, : lens_h[l]]
                    for l in range(out.shape[0]) if lens_h[l]
                )
                continue
            out, length, prev, run, seen = _encode_window(
                jnp.asarray(buf), jnp.int32(cnt), self._prev, self._run,
                self._seen, channels=ch, nb=self.nb,
            )
            self._prev, self._run, self._seen = prev, run, seen
            # bucketed fetch: an exact-length eager slice compiles a new
            # program per distinct byte length
            length = int(length)
            m = min(_round_up(max(length, 1), 8192), out.shape[0])
            out_parts.append(np.asarray(out[:m])[:length])
        return Result.ok(
            np.concatenate(out_parts) if out_parts else np.zeros(0, np.uint8)
        )

    def has_run_count(self) -> bool:
        return self._run is not None and int(self._run) > 0

    def finalize(self) -> Result[bytes]:
        """Pending run byte (if any) + end marker; resets state."""
        from ..common import END_MARKER

        if self._desc is None:
            return Result.err(Error.NOT_INITIALIZED)
        run = int(self._run)
        tail = (bytes([0xC0 | (run - 1)]) if run > 0 else b"") + END_MARKER
        self.reset()
        return Result.ok(tail)

    def reset(self) -> None:
        self._desc = None
        self._prev = None
        self._run = None
        self._seen = None

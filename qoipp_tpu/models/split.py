"""Split-replay decode: over-cap streams' chunk fields spread across lanes.

Packed lanes (models/packed.py) share replay depth across MANY streams via
in-band resets — but a single over-cap stream still pays its full chunk
count sequentially (replay depth = stream bytes, the weak tier of round-3
serving).  This engine splits each big stream's chunk bytes into K
cost-balanced segments (cut ON chunk boundaries by the native walker,
native/qoi_ref.cpp::qoiref_split_points), replays ALL segments in parallel
kernel lanes from SPECULATIVE carries, and reconciles the seams with a
transfer-summary fixpoint — the single-chip analog of the sp-sharded
ppermute seam pass (parallel/sharded.py):

  * replay round: every lane replays its segment with the summary kernel
    (ops/replay_kernel.replay_batch_summary) from its current in-state
    guess, producing (emits, out-state, transfer summary); summary bit 0
    means that state component passed through the lane untouched;
  * propagate: a lax.scan over the lanes rebuilds each lane's
    implied in-state from its chain predecessor's out-state (chain heads
    re-enter the decoder's initial carry — or an explicit carried state,
    for the device streaming windows);
  * converged when every implied in-state equals the guess.  Any fixpoint
    IS the exact sequential semantics, by induction from each chain head
    (the same argument as ops/decode.decode_bytes, which proves this
    algebra with lax.scan tiles; here the tiles are kernel lanes).

Convergence is typically 2-3 rounds on real content (a segment almost
always overwrites prev and all 64 table slots), so a stream split K ways
costs ~rounds/K of its sequential replay.  Adversarial INDEX chains
degrade gracefully: one lane per round, bounded by max-chain-length + 2
rounds — still bit-exact, just slower (the bound make_sp_decode proves).

Reference analog: none — the reference decodes a multi-MB stream strictly
sequentially (source/simple.cpp:111-170).  This is the single-device
answer to its "sequence length" scaling (SURVEY.md §5 long-context note).
"""

from __future__ import annotations

from functools import partial
from typing import List, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .. import oracle
from ..common import read_header
from ..ops import boundary
from ..ops import decode as dec_ops
from ..ops import replay_kernel as rk
from ..ops import sparse
from ..ops.bitops import START_PIXEL_PACKED
from .packed import _bucket_mult, _round_up, _unpack_pixels_np

_START_HASH = (11 * 255) % 64


def _compact_cap(max_chunks: int, qb: int) -> int:
    """Static chunk-domain cap for _compact_chunks, or 0 to stay in the
    byte domain.  Compaction only pays when the chunk domain is actually
    shorter than the byte domain (mean chunk length ~1: dense noise
    streams gain nothing)."""
    qc = _bucket_mult(max_chunks + sparse.BLK + 128, 512)
    # demand a real saving: the compaction pass itself costs ~one sweep of
    # the byte planes, so a <25% depth cut is not worth it
    return qc if 4 * qc <= 3 * qb else 0


def _compact_chunks(meta, val, pix_before, keep, n_cap: int, qc: int):
    """Compact (meta, val, pix_before) from the byte domain to the chunk
    domain (keep = chunk starts): the fixpoint's per-round replay depth and
    the placement's row count both drop by the mean chunk length
    (1.3-5x, content-dependent).  The compaction itself is paid ONCE,
    outside the seam fixpoint — rounds multiply the replay saving.

    Invalid tail rows (beyond each lane's kept count) become NOP metas
    with pb = n_cap — placement's "never writes" convention.  qc is
    the static chunk cap from the host walker's per-segment chunk counts
    (oracle.split_points ordinals)."""
    (meta_c, val_c, pb_c), counts = sparse.compact_rows(
        (meta, val, pix_before), keep, qc
    )
    valid = jnp.arange(qc, dtype=jnp.int32)[None, :] < counts[:, None]
    pb_c = jnp.where(valid, pb_c, jnp.int32(n_cap))
    return meta_c, val_c, pb_c


def _seen0_vec():
    return (
        jnp.zeros(64, jnp.uint32).at[_START_HASH].set(
            jnp.uint32(START_PIXEL_PACKED)
        )
    )


@partial(jax.jit, static_argnames=("qb", "n_cap", "qc"))
def _decode_split_lanes(regions, heads, chunks_sizes, px_budgets,
                        max_chain, qb: int, n_cap: int, qc: int = 0):
    """regions: (L, qb+8) u8 segment bytes (each lane = ONE segment, first
    byte a chunk start); heads: (L,) bool — lane begins a new chain (a
    stream's first segment); chunks_sizes: (L,) i32; px_budgets: (L,) i32
    — each lane's pixel span from the native walker, which clamps RUN
    production at the image's w*h exactly like the reference decoder
    (simple.cpp:156-163); max_chain: traced scalar — longest chain length
    (fixpoint round bound); qc: static chunk cap — when > 0, replay and
    placement run on the compacted chunk domain (_compact_chunks) instead of the
    byte domain.

    Returns ((L, n_cap) u32 packed pixels per lane, rounds scalar)."""
    l = regions.shape[0]
    info = boundary.analyze_region_batch(
        regions[:, :qb], chunks_sizes, jnp.int32(0)
    )
    real, pix_before = info["real"], info["pix_before"]
    # Clamp at the walker's (already n_px-clamped) per-segment pixel span:
    # a crafted stream whose RUNs over-produce past w*h would otherwise
    # make the device pix_before disagree with the walker's px offsets and
    # silently diverge from the reference's clamped decode.  Chunks fully
    # past the budget stop incrementing pb, so placement's pb-increment
    # write mask drops them; a partially clamped RUN still writes and the
    # fill covers exactly the budgeted span.  Valid encoder
    # output never trips this (the clamp is then the identity).
    pix_before = jnp.minimum(pix_before, px_budgets[:, None])
    meta, val = dec_ops.fields_dense_batch(regions, real)
    if qc:
        meta, val, pix_before = _compact_chunks(
            meta, val, pix_before, real, n_cap, qc
        )

    meta_t, val_t = meta.T, val.T  # (width, l), chunk-major
    width = meta_t.shape[0]

    seen0 = _seen0_vec()

    def propagate(out_p, out_s, pu, sw):
        """Exclusive chain-walk over lanes: implied in-state per lane.
        out_p/pu: (l,); out_s/sw: (l, 64)."""

        def step(carry, x):
            p_c, s_c = carry
            head_k, op, os_, pu_k, sw_k = x
            in_p = jnp.where(head_k, jnp.uint32(START_PIXEL_PACKED), p_c)
            in_s = jnp.where(head_k, seen0, s_c)
            o_p = jnp.where(pu_k > 0, op, in_p)
            o_s = jnp.where(sw_k > 0, os_, in_s)
            return (o_p, o_s), (in_p, in_s)

        (_, _), (in_p, in_s) = jax.lax.scan(
            step,
            (jnp.uint32(START_PIXEL_PACKED), seen0),
            (heads, out_p, out_s, pu, sw),
        )
        return in_p, in_s  # (l,), (l, 64)

    def body(st):
        in_p, in_s, _, _, it = st
        emits, out_p, out_s, pu, sw = rk.replay_batch_summary(
            meta_t, val_t, in_p, in_s
        )
        want_p, want_s = propagate(out_p[0], out_s.T, pu[0], sw.T)
        want_p = want_p[None, :]
        want_s = want_s.T
        done = jnp.all(want_p == in_p) & jnp.all(want_s == in_s)
        # emits in the carry came from the replay with in_p; done means
        # in_p was already the fixpoint, so those emits are the exact ones
        return (want_p, want_s, emits, done, it + 1)

    def cond(st):
        _, _, _, done, it = st
        return (~done) & (it < max_chain + 2)

    init_p = jnp.full((1, l), START_PIXEL_PACKED, jnp.uint32)
    # Round-0 guess (speed only — ANY fixpoint is exact): empty slots
    # guess alpha = 0xFF, not 0.  OP_RGB keeps the carried alpha byte
    # (reference simple.cpp:119-129), so a wrong alpha picked up from a
    # speculative zero slot can NEVER heal inside a pure-RGB stream — it
    # travels the chain one lane per round (measured: a 128-segment photo
    # converged in 127 rounds with zero guesses, 3 with these).  Valid
    # encoder output only INDEXes slots holding real (alpha-0xFF in RGB)
    # pixels, so this guess is usually right where it matters.
    init_s = jnp.broadcast_to(
        jnp.where(seen0 == 0, jnp.uint32(0xFF000000), seen0)[:, None],
        (64, l),
    )
    init_e = jnp.zeros((width, l), jnp.uint32)
    _, _, emits_t, _, rounds = jax.lax.while_loop(
        cond, body, (init_p, init_s, init_e, jnp.array(False), jnp.int32(0))
    )
    return sparse.place_pixels(pix_before, emits_t.T, n_cap), rounds


@partial(jax.jit, static_argnames=("qb", "n_cap", "qc"))
def _decode_window_lanes(regions, seg_lens, prev0, seen_col0, max_chain,
                         qb: int, n_cap: int, qc: int = 0):
    """Window variant of _decode_split_lanes for the device streaming
    decoder: ONE chain whose head re-enters a CARRIED state (prev0 (1,),
    seen_col0 (64,)), and lanes hold segments of a byte window whose last
    chunk may be torn — a chunk counts only if it fits entirely inside its
    lane's seg_len (the window driver re-feeds the torn tail).  qc > 0
    routes replay and placement through the compacted chunk domain (the host
    walker's per-segment chunk counts bound every lane's kept count, torn
    tails only shrink it).

    Returns (packed (L, n_cap) u32, n_pix (L,) i32, consumed (L,) i32,
    prev_out (1,), seen_out (64,), rounds).  Padded zero-length lanes pass
    the state through, so the LAST lane's out-state is the window carry."""
    l = regions.shape[0]
    q = jnp.arange(qb, dtype=jnp.int32)[None, :]
    is_start = boundary.chunk_starts_batch(regions[:, :qb])
    lens = boundary.chunk_len_of(regions[:, :qb]).astype(jnp.int32)
    complete = is_start & (q + lens <= seg_lens[:, None])

    tag = regions[:, :qb].astype(jnp.int32)
    is_run = ((tag & 0xC0) == 0xC0) & (tag != 0xFE) & (tag != 0xFF)
    produced_raw = jnp.where(is_run, (tag & 0x3F) + 1, 1).astype(jnp.int32)
    produced = jnp.where(complete, produced_raw, 0)
    pix_before = jnp.cumsum(produced, axis=1) - produced
    consumed = jnp.max(jnp.where(complete, q + lens, 0), axis=1)
    n_pix = jnp.sum(produced, axis=1)

    meta, val = dec_ops.fields_dense_batch(regions, complete)
    if qc:
        meta, val, pix_before = _compact_chunks(
            meta, val, pix_before, complete, n_cap, qc
        )
    meta_t, val_t = meta.T, val.T  # (width, l), chunk-major
    width = meta_t.shape[0]
    heads = jnp.zeros(l, bool).at[0].set(True)  # one chain

    def propagate(out_p, out_s, pu, sw):
        def step(carry, x):
            p_c, s_c = carry
            head_k, op, os_, pu_k, sw_k = x
            in_p = jnp.where(head_k, prev0[0], p_c)
            in_s = jnp.where(head_k, seen_col0, s_c)
            o_p = jnp.where(pu_k > 0, op, in_p)
            o_s = jnp.where(sw_k > 0, os_, in_s)
            return (o_p, o_s), (in_p, in_s)

        (lp, ls), (in_p, in_s) = jax.lax.scan(
            step, (prev0[0], seen_col0), (heads, out_p, out_s, pu, sw)
        )
        return in_p, in_s, lp, ls  # + final (window-carry) state

    def body(st):
        in_p, in_s, _, _, _, _, it = st
        emits, out_p, out_s, pu, sw = rk.replay_batch_summary(
            meta_t, val_t, in_p, in_s
        )
        want_p, want_s, fin_p, fin_s = propagate(
            out_p[0], out_s.T, pu[0], sw.T
        )
        want_p = want_p[None, :]
        want_s = want_s.T
        done = jnp.all(want_p == in_p) & jnp.all(want_s == in_s)
        return (want_p, want_s, emits, fin_p, fin_s, done, it + 1)

    def cond(st):
        return (~st[5]) & (st[6] < max_chain + 2)

    init_p = jnp.full((1, l), START_PIXEL_PACKED, jnp.uint32)
    seen0 = _seen0_vec()
    init_s = jnp.broadcast_to(
        jnp.where(seen0 == 0, jnp.uint32(0xFF000000), seen0)[:, None],
        (64, l),
    )
    init_e = jnp.zeros((width, l), jnp.uint32)
    _, _, emits_t, fin_p, fin_s, _, rounds = jax.lax.while_loop(
        cond, body,
        (init_p, init_s, init_e, prev0[0], seen_col0,
         jnp.array(False), jnp.int32(0)),
    )
    packed = sparse.place_pixels(pix_before, emits_t.T, n_cap)
    return packed, n_pix, consumed, fin_p[None], fin_s, rounds


class SplitDecoder:
    """Decode large QOI streams by splitting each across replay lanes.

    Lane planning: each stream gets segments proportional to its cost
    (byte_w * body bytes + px_w * pixels — the same measured decode cost
    model as PackedDecoder's planner: replay is sequential in lane DEPTH,
    placement sweeps lanes x pixel cap), so the heaviest lane sets both
    compile caps as tightly as the corpus allows.  All segments of all
    streams ride ONE dispatch; chains never span dispatches.

    lanes: target lane count (<= 128).
    """

    MAX_LANES = 128

    def __init__(self, lanes: int = 128):
        if not 1 <= lanes <= self.MAX_LANES:
            raise ValueError("lanes must be in 1..128")
        self.lanes = lanes

    def decode(self, blobs: Sequence) -> List[np.ndarray]:
        packed, where, descs, _ = self.decode_to_device(blobs)
        packed = np.asarray(packed)  # ONE bulk fetch
        out = []
        for segs, d in zip(where, descs):
            npx = d.width * d.height
            px = np.empty(npx, np.uint32)
            for lane, p0, p1 in segs:
                px[p0:p1] = packed[lane, : p1 - p0]
            out.append(_unpack_pixels_np(px, int(d.channels)))
        return out

    def decode_to_device(self, blobs: Sequence):
        """Stage + dispatch; returns ((L, n_cap) u32 device pixels, where
        [per stream: list of (lane, px_start, px_end)], descs, rounds).
        Results stay in device memory (the serving form)."""
        return self.dispatch_staged(self.stage_to_device(blobs))

    def stage_to_device(self, blobs: Sequence):
        """Plan + upload only (no compute dispatched) — see
        PackedDecoder.stage_to_device for the staging rationale."""
        return self.stage_plan(self.plan_and_pack(blobs))

    @staticmethod
    def stage_plan(plan):
        """Upload a plan_and_pack host plan — see
        PackedDecoder.stage_plan for the worker-thread rationale."""
        from ..utils.transport import stage_h2d

        (regions, heads, chunks_sizes, px_budgets, where, descs, qb,
         n_cap, max_chain, qc) = plan
        return (stage_h2d(regions), jnp.asarray(heads),
                jnp.asarray(chunks_sizes), jnp.asarray(px_budgets),
                jnp.int32(max_chain), where, descs, qb, n_cap, qc)

    def dispatch_staged(self, staged):
        (regions, heads, chunks_sizes, px_budgets, max_chain, where,
         descs, qb, n_cap, qc) = staged
        packed, rounds = _decode_split_lanes(
            regions, heads, chunks_sizes, px_budgets, max_chain, qb=qb,
            n_cap=n_cap, qc=qc,
        )
        return packed, where, descs, rounds

    def plan_and_pack(self, blobs: Sequence):
        """Host staging: native chunk-walk split per stream, one segment
        per lane.  Returns (regions (L, qb+8) u8, heads (L,) bool,
        chunks_sizes (L,) i32, px_budgets (L,) i32, where, descs, qb,
        n_cap, max_chain, qc — the static chunk-compaction cap, 0 when
        the byte domain is denser-than-worthwhile)."""
        arrs = [
            np.frombuffer(bytes(x), np.uint8)
            if not isinstance(x, np.ndarray) else x
            for x in blobs
        ]
        descs = []
        for a in arrs:
            h = read_header(a)
            if not h:
                raise ValueError(f"bad stream: {h.error()}")
            descs.append(h.value())
        sizes = [a.size - 22 for a in arrs]
        if any(s < 1 for s in sizes):
            raise ValueError("truncated stream (no body bytes)")
        pxs = [d.width * d.height for d in descs]

        # cost model (relative weights, as PackedDecoder): replay
        # (46 + 2.45 L) per lane-depth byte; placement 0.27 L per
        # pixel-cap cell.  Total cost is known from headers alone.
        L = self.lanes
        byte_w = 46.0 + 2.45 * L
        px_w = 0.27 * L
        if len(arrs) > L:
            # every stream needs >= 1 lane; trimming a stream to 0
            # segments would silently drop it (uninitialized output).
            # Callers with bigger sets dispatch in groups (ServingCodec).
            raise ValueError(
                f"{len(arrs)} streams > {L} lanes; dispatch in groups of "
                "<= lanes streams"
            )
        costs = [byte_w * s + px_w * p for s, p in zip(sizes, pxs)]
        target = sum(costs) / L
        n_segs = [max(1, int(round(c / target))) for c in costs]
        while sum(n_segs) > L:  # rounding overshoot: trim the largest
            n_segs[int(np.argmax(n_segs))] -= 1
        assert all(k >= 1 for k in n_segs)  # guaranteed by len(arrs) <= L

        def _walk(chunk_w=0.0, bw=byte_w):
            plans = []  # (stream idx, byte offsets, px offsets, ordinals)
            for i, a in enumerate(arrs):
                # anchored cuts: segments open with an OP_RGB/OP_RGBA
                # chunk so the seam fixpoint converges in O(1) rounds on
                # smooth DIFF/LUMA content (see the walker's docstring);
                # the lookahead budget bounds the balance skew
                lookahead = max(sizes[i] // max(n_segs[i], 1) // 4, 64)
                offs, poffs, cis = oracle.split_points(
                    a[14 : 14 + sizes[i]], pxs[i], n_segs[i], bw, px_w,
                    lookahead=lookahead,
                    prefer_rgba=int(descs[i].channels) == 4,
                    chunk_w=chunk_w,
                )
                plans.append((i, offs, poffs, cis))
            return plans

        def _caps(plans):
            seg_bytes = [
                int(offs[k + 1] - offs[k])
                for _, offs, _, _ in plans for k in range(len(offs) - 1)
            ]
            seg_px = [
                int(poffs[k + 1] - poffs[k])
                for _, _, poffs, _ in plans for k in range(len(poffs) - 1)
            ]
            seg_chunks = [
                int(cis[k + 1] - cis[k])
                for _, _, _, cis in plans for k in range(len(cis) - 1)
            ]
            gran = 8 * boundary.BLOCK
            qb = _bucket_mult(max(max(seg_bytes), gran), gran)
            n_cap = _bucket_mult(max(max(seg_px), 1), sparse.WIN)
            return len(seg_bytes), qb, n_cap, _compact_cap(max(seg_chunks),
                                                           qb)

        # One byte+px-balanced walk.  A chunk-weighted RE-walk when
        # compaction engages shaves at most ~15% of qc but moves the cut
        # positions, and the fixpoint rounds grew (15 -> 19 at L=64).
        plans = _walk()
        n_lanes, qb, n_cap, qc = _caps(plans)

        l_ne = _round_up(n_lanes, 8)  # bounded compile-shape set
        regions = np.zeros((l_ne, qb + 8), np.uint8)
        heads = np.zeros(l_ne, bool)
        heads[n_lanes:] = True  # padded lanes: their own chains
        chunks_sizes = np.zeros(l_ne, np.int32)
        px_budgets = np.zeros(l_ne, np.int32)
        where: List[List[Tuple[int, int, int]]] = [[] for _ in arrs]
        lane = 0
        max_chain = 1
        for i, offs, poffs, _ in plans:
            body = arrs[i][14 : 14 + sizes[i]]
            nseg = len(offs) - 1
            max_chain = max(max_chain, nseg)
            for k in range(nseg):
                b0, b1 = int(offs[k]), int(offs[k + 1])
                regions[lane, : b1 - b0] = body[b0:b1]
                chunks_sizes[lane] = b1 - b0
                px_budgets[lane] = int(poffs[k + 1]) - int(poffs[k])
                heads[lane] = k == 0
                where[i].append((lane, int(poffs[k]), int(poffs[k + 1])))
                lane += 1
        return (regions, heads, chunks_sizes, px_budgets, where, descs,
                qb, n_cap, max_chain, qc)

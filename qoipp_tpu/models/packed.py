"""Stream-packed batched decode: total work tracks sum(sizes), not
B * max(size).

The shape-static batched pipeline taxes every lane with the batch's
worst stream (models/scheduler.py bucketing only soften this).  Packing
is the sequence-packing analog for codec lanes: many whole streams are
concatenated into each replay lane, back to back.  Three format facts
make this exact with almost no new machinery:

  * complete QOI streams end on a chunk boundary, so concatenated chunk
    bytes keep the boundary pass's phase algebra intact — chunk-start
    detection needs NO changes;
  * decoder state resets between streams ride IN-BAND: bit 9 of the
    dense meta word marks a chunk that begins a new stream, and the
    replay kernel re-enters the initial (prev, table) carry before
    applying that chunk (ops/replay_kernel.py);
  * output offsets assigned contiguously per lane make the placement
    offsets equal the boundary pass's plain pixel prefix sum, so the
    placement runs UNCHANGED (runs never leak across streams: every
    stream's first pixel is written by its first chunk).

Streams of mixed geometry and mixed RGB/RGBA pack into the same lane
(decode state is channel-agnostic; channels only matter when unpacking a
stream's slice).  The reference has no analog — it decodes files one at
a time (example/source/04_bench.cpp:849-871).
"""

from __future__ import annotations

from functools import partial
from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..common import Desc, read_header, write_header
from ..ops import boundary
from ..ops import decode as dec_ops
from ..ops import encode as enc_ops
from ..ops import replay_kernel as rk
from ..ops import sparse


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def plan_lanes(items: Sequence[Tuple[int, int]], lane_bytes: int
               ) -> List[List[int]]:
    """First-fit-decreasing bin packing of (bytes, px) items into lanes of
    lane_bytes chunk-byte capacity.  Returns lists of item indices."""
    order = sorted(range(len(items)), key=lambda i: -items[i][0])
    lanes: List[List[int]] = []
    loads: List[int] = []
    for i in order:
        sz = items[i][0]
        for L, load in enumerate(loads):
            if load + sz <= lane_bytes:
                lanes[L].append(i)
                loads[L] += sz
                break
        else:
            lanes.append([i])
            loads.append(sz)
    return lanes


@partial(jax.jit, static_argnames=("qb", "n_cap", "l_total"))
def _decode_lanes(regions, seg_flat, chunks_sizes, qb: int, n_cap: int,
                  l_total: int | None = None):
    """regions: (L_ne, qb+8) u8 — only NONEMPTY lanes are uploaded (a
    16-multiple lane grid with empty tail lanes is padded HERE, on
    device).  seg_flat: (S,) i32 flat lane*qb+offset stream-start
    indices — a dense flags plane would double the upload for a handful
    of set bits."""
    l_ne = regions.shape[0]
    if l_total is None:
        l_total = l_ne
    if l_total > l_ne:
        regions = jnp.pad(regions, ((0, l_total - l_ne), (0, 0)))
    flags = (
        jnp.zeros(l_total * qb, jnp.uint32)
        .at[seg_flat]
        .set(1, indices_are_sorted=True, unique_indices=True)
        .reshape(l_total, qb)
    )
    info = boundary.analyze_region_batch(
        regions[:, :qb], chunks_sizes, jnp.int32(0)
    )
    real, pix_before = info["real"], info["pix_before"]
    meta, val = dec_ops.fields_dense_batch(regions, real)
    meta = meta | (flags << 9)  # stream resets
    emits = rk.replay_batch(meta.T, val.T).T
    return sparse.place_pixels(pix_before, emits, n_cap)


class PackedDecoder:
    """Decode arbitrary mixed QOI streams through packed replay lanes.

    Lane shapes are adaptive (mirroring PackedEncoder): streams spread
    over up to 128 lanes balanced by body bytes (LPT), and the lane depth
    qb is the smallest compile-size bucket that fits.  The replay's
    sequential depth is the lane depth, so MANY short balanced lanes
    minimize it: replay steps = max lane bytes ~= total/L.

    lane_bytes: per-STREAM body-byte capacity (larger streams must route
    to the batched pipeline — models/serving.py does this) and minimum
    lane depth granularity source.
    """

    MAX_LANES = 128

    def __init__(self, lane_bytes: int = 1 << 20):
        self.lane_bytes = _round_up(lane_bytes, boundary.BLOCK)

    def decode(self, blobs: Sequence) -> List[np.ndarray]:
        """QOI byte streams (ANY geometries/channels) -> list of raw pixel
        buffers (each stream's native channels), submission order."""
        packed, where, descs = self.decode_to_device(blobs)
        packed = np.asarray(packed)  # ONE bulk fetch
        return [
            _unpack_pixels_np(
                packed[Li, poff : poff + d.width * d.height],
                int(d.channels),
            )
            for (Li, poff), d in zip(where, descs)
        ]

    def decode_to_device(self, blobs: Sequence):
        """Stage + dispatch only: returns ((L, n_cap) u32 device pixels,
        where [(lane, px_offset)], descs).  Results stay in device
        memory — the serving-loop form; fetching them is the caller's
        cost."""
        return self.dispatch_staged(self.stage_to_device(blobs))

    def stage_to_device(self, blobs: Sequence):
        """Plan + upload only (no compute dispatched): returns an opaque
        staged plan whose inputs are device-resident.  Separating staging
        from dispatch lets serving loops overlap the next batch's upload
        with this batch's compute, and lets benches time the device
        execution alone (the number a co-located deployment feels)."""
        return self.stage_plan(self.plan_and_pack(blobs))

    @staticmethod
    def stage_plan(plan):
        """Upload a plan_and_pack host plan (numpy) to the device.  The
        host-to-device copy releases the GIL, so a serving loop can run
        this on a worker thread while the calling thread plans the next
        tier (ServingCodec.decode_dispatch_overlapped)."""
        from ..utils.transport import stage_h2d

        regions, seg, chunks_sizes, where, descs, qb, n_cap, l_total = plan
        return (stage_h2d(regions), jnp.asarray(seg),
                jnp.asarray(chunks_sizes), where, descs, qb, n_cap, l_total)

    def dispatch_staged(self, staged):
        """Dispatch a stage_to_device plan; returns (device pixels, where,
        descs) with results HBM-resident."""
        regions, seg, chunks_sizes, where, descs, qb, n_cap, l_total = staged
        packed = _decode_lanes(
            regions, seg, chunks_sizes, qb=qb, n_cap=n_cap, l_total=l_total
        )
        return packed, where, descs

    def plan_and_pack(self, blobs: Sequence):
        """Host staging: plan balanced lanes and build the dense device
        inputs.  Returns (regions (L_ne, qb+8) u8 — nonempty lanes only,
        seg (S,) i32 flat stream-start indices, chunks_sizes (l_total,)
        i32, where [(lane, px_offset)], descs, qb, n_cap, l_total)."""
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
        items = [
            (a.size - 22, d.width * d.height) for a, d in zip(arrs, descs)
        ]
        for (sz, _), d in zip(items, descs):
            if sz > self.lane_bytes:
                raise ValueError(
                    f"stream of {sz} body bytes exceeds lane capacity "
                    f"{self.lane_bytes}; raise lane_bytes or route the "
                    "stream to the batched pipeline"
                )
            if sz < 1:
                # A parseable header with no body bytes would repeat the
                # previous seg_flat index, breaking the sorted/unique
                # scatter invariants of _decode_lanes (a false
                # indices_are_sorted hint can miscompile on a device while
                # passing CPU tests).  Reject up front.
                raise ValueError(
                    f"stream of {sz} body bytes is truncated (total "
                    "size <= header + end marker); not a decodable stream"
                )
        # Lane-plan search with a decode cost model (relative weights):
        # replay is sequential in the lane DEPTH qb (46 per byte-step);
        # boundary+fields+H2D sweep every lane-grid cell (2.45 per cell);
        # placement sweeps lanes x pixel-cap (0.27 per cell).  qb is set
        # by the heaviest lane's BYTES and n_cap by the heaviest lane's
        # PIXELS, so the LPT balances a combined weight — a byte-light
        # pixel-heavy outlier (a flat screenshot) otherwise inflates
        # every lane's place sweep.  Lane counts stay multiples of 16
        # (XLA picks a transposed 18x-padded layout for (7, several-M)
        # u32 temps otherwise).
        slots = [sz for sz, _ in items]
        pxs = [px for _, px in items]
        gran = 8 * boundary.BLOCK
        lmax = min(self.MAX_LANES, max(_round_up(len(items), 16), 16))
        best = None
        for L in (16, 32, 48, 64, 96, 128):
            if L > lmax:
                break
            wts = [
                (46 + 2.45 * L) * sz + 0.27 * L * px
                for sz, px in items
            ]
            qb = _bucket_mult(
                max(-(-sum(slots) // L), max(slots, default=1), gran), gran
            )
            while True:
                try:
                    cand = plan_lanes_balanced(slots, L, qb, wts)
                    break
                except ValueError:
                    qb = _bucket_mult(qb + 1, gran)
            ncap = _bucket_mult(
                max((sum(pxs[i] for i in m) for m in cand if m), default=1),
                sparse.WIN,
            )
            cost = (46 + 2.45 * L) * qb + 0.27 * L * ncap
            if best is None or cost < best[0]:
                best = (cost, cand, qb)
        _, lanes, qb = best
        # drop empty lanes (nonempty-first); only NONEMPTY lanes are
        # uploaded — l_total keeps the device grid a multiple of 16 via
        # on-device zero padding (see _decode_lanes).  The uploaded lane
        # count itself buckets to a multiple of 8 (zero host lanes): the
        # regions shape is a compile shape, and heterogeneous corpora
        # would otherwise recompile per distinct nonempty-lane count for
        # <= 7 lanes of upload padding.
        lanes = [m for m in sorted(lanes, key=lambda m: -len(m)) if m]
        l_total = max(16, _round_up(max(len(lanes), 1), 16))
        l_ne = min(_round_up(max(len(lanes), 1), 8), l_total)

        regions = np.zeros((l_ne, qb + 8), np.uint8)
        seg_flat: List[int] = []
        chunks_sizes = np.zeros(l_total, np.int32)
        # (stream idx) -> (lane, px_offset)
        where: List[Tuple[int, int]] = [(0, 0)] * len(arrs)
        lane_px = np.zeros(l_ne, np.int64)
        for Li, members in enumerate(lanes):
            boff = 0
            poff = 0
            for i in members:
                sz, npx = items[i]
                regions[Li, boff : boff + sz] = arrs[i][14 : 14 + sz]
                seg_flat.append(Li * qb + boff)  # lane-major: stays sorted
                where[i] = (Li, poff)
                boff += sz
                poff += npx
            chunks_sizes[Li] = boff
            lane_px[Li] = poff

        n_cap = _bucket_mult(max(int(lane_px.max()), 1), sparse.WIN)
        seg = np.asarray(seg_flat or [0], np.int32)
        return regions, seg, chunks_sizes, where, descs, qb, n_cap, l_total


# ---------------------------------------------------------------------------
# Encode-side packing (the symmetric analog: ops/encode.encode_lanes_checked)
# ---------------------------------------------------------------------------


def _pack_pixels_np(raw: np.ndarray, channels: int) -> np.ndarray:
    """Host-side (N*ch,) u8 -> (N,) u32 r|g<<8|b<<16|a<<24 (RGB: a=255)."""
    px = raw.reshape(-1, channels).astype(np.uint32)
    word = px[:, 0] | (px[:, 1] << 8) | (px[:, 2] << 16)
    if channels == 4:
        return word | (px[:, 3] << 24)
    return word | np.uint32(0xFF000000)


def _unpack_pixels_np(packed: np.ndarray, channels: int) -> np.ndarray:
    """Host-side (N,) u32 -> (N*ch,) u8 — numpy analog of
    bitops.packed_to_pixels.  Per-stream results are sliced out of ONE
    bulk device fetch on host: a device call per stream would add a
    dispatch and a transfer per stream."""
    out = np.empty((packed.size, channels), np.uint8)
    out[:, 0] = packed & 0xFF
    out[:, 1] = (packed >> 8) & 0xFF
    out[:, 2] = (packed >> 16) & 0xFF
    if channels == 4:
        out[:, 3] = packed >> 24
    return out.reshape(-1)


def _bucket_mult(n: int, m: int) -> int:
    """Round n up to a coarse compile-size bucket that is a multiple of m
    (powers of two with 1.25x intermediate steps) — limits retraces while
    keeping padding waste under ~25%."""
    n = max(n, m)
    b = m
    while b < n:
        b *= 2
    for frac in (5 * b // 8, 3 * b // 4, 7 * b // 8):
        if frac >= n and frac % m == 0:
            return frac
    return b


def plan_lanes_balanced(slots: Sequence[int], n_lanes: int, lane_cap: int,
                        weights: Optional[Sequence[float]] = None
                        ) -> List[List[int]]:
    """LPT (longest-processing-time) assignment of streams to n_lanes
    lanes of lane_cap pixel slots: sort descending by weight (default:
    slot count), place each on the least-weighted lane with slot room.
    Balanced loads matter more than packing density here — every lane
    pays the WORST lane's static chunk/byte caps (the compile shapes),
    so an even spread minimizes total work."""
    w = list(weights) if weights is not None else list(slots)
    order = sorted(range(len(slots)), key=lambda i: -w[i])
    lanes: List[List[int]] = [[] for _ in range(n_lanes)]
    loads = [0] * n_lanes
    wloads = [0.0] * n_lanes
    for i in order:
        cands = sorted(range(n_lanes), key=lambda L: wloads[L])
        for L in cands:
            if loads[L] + slots[i] <= lane_cap:
                lanes[L].append(i)
                loads[L] += slots[i]
                wloads[L] += w[i]
                break
        else:
            raise ValueError("lane_cap too small for the stream set")
    return lanes


class PackedEncoder:
    """Encode arbitrary mixed raw images through packed pixel lanes.

    Streams of ANY geometry/channels concatenate back-to-back in the
    pixel domain (plus 2 reserved tail slots per stream that carry the
    trailing run + end marker through compaction), so total device work
    tracks sum(pixels) instead of B * max(pixels) — the encode-side
    analog of PackedDecoder.  Bit-exact with the reference encoder
    (source/simple.cpp:36-95) for every member stream.

    Lane shapes are adaptive: streams spread over `lanes` lanes balanced
    by pixel count (LPT), and the lane size is the smallest compile-size
    bucket that fits — every lane pays the worst lane's STATIC caps, so
    few large balanced lanes beat many thin ones.  The chunk cap is
    computed EXACTLY at pack time (host-side keep-predicate count), so
    the table-scan/emit stages sweep no dead capacity; the byte cap
    starts at a fraction of worst case and the call retries once at the
    safe caps if a lane's checked flag trips
    (ops/encode.encode_lanes_checked): typical content never retries.

    lane_px: pixel-slot capacity cap per stream AND minimum lane size
        (streams with more pixels must route to the batched pipeline —
        models/serving.py does this).
    lanes: default lane count of the plan search.
    out_frac: initial byte cap as a fraction of the safe bound (the chunk
        cap is computed EXACTLY at pack time; byte length still needs op
        selection, so it keeps the fraction + one safe retry).
    """

    def __init__(self, lane_px: int = 1 << 20, lanes: int = 8,
                 out_frac: float = 0.3,
                 lane_counts: Optional[Sequence[int]] = None):
        self.lane_px = _round_up(lane_px, 2048)
        self.lanes = lanes
        self.out_frac = out_frac
        # lane-count candidates for the plan search (None -> default set)
        self.lane_counts = lane_counts

    def plan_and_pack(self, raws: Sequence[np.ndarray],
                      descs: Sequence[Desc]):
        """Host staging: plan balanced lanes and build the dense device
        inputs.  Returns (packed (L, Np) u32, flags (L, Np) u8, where
        [(lane, order)], caps dict) — encode() is this + one (retriable)
        device call + host slicing."""

        if len(raws) != len(descs):
            raise ValueError("raws and descs length mismatch")
        slots, px_arrays, stream_chunks = [], [], []
        for raw, d in zip(raws, descs):
            npx = d.width * d.height
            ch = int(d.channels)
            if np.asarray(raw).size != npx * ch:
                raise ValueError(
                    f"raw buffer size {np.asarray(raw).size} != {npx * ch}"
                )
            if npx + 2 > self.lane_px:
                raise ValueError(
                    f"stream of {npx} px exceeds lane capacity "
                    f"{self.lane_px - 2}; raise lane_px or route the "
                    "stream to the batched pipeline"
                )
            pk = _pack_pixels_np(np.asarray(raw, dtype=np.uint8), ch)
            px_arrays.append(pk)
            slots.append(npx + 2)
            # chunk rows are EXACTLY countable per stream at pack time
            # (streams are table-independent), incl. its 2 tail rows
            stream_chunks.append(self._count_stream_chunks(pk) + 2)

        # Lane-plan search over lane counts with the measured cost model:
        # dense+compact stages scale with L*np_ (~1 ns/slot), table-scan +
        # emit with L*chunk_cap (~1.2 ns/row; chunk_cap = the WORST lane's
        # chunk count, so the LPT balances a slots+chunks weight).
        # Bucketed lane sizes keep the compile-shape set bounded.
        total = sum(slots)
        wts = [s + 1.2 * c for s, c in zip(slots, stream_chunks)]
        best = None
        cand_counts = (sorted(set(self.lane_counts))
                       if self.lane_counts
                       else sorted({self.lanes, 8, 10, 12, 16}))
        for n_lanes in cand_counts:
            np_ = _bucket_mult(
                max(-(-total // n_lanes), max(slots, default=1)), 2048
            )
            while True:
                try:
                    cand = plan_lanes_balanced(slots, n_lanes, np_, wts)
                    break
                except ValueError:
                    np_ = _bucket_mult(np_ + 1, 2048)
            cand = [m for m in cand if m]  # drop empty lanes
            ccap = _bucket_mult(
                max((sum(stream_chunks[i] for i in m) for m in cand),
                    default=1) + sparse.BLK + 256, 2048)
            cost = len(cand) * (np_ + 1.2 * ccap)
            if best is None or cost < best[0]:
                best = (cost, cand, np_, ccap)
        _, lanes, np_, chunk_cap_t = best

        L = len(lanes)
        packed = np.zeros((L, np_), np.uint32)
        flags = np.zeros((L, np_), np.uint8)
        # (stream idx) -> (lane, order within lane)
        where: List[Tuple[int, int]] = [(0, 0)] * len(raws)
        worst = np.zeros(L, np.int64)
        max_members = 1
        for Li, members in enumerate(lanes):
            off = 0
            for k, i in enumerate(members):
                d = descs[i]
                npx = d.width * d.height
                ch = int(d.channels)
                packed[Li, off : off + npx] = px_arrays[i]
                flags[Li, off] |= enc_ops.FLAG_SEG_START
                flags[Li, off : off + npx] |= enc_ops.FLAG_VALID
                flags[Li, off + npx] = enc_ops.FLAG_TAIL0
                flags[Li, off + npx + 1] = enc_ops.FLAG_TAIL1
                where[i] = (Li, k)
                off += npx + 2
                worst[Li] += (ch + 1) * npx + 9
            max_members = max(max_members, len(members))

        safe_chunk = _round_up(np_ + np_ // 62 + sparse.BLK + 256, 2048)
        safe_out = _bucket_mult(max(int(worst.max()), 1), sparse.WIN)
        max_count = max(chunk_cap_t - sparse.BLK - 256, 1)
        caps = dict(
            chunk_cap=min(chunk_cap_t, safe_chunk),
            # bytes still need op selection; ~3 B/chunk covers photo/DIFF/
            # LUMA mixes (typical ~2.2-2.6) — all-noise RGB content (~4.5)
            # trips the checked flag and retries once at the safe bound
            out_cap=min(
                _bucket_mult(3 * max_count + 32, sparse.WIN),
                _bucket_mult(int(self.out_frac * safe_out) + 1, sparse.WIN),
                safe_out,
            ),
            ends_cap=_round_up(max_members + 2048 + 128, 128),
            safe_chunk=safe_chunk,
            safe_out=safe_out,
        )
        return packed, flags, where, caps

    @staticmethod
    def _count_stream_chunks(pk: np.ndarray) -> int:
        """Exact compacted-row count for one stream's packed pixels:
        noneq pixels + RUN-62 flush points — the keep predicate of
        ops/encode._encode_lanes_impl's dense pass, on host numpy.
        (Tail rows are NOT included — the caller adds 2.)"""
        from ..ops.bitops import START_PIXEL_PACKED

        prev = np.empty_like(pk)
        prev[0] = np.uint32(START_PIXEL_PACKED)
        prev[1:] = pk[:-1]
        eq = pk == prev
        n_noneq = int((~eq).sum())
        # maximal eq streaks start right after a noneq/start break, so the
        # run counter inside a streak of length m is 1..m -> floor(m/62)
        # RUN-62 flushes
        e = eq.astype(np.int8)
        d = np.diff(np.concatenate([[0], e, [0]]))
        starts = np.nonzero(d == 1)[0]
        stops = np.nonzero(d == -1)[0]
        return n_noneq + int(((stops - starts) // 62).sum())

    def encode(self, raws: Sequence[np.ndarray],
               descs: Sequence[Desc]) -> List[np.ndarray]:
        """Raw pixel buffers + Descs -> list of complete QOI streams
        (header + body), submission order."""
        return self.finish(self.dispatch_staged(
            self.stage_to_device(raws, descs)
        ))

    def stage_to_device(self, raws: Sequence[np.ndarray],
                        descs: Sequence[Desc]):
        """Plan + upload only (no compute dispatched) — the encode analog
        of PackedDecoder.stage_to_device."""
        return self.stage_plan(self.plan_and_pack(raws, descs) + (descs,))

    @staticmethod
    def stage_plan(plan):
        """Upload a plan_and_pack host plan (+ descs) to the device.  The
        host-to-device copy releases the GIL (worker-thread overlap, see
        PackedDecoder.stage_plan)."""
        from ..utils.transport import stage_h2d

        packed, flags, where, caps, descs = plan
        return (stage_h2d(packed), stage_h2d(flags), where, caps, descs)

    @staticmethod
    def dispatch_staged(staged):
        """Dispatch the encode kernels on a staged plan; returns
        (out, ends, nseg, ok device arrays, staged, where, descs) with the
        byte lanes in device memory.  OPTIMISTIC: the checked-cap flag is
        not fetched here (that would sync once per tier); finish()
        validates it and re-dispatches once at
        the safe bounds if dense content tripped the fractional caps —
        typical content never does (3 B/chunk covers photo/DIFF/LUMA
        mixes; only RGBA-noise exceeds it)."""
        packed_d, flags_d, where, caps, descs = staged
        out, ends, nseg, ok = enc_ops.encode_lanes_checked(
            packed_d, flags_d,
            chunk_cap=caps["chunk_cap"], out_cap=caps["out_cap"],
            ends_cap=caps["ends_cap"],
        )
        return out, ends, nseg, ok, staged, where, descs

    @staticmethod
    def finish(dispatched) -> List[np.ndarray]:
        """Fetch + slice a dispatch_staged result into complete QOI
        streams (header + body), submission order.  Performs the
        checked-cap retry at the safe bounds when needed."""
        out, ends, nseg, ok, staged, where, descs = dispatched
        if not bool(jnp.all(ok)):
            packed_d, flags_d, _, caps, _ = staged
            out, ends, nseg, ok = enc_ops.encode_lanes_checked(
                packed_d, flags_d,
                chunk_cap=caps["safe_chunk"], out_cap=caps["safe_out"],
                ends_cap=caps["ends_cap"],
            )
            if not bool(jnp.all(ok)):
                raise AssertionError(
                    "packed encode overflowed the safe caps — caps are "
                    "sized from worst_size and cannot overflow; file a bug"
                )
        # fetch ends first (tiny), then only the real byte span of each
        # lane, so dead out_cap capacity is never copied to the host
        ends = np.asarray(ends)
        nseg_h = np.asarray(nseg)
        used = max(
            (int(ends[Li, nseg_h[Li] - 1]) for Li in range(ends.shape[0])
             if nseg_h[Li] > 0),
            default=1,
        )
        out = np.asarray(out[:, : _round_up(max(used, 1), 128)])

        results: List[np.ndarray] = []
        for i, d in enumerate(descs):
            Li, k = where[i]
            start = int(ends[Li, k - 1]) if k else 0
            stop = int(ends[Li, k])
            header = np.frombuffer(write_header(d), dtype=np.uint8)
            results.append(
                np.concatenate([header, out[Li, start:stop]])
            )
        return results

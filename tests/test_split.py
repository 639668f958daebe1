"""Split-replay decode: exactness of the lane-split + seam fixpoint engine
(models/split.py) against the oracle, including seam-sensitive content
(segments opening with RUN / INDEX chunks whose state crosses the seam)
and the adversarial convergence bound."""

import numpy as np
import pytest

from qoipp_tpu import Channels, Desc, oracle
from qoipp_tpu.models.split import SplitDecoder


def _mixed_image(rng, w, h, ch):
    """Content with long runs, palette reuse (INDEX), gradients (DIFF/LUMA)
    and noise (RGB/RGBA) — every op class crosses segment seams."""
    n = w * h
    px = rng.integers(0, 256, (n, ch)).astype(np.uint8)
    px[n // 8 : n // 3] = 23  # long run region
    pal = rng.integers(0, 256, (6, ch)).astype(np.uint8)
    px[n // 3 : n // 2] = pal[rng.integers(0, 6, n // 2 - n // 3)]
    ramp = (np.arange(n // 4) % 250).astype(np.uint8)
    px[n // 2 : n // 2 + n // 4] = ramp[:, None] // np.arange(1, ch + 1)
    return px.reshape(-1)


@pytest.mark.parametrize("lanes", [4, 16])
def test_split_single_stream_bit_exact(lanes):
    rng = np.random.default_rng(0)
    desc = Desc(320, 200, Channels.RGB)
    raw = _mixed_image(rng, 320, 200, 3)
    enc, _ = oracle.encode(raw, desc)
    dec = SplitDecoder(lanes=lanes)
    got = dec.decode([enc])
    assert np.array_equal(got[0], raw)


def test_split_multi_stream_chains():
    rng = np.random.default_rng(1)
    blobs, raws = [], []
    for k, (w, h, ch) in enumerate(
        [(300, 150, 3), (128, 128, 4), (64, 32, 3), (250, 99, 4)]
    ):
        raw = _mixed_image(rng, w, h, ch)
        enc, _ = oracle.encode(raw, Desc(w, h, Channels(ch)))
        blobs.append(enc)
        raws.append(raw)
    dec = SplitDecoder(lanes=24)
    got = dec.decode(blobs)
    for i, raw in enumerate(raws):
        assert np.array_equal(got[i], raw), f"stream {i}"


def test_split_run_opening_seams():
    # Flat image: almost every segment opens with a RUN chunk whose value
    # is the seam's prev — the pure carried-prev dependence.
    desc = Desc(256, 128, Channels.RGB)
    raw = np.full(256 * 128 * 3, 77, np.uint8)
    raw[:3] = (1, 2, 3)
    enc, _ = oracle.encode(raw, desc)
    dec = SplitDecoder(lanes=8)
    got = dec.decode([enc])
    assert np.array_equal(got[0], raw)


def test_split_index_heavy_convergence_bound():
    # Palette-cycling content: INDEX chunks read table slots that earlier
    # segments wrote — the seam's table dependence.  The fixpoint must
    # stay within max_chain + 2 rounds and stay exact.
    rng = np.random.default_rng(2)
    n = 200 * 100
    pal = rng.integers(0, 256, (48, 3)).astype(np.uint8)
    raw = pal[rng.integers(0, 48, n)].reshape(-1)
    desc = Desc(200, 100, Channels.RGB)
    enc, _ = oracle.encode(raw, desc)
    dec = SplitDecoder(lanes=16)
    packed, where, descs, rounds = dec.decode_to_device([enc])
    max_chain = max(len(s) for s in where)
    assert int(rounds) <= max_chain + 2
    got = dec.decode([enc])
    assert np.array_equal(got[0], raw)


def test_split_overproducing_runs_clamp_like_reference():
    # Crafted (non-encoder) stream whose RUN chunks over-produce past w*h:
    # the reference decoder clamps production at n_px (simple.cpp:156-163)
    # and the native walker mirrors that clamp, so the device lanes must
    # clamp pix_before at each segment's budget instead of silently
    # diverging.  Interleave RGB writes so the stream still
    # splits into many real segments.
    from qoipp_tpu.common import write_header

    w, h = 100, 10  # n_px = 1000
    desc = Desc(w, h, Channels.RGB)
    body = bytearray()
    rng = np.random.default_rng(7)
    produced = 0
    while produced < 3 * w * h:  # 3x over-production
        r, g, b = (int(x) for x in rng.integers(0, 256, 3))
        body += bytes([0xFE, r, g, b])  # OP_RGB anchor
        body += bytes([0xC0 | 61])      # RUN(62)
        produced += 63
    stream = bytes(write_header(desc)) + bytes(body) + b"\0" * 7 + b"\1"
    want = oracle.decode(np.frombuffer(stream, np.uint8), desc,
                         Channels.RGB)
    dec = SplitDecoder(lanes=8)
    got = dec.decode([stream])
    assert np.array_equal(got[0], want)


def test_split_planner_segments_on_chunk_boundaries():
    rng = np.random.default_rng(3)
    raw = _mixed_image(rng, 400, 300, 3)
    enc, _ = oracle.encode(raw, Desc(400, 300, Channels.RGB))
    dec = SplitDecoder(lanes=32)
    (regions, heads, chunks_sizes, px_budgets, where, descs, qb, n_cap,
     max_chain, qc) = dec.plan_and_pack([enc])
    segs = where[0]
    assert len(segs) > 1
    assert heads[segs[0][0]] and not any(heads[s[0]] for s in segs[1:])
    # pixel coverage is a partition of the image
    assert segs[0][1] == 0
    for (l0, a0, b0), (l1, a1, b1) in zip(segs, segs[1:]):
        assert b0 == a1
    assert segs[-1][2] == 400 * 300
    # per-lane pixel budgets mirror the walker's segment spans
    for lane, a, b in segs:
        assert px_budgets[lane] == b - a
    # lanes' byte loads are balanced within ~2x
    loads = [int(chunks_sizes[s[0]]) for s in segs]
    assert max(loads) <= 2 * max(min(loads), 1)


def test_split_chunk_compaction_engages_and_stays_exact():
    # Run-heavy content (mean chunk length ~ tens of bytes/chunk) must take
    # the compacted chunk-domain path (qc > 0) and stay bit-exact; the
    # same content forced through the byte domain (qc=0 gate for dense
    # streams) must agree.  Guards the _compact_chunks masking conventions
    # (NOPK metas, pb = n_cap never-write rows) on both engines.
    from qoipp_tpu.models.split import _decode_split_lanes

    rng = np.random.default_rng(4)
    n = 400 * 300
    # 8-pixel runs: ~2.5 bytes/chunk (RUN + OP_RGB per group) — sparse
    # enough that chunk count + the compact kernel's write-window slack
    # stays under the byte depth at 8 lanes
    raw = np.repeat(
        rng.integers(0, 256, (n // 8 + 1, 3), dtype=np.uint8), 8, axis=0
    ).reshape(-1)[: n * 3].copy()
    desc = Desc(400, 300, Channels.RGB)
    enc, _ = oracle.encode(raw, desc)
    dec = SplitDecoder(lanes=8)
    plan = dec.plan_and_pack([enc])
    qc = plan[9]
    assert qc > 0, "run-heavy stream should engage chunk compaction"
    got = dec.decode([enc])
    assert np.array_equal(got[0], raw)
    # byte-domain forcing: same plan, qc=0 — the two domains must agree on
    # every REAL pixel (tail rows beyond a lane's span may differ: the
    # fill repeats the last emitted value from different pad conventions)
    staged = dec.stage_plan(plan[:9] + (0,))
    packed0, where, descs, _ = dec.dispatch_staged(staged)
    packedc, _, _, _ = dec.dispatch_staged(dec.stage_plan(plan))
    p0, pc = np.asarray(packed0), np.asarray(packedc)
    for lane, a, b in where[0]:
        assert np.array_equal(p0[lane, : b - a], pc[lane, : b - a]), lane


def test_split_dense_stream_gates_to_byte_domain():
    # Palette-cycling content encodes as ~1-byte INDEX chunks: the chunk
    # domain is as long as the byte domain (plus the compact kernel's
    # slack), so the planner must keep qc = 0 (the dense gate).
    rng = np.random.default_rng(5)
    pal = rng.integers(0, 256, (48, 3)).astype(np.uint8)
    raw = pal[rng.integers(0, 48, 200 * 160)].reshape(-1)
    enc, _ = oracle.encode(raw, Desc(200, 160, Channels.RGB))
    dec = SplitDecoder(lanes=8)
    plan = dec.plan_and_pack([enc])
    assert plan[9] == 0
    got = dec.decode([enc])
    assert np.array_equal(got[0], raw)


def test_split_rejects_more_streams_than_lanes():
    from qoipp_tpu.models.split import SplitDecoder

    rng = np.random.default_rng(3)
    desc = Desc(32, 24, Channels.RGB)
    blobs = []
    for _ in range(5):
        raw = rng.integers(0, 256, 32 * 24 * 3, dtype=np.uint8)
        blobs.append(oracle.encode(raw, desc)[0])
    dec = SplitDecoder(lanes=4)
    with pytest.raises(ValueError, match="streams > 4 lanes"):
        dec.plan_and_pack(blobs)


def test_serving_groups_overcap_streams_beyond_lane_count():
    # more over-cap streams than split lanes: the router must dispatch
    # them in groups, never silently dropping one
    from qoipp_tpu.models.serving import ServingCodec

    rng = np.random.default_rng(9)
    desc = Desc(48, 40, Channels.RGB)
    n = 48 * 40 * 3
    raws, blobs = [], []
    for _ in range(7):  # all over-cap for split_min_bytes=256
        raw = rng.integers(0, 256, n, dtype=np.uint8)
        enc, _ = oracle.encode(raw, desc)
        raws.append(raw)
        blobs.append(enc)
    codec = ServingCodec(split_min_bytes=256, split_lanes=3,
                         min_len=1 << 10)
    outs = codec.decode(blobs)
    for i, raw in enumerate(raws):
        assert np.array_equal(outs[i], raw), f"stream {i}"

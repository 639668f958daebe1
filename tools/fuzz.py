#!/usr/bin/env python
"""Differential fuzz harness.

Mirrors the reference's libFuzzer harness (example/source/99_fuzz.cpp):
- decode fuzzing: random byte payloads behind a valid header must decode
  without crashing, and identically on every backend (99_fuzz.cpp:95-112);
- encode fuzzing: random raw buffers reinterpreted under random Descs
  (99_fuzz.cpp:114-123);
- stream fuzzing: random buffer sizes through the streaming codecs
  (99_fuzz.cpp:125-161).

Where the reference compares against ASan cleanliness, this harness does
DIFFERENTIAL checking: every backend (native oracle, JAX kernel pipeline,
streaming) must agree bit-for-bit.
"""

import argparse
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import qoipp_tpu as q
from qoipp_tpu import oracle
from qoipp_tpu.ops import decode as dec_ops


def fuzz_decode(rng, max_side=64):
    """Random chunk payload behind a valid header: oracle vs kernel."""
    w = int(rng.integers(1, max_side))
    h = int(rng.integers(1, max_side))
    ch = q.Channels.RGBA if rng.random() < 0.5 else q.Channels.RGB
    desc = q.Desc(w, h, ch)
    body_len = int(rng.integers(0, 5 * w * h + 30))
    body = rng.integers(0, 256, body_len, dtype=np.uint8)
    stream = np.frombuffer(
        q.write_header(desc) + body.tobytes() + q.END_MARKER, np.uint8
    )
    want = oracle.decode(stream, desc, ch)
    got = dec_ops.decode_single(stream, desc, ch)
    assert np.array_equal(got, want), f"decode divergence: {desc}, len={body_len}"


def fuzz_truncated(rng, max_side=48):
    """Truncated well-formed streams (tolerant decode)."""
    w = int(rng.integers(2, max_side))
    h = int(rng.integers(2, max_side))
    ch = q.Channels.RGB if rng.random() < 0.5 else q.Channels.RGBA
    desc = q.Desc(w, h, ch)
    raw = (rng.integers(0, 5, w * h * int(ch)) * 11).astype(np.uint8)
    enc, _ = oracle.encode(raw, desc)
    cut = int(rng.integers(15, enc.size))
    stream = enc[:cut]
    want = oracle.decode(stream, desc, ch)
    got = dec_ops.decode_single(stream, desc, ch)
    assert np.array_equal(got, want), f"truncated divergence: {desc}, cut={cut}"


def fuzz_encode_roundtrip(rng, max_side=64):
    """Random raw buffers: jax encode must equal oracle encode."""
    w = int(rng.integers(1, max_side))
    h = int(rng.integers(1, max_side))
    ch = q.Channels.RGBA if rng.random() < 0.5 else q.Channels.RGB
    desc = q.Desc(w, h, ch)
    mode = rng.random()
    n = w * h * int(ch)
    if mode < 0.3:
        raw = rng.integers(0, 256, n, dtype=np.uint8)
    elif mode < 0.7:
        raw = (rng.integers(0, 4, n) * int(rng.integers(1, 80))).astype(np.uint8)
    else:
        raw = np.tile(rng.integers(0, 256, int(ch), dtype=np.uint8), w * h)
    want, complete = oracle.encode(raw, desc)
    assert complete
    got = q.encode(raw, desc, backend="jax").value()
    assert np.array_equal(got, want), f"encode divergence: {desc}"
    dec = oracle.decode(want, desc, ch)
    assert np.array_equal(dec, raw), f"roundtrip failure: {desc}"


def fuzz_stream(rng, max_side=40):
    """Random buffer sizes through the native streaming codecs."""
    w = int(rng.integers(2, max_side))
    h = int(rng.integers(2, max_side))
    ch = q.Channels.RGBA if rng.random() < 0.5 else q.Channels.RGB
    desc = q.Desc(w, h, ch)
    raw = (rng.integers(0, 6, w * h * int(ch)) * 9).astype(np.uint8)
    want, _ = oracle.encode(raw, desc)

    enc_buf = int(rng.integers(5, 300))
    enc = q.StreamEncoder()
    out = np.zeros(enc_buf, np.uint8)
    hdr = np.zeros(14, np.uint8)
    parts = bytearray()
    enc.initialize(hdr, desc)
    parts += hdr.tobytes()
    consumed = 0
    while consumed < raw.size:
        r = enc.encode(out, raw[consumed : consumed + enc_buf]).value()
        parts += out[: r.written].tobytes()
        consumed += r.processed
    fin = np.zeros(9, np.uint8)
    n = enc.finalize(fin).value()
    parts += fin[:n].tobytes()
    got = np.frombuffer(bytes(parts), np.uint8)
    assert np.array_equal(got, want), f"stream encode divergence: {desc}, buf={enc_buf}"

    dec_buf = int(rng.integers(max(int(ch), 5), 300))
    dec = q.StreamDecoder()
    dec.initialize(want[:14])
    outd = np.zeros(dec_buf, np.uint8)
    pix = bytearray()
    consumed = 14
    end = want.size - 8
    while consumed < end:
        r = dec.decode(outd, want[consumed : consumed + dec_buf]).value()
        pix += outd[: r.written].tobytes()
        consumed += r.processed
        if r.processed == 0 and r.written == 0:
            break
    while dec.has_run_count():
        n = dec.drain_run(outd).value()
        pix += outd[:n].tobytes()
    got_raw = np.frombuffer(bytes(pix), np.uint8)[: raw.size]
    assert np.array_equal(got_raw, raw), f"stream decode divergence: {desc}, buf={dec_buf}"


def fuzz_split(rng, max_px=90_000):
    """Split-replay decode engine (models/split.SplitDecoder): one large
    stream spread across replay lanes with seam-fixpoint reconciliation
    must equal the oracle — INDEX-heavy palettes and long runs stress the
    cross-lane state dependency chain."""
    from qoipp_tpu.models.split import SplitDecoder

    w = int(rng.integers(64, 400))
    h = max(min(int(rng.integers(64, 400)), max_px // w), 8)
    ch = q.Channels.RGBA if rng.random() < 0.5 else q.Channels.RGB
    desc = q.Desc(w, h, ch)
    n = w * h * int(ch)
    mode = rng.random()
    if mode < 0.3:  # palette (INDEX-heavy; entries survive across lanes)
        pal = rng.integers(0, 256, (int(rng.integers(3, 60)), int(ch)),
                           dtype=np.uint8)
        raw = pal[rng.integers(0, len(pal), w * h)].reshape(-1)
    elif mode < 0.6:  # smooth gradients (DIFF/LUMA-heavy)
        raw = (np.cumsum(rng.integers(-2, 3, n)) % 256).astype(np.uint8)
    elif mode < 0.8:  # long runs
        raw = np.repeat(rng.integers(0, 256, n // 97 + 1, dtype=np.uint8),
                        97)[:n].copy()
    else:  # noise (RGB/RGBA ops)
        raw = rng.integers(0, 256, n, dtype=np.uint8)
    if ch == q.Channels.RGBA and rng.random() < 0.5:
        raw.reshape(-1, 4)[:, 3] = 255
    enc, _ = oracle.encode(raw, desc)
    dec = SplitDecoder(lanes=int(rng.integers(4, 48)))
    outs = dec.decode([enc])
    assert np.array_equal(outs[0], raw), \
        f"split decode divergence: {desc}, lanes={dec.lanes}"


def fuzz_device_window(rng, max_px=60_000):
    """Device windowed streaming decoder (ops/device_stream): random window
    sizes tear chunks at arbitrary byte positions; the carried (prev,
    table) state and the torn-tail re-feed must stay exact — including
    when the split-lane compaction gate flips between windows."""
    from qoipp_tpu.ops.device_stream import DeviceStreamDecoder

    w = int(rng.integers(40, 300))
    h = max(min(int(rng.integers(40, 300)), max_px // w), 8)
    ch = q.Channels.RGBA if rng.random() < 0.5 else q.Channels.RGB
    desc = q.Desc(w, h, ch)
    n = w * h * int(ch)
    mode = rng.random()
    if mode < 0.35:  # runs (sparse chunk domain: compaction engages)
        rep = int(rng.integers(4, 40))
        raw = np.repeat(
            rng.integers(0, 256, (n // rep + 1,), dtype=np.uint8), rep
        )[:n].copy()
    elif mode < 0.65:  # palette (dense: gate off)
        pal = rng.integers(0, 256, (int(rng.integers(3, 50)), int(ch)),
                           dtype=np.uint8)
        raw = pal[rng.integers(0, len(pal), w * h)].reshape(-1)
    else:  # gradient
        raw = (np.cumsum(rng.integers(-2, 3, n)) % 256).astype(np.uint8)
    enc, _ = oracle.encode(raw, desc)
    win = int(rng.integers(600, 60_000))
    dec = DeviceStreamDecoder(
        window_cap=win + 1024, pixel_cap=-(-w * h // 8192) * 8192,
        split_lanes=int(rng.integers(2, 24)),
    )
    assert dec.initialize(enc[:14])
    body = enc[14:-8]
    parts = []
    for s in range(0, body.size, win):
        r = dec.decode_window(body[s : s + win])
        assert r, r.error()
        parts.append(r.value())
    got = np.concatenate([p for p in parts if p.size] or [np.zeros(0, np.uint8)])
    assert np.array_equal(got, raw), \
        f"device window divergence: {desc}, win={win}, lanes={dec.split_lanes}"


def fuzz_device_window_encode(rng, max_px=40_000):
    """Device windowed streaming ENCODER: random window capacities and
    feed sizes (whole pixels, torn anywhere) with carried (prev, run,
    table) state must assemble the oracle's exact stream, including the
    finalize pending-run/end-marker contract."""
    from qoipp_tpu.ops.device_stream import DeviceStreamEncoder

    w = int(rng.integers(30, 260))
    h = max(min(int(rng.integers(30, 260)), max_px // w), 6)
    ch = q.Channels.RGBA if rng.random() < 0.5 else q.Channels.RGB
    desc = q.Desc(w, h, ch)
    n = w * h * int(ch)
    mode = rng.random()
    if mode < 0.35:  # runs crossing window seams
        rep = int(rng.integers(3, 80))
        raw = np.repeat(
            rng.integers(0, 256, (n // rep + 1,), dtype=np.uint8), rep
        )[:n].copy()
    elif mode < 0.65:  # palette (INDEX state crosses windows)
        pal = rng.integers(0, 256, (int(rng.integers(3, 50)), int(ch)),
                           dtype=np.uint8)
        raw = pal[rng.integers(0, len(pal), w * h)].reshape(-1)
    else:
        raw = (np.cumsum(rng.integers(-3, 4, n)) % 256).astype(np.uint8)
    want, _ = oracle.encode(raw, desc)
    # fixed window-size/lane set: each distinct (window, lanes) pair
    # compiles its own program; lanes > 1 exercises the closed-form-carry
    # multi-lane path (_encode_window_lanes)
    wins = (256, 1024, 3000, 8192)
    lanes = (1, 8)[int(rng.integers(0, 2))]
    enc = DeviceStreamEncoder(window_px=int(wins[int(rng.integers(0, 4))]),
                              split_lanes=lanes)
    r = enc.initialize(desc)
    assert r, r.error()
    stream = bytearray(r.value())
    step_px = int(rng.integers(1, enc.window_px + 1))
    step = step_px * int(ch)
    for s in range(0, n, step):
        r = enc.encode_window(raw[s : s + step])
        assert r, r.error()
        stream += bytes(r.value())
    r = enc.finalize()
    assert r, r.error()
    stream += bytes(r.value())
    got = np.frombuffer(bytes(stream), np.uint8)
    assert np.array_equal(got, want), \
        f"device window encode divergence: {desc}, win={enc.window_px}, " \
        f"step={step_px}"


def fuzz_serving(rng):
    """ServingCodec router: mixed corpora straddling every routing
    boundary (packed tier / split engine / bucketed batch) through
    decode AND encode must equal the oracle per stream.  Geometries come
    from a small fixed set so jit caches persist across iterations; the
    codec presets force all three engines to engage at toy sizes."""
    from qoipp_tpu.models.serving import ServingCodec

    presets = [
        dict(pack_lane_bytes=16 << 10, pack_lane_px=1 << 12,
             split_min_bytes=8 << 10, min_len=1 << 10),
        dict(pack_lane_bytes=8 << 10, pack_lane_px=1 << 11,
             split_min_bytes=4 << 10, min_len=1 << 10),
        # split_lanes=2 forces GROUPED split dispatches whenever > 2
        # streams go over-cap (the silent-drop regression class)
        dict(pack_lane_bytes=16 << 10, pack_lane_px=1 << 12,
             split_min_bytes=2 << 10, min_len=1 << 10, split_lanes=2),
    ]
    cache = getattr(fuzz_serving, "_codecs", {})
    fuzz_serving._codecs = cache
    key = int(rng.integers(0, len(presets)))
    codec = cache.get(key)
    if codec is None:
        codec = cache[key] = ServingCodec(**presets[key])

    geoms = [(40, 30), (64, 48), (100, 80), (128, 90)]
    b = int(rng.integers(2, 7))
    raws, blobs, descs = [], [], []
    for _ in range(b):
        w, h = geoms[int(rng.integers(0, len(geoms)))]
        ch = q.Channels.RGBA if rng.random() < 0.4 else q.Channels.RGB
        desc = q.Desc(w, h, ch)
        n = w * h * int(ch)
        mode = rng.random()
        if mode < 0.3:  # noise (dense streams: over split_min at 100x80+)
            raw = rng.integers(0, 256, n, dtype=np.uint8)
        elif mode < 0.6:  # palette
            pal = rng.integers(0, 256, (int(rng.integers(3, 40)), int(ch)),
                               dtype=np.uint8)
            raw = pal[rng.integers(0, len(pal), w * h)].reshape(-1)
        else:  # runs
            rep = int(rng.integers(5, 60))
            raw = np.repeat(
                rng.integers(0, 256, n // rep + 1, dtype=np.uint8), rep
            )[:n].copy()
        enc, complete = oracle.encode(raw, desc)
        assert complete
        raws.append(raw)
        blobs.append(enc)
        descs.append(desc)

    outs = codec.decode(blobs)
    for i, raw in enumerate(raws):
        assert np.array_equal(outs[i], raw), \
            f"serving decode divergence: stream {i} {descs[i]} preset {key}"
    streams = codec.encode(raws, descs)
    for i, want in enumerate(blobs):
        assert np.array_equal(streams[i], want), \
            f"serving encode divergence: stream {i} {descs[i]} preset {key}"


FUZZERS = {
    "decode": fuzz_decode,
    "truncated": fuzz_truncated,
    "encode": fuzz_encode_roundtrip,
    "stream": fuzz_stream,
    "split": fuzz_split,
    "window": fuzz_device_window,
    "window-enc": fuzz_device_window_encode,
    "serving": fuzz_serving,
}


def main(argv=None):
    p = argparse.ArgumentParser(description="Differential QOI fuzzer")
    p.add_argument("-n", "--iterations", type=int, default=50)
    p.add_argument("-s", "--seed", type=int, default=0)
    p.add_argument("--only", choices=sorted(FUZZERS), default=None)
    p.add_argument("--cpu", action="store_true",
                   help="force the CPU backend (set before the backend "
                        "initializes)")
    args = p.parse_args(argv)
    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")

    rng = np.random.default_rng(args.seed)
    targets = [FUZZERS[args.only]] if args.only else list(FUZZERS.values())
    for i in range(args.iterations):
        for fz in targets:
            fz(rng)
        if (i + 1) % 10 == 0:
            print(f"{i + 1}/{args.iterations} iterations clean", flush=True)
    print(f"fuzz OK: {args.iterations} iterations x {len(targets)} targets")
    return 0


if __name__ == "__main__":
    sys.exit(main())

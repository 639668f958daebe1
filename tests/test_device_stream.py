"""Device-resident windowed streaming codec tests: window-size sweeps must
reproduce the one-shot stream bit-exactly (the device analog of the reference's
buffer-size sweep, stream_test.cpp:192-252, at window granularity)."""

import numpy as np
import pytest

from qoipp_tpu import Channels, Desc
from qoipp_tpu import oracle
from qoipp_tpu.ops.device_stream import DeviceStreamDecoder, DeviceStreamEncoder

DESC3 = Desc(29, 17, Channels.RGB)
DESC4 = Desc(24, 14, Channels.RGBA)


def make_image(desc, seed=0):
    rng = np.random.default_rng(seed)
    n = desc.width * desc.height
    ch = int(desc.channels)
    pal = rng.integers(0, 256, (7, ch)).astype(np.uint8)
    raw = pal[rng.integers(0, 7, n)].reshape(-1)
    enc, _ = oracle.encode(raw, desc)
    return raw, enc


@pytest.mark.parametrize("feed", [7, 64, 333, 1019])
def test_decode_window_sweep(feed, raw3=None):
    raw, enc = make_image(DESC3, seed=1)
    dec = DeviceStreamDecoder(window_cap=1024)
    d = dec.initialize(enc[:14]).value()
    assert d.width == 29
    chunks = enc[14:-8]
    out = []
    for i in range(0, chunks.size, feed):
        r = dec.decode_window(chunks[i : i + feed]).value()
        out.append(r)
    got = np.concatenate(out)
    assert np.array_equal(got, raw), f"feed={feed}"
    dec.reset()


@pytest.mark.parametrize("feed", [11, 128, 500])
def test_decode_window_sweep_rgba(feed):
    raw, enc = make_image(DESC4, seed=2)
    dec = DeviceStreamDecoder(window_cap=512)
    dec.initialize(enc[:14]).value()
    chunks = enc[14:-8]
    out = []
    for i in range(0, chunks.size, feed):
        out.append(dec.decode_window(chunks[i : i + feed]).value())
    got = np.concatenate(out)
    assert np.array_equal(got, raw), f"feed={feed}"


def test_decode_target_conversion():
    raw, enc = make_image(DESC3, seed=3)
    dec = DeviceStreamDecoder(window_cap=512)
    d = dec.initialize(enc[:14], target=Channels.RGBA).value()
    assert d.channels == Channels.RGBA
    got = dec.decode_window(enc[14:-8]).value().reshape(-1, 4)
    assert np.array_equal(got[:, :3].reshape(-1), raw)
    assert np.all(got[:, 3] == 255)


@pytest.mark.parametrize("window_px", [37, 100, 256])
def test_encode_window_sweep(window_px):
    raw, want = make_image(DESC3, seed=4)
    enc = DeviceStreamEncoder(window_px=window_px)
    stream = bytearray(enc.initialize(DESC3).value())
    ch = 3
    n = DESC3.width * DESC3.height
    step = window_px * ch
    for i in range(0, n * ch, step):
        stream += enc.encode_window(raw[i : i + step]).value().tobytes()
    stream += enc.finalize().value()
    assert np.array_equal(np.frombuffer(bytes(stream), np.uint8), want), (
        f"window={window_px}"
    )


@pytest.mark.parametrize("window_px", [50, 129])
def test_encode_window_sweep_rgba(window_px):
    raw, want = make_image(DESC4, seed=5)
    enc = DeviceStreamEncoder(window_px=window_px)
    stream = bytearray(enc.initialize(DESC4).value())
    n4 = raw.size
    step = window_px * 4
    for i in range(0, n4, step):
        stream += enc.encode_window(raw[i : i + step]).value().tobytes()
    stream += enc.finalize().value()
    assert np.array_equal(np.frombuffer(bytes(stream), np.uint8), want)


def test_encode_run_across_windows():
    # A long run crossing several window boundaries must keep its counter.
    desc = Desc(200, 1, Channels.RGB)
    raw = np.full(600, 7, np.uint8)
    raw[:3] = (1, 2, 3)
    want, _ = oracle.encode(raw, desc)
    enc = DeviceStreamEncoder(window_px=32)
    stream = bytearray(enc.initialize(desc).value())
    for i in range(0, 600, 96):
        stream += enc.encode_window(raw[i : i + 96]).value().tobytes()
    assert enc.has_run_count()
    stream += enc.finalize().value()
    assert np.array_equal(np.frombuffer(bytes(stream), np.uint8), want)


def _seam_heavy_image(w, h, ch, seed):
    """Runs (incl. whole-lane spans), palette reuse, gradients and noise —
    every op class crosses sub-window seams at any lane split."""
    rng = np.random.default_rng(seed)
    n = w * h
    px = rng.integers(0, 256, (n, ch)).astype(np.uint8)
    px[n // 8 : n // 3] = 19  # long run spanning multiple lanes
    pal = rng.integers(0, 256, (6, ch)).astype(np.uint8)
    px[n // 3 : n // 2] = pal[rng.integers(0, 6, n // 2 - n // 3)]
    ramp = (np.arange(n // 4) % 250).astype(np.uint8)
    px[n // 2 : n // 2 + n // 4] = ramp[:, None] // np.arange(1, ch + 1)
    return px.reshape(-1)


@pytest.mark.parametrize("lanes", [4, 8])
def test_encode_window_lanes_mixed(lanes):
    # Multi-lane window encode (closed-form carries): multi-window stream
    # with a partially-filled last window must be bit-exact with the
    # oracle on seam-heavy content.
    desc = Desc(96, 40, Channels.RGB)
    raw = _seam_heavy_image(96, 40, 3, seed=11)
    want, _ = oracle.encode(raw, desc)
    enc = DeviceStreamEncoder(window_px=1024, split_lanes=lanes)
    stream = bytearray(enc.initialize(desc).value())
    for i in range(0, raw.size, 1024 * 3):
        stream += enc.encode_window(raw[i : i + 1024 * 3]).value().tobytes()
    stream += enc.finalize().value()
    assert np.array_equal(np.frombuffer(bytes(stream), np.uint8), want)


def test_encode_window_lanes_rgba():
    desc = Desc(64, 48, Channels.RGBA)
    raw = _seam_heavy_image(64, 48, 4, seed=12)
    # alpha flips crossing lane seams force OP_RGBA decisions against
    # carried prev pixels
    raw[3::1024] = 7
    want, _ = oracle.encode(raw, desc)
    enc = DeviceStreamEncoder(window_px=768, split_lanes=8)
    stream = bytearray(enc.initialize(desc).value())
    for i in range(0, raw.size, 768 * 4):
        stream += enc.encode_window(raw[i : i + 768 * 4]).value().tobytes()
    stream += enc.finalize().value()
    assert np.array_equal(np.frombuffer(bytes(stream), np.uint8), want)


def test_encode_window_lanes_flat_runs():
    # Whole lanes of equal pixels: the run recurrence's full-lane branch
    # ((run_in + v) % 62) and in-lane 62-flushes, plus a pending trailing
    # run carried through finalize.
    desc = Desc(1000, 3, Channels.RGB)
    raw = np.full(3000 * 3, 55, np.uint8)
    raw[:3] = (9, 8, 7)
    raw[1501 * 3 : 1502 * 3] = (1, 2, 3)  # one break mid-lane
    want, _ = oracle.encode(raw, desc)
    enc = DeviceStreamEncoder(window_px=1500, split_lanes=4)
    stream = bytearray(enc.initialize(desc).value())
    for i in range(0, raw.size, 1500 * 3):
        stream += enc.encode_window(raw[i : i + 1500 * 3]).value().tobytes()
    assert enc.has_run_count()
    stream += enc.finalize().value()
    assert np.array_equal(np.frombuffer(bytes(stream), np.uint8), want)


def test_encode_window_lanes_index_chains():
    # Palette-cycling content: INDEX hits on table slots written by
    # EARLIER lanes — the exclusive overwrite-combine table carry.
    rng = np.random.default_rng(13)
    n = 4096
    pal = rng.integers(0, 256, (48, 3)).astype(np.uint8)
    raw = pal[rng.integers(0, 48, n)].reshape(-1)
    desc = Desc(n, 1, Channels.RGB)
    want, _ = oracle.encode(raw, desc)
    enc = DeviceStreamEncoder(window_px=n, split_lanes=8)
    stream = bytearray(enc.initialize(desc).value())
    stream += enc.encode_window(raw).value().tobytes()
    stream += enc.finalize().value()
    assert np.array_equal(np.frombuffer(bytes(stream), np.uint8), want)


def test_streaming_errors():
    dec = DeviceStreamDecoder(window_cap=256)
    from qoipp_tpu import Error

    assert dec.decode_window(b"x").error() == Error.NOT_INITIALIZED
    assert dec.initialize(b"bad header....").error() == Error.NOT_QOI
    enc = DeviceStreamEncoder()
    assert enc.encode_window(b"xxx").error() == Error.NOT_INITIALIZED
    assert enc.finalize().error() == Error.NOT_INITIALIZED


def test_roundtrip_device_stream():
    # encode windows -> decode windows, both device-side
    desc = Desc(64, 32, Channels.RGB)
    raw, _ = make_image(desc, seed=6)
    enc = DeviceStreamEncoder(window_px=500)
    stream = bytearray(enc.initialize(desc).value())
    stream += enc.encode_window(raw).value().tobytes()
    stream += enc.finalize().value()

    dec = DeviceStreamDecoder(window_cap=4096)
    dec.initialize(bytes(stream[:14])).value()
    got = dec.decode_window(bytes(stream[14:-8])).value()
    assert np.array_equal(got, raw)

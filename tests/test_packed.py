"""Stream-packed decode: exactness across in-lane stream boundaries."""

import numpy as np
import pytest

from qoipp_tpu import Channels, Desc, oracle
from qoipp_tpu.models.packed import PackedDecoder, plan_lanes


def corpus():
    rng = np.random.default_rng(11)
    out = []
    # mixed geometries + channels; crafted boundary-sensitive openers:
    specs = [
        (Desc(31, 7, Channels.RGB), "noise"),
        (Desc(64, 64, Channels.RGBA), "palette"),
        (Desc(16, 16, Channels.RGBA), "zero_first"),   # first chunk = INDEX
        (Desc(40, 3, Channels.RGB), "run_first"),      # first chunk = RUN
        (Desc(128, 90, Channels.RGB), "gradient"),
        (Desc(8, 8, Channels.RGBA), "alpha"),
        (Desc(300, 200, Channels.RGB), "noise"),
        (Desc(5, 5, Channels.RGB), "flat"),
    ]
    for desc, kind in specs:
        n = desc.width * desc.height
        ch = int(desc.channels)
        if kind == "noise":
            raw = rng.integers(0, 256, n * ch, np.uint8)
        elif kind == "palette":
            pal = rng.integers(0, 256, (6, ch)).astype(np.uint8)
            raw = pal[rng.integers(0, 6, n)].reshape(-1)
        elif kind == "zero_first":
            # pixel 0 = (0,0,0,0): matches the encoder's zero table slot 0,
            # so the stream OPENS with OP_INDEX — the packed reset must
            # provide the fresh zero table, not the previous stream's
            px = rng.integers(0, 256, (n, 4), np.uint8)
            px[0] = 0
            raw = px.reshape(-1)
        elif kind == "run_first":
            # pixel 0 = (0,0,0) = start pixel: stream opens with OP_RUN —
            # the packed reset must restore prev = (0,0,0,255)
            px = np.zeros((n, ch), np.uint8)
            px[n // 2 :] = rng.integers(0, 256, (n - n // 2, ch))
            raw = px.reshape(-1)
        elif kind == "gradient":
            x = np.arange(n) % desc.width
            raw = np.stack([(x // 2) % 256] * ch, 1).astype(np.uint8).reshape(-1)
        elif kind == "alpha":
            px = rng.integers(0, 256, (n, 4), np.uint8)
            raw = px.reshape(-1)
        else:
            raw = np.full(n * ch, 9, np.uint8)
        enc, complete = oracle.encode(raw, desc)
        assert complete
        out.append((raw, desc, enc))
    return out


def test_plan_lanes_packs_and_fits():
    items = [(700, 10), (300, 5), (600, 8), (100, 2), (400, 6)]
    lanes = plan_lanes(items, 1000)
    assert sorted(i for L in lanes for i in L) == list(range(5))
    for L in lanes:
        assert sum(items[i][0] for i in L) <= 1000


def test_packed_decode_mixed_streams_bit_exact():
    data = corpus()
    blobs = [enc for _, _, enc in data]
    dec = PackedDecoder(lane_bytes=1 << 19)
    got = dec.decode(blobs)
    for i, (raw, desc, enc) in enumerate(data):
        assert np.array_equal(got[i], raw), f"stream {i} ({desc})"


def test_packed_decode_rejects_truncated_stream():
    # A parseable header with no body bytes must be rejected up front —
    # an sz <= 0 item would repeat a seg_flat index and break the sorted/
    # unique scatter invariants of _decode_lanes (silent corruption on a
    # device where a false indices_are_sorted hint miscompiles).
    from qoipp_tpu.common import write_header

    good_raw = np.full(12, 7, np.uint8)
    good, _ = oracle.encode(good_raw, Desc(2, 2, Channels.RGB))
    truncated = np.frombuffer(
        write_header(Desc(2, 2, Channels.RGB)) + b"\x00" * 8, np.uint8
    )
    dec = PackedDecoder()
    with pytest.raises(ValueError, match="truncated"):
        dec.decode([good, truncated])


def test_packed_decode_lane_count_buckets_to_8():
    # The uploaded regions' leading dim must bucket to a multiple of 8
    # so heterogeneous corpora keep a bounded compile-shape set.
    rng = np.random.default_rng(5)
    blobs = []
    for k in range(9):  # an awkward count: 9 nonempty lanes -> pad to 16
        desc = Desc(64, 64, Channels.RGB)
        raw = rng.integers(0, 256, 64 * 64 * 3, np.uint8)
        enc, _ = oracle.encode(raw, desc)
        blobs.append(enc)
    dec = PackedDecoder(lane_bytes=1 << 19)
    regions, *_ = dec.plan_and_pack(blobs)
    assert regions.shape[0] % 8 == 0


def test_packed_decode_many_tiny_streams_one_lane():
    # dozens of tiny streams share lanes; every boundary is a reset
    rng = np.random.default_rng(3)
    data = []
    for k in range(40):
        desc = Desc(3 + k % 5, 2 + k % 3, Channels.RGBA if k % 2 else Channels.RGB)
        n = desc.width * desc.height
        raw = rng.integers(0, 256, n * int(desc.channels), np.uint8)
        enc, _ = oracle.encode(raw, desc)
        data.append((raw, desc, enc))
    dec = PackedDecoder(lane_bytes=1 << 14)
    got = dec.decode([e for _, _, e in data])
    for i, (raw, desc, _) in enumerate(data):
        assert np.array_equal(got[i], raw), f"stream {i}"

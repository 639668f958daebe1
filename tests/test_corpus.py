"""Tier-3 corpus tests (mirrors reference: simple_test.cpp:326-362 /
stream_test.cpp:262-311): every corpus image must encode byte-exactly and
decode byte-exactly against the oracle, on every backend.

Corpus resolution order:
1. tests/resources/qoi_test_images/ — the qoiformat.org suite, if the user
   fetched it (no network in CI; mirrors test/fetch_test_images.sh).
2. tests/local_corpus.py — real photos / screenshots / icons / textures
   shipped inside locally-installed packages (PIL-decoded), mirroring the
   qoiformat.org classes.
3. A deterministic synthetic corpus covering the op mix (gradients, flat
   patches, noise, palettes, alpha variation).
"""

from pathlib import Path

import numpy as np
import pytest

import qoipp_tpu as q
from qoipp_tpu import oracle
from qoipp_tpu.ops import decode as dec_ops

CORPUS_DIR = Path(__file__).resolve().parent / "resources" / "qoi_test_images"


def synthetic_corpus():
    rng = np.random.default_rng(7)
    out = []
    # gradient RGB
    w, h = 160, 120
    x = np.arange(w * h)
    raw = np.stack([(x % 256), (x // 3) % 256, (255 - x) % 256], 1).astype(np.uint8)
    out.append(("gradient_rgb", raw.reshape(-1), q.Desc(w, h, q.Channels.RGB)))
    # flat patches
    base = rng.integers(0, 256, (16, 3)).astype(np.uint8)
    ids = np.maximum.accumulate(
        np.where(rng.random(w * h) < 0.02, rng.integers(0, 16, w * h), 0)
    ) % 16
    out.append(("patches_rgb", base[ids].reshape(-1), q.Desc(w, h, q.Channels.RGB)))
    # noise RGBA
    raw = rng.integers(0, 256, w * h * 4, dtype=np.uint8)
    out.append(("noise_rgba", raw, q.Desc(w, h, q.Channels.RGBA)))
    # palette with alpha variation
    pal = rng.integers(0, 256, (9, 4)).astype(np.uint8)
    raw = pal[rng.integers(0, 9, w * h)].reshape(-1)
    out.append(("palette_rgba", raw, q.Desc(w, h, q.Channels.RGBA)))
    # long runs
    raw = np.full(w * h * 3, 40, np.uint8)
    raw[: 3 * 100] = rng.integers(0, 256, 300).astype(np.uint8)
    out.append(("runs_rgb", raw, q.Desc(w, h, q.Channels.RGB)))
    return out


def corpus():
    if CORPUS_DIR.exists():
        items = []
        for path in sorted(CORPUS_DIR.glob("*.qoi")):
            img = q.decode(path, backend="native")
            if img:
                items.append((path.stem, img.value().data, img.value().desc))
        if items:
            return items
    import local_corpus

    if local_corpus.available():
        # keep the hermetic tier fast: the >1.1-MPix images (full screenshot,
        # 1080p photo) are exercised by bench.py and tools/bench.py
        return [
            (name, raw, desc)
            for name, _, raw, desc, _ in local_corpus.build()
            if desc.width * desc.height <= 1_100_000
        ] + synthetic_corpus()
    return synthetic_corpus()


CORPUS = corpus()


@pytest.mark.parametrize("name,raw,desc", CORPUS, ids=[c[0] for c in CORPUS])
def test_corpus_encode_parity(name, raw, desc):
    want, complete = oracle.encode(raw, desc)
    assert complete
    got = q.encode(raw, desc, backend="jax").value()
    assert np.array_equal(got, want), name


@pytest.mark.parametrize("name,raw,desc", CORPUS, ids=[c[0] for c in CORPUS])
def test_corpus_decode_parity(name, raw, desc):
    blob, _ = oracle.encode(raw, desc)
    got = dec_ops.decode_single(blob, desc, desc.channels)
    assert np.array_equal(got, raw), name


@pytest.mark.parametrize("name,raw,desc", CORPUS[:2], ids=[c[0] for c in CORPUS[:2]])
def test_corpus_stream_random_buffers(name, raw, desc):
    # 3 randomized buffer sizes per image (stream_test.cpp:262-311 analog)
    rng = np.random.default_rng(hash(name) % 2**31)
    blob, _ = oracle.encode(raw, desc)
    for _ in range(3):
        buf = int(rng.integers(max(5, int(desc.channels)), 4096))
        dec = q.StreamDecoder()
        dec.initialize(blob[:14]).value()
        out = np.zeros(buf, np.uint8)
        pix = bytearray()
        consumed = 14
        end = blob.size - 8
        while consumed < end:
            r = dec.decode(out, blob[consumed : consumed + buf]).value()
            pix += out[: r.written].tobytes()
            consumed += r.processed
            if r.processed == 0 and r.written == 0:
                break
        while dec.has_run_count():
            n = dec.drain_run(out).value()
            pix += out[:n].tobytes()
        got = np.frombuffer(bytes(pix), np.uint8)[: raw.size]
        assert np.array_equal(got, raw), f"{name} buf={buf}"


def test_fuzz_smoke():
    # A slice of the differential fuzzer runs in CI (tools/fuzz.py has the
    # full harness).
    import sys

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))
    import fuzz as fuzz_tool

    rng = np.random.default_rng(123)
    for _ in range(3):
        fuzz_tool.fuzz_decode(rng, max_side=24)
        fuzz_tool.fuzz_truncated(rng, max_side=24)
        fuzz_tool.fuzz_encode_roundtrip(rng, max_side=24)
        fuzz_tool.fuzz_stream(rng, max_side=24)

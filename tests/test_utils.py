"""Aux subsystem tests: native loader, stream inspection, RGBA pipeline,
timing helpers."""

from pathlib import Path

import numpy as np
import pytest

import qoipp_tpu as q
from qoipp_tpu import oracle


def test_native_pack_files(tmp_path):
    desc = q.Desc(32, 16, q.Channels.RGB)
    rng = np.random.default_rng(0)
    blobs = []
    for i in range(3):
        raw = (rng.integers(0, 4, 32 * 16 * 3) * 17).astype(np.uint8)
        blob, _ = oracle.encode(raw, desc)
        (tmp_path / f"{i}.qoi").write_bytes(blob.tobytes())
        blobs.append(blob)
    row = max(b.size for b in blobs) + 64
    out, sizes = oracle.pack_files(sorted(tmp_path.glob("*.qoi")), row)
    assert out.shape == (3, row)
    for i, b in enumerate(blobs):
        assert sizes[i] == b.size
        assert np.array_equal(out[i, : b.size], b)
        assert np.all(out[i, b.size :] == 0)


def test_pack_files_errors(tmp_path):
    with pytest.raises(OSError):
        oracle.pack_files([tmp_path / "missing.qoi"], 128)


def test_inspect_stream(qoi3):
    from qoipp_tpu.utils.debug import inspect_stream

    stats = inspect_stream(qoi3)
    assert stats.desc.width == 29 and stats.desc.height == 17
    assert stats.pixels == 29 * 17
    assert sum(stats.ops.values()) == stats.chunks
    assert stats.ops["RGBA"] == 0  # RGB stream
    assert "chunks" in str(stats)


def test_rgba_batch_pipeline():
    import jax.numpy as jnp

    desc = q.Desc(40, 24, q.Channels.RGBA)
    rng = np.random.default_rng(1)
    pal = rng.integers(0, 256, (6, 4)).astype(np.uint8)
    raws, blobs = [], []
    for i in range(4):
        raw = pal[rng.integers(0, 6, 40 * 24)].reshape(-1)
        blob, _ = oracle.encode(raw, desc)
        raws.append(raw)
        blobs.append(blob)
    pipe = q.BatchPipeline(desc)
    streams, sizes = pipe.pack_streams(blobs)
    imgs = np.asarray(pipe.decode(jnp.asarray(streams), jnp.asarray(sizes)))
    for i in range(4):
        assert np.array_equal(imgs[i].reshape(-1), raws[i]), i
    enc_streams, lengths = pipe.encode(np.stack(raws))
    enc_streams, lengths = np.asarray(enc_streams), np.asarray(lengths)
    for i in range(4):
        assert np.array_equal(enc_streams[i, : lengths[i]], blobs[i]), i


def test_mixed_opaque_batch():
    # A batch mixing opaque and alpha-varying streams must take the general
    # expansion path and stay exact.
    import jax.numpy as jnp

    desc = q.Desc(32, 16, q.Channels.RGBA)
    rng = np.random.default_rng(2)
    opaque = np.full((32 * 16, 4), (9, 8, 7, 255), np.uint8).reshape(-1)
    varying = np.stack(
        [rng.integers(0, 255, (32 * 16, 3)).astype(np.uint8).reshape(32 * 16, 3)[:, c]
         for c in range(3)] + [rng.integers(0, 2, 32 * 16).astype(np.uint8) * 255],
        axis=1,
    ).astype(np.uint8).reshape(-1)
    raws = [opaque, varying]
    blobs = [oracle.encode(r, desc)[0] for r in raws]
    pipe = q.BatchPipeline(desc)
    streams, sizes = pipe.pack_streams(blobs)
    imgs = np.asarray(pipe.decode(jnp.asarray(streams), jnp.asarray(sizes)))
    for i in range(2):
        assert np.array_equal(imgs[i].reshape(-1), raws[i]), i


def test_timing_helpers():
    from qoipp_tpu.utils.timing import mpix_per_s, time_ms

    assert mpix_per_s(1_000_000, 1.0) == pytest.approx(1000.0)
    assert time_ms(lambda: None, runs=2, warmup=0) >= 0


def test_chunked_h2d_staging_bit_identical():
    # Transport-granularity wiring (utils/transport.stage_h2d): with a
    # tiny chunk size every engine's staged upload splits into many
    # device_put pieces + one device concat — decode/encode results must
    # be bit-identical with one-shot staging (only the transport
    # granularity may change, never the bytes).
    from qoipp_tpu.models.serving import ServingCodec
    from qoipp_tpu.utils import transport

    rng = np.random.default_rng(21)
    corpus, blobs = [], []
    for k in range(8):
        desc = q.Desc(40 + 8 * k, 30,
                      q.Channels.RGB if k % 2 else q.Channels.RGBA)
        raw = rng.integers(
            0, 256, desc.width * desc.height * int(desc.channels), np.uint8
        )
        corpus.append((raw, desc))
        blobs.append(oracle.encode(raw, desc)[0])
    codec = ServingCodec(pack_lane_bytes=8 << 10, min_len=1 << 12)
    want_dec = codec.decode(blobs)
    want_enc = codec.encode([r for r, _ in corpus], [d for _, d in corpus])
    assert transport.get_h2d_chunk_bytes() == 0  # default off
    transport.set_h2d_chunk_bytes(512)
    try:
        got_dec = codec.decode(blobs)
        got_enc = codec.encode([r for r, _ in corpus],
                               [d for _, d in corpus])
    finally:
        transport.set_h2d_chunk_bytes(0)
    for a, b in zip(want_dec, got_dec):
        assert np.array_equal(a, b)
    for a, b in zip(want_enc, got_enc):
        assert np.array_equal(a, b)


def test_stage_h2d_edges():
    from qoipp_tpu.utils import transport

    a1 = np.arange(1000, dtype=np.uint8)
    a2 = np.arange(64, dtype=np.uint32).reshape(8, 8)
    transport.set_h2d_chunk_bytes(64)
    try:
        assert np.array_equal(np.asarray(transport.stage_h2d(a1)), a1)
        assert np.array_equal(np.asarray(transport.stage_h2d(a2)), a2)
        # chunk bigger than the array: one-shot path
        transport.set_h2d_chunk_bytes(1 << 20)
        assert np.array_equal(np.asarray(transport.stage_h2d(a1)), a1)
        # scalar-ish input
        transport.set_h2d_chunk_bytes(1)
        assert int(np.asarray(transport.stage_h2d(np.uint32(7)))) == 7
    finally:
        transport.set_h2d_chunk_bytes(0)


@pytest.mark.parametrize("env", [None, "custom"])
def test_compile_cache_placement(monkeypatch, tmp_path, env):
    # JAX_COMPILATION_CACHE_DIR wins and no path is set in code; without
    # it the cache goes to the checkout's own .jax_cache
    import jax

    from qoipp_tpu.utils import timing

    before = jax.config.jax_compilation_cache_dir
    marker = str(tmp_path / "untouched")
    jax.config.update("jax_compilation_cache_dir", marker)
    try:
        if env is None:
            monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
            want = str(Path(timing.__file__).resolve().parents[2]
                       / ".jax_cache")
            assert timing.compile_cache_dir() == want
            timing.enable_compile_cache()
            assert jax.config.jax_compilation_cache_dir == want
        else:
            monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR",
                               str(tmp_path / env))
            assert timing.compile_cache_dir() == str(tmp_path / env)
            timing.enable_compile_cache()
            assert jax.config.jax_compilation_cache_dir == marker
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_device_time_ms_blocks_on_results():
    from qoipp_tpu.utils.timing import device_time_ms

    calls = []

    def fn(x):
        calls.append(1)
        return x + 1

    assert device_time_ms(fn, np.float32(1), runs=3) >= 0
    assert len(calls) == 4  # one untimed warm-up + 3 timed

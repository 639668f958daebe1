"""Public one-shot API tests, mirroring the reference's simple_test coverage
(test/source/simple_test.cpp): encode/decode exactness, buffer/callback/file
variants, error paths, channel conversion, vertical flip."""

import numpy as np
import pytest

import qoipp_tpu as q

DESC3 = q.Desc(29, 17, q.Channels.RGB)
DESC4 = q.Desc(24, 14, q.Channels.RGBA)


# ---- encode ---------------------------------------------------------------


def test_encode_golden(raw3, qoi3, raw4, qoi4):
    assert np.array_equal(q.encode(raw3, DESC3).value(), qoi3)
    assert np.array_equal(q.encode(raw4, DESC4).value(), qoi4)


def test_encode_jax_backend(raw3, qoi3):
    assert np.array_equal(q.encode(raw3, DESC3, backend="jax").value(), qoi3)


def test_encode_errors(raw3):
    assert q.encode(b"", DESC3).error() == q.Error.EMPTY
    assert (
        q.encode(raw3, q.Desc(0, 17, q.Channels.RGB)).error()
        == q.Error.INVALID_DESC
    )
    assert q.encode(raw3[:-3], DESC3).error() == q.Error.MISMATCHED_DESC


def test_encode_generator(raw3, qoi3):
    # PixelGenFun variant (reference: simple_test.cpp:110-139)
    px = raw3.reshape(-1, 3)

    def gen(i):
        return q.Pixel(int(px[i, 0]), int(px[i, 1]), int(px[i, 2]), 0)

    # RGB forces alpha 0xFF in the reader (util.hpp:331-334)
    assert np.array_equal(q.encode(gen, DESC3).value(), qoi3)


def test_encode_into_buffer(raw3, qoi3):
    buf = np.zeros(q.worst_size(DESC3).value(), np.uint8)
    st = q.encode_into(buf, raw3, DESC3).value()
    assert st.complete and st.written == qoi3.size
    assert np.array_equal(buf[: st.written], qoi3)


def test_encode_into_insufficient(raw3, qoi3):
    # Partial encode stops at a chunk boundary (simple_test.cpp:98-107).
    buf = np.zeros(1007, np.uint8)
    st = q.encode_into(buf, raw3, DESC3).value()
    assert not st.complete
    assert st.written <= 1007
    assert np.array_equal(buf[: st.written], qoi3[: st.written])


def test_encode_into_byte_sink(raw3, qoi3):
    got = []
    n = q.encode_into(got.append, raw3, DESC3).value()
    assert n == qoi3.size
    assert np.array_equal(np.array(got, np.uint8), qoi3)


def test_encode_into_file(tmp_path, raw3, qoi3):
    p = tmp_path / "out.qoi"
    n = q.encode_into(p, raw3, DESC3).value()
    assert n == qoi3.size
    assert np.array_equal(np.frombuffer(p.read_bytes(), np.uint8), qoi3)
    # FileExists unless overwrite (simple_test.cpp:244-280)
    assert q.encode_into(p, raw3, DESC3).error() == q.Error.FILE_EXISTS
    assert q.encode_into(p, raw3, DESC3, overwrite=True).value() == qoi3.size
    assert q.encode_into(tmp_path, raw3, DESC3, overwrite=True).error() in (
        q.Error.FILE_EXISTS,
        q.Error.NOT_REGULAR_FILE,
    )


# ---- decode ---------------------------------------------------------------


def test_decode_golden(raw3, qoi3, raw4, qoi4):
    img = q.decode(qoi3).value()
    assert img.desc == DESC3
    assert np.array_equal(img.data, raw3)
    img4 = q.decode(qoi4).value()
    assert img4.desc == DESC4
    assert np.array_equal(img4.data, raw4)


def test_decode_jax_backend(raw3, qoi3):
    img = q.decode(qoi3, backend="jax").value()
    assert np.array_equal(img.data, raw3)


def test_decode_channel_conversion(qoi3, raw3, qoi4, raw4):
    img = q.decode(qoi3, target=q.Channels.RGBA).value()
    assert img.desc.channels == q.Channels.RGBA
    px = img.data.reshape(-1, 4)
    assert np.array_equal(px[:, :3].reshape(-1), raw3)
    assert np.all(px[:, 3] == 255)
    img = q.decode(qoi4, target=q.Channels.RGB).value()
    assert np.array_equal(img.data, raw4.reshape(-1, 4)[:, :3].reshape(-1))


def test_decode_flip(qoi3, raw3):
    img = q.decode(qoi3, flip_vertically=True).value()
    rows = raw3.reshape(17, 29 * 3)
    assert np.array_equal(img.data.reshape(17, 29 * 3), rows[::-1])


def test_decode_errors():
    assert q.decode(b"").error() == q.Error.EMPTY
    assert q.decode(b"x" * 22).error() == q.Error.TOO_SHORT
    assert q.decode(b"x" * 30).error() == q.Error.NOT_QOI


def test_decode_incomplete(qoi3_incomplete):
    # Truncated input still succeeds (simple_test.cpp:316-322).
    img = q.decode(qoi3_incomplete).value()
    assert img.desc == DESC3
    assert img.data.size == 29 * 17 * 3


def test_decode_file(tmp_path, qoi3, raw3):
    p = tmp_path / "img.qoi"
    p.write_bytes(qoi3.tobytes())
    img = q.decode(p).value()
    assert np.array_equal(img.data, raw3)
    assert q.decode(tmp_path / "nope.qoi").error() == q.Error.FILE_NOT_EXISTS
    assert q.decode(tmp_path).error() == q.Error.NOT_REGULAR_FILE


def test_decode_into_buffer(qoi3, raw3):
    buf = np.zeros(29 * 17 * 3, np.uint8)
    desc = q.decode_into(buf, qoi3).value()
    assert desc == DESC3
    assert np.array_equal(buf, raw3)
    small = np.zeros(10, np.uint8)
    assert q.decode_into(small, qoi3).error() == q.Error.NOT_ENOUGH_SPACE


def test_decode_into_pixel_sink(qoi4, raw4):
    got = []
    desc = q.decode_into(lambda p: got.append(tuple(p)), qoi4).value()
    assert desc.width == 24
    px = np.array(got, np.uint8).reshape(-1)
    assert np.array_equal(px, raw4)


def test_decode_into_pixel_sink_vectorized(qoi4, raw4, qoi3, raw3):
    # opt-in block sink: receives (N, 4) uint8 arrays, alpha forced 0xFF
    # for RGB sources (api.decode_into; ref sink: source/util.hpp:281-296)
    blocks = []

    def sink(a):
        blocks.append(np.array(a))

    sink.vectorized = True
    desc = q.decode_into(sink, qoi4).value()
    assert desc.width == 24
    px = np.concatenate(blocks).reshape(-1)
    assert np.array_equal(px, raw4)

    blocks.clear()
    q.decode_into(sink, qoi3)
    px = np.concatenate(blocks)
    assert np.array_equal(px[:, :3].reshape(-1), raw3)
    assert (px[:, 3] == 0xFF).all()


def test_decode_into_file(tmp_path, qoi3, raw3):
    p = tmp_path / "img.qoi"
    p.write_bytes(qoi3.tobytes())
    buf = np.zeros(29 * 17 * 3, np.uint8)
    assert q.decode_into(buf, p).value() == DESC3
    assert np.array_equal(buf, raw3)


def test_full_roundtrip_both_backends(raw4):
    for backend in ("native", "jax"):
        enc = q.encode(raw4, DESC4, backend=backend).value()
        img = q.decode(enc, backend=backend).value()
        assert np.array_equal(img.data, raw4)


def test_encode_generator_vectorized(raw3, qoi3):
    # Array-in/array-out generator fast path (the array analog of the
    # reference streaming generator pixels through the core,
    # util.hpp:322-337): must be bit-identical to the scalar path.
    px = raw3.reshape(-1, 3)

    def gen(ids):
        out = np.zeros((len(ids), 4), np.uint8)
        out[:, :3] = px[ids]
        return out  # alpha 0 — RGB encode forces 0xFF

    assert np.array_equal(q.encode(gen, DESC3).value(), qoi3)


def test_oneshot_threshold_configuration(monkeypatch):
    # Deployment-facing threshold config (co-located PCIe hosts opt into
    # device routing without monkeypatching module internals).
    from qoipp_tpu import api

    api.set_oneshot_device_threshold(1 << 18)
    assert api.ONESHOT_DEVICE_THRESHOLD == 1 << 18
    api.set_oneshot_device_threshold(None)
    assert api.ONESHOT_DEVICE_THRESHOLD is None
    with pytest.raises(ValueError):
        api.set_oneshot_device_threshold(-1)

    monkeypatch.setenv("QOIPP_TPU_ONESHOT_DEVICE_THRESHOLD", "262144")
    assert api._env_threshold() == 262144
    monkeypatch.setenv("QOIPP_TPU_ONESHOT_DEVICE_THRESHOLD", "none")
    assert api._env_threshold() is None


@pytest.mark.parametrize("platform,want", [("gpu", "jax"), ("cpu", "native")])
def test_oneshot_auto_routes_on_gpu(monkeypatch, platform, want):
    # backend="auto" sends one-shot calls at or above the threshold to the
    # device only when JAX's default backend is a GPU
    import jax

    from qoipp_tpu import api

    monkeypatch.setattr(api, "ONESHOT_DEVICE_THRESHOLD", 1000)
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    assert api._resolve_backend("auto", 1000) == want
    assert api._resolve_backend("auto", 999) == "native"
    assert api._resolve_backend("native", 10 ** 6) == "native"

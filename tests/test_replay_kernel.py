"""The replay kernel: its lax.scan reference (the CPU route) against a
per-row numpy model, the kernel's route choice, its GPU lowering (shapes,
padding, choice of kernel), and — on a card only — the compiled CUDA
kernel against the reference."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from qoipp_tpu.ops import replay_kernel as rk

START = 0xFF000000
START_HASH = (11 * 255) % 64


def _rand_u32(rng, shape):
    return rng.integers(0, 1 << 32, shape, np.uint64).astype(np.uint32)


def _hash(v):
    r, g, b, a = v & 255, (v >> 8) & 255, (v >> 16) & 255, v >> 24
    return (r * 3 + g * 5 + b * 7 + a * 11) % 64


def _replay_np(meta, val, prev, seen):
    """Per-lane, per-row model of the chunk state machine."""
    c, b = meta.shape
    emits = np.zeros((c, b), np.uint32)
    prev_o = prev.astype(np.int64).copy()
    seen_o = seen.astype(np.int64).copy()
    pupd = np.zeros((1, b), np.int32)
    swr = np.zeros((64, b), np.int32)
    for j in range(b):
        p, t = int(prev_o[0, j]), seen_o[:, j]
        for r in range(c):
            m, x = int(meta[r, j]), int(val[r, j])
            cls, arg = m & 7, (m >> 3) & 63
            if (m >> 9) & 1:
                p = START
                t[:] = 0
                t[START_HASH] = START
                pupd[0, j] = 1
                swr[:, j] = 1
            v = p
            if cls == rk.CLS_SETA:
                v = x
            elif cls == rk.CLS_SETC:
                v = (p & 0xFF000000) | x
            elif cls == rk.CLS_ADD:
                v = sum((((p >> s) + (x >> s)) & 255) << s
                        for s in (0, 8, 16, 24))
            elif cls == rk.CLS_IDX:
                v = int(t[arg])
            if rk.CLS_SETA <= cls <= rk.CLS_IDX:
                p = v
                t[_hash(v)] = v
                pupd[0, j] = 1
                swr[_hash(v), j] = 1
            emits[r, j] = v
        prev_o[0, j] = p
    return (emits, prev_o.astype(np.uint32), seen_o.astype(np.uint32),
            pupd, swr)


def _fields(rng, c, b, reset_rate):
    cls = rng.integers(0, 6, (c, b))
    arg = rng.integers(0, 64, (c, b))
    rst = rng.random((c, b)) < reset_rate
    meta = (cls | (arg << 3) | (rst.astype(np.int64) << 9)).astype(np.uint32)
    return meta, _rand_u32(rng, (c, b))


# (variant, reset_rate, rows, lanes): rows and lanes off the kernel's
# block multiples, carried state, summaries, stream-start resets
CASES = [
    ("plain", 0.0, 203, 13),
    ("carry", 0.0, 64, 8),
    ("summary", 0.0, 129, 20),
    ("summary", 0.05, 96, 9),
    ("plain", 0.05, 40, 3),
]


def _inputs(variant, reset_rate, c, b):
    rng = np.random.default_rng(c * 1000 + b)
    meta, val = _fields(rng, c, b, reset_rate)
    if variant == "plain":
        prev, seen = (np.asarray(x) for x in rk.initial_state(b))
    else:
        prev, seen = _rand_u32(rng, (1, b)), _rand_u32(rng, (64, b))
    return meta, val, prev, seen


def _run(variant, meta, val, prev, seen):
    args = [jnp.asarray(a) for a in (meta, val, prev, seen)]
    if variant == "plain":
        return (rk.replay_batch(args[0], args[1]),)
    if variant == "carry":
        return rk.replay_batch_carry(*args)
    return rk.replay_batch_summary(*args)


@pytest.mark.parametrize("variant,reset_rate,c,b", CASES)
def test_replay_matches_reference(variant, reset_rate, c, b):
    meta, val, prev, seen = _inputs(variant, reset_rate, c, b)
    got = _run(variant, meta, val, prev, seen)
    want = _replay_np(meta, val, prev, seen)
    assert len(got) in (1, 3, 5)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert np.array_equal(np.asarray(g), w)


def _meta(cls, arg=0, rst=0):
    return cls | (arg << 3) | (rst << 9)


def test_replay_index_writeback_adversarial():
    # INDEX reads slot s holding a value v with hash(v) != s (only an
    # adversarial stream can build that table) and must write v back to
    # slot hash(v); the next INDEX of hash(v) reads it, and a reset brings
    # the seeded table back
    seen = np.zeros((64, 1), np.uint32)
    v = 0x80402010
    s = (_hash(v) + 7) % 64
    seen[s, 0] = v
    rows = [
        (_meta(rk.CLS_IDX, s), 0),
        (_meta(rk.CLS_SETA), 0x11223344),
        (_meta(rk.CLS_IDX, _hash(v)), 0),
        (_meta(rk.CLS_RUN), 0),
        (_meta(rk.CLS_IDX, START_HASH, rst=1), 0),
        (_meta(rk.CLS_IDX, s), 0),
    ]
    meta = np.array([[m] for m, _ in rows], np.uint32)
    val = np.array([[x] for _, x in rows], np.uint32)
    prev = np.full((1, 1), START, np.uint32)
    got = _run("summary", meta, val, prev, seen)
    assert np.asarray(got[0])[:, 0].tolist() == [v, 0x11223344, v, v,
                                                START, 0]
    for g, w in zip(got, _replay_np(meta, val, prev, seen)):
        assert np.array_equal(np.asarray(g), w)


@pytest.mark.parametrize("platform,want", [
    ("gpu", "cuda"), ("cpu", "reference"), ("metal", None), ("rocm", None),
])
def test_replay_route(monkeypatch, platform, want):
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    if want is None:
        with pytest.raises(NotImplementedError):
            rk.route()
    else:
        assert rk.route() == want


@pytest.mark.parametrize("summary,rows,lanes", [
    (False, 100, 20), (True, 96, 7),
])
def test_replay_lowers_for_gpu(monkeypatch, summary, rows, lanes):
    # the GPU route lowers to the FFI kernel with rows padded to the
    # kernel's group size (lowering runs here; compiling needs the card)
    monkeypatch.setattr(rk, "route", lambda: "cuda")
    monkeypatch.setattr(rk, "_register", lambda: None)
    m = jax.ShapeDtypeStruct((rows, lanes), jnp.uint32)
    p = jax.ShapeDtypeStruct((1, lanes), jnp.uint32)
    s = jax.ShapeDtypeStruct((64, lanes), jnp.uint32)
    fn = jax.jit(rk._replay.__wrapped__, static_argnames=("summary",))
    low = fn.trace(m, m, p, s, summary=summary).lower(
        lowering_platforms=("cuda",))
    text = low.as_text()
    target = rk.GPU_TARGETS[1] if summary else rk.GPU_TARGETS[0]
    padded = -(-rows // rk.ROWS) * rk.ROWS
    assert f"@{target}" in text or f'"{target}"' in text
    assert f"tensor<{padded}x{lanes}xui32>" in text
    outs = jax.eval_shape(lambda *a: fn(*a, summary=summary), m, m, p, s)
    want = [(rows, lanes), (1, lanes), (64, lanes)]
    want += [(1, lanes), (64, lanes)] if summary else []
    assert [o.shape for o in outs] == want


@pytest.fixture
def gpu():
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: the CUDA replay kernel has no CPU mode")


def check_kernel_case(variant, reset_rate, c, b):
    """The compiled kernel against the lax.scan reference (GPU only)."""
    meta, val, prev, seen = (jnp.asarray(a) for a in
                             _inputs(variant, reset_rate, c, b))
    got = _run(variant, meta, val, prev, seen)
    want = rk.replay_reference(meta, val, prev, seen)
    for g, w in zip(got, want):
        assert np.array_equal(np.asarray(g), np.asarray(w)), variant


# the CPU cases plus one at a real width (128 lanes, thousands of rows)
GPU_CASES = CASES + [("summary", 0.001, 4099, 128)]


@pytest.mark.gpu
@pytest.mark.parametrize("variant,reset_rate,c,b", GPU_CASES)
def test_replay_kernel_gpu(gpu, variant, reset_rate, c, b):
    check_kernel_case(variant, reset_rate, c, b)

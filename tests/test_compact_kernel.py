"""Differential tests for the plain-XLA sparse ops (ops/sparse.py) against
per-row numpy loops."""

import jax.numpy as jnp
import numpy as np
import pytest

from qoipp_tpu.ops.sparse import (
    BLK,
    compact_rows,
    emit_bytes,
    place_pixels,
)


def _compact_np(planes, keep, cap):
    outs = [np.zeros((keep.shape[0], cap), p.dtype) for p in planes]
    counts = keep.sum(axis=1).astype(np.int32)
    for i in range(keep.shape[0]):
        rows = np.nonzero(keep[i])[0][:cap]
        for o, p in zip(outs, planes):
            o[i, : rows.size] = p[i, rows]
    return outs, counts


def _rand_u32(rng, shape):
    return rng.integers(0, 1 << 32, shape, np.uint64).astype(np.uint32)


def _check_compact(planes, keep, cap):
    got, counts = compact_rows(
        tuple(jnp.asarray(p) for p in planes), jnp.asarray(keep), cap=cap
    )
    want, wcounts = _compact_np(planes, keep, cap)
    assert np.array_equal(np.asarray(counts), wcounts)
    for g, w in zip(got, want):
        assert np.array_equal(np.asarray(g), w)


@pytest.mark.parametrize("density", [0.0, 0.03, 0.4, 1.0])
@pytest.mark.parametrize("b,n", [(3, 2 * BLK), (1, 4 * BLK)])
def test_compact_differential(density, b, n):
    rng = np.random.default_rng(int(density * 100) + b)
    keep = rng.random((b, n)) < density
    planes = tuple(_rand_u32(rng, (b, n)) for _ in range(2))
    cap = ((int(keep.sum(axis=1).max()) + BLK + 256) // 128 + 1) * 128
    _check_compact(planes, keep, cap)


def test_compact_three_planes_block_edges():
    # keeps clustered at block boundaries + a full block kept
    b, n = 2, 3 * BLK
    rng = np.random.default_rng(9)
    keep = np.zeros((b, n), bool)
    keep[:, BLK - 5 : BLK + 5] = True
    keep[0, BLK : 2 * BLK] = True  # full middle block
    keep[1, ::97] = True
    planes = tuple(_rand_u32(rng, (b, n)) for _ in range(3))
    cap = ((int(keep.sum(axis=1).max()) + BLK + 256) // 128 + 1) * 128
    _check_compact(planes, keep, cap)


def test_compact_mixed_dtypes_and_overflow():
    # int32 and uint32 planes in one call; a cap below the kept count
    # keeps the first cap rows of each lane (no spill into the next lane)
    # and still reports the true count
    b, n = 3, 1000
    rng = np.random.default_rng(13)
    keep = rng.random((b, n)) < 0.5
    planes = (_rand_u32(rng, (b, n)),
              rng.integers(-(1 << 31), 1 << 31, (b, n)).astype(np.int32))
    _check_compact(planes, keep, cap=128)


def _emit_np(off, tlo, thn, out_cap):
    b, c = off.shape
    out = np.zeros((b, out_cap), np.uint8)
    for i in range(b):
        for r in range(c):
            n = int(thn[i, r] >> 16)
            t = [(int(tlo[i, r]) >> (8 * k)) & 0xFF for k in range(4)]
            t += [(int(thn[i, r]) >> (8 * k)) & 0xFF for k in range(2)]
            for k in range(n):
                p = int(off[i, r]) + k
                if 0 <= p < out_cap:
                    out[i, p] = t[k]
    return out


@pytest.mark.parametrize("seed,base", [(0, 0), (1, 14), (2, 700)])
def test_emit_bytes_differential(seed, base):
    # rows of 0..6 bytes laid back to back from `base`; base=700 pushes
    # the tail past out_cap (those bytes are dropped, not wrapped)
    rng = np.random.default_rng(seed)
    b, c, out_cap = 3, 300, 1024
    nbytes = rng.integers(0, 7, (b, c)).astype(np.uint32)
    off = (base + np.cumsum(nbytes, axis=1) - nbytes).astype(np.int32)
    tlo = _rand_u32(rng, (b, c))
    thn = (_rand_u32(rng, (b, c)) & 0xFFFF) | (nbytes << 16)
    got = emit_bytes(jnp.asarray(off), jnp.asarray(tlo), jnp.asarray(thn),
                     out_cap)
    assert np.array_equal(np.asarray(got), _emit_np(off, tlo, thn, out_cap))


def _place_np(pb, emits, n_cap):
    b, q = pb.shape
    out = np.zeros((b, n_cap), np.uint32)
    for i in range(b):
        cur, p = np.uint32(0), 0
        writes = {}
        for r in range(q):
            nxt = pb[i, r + 1] if r + 1 < q else n_cap
            if nxt > pb[i, r] and pb[i, r] < n_cap:
                writes[int(pb[i, r])] = emits[i, r]
        for p in range(n_cap):
            cur = writes.get(p, cur)
            out[i, p] = cur
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_place_pixels_differential(seed):
    # chunk rows producing 0..63 pixels each (0 = a non-chunk byte row);
    # offsets run past n_cap, and lane 0 starts late (pixels before its
    # first write read 0)
    rng = np.random.default_rng(seed)
    b, q, n_cap = 3, 400, 2048
    produced = np.where(rng.random((b, q)) < 0.5, 0,
                        rng.integers(1, 64, (b, q)))
    produced[0, :5] = 0
    pb = (np.cumsum(produced, axis=1) - produced).astype(np.int32)
    pb[0] += 17
    emits = _rand_u32(rng, (b, q))
    got = place_pixels(jnp.asarray(pb), jnp.asarray(emits), n_cap)
    assert np.array_equal(np.asarray(got), _place_np(pb, emits, n_cap))

#!/usr/bin/env python
"""Two-level boundary-scan experiment (decode front half, all engines).

The shipped `ops/boundary.chunk_starts_batch` runs two BLOCK=128-step
`lax.scan`s (per-block phase-map build, then per-byte replay) around a
log-depth cross-block compose — 256 sequential vector steps total, 8.5 ms
of the ~90 ms B=128 decode batch (profile_r3).  Phase maps over {0..4}
are associative, so the 128-step per-block scans can themselves be
hierarchical: M=16-step scans build MICRO maps, 3 pairwise-compose
levels merge the 8 micro maps per block, and the replay runs M steps
from per-micro entry phases — ~40 sequential steps instead of 256, at
the cost of materializing 5-row maps at micro granularity.

Candidate is bit-identical by construction (same map algebra); this file
proves it differentially and times both at production shapes.

Run on the GPU:
  python benchmarks/expt_boundary2l.py
CPU correctness only:
  python benchmarks/expt_boundary2l.py --correctness-only
"""

import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import jax
import jax.numpy as jnp

from qoipp_tpu.ops import boundary
from qoipp_tpu.ops.boundary import BLOCK, chunk_len_of
from qoipp_tpu.utils.timing import device_time_ms, enable_compile_cache

M = 16               # micro-scan length
NM = BLOCK // M      # micro maps per block


def _compose(a, b_):
    """(f then g)(phi) = g[f[phi]] — one-hot select over the 5 map rows,
    same formulation as the shipped cross-block compose."""
    out = jnp.zeros_like(a)
    for j in range(5):
        out = out | jnp.where(a == j, b_[:, j : j + 1, :], 0)
    return out


def _apply(maps, phi):
    """Apply (B, 5, K) maps to (B, K) phases — one-hot select."""
    out = jnp.zeros_like(phi)
    for j in range(5):
        out = out | jnp.where(phi == j, maps[:, j, :], 0)
    return out


def chunk_starts_batch_2l(regions):
    """Two-level variant of boundary.chunk_starts_batch (bit-identical)."""
    b, qb = regions.shape
    nblk = qb // BLOCK
    k = nblk * NM
    lens = chunk_len_of(regions).reshape(b, k, M)
    lens_t = lens.transpose(2, 0, 1)  # (M, B, K)

    # Stage A': M-step micro maps, carry (B, 5, K).
    ident = jnp.broadcast_to(
        jnp.arange(5, dtype=jnp.uint8)[None, :, None], (b, 5, k)
    )

    def step_map(carry, lens_col):
        nxt = jnp.where(carry > 0, carry - 1, (lens_col - 1)[:, None, :])
        return nxt, None

    micro, _ = jax.lax.scan(step_map, ident, lens_t, unroll=M)

    # Stage A'': inclusive Hillis-Steele scan over the NM micros of each
    # block (log2(NM) compose levels); exclusive prefix = shifted result.
    # compose(a, b) = "a then b", so inc[j] = m_0 then .. then m_j.
    m5 = micro.reshape(b, 5, nblk, NM)
    ident4 = jnp.broadcast_to(
        jnp.arange(5, dtype=jnp.uint8)[None, :, None, None], m5.shape
    )
    acc = m5
    sh = 1
    while sh < NM:
        shifted = jnp.concatenate(
            [ident4[:, :, :, :sh], acc[:, :, :, :-sh]], axis=3
        )
        acc = _compose(
            shifted.reshape(b, 5, -1), acc.reshape(b, 5, -1)
        ).reshape(b, 5, nblk, NM)
        sh *= 2
    pre = jnp.concatenate(
        [ident4[:, :, :, :1], acc[:, :, :, :-1]], axis=3
    )  # pre[j] = m_0 then .. then m_{j-1}; identity at j=0
    block_map = acc[:, :, :, NM - 1]  # (B, 5, nblk): full-block compose

    # Stage B: cross-block exclusive composition (unchanged).
    inclusive = jax.lax.associative_scan(_compose, block_map, axis=2)
    ident_blk = jnp.broadcast_to(
        jnp.arange(5, dtype=jnp.uint8)[None, :, None], (b, 5, nblk)
    )
    entry_map = jnp.concatenate([ident_blk[:, :, :1], inclusive[:, :, :-1]],
                                axis=2)
    entry_blk = entry_map[:, 0, :]  # (B, nblk) — chain enters with phi=0

    # per-micro entry phases: apply each micro's exclusive prefix map to
    # its block's entry phase
    entry_rep = jnp.repeat(entry_blk, NM, axis=1)  # (B, K)
    entry_micro = _apply(pre.reshape(b, 5, k), entry_rep)  # (B, K)

    # Stage C': M-step replay from per-micro entries.
    def step_phase(phi, lens_col):
        nxt = jnp.where(phi > 0, phi - 1, lens_col - 1)
        return nxt, phi

    _, phases = jax.lax.scan(step_phase, entry_micro, lens_t, unroll=M)
    return phases.transpose(1, 2, 0).reshape(b, qb) == 0


def _rand_streams(rng, b, qb):
    """Byte soup with realistic tag mix (every len class present) plus
    adversarial payload bytes that LOOK like tags."""
    out = np.zeros((b, qb), np.uint8)
    for i in range(b):
        pos = 0
        buf = []
        while pos < qb:
            r = rng.random()
            if r < 0.35:
                buf.append(rng.integers(0, 0xC0))      # 1-byte
                pos += 1
            elif r < 0.55:
                buf += [0x80 | rng.integers(0, 64), rng.integers(0, 256)]
                pos += 2
            elif r < 0.8:
                buf += [0xFE, 0xFE, 0xFF, 0xC3]        # RGB w/ taggy payload
                pos += 4
            elif r < 0.9:
                buf += [0xFF, 0xFF, 0xFE, 0x80, 0xC0]  # RGBA taggy payload
                pos += 5
            else:
                buf.append(0xC0 | rng.integers(0, 62))  # RUN
                pos += 1
        out[i] = np.asarray(buf[:qb], np.uint8)
    return out


def main():
    corr_only = "--correctness-only" in sys.argv
    if corr_only:
        jax.config.update("jax_platforms", "cpu")
    enable_compile_cache()
    rng = np.random.default_rng(11)

    base = jax.jit(boundary.chunk_starts_batch)
    cand = jax.jit(chunk_starts_batch_2l)
    for b, qb in [(2, BLOCK), (3, 4 * BLOCK), (2, 37 * BLOCK)]:
        reg = jnp.asarray(_rand_streams(rng, b, qb))
        a = np.asarray(base(reg))
        c = np.asarray(cand(reg))
        assert np.array_equal(a, c), f"MISMATCH at ({b},{qb})"
    print("correctness: identical on 3 adversarial batches", file=sys.stderr)
    if corr_only:
        return

    # production shape: B=128 x ~750KB regions (bench.py synthetic corpus)
    B, QB = 128, 749568 // BLOCK * BLOCK
    reg = jnp.asarray(_rand_streams(rng, 4, QB))
    reg = jnp.tile(reg, (B // 4, 1))
    for name, fn in [("baseline", base), ("two-level", cand)]:
        fn(reg)
        ts = [device_time_ms(lambda: fn(reg), runs=10) for _ in range(3)]
        print(f"{name}: {min(ts):.2f} ms (best of 3x10, B={B} QB={QB})")


if __name__ == "__main__":
    main()

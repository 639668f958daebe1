"""Parallel QOI chunk-boundary discovery.

A QOI byte stream is not self-synchronizing: a payload byte can look like
any tag, so chunk starts must be chained from the header (SURVEY.md §7
"hard parts" #2).  The reference resolves this trivially by decoding
sequentially (source/simple.cpp:111-170); here we parallelize it.

Formulation: every position p has a tag-determined chunk length len(p) in
{1,2,4,5}.  Define the *phase* phi(p) in {0..4} = (next chunk start >= p)
- p.  Because lengths are <= 5, consecutive starts are <= 5 apart and phi
is always < 5.  Its per-byte transition has a closed form:

    phi(p+1) = phi(p) - 1            if phi(p) > 0
             = len(p) - 1            if phi(p) == 0   (p is a start)

Blocks of B bytes therefore compose as maps {0..4} -> {0..4}:
1. per-block map: a B-step lax.scan on a (batch, 5, num_blocks) uint8
   carry (vector select+decrement per step — no gathers; num_blocks is
   the minor axis);
2. cross-block: jax.lax.associative_scan composing the 5-entry maps with
   one-hot selects;
3. per-position phases: a second B-step scan replaying each block from its
   now-known entry phase.  is_start(p) == (phi(p) == 0).

Total: 2B sequential steps of tiny vector work + one log-depth scan over
block summaries — O(6 bytes/position) of memory traffic.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

BLOCK = 128  # bytes per phase block


def chunk_len_of(tags):
    """Chunk byte length decided by the tag byte alone (SURVEY.md §0):
    INDEX/DIFF/RUN=1, LUMA=2, RGB=4, RGBA=5."""
    t = tags.astype(jnp.int32)
    is_rgb = t == 0xFE
    is_rgba = t == 0xFF
    is_luma = (~is_rgb) & (~is_rgba) & ((t & 0xC0) == 0x80)
    return (
        1
        + jnp.where(is_luma, 1, 0)
        + jnp.where(is_rgb, 3, 0)
        + jnp.where(is_rgba, 4, 0)
    ).astype(jnp.uint8)


def chunk_starts_batch(regions):
    """regions: (B, Qb) uint8 chunk-region bytes (stream bytes from offset
    14, zero-padded; Qb % BLOCK == 0).  Returns is_start: (B, Qb) bool.

    Position 0 (stream offset 14) is by definition the first chunk start.
    """
    b, qb = regions.shape
    nblk = qb // BLOCK
    lens = chunk_len_of(regions).reshape(b, nblk, BLOCK)
    # scan inputs: (BLOCK steps, B, nblk) — nblk on the minor axis
    lens_t = lens.transpose(2, 0, 1)

    # Stage A: per-block composed phase maps, carry (B, 5, nblk).
    ident = jnp.broadcast_to(
        jnp.arange(5, dtype=jnp.uint8)[None, :, None], (b, 5, nblk)
    )

    def step_map(carry, lens_col):
        nxt = jnp.where(carry > 0, carry - 1, (lens_col - 1)[:, None, :])
        return nxt, None

    block_map, _ = jax.lax.scan(step_map, ident, lens_t, unroll=32)

    # Stage B: exclusive composition across blocks (f then g => g[f[phi]]),
    # one-hot select over the 5 sublane rows (no gathers).
    def compose(a, b_):
        out = jnp.zeros_like(a)
        for j in range(5):
            out = out | jnp.where(a == j, b_[:, j : j + 1, :], 0)
        return out

    inclusive = jax.lax.associative_scan(compose, block_map, axis=2)
    entry_map = jnp.concatenate(
        [ident[:, :, :1], inclusive[:, :, :-1]], axis=2
    )
    entry_phase = entry_map[:, 0, :]  # chain enters block 0 with phi = 0

    # Stage C: replay each block from its entry phase, record phi per byte.
    def step_phase(phi, lens_col):
        nxt = jnp.where(phi > 0, phi - 1, lens_col - 1)
        return nxt, phi

    _, phases = jax.lax.scan(step_phase, entry_phase, lens_t, unroll=32)
    # phases: (BLOCK, B, nblk) -> (B, Qb)
    return phases.transpose(1, 2, 0).reshape(b, qb) == 0


def chunk_starts(region):
    """Single-stream variant of chunk_starts_batch ((Qb,) -> (Qb,))."""
    return chunk_starts_batch(region[None])[0]


@partial(jax.jit, static_argnames=())
def analyze_region_batch(regions, chunks_sizes, n_px):
    """Batched boundary analysis.

    regions:      (B, Qb) uint8 — stream bytes from offset 14, zero-extended.
    chunks_sizes: (B,) traced — real chunk-region byte counts (stream size
                  - 22; the reference's loop bound, simple.cpp:110-113).
    n_px:         traced scalar — pixels each image owes.

    Returns dict of (B, Qb)-shaped arrays:
      real:       this position starts a chunk the reference would decode
                  (loop condition: data left OR pixels owed).
      produced:   pixels this chunk emits (RUN: (tag&63)+1, else 1); 0 for
                  non-chunk positions.
      pix_before: exclusive prefix sum of produced over real chunks.
    plus (B,) totals (total_chunks / total_pixels).
    """
    b, qb = regions.shape
    q = jnp.arange(qb, dtype=jnp.int32)[None, :]
    is_start = chunk_starts_batch(regions)

    tag = regions.astype(jnp.int32)
    is_run = (tag & 0xC0) == 0xC0
    # 0xFE/0xFF are RGB/RGBA, not RUN (reserved codes — SURVEY.md §0).
    is_run = is_run & (tag != 0xFE) & (tag != 0xFF)
    produced_raw = jnp.where(is_run, (tag & 0x3F) + 1, 1).astype(jnp.int32)

    produced0 = jnp.where(is_start, produced_raw, 0)
    pix_before0 = jnp.cumsum(produced0, axis=1) - produced0

    # The reference's decode loop runs while (di < chunks_size) OR
    # (pi < n_px) — a start position is "real" iff that held when reached.
    real = is_start & ((q < chunks_sizes[:, None]) | (pix_before0 < n_px))
    produced = jnp.where(real, produced_raw, 0)
    pix_before = jnp.cumsum(produced, axis=1) - produced

    return {
        "real": real,
        "produced": produced,
        "pix_before": pix_before,
        "total_chunks": jnp.sum(real.astype(jnp.int32), axis=1),
        "total_pixels": jnp.sum(produced, axis=1),
    }


@partial(jax.jit, static_argnames=())
def analyze_region(region, chunks_size, n_px):
    """Single-stream boundary analysis ((Qb,) arrays; see
    analyze_region_batch)."""
    out = analyze_region_batch(
        region[None], jnp.asarray(chunks_size).reshape(1), n_px
    )
    return {k: v[0] for k, v in out.items()}

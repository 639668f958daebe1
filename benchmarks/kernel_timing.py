#!/usr/bin/env python
"""Per-kernel timings on the GPU at the shapes chip_smoke.py uses.

Times each hand-written kernel beside the plain-XLA version of the same
computation, after checking that both agree:

  replay      the CUDA kernel (native/replay.cu through the FFI) and the
              plain lax.scan (replay_reference, at a reduced depth: it is a
              while loop of several device ops per chunk row)
  place       ops/sparse.place_pixels (decode placement + run fill)
  compact     ops/sparse.compact_rows (encode chunk compaction)
  emit        ops/sparse.emit_bytes (encode byte materialisation)

Shapes: the 128 x 1920x1088 RGB decode batch of chip_smoke.py (rows = its
longest stream's byte count) and one 32-image encode sub-batch.  Prints
one line per measurement with the card's name and power limit.

  python benchmarks/kernel_timing.py
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]


def timeit(fn, *args, runs=5):
    import jax

    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(runs):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / runs * 1e3


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ref-rows", type=int, default=8192)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from bench import make_corpus
    from qoipp_tpu.models.pipeline import BatchPipeline
    from qoipp_tpu.ops import boundary, decode as dec_ops, sparse
    from qoipp_tpu.ops import replay_kernel as rk
    from qoipp_tpu.utils.timing import enable_compile_cache

    assert jax.devices()[0].platform == "gpu", "needs a GPU"
    enable_compile_cache()
    name = card()
    say = lambda s: print(f"{s} [{name}]", flush=True)

    # ---- decode-side inputs: the chip_smoke RGB batch ---------------------
    desc, raws, blobs = make_corpus(128, 1920, 1088, seed=3)
    max_len = max(x.size for x in blobs)
    pipe = BatchPipeline(desc, max_stream_len=max_len)
    streams, sizes = pipe.pack_streams(blobs)
    streams, sizes = jnp.asarray(streams), jnp.asarray(sizes)

    @jax.jit
    def fields(streams, sizes):
        regions = streams[:, 14:]
        q = jnp.arange(regions.shape[1], dtype=jnp.int32)[None, :]
        regions = jnp.where(q < (sizes - 14)[:, None], regions, 0)
        info = boundary.analyze_region_batch(
            regions[:, : pipe.qb], sizes - 22, jnp.int32(pipe.n_px))
        meta, val = dec_ops.fields_dense_batch(regions, info["real"])
        return meta.T, val.T, info["pix_before"]

    meta_t, val_t, pb = jax.block_until_ready(fields(streams, sizes))
    rows, b = meta_t.shape
    say(f"replay shape: {rows} rows x {b} lanes")
    prev0, seen0 = rk.initial_state(b)

    t = timeit(lambda m, v: rk.replay_batch_carry(m, v, prev0, seen0),
               meta_t, val_t)
    emits = rk.replay_batch_carry(meta_t, val_t, prev0, seen0)[0]
    say(f"kernel replay cuda: {t:.3f} ms = {t * 1e6 / rows:.1f} ns/row")

    r = args.ref_rows
    ref = rk.replay_reference
    t = timeit(ref, meta_t[:r], val_t[:r], prev0, seen0, runs=2)
    want = ref(meta_t[:r], val_t[:r], prev0, seen0)
    assert bool(jnp.all(want[0] == emits[:r]))
    say(f"plain replay lax.scan ({r} rows): {t:.3f} ms = "
        f"{t * 1e6 / r:.1f} ns/row; at {rows} rows ~{t * rows / r:.1f} ms")

    t = timeit(sparse.place_pixels, pb, emits.T, pipe.n_cap)
    say(f"plain place_pixels ({b} x {pb.shape[1]} rows -> {pipe.n_cap} px): "
        f"{t:.3f} ms")

    # ---- encode-side: one 32-image sub-batch ------------------------------
    from qoipp_tpu.models.packed import _pack_pixels_np

    sub = 32
    pk = np.zeros((sub, pipe.nb), np.uint32)
    for i in range(sub):
        pk[i, : pipe.n_px] = _pack_pixels_np(raws[i], 3)
    pk = jnp.asarray(pk)
    prev = jnp.concatenate(
        [jnp.full((sub, 1), 0xFF000000, jnp.uint32), pk[:, :-1]], axis=1)
    keep = pk != prev
    cap = min(pipe.nb, pipe.max_encode_len) + 2048 + 256
    cap = -(-cap // 128) * 128
    t = timeit(lambda p, k: sparse.compact_rows((p, p), k, cap), pk, keep)
    say(f"plain compact_rows ({sub} x {pipe.nb} -> {cap}, 2 planes, "
        f"keep {float(jnp.mean(keep)):.3f}): {t:.3f} ms")

    nb_c = jnp.asarray(np.random.default_rng(0).integers(
        0, 7, (sub, cap)).astype(np.uint32))
    off = (jnp.cumsum(nb_c, axis=1) - nb_c).astype(jnp.int32) + 14
    out_cap = -(-int(off.max() + 16) // sparse.WIN) * sparse.WIN
    tlo = jnp.full((sub, cap), 0x04030201, jnp.uint32)
    thn = (nb_c << 16) | 0x0605
    t = timeit(lambda o, a, c: sparse.emit_bytes(o, a, c, out_cap),
               off, tlo, thn)
    say(f"plain emit_bytes ({sub} x {cap} rows -> {out_cap} B): {t:.3f} ms")


if __name__ == "__main__":
    main()

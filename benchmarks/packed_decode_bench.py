#!/usr/bin/env python
"""Stream-packed decode on the real mixed-geometry corpus.

The un-bucketed batch pipeline pays B * max(stream) on mixed corpora and
the bucketed scheduler still pays per-bucket padding + dispatches.  Packing (models/packed.py) makes replay work track
sum(sizes): whole real images of ANY geometry/channels share lanes.

Usage: python benchmarks/packed_decode_bench.py [--replicate N]
"""

import argparse
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--replicate", type=int, default=4)
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--lane-kb", type=int, default=256)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from qoipp_tpu import oracle
    from qoipp_tpu.models.packed import PackedDecoder
    from qoipp_tpu.models import packed as packed_mod
    from qoipp_tpu.utils.timing import enable_compile_cache
    import local_corpus

    enable_compile_cache()
    items = local_corpus.build()
    blobs = [np.fromfile(p, np.uint8) for _, _, _, _, p in items]
    raws = [raw for _, _, raw, _, _ in items]
    descs = [d for _, _, _, d, _ in items]
    # packing wants many SHORT lanes (replay depth = lane bytes): streams
    # larger than the lane cap belong to the batched/bucketed pipeline in
    # a composite deployment -- bench the packable tail
    cap = args.lane_kb << 10
    kept = [i for i, b in enumerate(blobs) if b.size - 22 <= cap]
    dropped = len(blobs) - len(kept)
    blobs = [blobs[i] for i in kept]
    raws = [raws[i] for i in kept]
    descs = [descs[i] for i in kept]
    if dropped:
        print(f"(+{dropped} streams over {args.lane_kb} KB routed to the "
              f"batched pipeline in a composite deployment)", file=sys.stderr)
    blobs = blobs * args.replicate
    raws = raws * args.replicate
    descs = descs * args.replicate
    total_px = sum(d.width * d.height for d in descs)
    total_mb = sum(b.size for b in blobs) / 1e6
    print(f"corpus: {len(blobs)} real images (mixed geometry/channels), "
          f"{total_mb:.1f} MB streams, {total_px/1e6:.1f} MPix",
          file=sys.stderr)

    t0 = time.perf_counter()
    for b_, d in zip(blobs, descs):
        oracle.decode(b_, d, d.channels)
    t_or = time.perf_counter() - t0
    print(f"oracle: {total_px/t_or/1e6:.1f} MPix/s ({t_or*1e3:.0f} ms)",
          file=sys.stderr)

    dec = PackedDecoder(lane_bytes=cap)
    got = dec.decode(blobs)  # cold: compiles + parity material
    ok = all(np.array_equal(g, r) for g, r in zip(got, raws))
    print(f"packed parity: {'100%' if ok else 'FAILED'}", file=sys.stderr)

    # end-to-end (host pack + device + host slice)
    t0 = time.perf_counter()
    for _ in range(args.runs):
        dec.decode(blobs)
    t_e2e = (time.perf_counter() - t0) / args.runs

    # device-only: stage the packed lanes once, time the jit (the same
    # balanced plan decode() settled on)
    regions, seg, sizes, _, _, qb, n_cap, l_total = dec.plan_and_pack(blobs)
    L = l_total
    regions_d = jnp.asarray(regions)
    seg_d = jnp.asarray(seg)
    sizes_d = jnp.asarray(sizes)
    jax.block_until_ready(packed_mod._decode_lanes(
        regions_d, seg_d, sizes_d, qb=qb, n_cap=n_cap, l_total=l_total))
    from qoipp_tpu.utils.timing import device_time_ms
    fn = lambda r, s, c: packed_mod._decode_lanes(
        r, s, c, qb=qb, n_cap=n_cap, l_total=l_total)
    t_dev = device_time_ms(fn, regions_d, seg_d, sizes_d,
                           runs=args.runs * 2) / 1e3

    print(f"packed: device {total_px/t_dev/1e6:.1f} MPix/s "
          f"({t_dev*1e3:.0f} ms, {L} lanes x {qb>>10} KB), "
          f"end-to-end {total_px/t_e2e/1e6:.1f} MPix/s, parity "
          f"{'100%' if ok else 'FAILED'}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

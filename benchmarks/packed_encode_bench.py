#!/usr/bin/env python
"""Encode-side stream packing on the real mixed-geometry corpus.

The un-bucketed batch pipeline pays B * max(pixels) on mixed corpora.
Packed
encode lanes (models/packed.PackedEncoder) make the compact + table-scan
+ emit work track sum(pixels): whole real images of ANY geometry and
channels share lanes.

Usage: python benchmarks/packed_encode_bench.py [--replicate N]
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
    ap.add_argument("--lane-kpx", type=int, default=512,
                    help="lane pixel-slot capacity in Ki-pixels")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from qoipp_tpu import oracle
    from qoipp_tpu.models.packed import PackedEncoder
    from qoipp_tpu.ops import encode as enc_ops
    from qoipp_tpu.utils.timing import enable_compile_cache
    import local_corpus

    enable_compile_cache()
    items = local_corpus.build()
    raws = [raw for _, _, raw, _, _ in items]
    descs = [d for _, _, _, d, _ in items]
    cap_px = (args.lane_kpx << 10) - 2
    kept = [i for i, d in enumerate(descs) if d.width * d.height <= cap_px]
    dropped = len(descs) - len(kept)
    raws = [raws[i] for i in kept] * args.replicate
    descs = [descs[i] for i in kept] * args.replicate
    if dropped:
        print(f"(+{dropped} images over {args.lane_kpx} Kpx routed to the "
              f"batched pipeline in a composite deployment)", file=sys.stderr)
    total_px = sum(d.width * d.height for d in descs)
    print(f"corpus: {len(raws)} real images (mixed geometry/channels), "
          f"{total_px/1e6:.1f} MPix", file=sys.stderr)

    t0 = time.perf_counter()
    refs = [oracle.encode(r, d)[0] for r, d in zip(raws, descs)]
    t_or = time.perf_counter() - t0
    print(f"oracle: {total_px/t_or/1e6:.1f} MPix/s ({t_or*1e3:.0f} ms)",
          file=sys.stderr)

    enc = PackedEncoder(lane_px=args.lane_kpx << 10)
    got = enc.encode(raws, descs)  # cold: compiles + parity material
    ok = all(np.array_equal(g, r) for g, r in zip(got, refs))
    print(f"packed encode parity: {'100%' if ok else 'FAILED'}",
          file=sys.stderr)

    # end-to-end (host pack + device + host slice)
    t0 = time.perf_counter()
    for _ in range(args.runs):
        enc.encode(raws, descs)
    t_e2e = (time.perf_counter() - t0) / args.runs

    # device-only: stage the packed lanes once, time the jit (same caps
    # the encode() call settled on — fractional, or safe after a retry)
    packed, flags, _, caps = enc.plan_and_pack(raws, descs)
    L, np_ = packed.shape
    packed_d = jnp.asarray(packed)
    flags_d = jnp.asarray(flags)

    def run(chunk_cap, out_cap):
        return enc_ops._encode_lanes_impl(
            packed_d, flags_d, chunk_cap, out_cap, caps["ends_cap"]
        )

    r = run(caps["chunk_cap"], caps["out_cap"])
    jax.block_until_ready(r)
    caps_used = (caps["chunk_cap"], caps["out_cap"])
    if not bool(r[3].all()):
        caps_used = (caps["safe_chunk"], caps["safe_out"])
        jax.block_until_ready(run(*caps_used))
        print("(fractional caps tripped; timing the safe-cap program)",
              file=sys.stderr)
    from qoipp_tpu.utils.timing import device_time_ms
    t_dev = device_time_ms(run, *caps_used, runs=args.runs * 2) / 1e3

    print(f"packed encode: device {total_px/t_dev/1e6:.1f} MPix/s "
          f"({t_dev*1e3:.0f} ms, {L} lanes x {np_>>10} Kpx, "
          f"chunk_cap {caps_used[0]>>10}K out_cap {caps_used[1]>>10}K), "
          f"end-to-end {total_px/t_e2e/1e6:.1f} MPix/s, parity "
          f"{'100%' if ok else 'FAILED'}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

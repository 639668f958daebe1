#!/usr/bin/env python
"""Composite serving codec on the FULL real mixed corpus (no stream
dropped): one front-end call, engines routed by size.

This is the serving-shaped workload: decode a mixed directory of real
images (tiny icons .. multi-MB photos) through
qoipp_tpu.models.serving.ServingCodec with 100% parity.

Three timings per direction, matching how a serving deployment pays:

  * serve (HBM-resident): plan + stage + dispatch + device completion
    (jax.block_until_ready on every device output).
  * fetch+unpack: bulk device->host fetch + host slicing.
  * end-to-end: the plain decode()/encode() call.

Usage: python benchmarks/serving_bench.py [--replicate N]
"""

import argparse
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))


def _sync_decode_plan(plan):
    """Wait for every device output of a decode plan."""
    import jax

    _, packed_parts, split_parts = plan
    jax.block_until_ready([dev for _, (dev, *_r) in packed_parts + split_parts])


def _sync_encode_plan(plan):
    """Wait for every device output of an encode plan."""
    import jax

    _, packed_parts, bucket_parts = plan
    jax.block_until_ready([out for _, (out, *_r) in packed_parts]
                          + [streams for _, streams, *_r in bucket_parts])


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--replicate", type=int, default=8)
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--lane-kb", type=int, default=8 << 10)
    ap.add_argument("--no-encode", action="store_true")
    args = ap.parse_args()

    from qoipp_tpu import oracle
    from qoipp_tpu.models.serving import ServingCodec
    from qoipp_tpu.utils.timing import enable_compile_cache
    import local_corpus

    enable_compile_cache()
    items = local_corpus.build()
    blobs = [np.fromfile(p, np.uint8) for _, _, _, _, p in items]
    raws = [raw for _, _, raw, _, _ in items]
    descs = [d for _, _, _, d, _ in items]
    blobs = blobs * args.replicate
    raws = raws * args.replicate
    descs = descs * args.replicate
    total_px = sum(d.width * d.height for d in descs)
    print(f"corpus: {len(blobs)} real images (mixed, INCLUDING over-cap), "
          f"{sum(b.size for b in blobs)/1e6:.1f} MB streams, "
          f"{total_px/1e6:.1f} MPix", file=sys.stderr)

    t0 = time.perf_counter()
    for b_, d in zip(blobs, descs):
        oracle.decode(b_, d, d.channels)
    t_or = time.perf_counter() - t0
    print(f"oracle decode: {total_px/t_or/1e6:.1f} MPix/s", file=sys.stderr)

    codec = ServingCodec(pack_lane_bytes=args.lane_kb << 10)
    plan = codec.decode_dispatch(blobs)  # cold: compiles
    _sync_decode_plan(plan)
    got = codec.decode_finish(plan)
    ok_dec = all(np.array_equal(g, r) for g, r in zip(got, raws))
    print(f"serving decode parity: {'100%' if ok_dec else 'FAILED'}",
          file=sys.stderr)

    # serve (HBM-resident): dispatch + device completion
    t0 = time.perf_counter()
    for _ in range(args.runs):
        plan = codec.decode_dispatch(blobs)
        _sync_decode_plan(plan)
    t_serve = (time.perf_counter() - t0) / args.runs
    print(f"serving decode (HBM-resident): {total_px/t_serve/1e6:.1f} "
          f"MPix/s ({t_serve*1e3:.0f} ms)")

    # overlapped: host planning pipelined against worker-thread uploads
    t0 = time.perf_counter()
    for _ in range(args.runs):
        plan_ov = codec.decode_dispatch_overlapped(blobs)
        _sync_decode_plan(plan_ov)
    t_ov = (time.perf_counter() - t0) / args.runs
    print(f"serving decode (HBM-resident, overlapped): "
          f"{total_px/t_ov/1e6:.1f} MPix/s ({t_ov*1e3:.0f} ms)")

    # device execution alone: inputs pre-staged in HBM, time dispatch ->
    # completion (the number a co-located deployment's device share is)
    staged = codec.decode_stage(blobs)
    for parts in (staged[1], staged[2]):
        for _, s in parts:
            np.asarray(s[0][0, 0])  # force the uploads to finish
    _sync_decode_plan(codec.decode_dispatch_staged(staged))  # warm
    t0 = time.perf_counter()
    for _ in range(args.runs):
        _sync_decode_plan(codec.decode_dispatch_staged(staged))
    t_exec = (time.perf_counter() - t0) / args.runs
    print(f"serving decode device-exec (pre-staged): "
          f"{total_px/t_exec/1e6:.1f} MPix/s ({t_exec*1e3:.0f} ms)")

    # resident-corpus cache mode: stage ONCE, decode R times; the
    # steady-state request cost is the device dispatch alone
    corpus = codec.make_resident(blobs)
    _sync_decode_plan(corpus.decode_device())  # warm
    t0 = time.perf_counter()
    for _ in range(args.runs):
        _sync_decode_plan(corpus.decode_device())
    t_res = (time.perf_counter() - t0) / args.runs
    print(f"serving decode resident-corpus (steady state): "
          f"{total_px/t_res/1e6:.1f} MPix/s ({t_res*1e3:.0f} ms/request)")
    got_r = corpus.decode()
    ok_res = all(np.array_equal(g, r) for g, r in zip(got_r, raws))
    print(f"resident-corpus parity: {'100%' if ok_res else 'FAILED'}",
          file=sys.stderr)
    ok_dec = ok_dec and ok_res

    t0 = time.perf_counter()
    codec.decode_finish(plan)
    t_fetch = time.perf_counter() - t0
    print(f"  fetch+unpack: {t_fetch*1e3:.0f} ms "
          f"({total_px/t_fetch/1e6:.1f} MPix/s)", file=sys.stderr)

    t0 = time.perf_counter()
    for _ in range(args.runs):
        codec.decode(blobs)
    t_dec = (time.perf_counter() - t0) / args.runs
    print(f"serving decode end-to-end: {total_px/t_dec/1e6:.1f} MPix/s "
          f"({t_dec*1e3:.0f} ms)")

    if args.no_encode:
        return 0 if ok_dec else 1

    t0 = time.perf_counter()
    refs = [oracle.encode(r, d)[0] for r, d in zip(raws, descs)]
    t_ore = time.perf_counter() - t0
    print(f"oracle encode: {total_px/t_ore/1e6:.1f} MPix/s", file=sys.stderr)

    streams = codec.encode(raws, descs)
    ok_enc = all(np.array_equal(s, r) for s, r in zip(streams, refs))
    print(f"serving encode parity: {'100%' if ok_enc else 'FAILED'}",
          file=sys.stderr)

    # serve (HBM-resident byte lanes): plan + stage + dispatch + completion
    t0 = time.perf_counter()
    for _ in range(args.runs):
        plan_e = codec.encode_dispatch(raws, descs)
        _sync_encode_plan(plan_e)
    t_eserve = (time.perf_counter() - t0) / args.runs
    print(f"serving encode (HBM-resident): {total_px/t_eserve/1e6:.1f} "
          f"MPix/s ({t_eserve*1e3:.0f} ms)")

    # device execution alone (inputs pre-staged in HBM)
    estaged = codec.encode_stage(raws, descs)
    for _, s in estaged[1]:
        np.asarray(s[0][0, 0])  # force packed-tier uploads
    for _, _, batch_d, _ in estaged[2]:
        np.asarray(batch_d[0, 0])
    t0 = time.perf_counter()
    for _ in range(args.runs):
        _sync_encode_plan(codec.encode_dispatch_staged(estaged))
    t_eexec = (time.perf_counter() - t0) / args.runs
    print(f"serving encode device-exec (pre-staged): "
          f"{total_px/t_eexec/1e6:.1f} MPix/s ({t_eexec*1e3:.0f} ms)")

    t0 = time.perf_counter()
    codec.encode_finish(plan_e)
    t_efetch = time.perf_counter() - t0
    print(f"  fetch+assemble: {t_efetch*1e3:.0f} ms "
          f"({total_px/t_efetch/1e6:.1f} MPix/s; D2H-bound)",
          file=sys.stderr)

    t0 = time.perf_counter()
    for _ in range(args.runs):
        codec.encode(raws, descs)
    t_enc = (time.perf_counter() - t0) / args.runs
    print(f"serving encode end-to-end: {total_px/t_enc/1e6:.1f} MPix/s "
          f"({t_enc*1e3:.0f} ms)")
    return 0 if (ok_dec and ok_enc) else 1


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python
"""Smoke run of the codec on one NVIDIA GPU (or four, with --four).

Drives the public entry points at real sizes, compiled for the card, and
checks every output byte-exactly against the native oracle
(native/qoi_ref.cpp).  Every corpus is generated from --seed.

  python chip_smoke.py            # one card: every phase below
  python chip_smoke.py --four     # four cards: dp and sp decode/encode only

Phases (one card):
  1. device     a GPU is present; the card's name and power limit
  2. pipeline   BatchPipeline decode + encode, 128 x 1920x1088 RGB and
                64 x 1920x1088 RGBA
  3. serving    ServingCodec decode + encode of a mixed corpus, thumbnails
                to 1080p, RGB and RGBA, plus a noisy 4096x4096 stream above
                split_min_bytes (the split engine)
  4. stream     DeviceStreamEncoder / DeviceStreamDecoder, 1080p RGBA
                frames window by window
  5. oneshot    q.encode / q.decode(backend="jax") on a 1080p image
  6. kernel     the CUDA replay kernel against its lax.scan reference (the
                gpu-marked cases of tests/test_replay_kernel.py)
  7. route      the compiled BatchPipeline decode holds the replay kernel's
                custom call, and no kernel runs interpreted

Warm wall times go to stdout, one line per phase with the card's name and
power limit.  A failed check raises: the script exits non-zero and prints
no result line.  The last line, printed only when every phase passed, is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np


def cards() -> list:
    """nvidia-smi's name,power.limit line for each card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip()
    return out.splitlines()


def log(msg: str) -> None:
    print(msg, flush=True)


class Phases:
    def __init__(self, card_name: str):
        self.card = card_name

    def timed(self, label: str, fn, *args):
        """Run fn once (compile + check), then once more timed warm."""
        import jax

        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        cold = time.perf_counter() - t0
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        warm = time.perf_counter() - t0
        log(f"time {label}: warm {warm * 1e3:.2f} ms, first call "
            f"{cold:.2f} s [{self.card}] (smoke timing, not a benchmark)")
        return out


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(f"parity FAILED: {what}")


# ---------------------------------------------------------------------------
# one card
# ---------------------------------------------------------------------------


def phase_pipeline(ph: Phases, seed: int) -> None:
    import jax.numpy as jnp

    from bench import make_corpus
    from qoipp_tpu import oracle
    from qoipp_tpu.models.packed import _pack_pixels_np
    from qoipp_tpu.models.pipeline import BatchPipeline

    for b, ch in ((128, 3), (64, 4)):
        desc, raws, blobs = make_corpus(b, 1920, 1088, seed=seed + ch,
                                        channels=ch)
        label = f"{b}x1920x1088x{ch}"
        max_len = max(x.size for x in blobs)
        pipe = BatchPipeline(desc, max_stream_len=max_len,
                             max_encode_len=max_len + 4096)
        streams, sizes = pipe.pack_streams(blobs)
        streams, sizes = jnp.asarray(streams), jnp.asarray(sizes)
        packed = ph.timed(f"pipeline decode {label}", pipe.decode_packed,
                          streams, sizes)
        got = np.asarray(packed[:, : pipe.n_px])
        pk = np.zeros((b, pipe.nb), np.uint32)
        for i, blob in enumerate(blobs):
            want = _pack_pixels_np(oracle.decode(blob, desc, desc.channels),
                                   ch)
            check(np.array_equal(got[i], want), f"pipeline decode {i}")
            pk[i, : pipe.n_px] = _pack_pixels_np(raws[i], ch)
        pk = jnp.asarray(pk)
        enc, lengths, ok = ph.timed(f"pipeline encode {label}",
                                    pipe.encode_packed_chunked, pk)
        check(bool(np.all(np.asarray(ok))), "pipeline encode caps")
        enc, lengths = np.asarray(enc), np.asarray(lengths)
        for i, blob in enumerate(blobs):
            check(lengths[i] == blob.size
                  and np.array_equal(enc[i, : blob.size], blob),
                  f"pipeline encode {i}")
        log(f"parity pipeline {label}: {b} decodes + {b} encodes exact")


def _serving_corpus(seed: int):
    from bench import make_corpus
    from qoipp_tpu import Channels, Desc, oracle

    sizes = [(64, 64), (96, 128), (320, 240), (640, 480), (1280, 720),
             (1920, 1080)]
    descs, raws, blobs = [], [], []
    for k, (w, h) in enumerate(sizes):
        for ch in (3, 4):
            d, r, bl = make_corpus(3, w, h, seed=seed + 10 * k + ch,
                                   channels=ch)
            descs += [d] * 3
            raws += r
            blobs += bl
    rng = np.random.default_rng(seed)
    big = Desc(4096, 4096, Channels.RGB)
    raw = rng.integers(0, 256, 4096 * 4096 * 3, dtype=np.uint8)
    enc, complete = oracle.encode(raw, big)
    check(complete, "oracle encode of the noisy 4096x4096 image")
    descs.append(big)
    raws.append(raw)
    blobs.append(enc)
    return descs, raws, blobs


def phase_serving(ph: Phases, seed: int) -> None:
    from qoipp_tpu import oracle
    from qoipp_tpu.models.serving import ServingCodec

    descs, raws, blobs = _serving_corpus(seed)
    split_min = 1 << 20
    codec = ServingCodec(split_min_bytes=split_min)
    check(blobs[-1].size - 22 > split_min,
          "the noisy stream must exceed split_min_bytes")
    label = f"{len(blobs)} mixed streams"
    dec = ph.timed(f"serving decode {label}", codec.decode, blobs)
    for i, (d, blob) in enumerate(zip(descs, blobs)):
        want = oracle.decode(blob, d, d.channels)
        check(np.array_equal(np.asarray(dec[i]), want), f"serving decode {i}")
    enc = ph.timed(f"serving encode {label}", codec.encode, raws, descs)
    for i, blob in enumerate(blobs):
        check(np.array_equal(np.asarray(enc[i]), blob), f"serving encode {i}")
    log(f"parity serving: {len(blobs)} decodes + {len(blobs)} encodes exact "
        f"(largest stream {blobs[-1].size} B, split engine)")


def phase_stream(ph: Phases, seed: int) -> None:
    from bench import make_corpus
    from qoipp_tpu import oracle
    from qoipp_tpu.common import END_MARKER
    from qoipp_tpu.ops.device_stream import (
        DeviceStreamDecoder,
        DeviceStreamEncoder,
    )

    desc, raws, blobs = make_corpus(3, 1920, 1088, seed=seed + 40,
                                    channels=4)
    n_px = desc.width * desc.height
    win = 1 << 18

    def encode_frames():
        out = []
        for raw in raws:
            enc = DeviceStreamEncoder(window_px=win)
            parts = [enc.initialize(desc).value()]
            for s in range(0, n_px, win):
                res = enc.encode_window(raw[s * 4 : (s + win) * 4])
                parts.append(res.value().tobytes())
            parts.append(enc.finalize().value())
            out.append(b"".join(parts))
        return out

    def decode_frames():
        out = []
        for blob in blobs:
            dec = DeviceStreamDecoder()
            dec.initialize(blob[:14]).value()
            body = blob[14 : blob.size - len(END_MARKER)]
            step = 1 << 18
            parts = [dec.decode_window(body[s : s + step]).value()
                     for s in range(0, body.size, step)]
            out.append(np.concatenate(parts))
        return out

    enc = ph.timed(f"stream encode 3 frames 1920x1088x4 (windows of {win} px)",
                   encode_frames)
    for i, blob in enumerate(blobs):
        check(enc[i] == blob.tobytes(), f"stream encode frame {i}")
    dec = ph.timed("stream decode 3 frames 1920x1088x4 (256 KiB windows)",
                   decode_frames)
    for i, blob in enumerate(blobs):
        want = oracle.decode(blob, desc, desc.channels)
        check(np.array_equal(dec[i], want), f"stream decode frame {i}")
    log("parity stream: 3 frames encoded + decoded window by window, exact")


def phase_oneshot(ph: Phases, seed: int) -> None:
    import qoipp_tpu as q
    from bench import make_corpus

    desc, raws, blobs = make_corpus(1, 1920, 1080, seed=seed + 50)
    enc = ph.timed("oneshot encode 1920x1080x3",
                   lambda: q.encode(raws[0], desc, backend="jax").value())
    check(np.array_equal(np.asarray(enc), blobs[0]), "one-shot encode")
    img = ph.timed("oneshot decode 1920x1080x3",
                   lambda: q.decode(blobs[0], backend="jax").value())
    check(np.array_equal(np.asarray(img.data).reshape(-1), raws[0]),
          "one-shot decode")
    log("parity oneshot: encode + decode exact")


def phase_kernel() -> None:
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parent / "tests" / "test_replay_kernel.py"
    spec = importlib.util.spec_from_file_location("test_replay_kernel", path)
    tests = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tests)
    GPU_CASES = tests.GPU_CASES
    for case in GPU_CASES:
        tests.check_kernel_case(*case)
    log(f"parity kernel: CUDA replay == lax.scan reference on "
        f"{len(GPU_CASES)} cases")


def phase_route(seed: int) -> None:
    import jax.numpy as jnp

    from bench import make_corpus
    from qoipp_tpu.models.pipeline import BatchPipeline
    from qoipp_tpu.ops import replay_kernel as rk

    check(rk.route() == "cuda", "the replay kernel must run compiled")
    desc, _, blobs = make_corpus(4, 256, 128, seed=seed)
    pipe = BatchPipeline(desc)
    streams, sizes = pipe.pack_streams(blobs)
    text = pipe._decode.lower(
        jnp.asarray(streams), jnp.asarray(sizes)
    ).compile().as_text()
    hits = [line.strip() for line in text.splitlines()
            if any(t in line for t in rk.GPU_TARGETS)]
    check(bool(hits),
          f"replay kernel {rk.GPU_TARGETS} missing from the compiled decode")
    log(f"route: compiled decode holds the replay kernel "
        f"({len(hits)} lines, first: {hits[0][:160]})")


def run_one(args, ph: Phases) -> None:
    phase_pipeline(ph, args.seed)
    phase_serving(ph, args.seed)
    phase_stream(ph, args.seed)
    phase_oneshot(ph, args.seed)
    phase_kernel()
    phase_route(args.seed)


# ---------------------------------------------------------------------------
# four cards
# ---------------------------------------------------------------------------


def run_four(args, ph: Phases) -> None:
    """dp decode/encode on a 4-card data mesh and sp decode/encode on a
    4-card seq mesh, each against the oracle."""
    import jax
    import jax.numpy as jnp

    from bench import make_corpus
    from qoipp_tpu import oracle
    from qoipp_tpu.models.pipeline import BatchPipeline
    from qoipp_tpu.ops import boundary
    from qoipp_tpu.ops import decode as dec_ops
    from qoipp_tpu.ops.bitops import pixels_to_packed
    from qoipp_tpu.parallel import mesh as mesh_mod
    from qoipp_tpu.parallel import sharded

    n = len(jax.devices())
    check(n == 4, f"--four needs 4 GPUs, found {n}")

    # dp: 64 x 1080p RGB, 16 per card
    desc, raws, blobs = make_corpus(64, 1920, 1088, seed=args.seed + 3)
    max_len = max(x.size for x in blobs)
    pipe = BatchPipeline(desc, max_stream_len=max_len,
                         max_encode_len=max_len + 4096)
    m = mesh_mod.make_mesh((4, 1), ("data", "seq"))
    dp_dec = sharded.make_dp_decode(pipe, m)
    dp_enc = sharded.make_dp_encode(pipe, m)
    streams, sizes = pipe.pack_streams(blobs)
    packed, _ = ph.timed("dp decode 64x1920x1088x3 on 4 cards", dp_dec,
                         jnp.asarray(streams), jnp.asarray(sizes))
    got = np.asarray(packed[:, : pipe.n_px])
    for i, blob in enumerate(blobs):
        want = np.asarray(pixels_to_packed(
            jnp.asarray(oracle.decode(blob, desc, desc.channels)), 3))
        check(np.array_equal(got[i], want), f"dp decode {i}")
    pk = jnp.pad(packed[:, : pipe.n_px], ((0, 0), (0, pipe.nb - pipe.n_px)))
    enc, lengths = ph.timed("dp encode 64x1920x1088x3 on 4 cards", dp_enc, pk)
    enc, lengths = np.asarray(enc), np.asarray(lengths)
    for i, blob in enumerate(blobs):
        check(lengths[i] == blob.size
              and np.array_equal(enc[i, : blob.size], blob), f"dp encode {i}")
    log("parity dp: 64 decodes + 64 encodes exact on 4 cards")

    # sp: one 4096x2304 RGB image sharded over 4 cards
    sm = mesh_mod.make_mesh((1, 4), ("data", "seq"))
    sdesc, sraws, sblobs = make_corpus(1, 4096, 2304, seed=args.seed + 4)
    raw, enc1 = sraws[0], sblobs[0]
    n_px = sdesc.width * sdesc.height
    tiles = 64
    qb = dec_ops._bucket(enc1.size - 14, boundary.BLOCK)
    while qb % (4 * tiles):
        qb += boundary.BLOCK
    region = np.zeros(qb + 8, np.uint8)
    region[: enc1.size - 14] = enc1[14:]
    region_j = jnp.asarray(region)
    info = boundary.analyze_region(region_j[:qb], jnp.int32(enc1.size - 22),
                                   jnp.int32(n_px))
    cls, val, nmask, arg = jax.jit(dec_ops.classify_dense,
                                   static_argnames=("qb",))(
        region_j, qb, info["real"])
    sp_dec = sharded.make_sp_decode(sm, qb, tiles_per_device=tiles)
    emits, prevs = ph.timed("sp decode 4096x2304x3 on 4 cards", sp_dec,
                            cls, val, nmask, arg)
    got_px = dec_ops.expand_pixels(emits, prevs, info["real"],
                                   info["produced"], info["pix_before"],
                                   dec_ops._bucket(n_px, 128))[:n_px]
    want_px = pixels_to_packed(jnp.asarray(raw), 3)
    check(bool(jnp.all(got_px == want_px)), "sp decode")

    n_local = -(-n_px // 4 // 64) * 64
    n_last = n_px - 3 * n_local
    px = jnp.pad(want_px, (0, 4 * n_local - n_px))
    sp_enc = sharded.make_sp_encode(sm, n_local, channels=3)
    bodies, lens = ph.timed("sp encode 4096x2304x3 on 4 cards", sp_enc, px,
                            jnp.int32(n_last))
    bodies, lens = np.asarray(bodies), np.asarray(lens)
    body = b"".join(bodies[s, : lens[s]].tobytes() for s in range(4))
    check(body == enc1[14:].tobytes(), "sp encode")
    log("parity sp: decode + encode of one 4096x2304 image exact on 4 cards")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four", action="store_true",
                    help="run the 4-card dp/sp phases only")
    args = ap.parse_args()

    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"no GPU: jax found {devs[0].platform}", file=sys.stderr)
        sys.exit(2)
    smi = cards()
    card_name = smi[0]
    log(f"card: {card_name}")
    log(f"device: {devs[0].platform} {devs[0].device_kind} x{len(devs)}")

    from qoipp_tpu.utils.timing import enable_compile_cache

    enable_compile_cache()
    ph = Phases(card_name)
    if args.four:
        run_four(args, ph)
    else:
        run_one(args, ph)
    for line in smi:  # verbatim, as nvidia-smi prints them
        log(line)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform,
        "kind": devs[0].device_kind,
        "count": len(devs),
    }}), flush=True)


if __name__ == "__main__":
    main()

#!/usr/bin/env python
"""Multi-codec QOI benchmark CLI.

Mirrors the reference's 04_bench example (example/source/04_bench.cpp):
per-image + summary tables of encode/decode ms, MPix/s, encoded size and
compression ratio; cross-verification against the oracle before timing
(04_bench.cpp:685-731); 1 cold + warmup + N timed runs averaged
(04_bench.cpp:733-754); per-codec toggles and --no-verify/--only-totals
flags (04_bench.cpp:121-137).

Codecs benchmarked:
  native     the framework's C++ CPU oracle (reference-equivalent)
  jax        one-shot device codec (qoipp_tpu encode/decode backend=jax)
  jax-batch  batched device pipeline (all images in one device program)
  stream     native streaming codec driven with a 64 KiB buffer
  png        Pillow PNG (the reference benches stb/fpng the same way)
  serving    composite device front-end (size-tiered packed lanes +
             bucketed batches; decode timed to HBM-resident completion)

Corpus: a directory of .qoi (and .png, if Pillow is present) files, or a
generated synthetic corpus with --synthetic N.
"""

import argparse
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import qoipp_tpu as q
from qoipp_tpu import oracle


def load_corpus(args):
    images = []  # (name, raw, desc)
    if args.synthetic:
        rng = np.random.default_rng(0)
        for i in range(args.synthetic):
            w, h = args.width, args.height
            base = rng.integers(0, 256, (24, 3)).astype(np.uint8)
            ids = rng.integers(0, 24, w * h)
            ids = np.maximum.accumulate(
                np.where(rng.random(w * h) < 0.03, ids, 0)
            ) % 24
            raw = base[ids].reshape(-1)
            images.append((f"synthetic_{i}", raw, q.Desc(w, h, q.Channels.RGB)))
        return images

    root = Path(args.corpus)
    for path in sorted(root.rglob("*")):
        if path.suffix.lower() == ".qoi":
            img = q.decode(path, backend="native")
            if img:
                images.append((path.name, img.value().data, img.value().desc))
        elif path.suffix.lower() == ".png":
            try:
                from PIL import Image as PILImage

                im = PILImage.open(path)
                im = im.convert("RGBA" if "A" in im.mode else "RGB")
                arr = np.asarray(im, np.uint8)
                ch = q.Channels.RGBA if arr.shape[-1] == 4 else q.Channels.RGB
                images.append(
                    (path.name, arr.reshape(-1), q.Desc(arr.shape[1], arr.shape[0], ch))
                )
            except Exception:
                pass
    return images


def timed(fn, runs, warmup):
    fn()  # cold
    for _ in range(warmup):
        fn()
    t0 = time.perf_counter()
    for _ in range(runs):
        fn()
    return (time.perf_counter() - t0) / runs


def drive_stream_encode(raw, desc, buf=65536):
    enc = q.StreamEncoder()
    out = np.zeros(buf, np.uint8)
    parts = bytearray()
    enc.initialize(out, desc)
    parts += out[:14].tobytes()
    consumed = 0
    while consumed < raw.size:
        r = enc.encode(out, raw[consumed:]).value()
        parts += out[: r.written].tobytes()
        consumed += r.processed
    fin = np.zeros(9, np.uint8)
    n = enc.finalize(fin).value()
    parts += fin[:n].tobytes()
    return np.frombuffer(bytes(parts), np.uint8)


def drive_stream_decode(blob, desc, buf=65536):
    dec = q.StreamDecoder()
    dec.initialize(blob[:14])
    out = np.zeros(buf, np.uint8)
    parts = bytearray()
    consumed = 14
    end = blob.size - 8
    while consumed < end:
        r = dec.decode(out, blob[consumed:end]).value()
        parts += out[: r.written].tobytes()
        consumed += r.processed
        if r.processed == 0 and r.written == 0:
            break
    while dec.has_run_count():
        n = dec.drain_run(out).value()
        parts += out[:n].tobytes()
    dec.reset()
    return np.frombuffer(bytes(parts), np.uint8)


def fmt_row(cols):
    return "  ".join(f"{c:>12}" for c in cols)


def main(argv=None):
    p = argparse.ArgumentParser(description="QOI codec benchmark")
    p.add_argument("corpus", nargs="?", default=None,
                   help="directory of .qoi/.png images")
    p.add_argument("--synthetic", type=int, default=0,
                   help="generate N synthetic images instead")
    p.add_argument("--width", type=int, default=1024)
    p.add_argument("--height", type=int, default=768)
    p.add_argument("--runs", type=int, default=3)
    p.add_argument("--no-warmup", action="store_true")
    p.add_argument("--no-verify", action="store_true")
    p.add_argument("--no-encode", action="store_true")
    p.add_argument("--no-decode", action="store_true")
    p.add_argument("--only-totals", action="store_true")
    for c in ("native", "jax", "jax-batch", "stream", "png", "serving"):
        p.add_argument(f"--no-{c}", action="store_true")
    args = p.parse_args(argv)
    if not args.corpus and not args.synthetic:
        args.synthetic = 4

    images = load_corpus(args)
    if not images:
        print("no images found", file=sys.stderr)
        return 1
    warmup = 0 if args.no_warmup else 3

    codecs = [c for c in ("native", "jax", "stream", "png")
              if not getattr(args, f"no_{c.replace('-', '_')}")]
    try:
        import PIL  # noqa: F401
    except ImportError:
        codecs = [c for c in codecs if c != "png"]

    # verification pass: the full enc x dec CROSS MATRIX before timing —
    # every codec's encoded bytes decoded by EVERY codec's decoder, both
    # compared to the raw pixels (04_bench.cpp:685-731 verifies enc(A)->
    # dec(B) and enc(B)->dec(A) in both directions the same way).
    if not args.no_verify:
        qoi_codecs = [c for c in codecs if c != "png"]

        def enc_with(c, raw, desc):
            if c == "native":
                out, complete = oracle.encode(raw, desc)
                assert complete
                return out
            if c == "jax":
                return q.encode(raw, desc, backend="jax").value()
            return drive_stream_encode(raw, desc)

        def dec_with(c, blob, desc):
            if c == "native":
                return oracle.decode(blob, desc, desc.channels)
            if c == "jax":
                return q.decode(blob, backend="jax").value().data
            return drive_stream_decode(blob, desc)

        for name, raw, desc in images:
            encs = {c: enc_with(c, raw, desc) for c in qoi_codecs}
            want = encs.get("native", next(iter(encs.values())))
            for ce, blob in encs.items():
                assert np.array_equal(blob, want), (
                    f"{ce} encode bytes differ from native on {name}"
                )
                for cd in qoi_codecs:
                    got = dec_with(cd, blob, desc)
                    assert np.array_equal(got, raw), (
                        f"cross roundtrip {ce}->enc->{cd}->dec mismatch on {name}"
                    )
        print(f"verification: {len(qoi_codecs)}x{len(qoi_codecs)} enc/dec "
              "cross matrix bit-exact on every image")

    header = ["image", "codec", "enc ms", "dec ms", "enc MP/s", "dec MP/s",
              "enc d%", "dec d%", "size KiB", "ratio %"]
    if not args.only_totals:
        print(fmt_row(header))
    totals = {}
    for name, raw, desc in images:
        n_px = desc.width * desc.height
        blob, _ = oracle.encode(raw, desc)
        base_te = base_td = None
        for c in codecs:
            te = td = float("nan")
            size_b = blob.size
            if c == "png":
                import io

                from PIL import Image as PILImage

                mode = "RGBA" if desc.channels == q.Channels.RGBA else "RGB"
                arr2d = raw.reshape(desc.height, desc.width, int(desc.channels))

                def png_enc():
                    bio = io.BytesIO()
                    PILImage.fromarray(arr2d, mode).save(bio, format="PNG")
                    return bio.getvalue()

                png_blob = png_enc()
                size_b = len(png_blob)

                def png_dec():
                    return np.asarray(PILImage.open(io.BytesIO(png_blob)))

                if not args.no_encode:
                    te = timed(png_enc, args.runs, warmup)
                if not args.no_decode:
                    td = timed(png_dec, args.runs, warmup)
            else:
                if not args.no_encode:
                    if c == "native":
                        te = timed(lambda: oracle.encode(raw, desc), args.runs, warmup)
                    elif c == "jax":
                        te = timed(lambda: q.encode(raw, desc, backend="jax"),
                                   args.runs, warmup)
                    else:
                        te = timed(lambda: drive_stream_encode(raw, desc),
                                   args.runs, warmup)
                if not args.no_decode:
                    if c == "native":
                        td = timed(lambda: oracle.decode(blob, desc, desc.channels),
                                   args.runs, warmup)
                    elif c == "jax":
                        td = timed(lambda: q.decode(blob, backend="jax"),
                                   args.runs, warmup)
                    else:
                        td = timed(lambda: drive_stream_decode(blob, desc),
                                   args.runs, warmup)
            if c == "native":
                base_te, base_td = te, td

            def delta(x, base):
                if x != x or not base or base != base:
                    return "-"
                return f"{100*(x-base)/base:+.0f}%"

            row = [name[:12], c, f"{te*1e3:.2f}", f"{td*1e3:.2f}",
                   f"{n_px/te/1e6:.1f}" if te == te else "-",
                   f"{n_px/td/1e6:.1f}" if td == td else "-",
                   delta(te, base_te), delta(td, base_td),
                   f"{size_b/1024:.1f}",
                   f"{100*size_b/raw.size:.1f}"]
            if not args.only_totals:
                print(fmt_row(row))
            acc = totals.setdefault(c, [0.0, 0.0, 0])
            acc[0] += te if te == te else 0
            acc[1] += td if td == td else 0
            acc[2] += n_px

    # batched device pipeline (one program for the whole corpus) ----------
    if not getattr(args, "no_jax_batch") and len({
        (d.width, d.height, d.channels) for _, _, d in images
    }) == 1:
        from qoipp_tpu.models.pipeline import BatchPipeline
        import jax
        import jax.numpy as jnp

        _, _, desc0 = images[0]
        blobs = [oracle.encode(r, d)[0] for _, r, d in images]
        pipe = BatchPipeline(
            desc0,
            max_stream_len=max(b.size for b in blobs),
            max_encode_len=max(b.size for b in blobs) + 1024,
        )
        streams, sizes = pipe.pack_streams(blobs)
        streams = jnp.asarray(streams)
        sizes = jnp.asarray(sizes)
        n_total = sum(d.width * d.height for _, _, d in images)

        td = te = float("nan")
        if not args.no_decode:
            def run_dec():
                jax.block_until_ready(pipe.decode_packed(streams, sizes))

            td = timed(run_dec, args.runs, warmup)
        if not args.no_encode:
            from qoipp_tpu.ops.bitops import pixels_to_packed

            ch = int(desc0.channels)
            packed_in = jnp.stack([
                jnp.pad(pixels_to_packed(jnp.asarray(r), ch),
                        (0, pipe.nb - pipe.n_px))
                for _, r, _ in images
            ])

            def run_enc():
                jax.block_until_ready(pipe.encode_packed_checked(packed_in))

            te = timed(run_enc, args.runs, warmup)
        print(fmt_row([
            "TOTAL", "jax-batch",
            f"{te*1e3:.2f}" if te == te else "-",
            f"{td*1e3:.2f}" if td == td else "-",
            f"{n_total/te/1e6:.1f}" if te == te else "-",
            f"{n_total/td/1e6:.1f}" if td == td else "-",
            "-", "-", "-", "-"]))

    # composite serving codec (mixed geometries: size-tiered packed lanes
    # + bucketed batches behind ONE front-end; 04_bench's multi-codec
    # table analog for the device engines) --------------------------------
    if not getattr(args, "no_serving"):
        import jax

        from qoipp_tpu.models.serving import ServingCodec

        codec = ServingCodec()
        blobs = [oracle.encode(r, d)[0] for _, r, d in images]
        n_total = sum(d.width * d.height for _, _, d in images)
        td = te = float("nan")
        if not args.no_decode:
            if not args.no_verify:
                got = codec.decode(blobs)
                for (_, r, _), g in zip(images, got):
                    if not np.array_equal(g, r):
                        print("serving decode VERIFY FAILED", file=sys.stderr)
                        return 1

            def run_sdec():
                # device-resident completion; the fetch is not timed
                plan = codec.decode_dispatch(blobs)
                jax.block_until_ready(
                    [dev for _, (dev, *_r) in plan[1] + plan[2]])

            td = timed(run_sdec, args.runs, warmup)
        if not args.no_encode:
            raws = [r for _, r, _ in images]
            descs2 = [d for _, _, d in images]
            if not args.no_verify:
                got = codec.encode(raws, descs2)
                for g, b_ in zip(got, blobs):
                    if not np.array_equal(g, b_):
                        print("serving encode VERIFY FAILED", file=sys.stderr)
                        return 1

            def run_senc():
                codec.encode(raws, descs2)

            te = timed(run_senc, args.runs, warmup)
        print(fmt_row([
            "TOTAL", "serving",
            f"{te*1e3:.2f}" if te == te else "-",
            f"{td*1e3:.2f}" if td == td else "-",
            f"{n_total/te/1e6:.1f}" if te == te else "-",
            f"{n_total/td/1e6:.1f}" if td == td else "-",
            "-", "-", "-", "-"]))

    for c, (te, td, npx) in totals.items():
        print(fmt_row([
            "TOTAL", c,
            f"{te*1e3:.2f}", f"{td*1e3:.2f}",
            f"{npx/te/1e6:.1f}" if te else "-",
            f"{npx/td/1e6:.1f}" if td else "-", "-", "-", "-", "-",
        ]))
    return 0


if __name__ == "__main__":
    sys.exit(main())

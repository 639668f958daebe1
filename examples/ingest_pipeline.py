#!/usr/bin/env python
"""End-to-end vision-ingest demo — the dataset-ingest use case:
a directory of QOI files is batch-decoded ON DEVICE into HBM-resident
tensors and fed straight into a (toy) vision model forward pass, with no
host round trip between decode and compute.

    python examples/ingest_pipeline.py [--batch 16] [--size 256]

Pipeline:  native batch file loader (C, one pass)
        -> BatchPipeline.decode (boundary scan + Pallas replay kernel)
        -> normalize to bf16 NHWC in HBM
        -> conv-ish forward (matmuls)
"""

import argparse
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import qoipp_tpu as q
from qoipp_tpu import oracle
from qoipp_tpu.utils.timing import device_time_ms, mpix_per_s


def make_dataset(root: Path, n: int, side: int) -> None:
    rng = np.random.default_rng(0)
    desc = q.Desc(side, side, q.Channels.RGB)
    for i in range(n):
        base = rng.integers(0, 256, (12, 3)).astype(np.uint8)
        ids = np.maximum.accumulate(
            np.where(rng.random(side * side) < 0.04,
                     rng.integers(0, 12, side * side), 0)
        ) % 12
        raw = base[ids].reshape(-1)
        blob, _ = oracle.encode(raw, desc)
        (root / f"img_{i:03d}.qoi").write_bytes(blob.tobytes())


def toy_model_apply(params, images_bf16):
    """A stand-in vision trunk: patchify + two matmuls + pooling."""
    import jax.numpy as jnp

    b, h, w, c = images_bf16.shape
    p = 8
    patches = images_bf16.reshape(b, h // p, p, w // p, p, c)
    patches = patches.transpose(0, 1, 3, 2, 4, 5).reshape(
        b, (h // p) * (w // p), p * p * c
    )
    x = jnp.dot(patches, params["w1"], preferred_element_type=jnp.float32)
    x = jnp.maximum(x, 0).astype(jnp.bfloat16)
    x = jnp.dot(x, params["w2"], preferred_element_type=jnp.float32)
    return x.mean(axis=1)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--dataset", type=Path, default=None,
                    help="directory of same-geometry .qoi files")
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp

    if args.dataset is None:
        tmp = tempfile.mkdtemp()
        args.dataset = Path(tmp)
        make_dataset(args.dataset, args.batch, args.size)
        print(f"generated {args.batch} x {args.size}^2 QOI files in {tmp}")

    paths = sorted(args.dataset.glob("*.qoi"))[: args.batch]
    hdr = q.read_header(paths[0]).value()
    pipe = q.BatchPipeline(hdr)

    t0 = time.perf_counter()
    streams_np, sizes_np = pipe.load_files(paths)  # native C loader
    t_load = (time.perf_counter() - t0) * 1e3
    streams = jax.device_put(jnp.asarray(streams_np))
    sizes = jax.device_put(jnp.asarray(sizes_np))

    rng = np.random.default_rng(0)
    pdim = 8 * 8 * 3
    params = {
        "w1": jnp.asarray(rng.normal(0, 0.02, (pdim, 256)), jnp.bfloat16),
        "w2": jnp.asarray(rng.normal(0, 0.02, (256, 128)), jnp.bfloat16),
    }

    @jax.jit
    def ingest_step(streams, sizes, params):
        images = pipe.decode(streams, sizes)          # (B,H,W,3) u8 in HBM
        x = images.astype(jnp.bfloat16) / 127.5 - 1.0
        return toy_model_apply(params, x)

    ms = device_time_ms(ingest_step, streams, sizes, params, runs=10)
    n_px = len(paths) * hdr.width * hdr.height
    out = ingest_step(streams, sizes, params)
    print(f"load (native):    {t_load:.1f} ms for {len(paths)} files")
    print(f"decode+forward:   {ms:.2f} ms = {mpix_per_s(n_px, ms):.0f} MPix/s "
          f"end-to-end on {jax.devices()[0].platform}")
    print(f"features:         {out.shape} {out.dtype} (device-resident)")
    return 0


if __name__ == "__main__":
    sys.exit(main())

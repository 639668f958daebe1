#!/usr/bin/env python
"""Composite serving decode: route streams by size to the right engine.

Production corpora mix tiny icons with multi-MB photos.  One engine
cannot serve both well on one accelerator shape:

  * stream packing (models/packed.py) — total work tracks sum(sizes),
    ideal for the many-small-streams tail, but replay depth = lane
    bytes, so lanes must stay short;
  * length-bucketed batching (models/scheduler.py) — uniform-geometry
    batches of mid/large streams at tight per-bucket caps.

This example routes a mixed corpus through both BY HAND to show the
mechanics; the PRODUCTION form is the package component
`qoipp_tpu.models.serving.ServingCodec` (size-tiered packed plans +
bucketed fallback behind one front-end — use that in real deployments).
Every stream verifies against the native oracle.  Run anywhere (on the
CPU the replay runs as its plain lax.scan reference):

    python examples/serving_codec.py
"""

import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import qoipp_tpu as q
from qoipp_tpu import oracle
from qoipp_tpu.models.packed import PackedDecoder
from qoipp_tpu.models.scheduler import BucketedCodec

PACK_CAP = 1 << 12  # streams below this pack into shared lanes


def make_corpus(n=24, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n):
        if k % 3 == 0:  # tiny icons
            desc = q.Desc(16 + k % 7, 12, q.Channels.RGBA)
        elif k % 3 == 1:  # medium tiles
            desc = q.Desc(96, 64, q.Channels.RGB)
        else:  # large-ish photos (shared geometry for the bucketed path)
            desc = q.Desc(128, 96, q.Channels.RGB)
        npx = desc.width * desc.height
        ch = int(desc.channels)
        pal = rng.integers(0, 256, (9, ch)).astype(np.uint8)
        raw = pal[rng.integers(0, 9, npx)].reshape(-1)
        enc, _ = oracle.encode(raw, desc)
        out.append((raw, desc, enc))
    return out


def main():
    corpus = make_corpus()
    blobs = [e for _, _, e in corpus]
    descs = [d for _, d, _ in corpus]

    small = [i for i, b in enumerate(blobs) if b.size - 22 <= PACK_CAP]
    large = [i for i in range(len(blobs)) if i not in small]
    print(f"routing: {len(small)} packed, {len(large)} bucketed")

    results = [None] * len(blobs)

    if small:
        packer = PackedDecoder(lane_bytes=PACK_CAP)
        for i, raw in zip(small, packer.decode([blobs[i] for i in small])):
            results[i] = raw

    # bucketed path needs uniform geometry per codec: group by desc
    by_desc = {}
    for i in large:
        by_desc.setdefault(
            (descs[i].width, descs[i].height, int(descs[i].channels)), []
        ).append(i)
    for (_, _, ch), idxs in by_desc.items():
        codec = BucketedCodec(descs[idxs[0]], min_len=1 << 12)
        imgs = codec.decode([blobs[i] for i in idxs])
        for j, i in enumerate(idxs):
            results[i] = imgs[j].reshape(-1)

    ok = all(
        np.array_equal(results[i], corpus[i][0]) for i in range(len(blobs))
    )
    print("parity vs oracle:", "100%" if ok else "FAILED")

    # The production front-end + the resident-corpus cache mode: stage
    # the whole corpus into HBM once, then serve decode requests from
    # device memory (steady-state cost = device dispatch alone).
    serving = q.ServingCodec(pack_lane_bytes=PACK_CAP, min_len=1 << 12)
    resident = serving.make_resident(blobs)
    again = resident.decode()  # request 1
    again2 = resident.decode()  # request 2 — no re-upload
    ok2 = all(
        np.array_equal(a, corpus[i][0]) and np.array_equal(b, corpus[i][0])
        for i, (a, b) in enumerate(zip(again, again2))
    )
    print("resident-corpus parity (2 requests):", "100%" if ok2 else "FAILED")
    return 0 if (ok and ok2) else 1


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python
"""One-shot auto-backend routing measurement.

api._resolve_backend can route one-shot images at or above a threshold to
the GPU.  This measures what a user actually pays for ONE image through
the public api — wall clock including host<->device transfers — cold
(first call, compile included) and warm, per direction, across sizes,
against the native oracle, so the threshold can follow the crossover
(ROADMAP A7).
"""

import sys
import time

import numpy as np

sys.path.insert(0, str(__import__("pathlib").Path(__file__).resolve()
                       .parent.parent))


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main():
    import jax

    from qoipp_tpu.utils.timing import enable_compile_cache

    enable_compile_cache()

    from bench import make_corpus
    from qoipp_tpu import Channels, Desc, api, oracle

    log(f"device: {jax.devices()[0]}")

    for (w, h) in ((512, 512), (1920, 1080), (3840, 2160)):
        desc, raws, blobs = make_corpus(1, w, h, seed=11)
        raw, blob = raws[0], blobs[0]
        n_px = w * h

        rows = {}
        for be in ("native", "jax"):
            # decode: cold then warm (same stream)
            t0 = time.perf_counter()
            r = api.decode(blob, backend=be)
            t_cold_d = time.perf_counter() - t0
            assert r
            ts = []
            for _ in range(3):
                t0 = time.perf_counter()
                r = api.decode(blob, backend=be)
                ts.append(time.perf_counter() - t0)
            t_d = min(ts)

            t0 = time.perf_counter()
            e = api.encode(raw, desc, backend=be)
            t_cold_e = time.perf_counter() - t0
            assert e and np.array_equal(e.value(), blob)
            ts = []
            for _ in range(3):
                t0 = time.perf_counter()
                e = api.encode(raw, desc, backend=be)
                ts.append(time.perf_counter() - t0)
            t_e = min(ts)
            rows[be] = (t_d, t_e, t_cold_d, t_cold_e)
            log(f"[{w}x{h} {be:6s}] decode {t_d*1e3:8.1f} ms warm "
                f"({n_px/t_d/1e6:7.1f} MPix/s), cold {t_cold_d*1e3:8.1f} ms | "
                f"encode {t_e*1e3:8.1f} ms warm ({n_px/t_e/1e6:7.1f} MPix/s), "
                f"cold {t_cold_e*1e3:8.1f} ms")
        nd, ne = rows["native"][0], rows["native"][1]
        jd, je = rows["jax"][0], rows["jax"][1]
        log(f"[{w}x{h}] native/jax speedup: decode {jd/nd:.1f}x  "
            f"encode {je/ne:.1f}x  (>1 means native faster)")


if __name__ == "__main__":
    main()

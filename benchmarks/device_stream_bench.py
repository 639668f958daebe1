#!/usr/bin/env python
"""Device windowed streaming codec bench: streaming chunked encode/decode
over multi-MB images with bounded state.  Times qoipp_tpu.ops.device_stream.{DeviceStreamDecoder,DeviceStreamEncoder}
on a multi-MB single image across a window-size sweep, parity-checked
against the native oracle.  Reference analog: the stream codec is a timed
first-class competitor ("qoipp2") in example/source/04_bench.cpp:196-201.

Two numbers per config:
  * end-to-end MPix/s through the public API (host->device->host per
    window);
  * device-compute MPix/s (window kernels timed with device_time_ms, no
    per-window host transfer).
"""

import sys
import time

import numpy as np

sys.path.insert(0, str(__import__("pathlib").Path(__file__).resolve()
                       .parent.parent))


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def make_image(w, h, seed=3):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    grad = ((x * 255 // max(w - 1, 1)) // 3 + (y * 150 // max(h - 1, 1)) // 3)
    base = np.stack([grad, grad + 40, 255 - grad], axis=-1).astype(np.uint8)
    for _ in range(240):
        py, px = rng.integers(0, h), rng.integers(0, w)
        ph, pw = rng.integers(8, h // 6), rng.integers(8, w // 6)
        base[py : py + ph, px : px + pw] = rng.integers(0, 256, 3)
    py, px = rng.integers(0, h // 2), rng.integers(0, w // 2)
    base[py : py + h // 8, px : px + w // 8] = rng.integers(
        0, 256, (min(h // 8, h - py), min(w // 8, w - px), 3)
    )
    return base.reshape(-1)


def main():
    import jax
    import jax.numpy as jnp

    from qoipp_tpu.utils.timing import enable_compile_cache

    enable_compile_cache()

    from qoipp_tpu import Channels, Desc, oracle
    from qoipp_tpu.ops import device_stream as ds
    from qoipp_tpu.ops import replay_kernel as rk
    from qoipp_tpu.utils.timing import device_time_ms

    dev = jax.devices()[0]
    log(f"device: {dev.platform} {dev}")

    W, H = 4096, 4096  # 16.8 MPix RGB; stream is multi-MB
    desc = Desc(W, H, Channels.RGB)
    raw = make_image(W, H)
    t0 = time.perf_counter()
    enc, complete = oracle.encode(raw, desc)
    assert complete
    t_oe = time.perf_counter() - t0
    n_px = W * H
    log(f"image: {W}x{H} RGB = {n_px/1e6:.1f} MPix, stream {enc.size/1e6:.1f} MB"
        f"  (oracle encode {n_px/t_oe/1e6:.0f} MPix/s)")
    t0 = time.perf_counter()
    want = oracle.decode(enc, desc, desc.channels)
    t_od = time.perf_counter() - t0
    log(f"oracle decode: {n_px/t_od/1e6:.0f} MPix/s")

    body = enc[14:-8]

    # ---------------- decode: end-to-end API sweep ---------------------------
    # run-heavy windows can emit ~10 px/B; place kernel needs % 8192
    pcap = -(-n_px // 8192) * 8192
    for win_mb in (1, 2, 4):
        win = win_mb << 20
        dec = ds.DeviceStreamDecoder(window_cap=win, pixel_cap=pcap)
        assert dec.initialize(enc[:14]).value() is not None
        # warm compile
        r = dec.decode_window(body[: min(win, body.size)])
        assert r
        dec.reset()
        assert dec.initialize(enc[:14])
        t0 = time.perf_counter()
        parts = []
        for s in range(0, body.size, win):
            r = dec.decode_window(body[s : s + win])
            assert r, r.error()
            parts.append(r.value())
        t = time.perf_counter() - t0
        got = np.concatenate(parts)
        ok = np.array_equal(got, want)
        log(f"[decode win={win_mb}MB] end-to-end {n_px/t/1e6:.1f} MPix/s "
            f"({t*1e3:.0f} ms, {body.size//win + 1} windows) parity "
            f"{'100%' if ok else 'FAIL'}")
        dec.reset()

    # ---------------- decode: device-compute (window kernels only) ----------
    # stage one window's split plan (host walker + upload), then time the
    # split-lane window decode alone — the co-located projection
    from qoipp_tpu.models.split import _compact_cap, _decode_window_lanes

    for win_mb in (1, 2, 4):
        win = win_mb << 20
        dec = ds.DeviceStreamDecoder(window_cap=win, pixel_cap=pcap)
        dec.initialize(enc[:14])
        wbytes = bytes(body[: min(win, body.size)].tobytes()
                       if isinstance(body, np.ndarray)
                       else body[: min(win, body.size)])
        # replicate _decode_one_window's staging
        warr = np.frombuffer(wbytes, np.uint8)
        k = min(dec.split_lanes, max(len(wbytes) // 512, 1))
        byte_w, px_w = 46.0 + 2.45 * k, 0.27 * k
        offs, poffs, cis = oracle.split_points(
            warr, 1 << 60, k, byte_w, px_w,
            lookahead=max(len(wbytes) // k // 4, 64))
        nseg = len(offs) - 1
        from qoipp_tpu.ops.decode import _bucket
        from qoipp_tpu.ops import boundary as bd, sparse
        l = -(-nseg // 8) * 8
        qseg = _bucket(int(np.diff(offs).max()), 8 * bd.BLOCK)
        n_cap = _bucket(-(-max(int(np.diff(poffs).max()), 1) // sparse.WIN)
                        * sparse.WIN, sparse.WIN)
        qc = _compact_cap(int(np.diff(cis).max()), qseg)
        regions = np.zeros((l, qseg + 8), np.uint8)
        seg_lens = np.zeros(l, np.int32)
        for s in range(nseg):
            b0, b1 = int(offs[s]), int(offs[s + 1])
            regions[s, : b1 - b0] = warr[b0:b1]
            seg_lens[s] = b1 - b0
        r_d = jax.device_put(jnp.asarray(regions), dev)
        s_d = jax.device_put(jnp.asarray(seg_lens), dev)
        prev0 = jnp.full((1,), 0xFF000000, jnp.uint32)
        seen0 = jnp.zeros(64, jnp.uint32)

        def run(r_d, s_d, prev0, seen0):
            return _decode_window_lanes(r_d, s_d, prev0, seen0,
                                        jnp.int32(l), qb=qseg, n_cap=n_cap,
                                        qc=qc)

        out = jax.block_until_ready(run(r_d, s_d, prev0, seen0))
        n_pix_w = int(np.asarray(out[1]).sum())
        rounds = int(out[5])
        # RTT subtraction can go non-positive under concurrent host load —
        # clamp (and treat such runs as suspect; re-run on a quiet host)
        t = max(device_time_ms(run, r_d, s_d, prev0, seen0, runs=6), 1e-3)
        log(f"[decode win={win_mb}MB] device-compute {n_pix_w/t/1e3:.1f} "
            f"MPix/s ({t:.1f} ms/window, {n_pix_w/1e6:.2f} MPix/window, "
            f"{nseg} lanes, {rounds} rounds)")

    # ---------------- encode: end-to-end API sweep ---------------------------
    for wpx_log in (18, 20, 21):
        wpx = 1 << wpx_log
        ence = ds.DeviceStreamEncoder(window_px=wpx)
        hdr = ence.initialize(desc)
        assert hdr
        r = ence.encode_window(raw[: wpx * 3])  # warm
        assert r
        ence.reset()
        assert ence.initialize(desc)
        t0 = time.perf_counter()
        parts = [hdr.value()]
        for s in range(0, n_px, wpx):
            r = ence.encode_window(raw[s * 3 : (s + wpx) * 3])
            assert r, r.error()
            parts.append(r.value().tobytes())
        parts.append(ence.finalize().value())
        t = time.perf_counter() - t0
        got = np.frombuffer(b"".join(parts), np.uint8)
        ok = got.size == enc.size and np.array_equal(got, enc)
        log(f"[encode win=2^{wpx_log}px] end-to-end {n_px/t/1e6:.1f} MPix/s "
            f"({t*1e3:.0f} ms) parity {'100%' if ok else 'FAIL'}")
        ence.reset()

    # ---------------- encode: device-compute (window kernel only) -----------
    from qoipp_tpu.ops.bitops import START_PIXEL_PACKED
    from qoipp_tpu.ops import encode as enc_ops

    for wpx_log in (18, 20, 21):
        wpx = 1 << wpx_log
        nb = enc_ops.pad_to_tile(wpx)
        buf = np.zeros(nb * 3, np.uint8)
        buf[: wpx * 3] = raw[: wpx * 3]
        raw_d = jax.device_put(jnp.asarray(buf), dev)
        prev = jnp.uint32(START_PIXEL_PACKED)
        run_c = jnp.uint32(0)
        seen = jnp.zeros(64, jnp.uint32)

        def erun(raw_d, prev, run_c, seen):
            return ds._encode_window(raw_d, jnp.int32(wpx), prev, run_c,
                                     seen, channels=3, nb=nb)

        _ = jax.block_until_ready(erun(raw_d, prev, run_c, seen))
        t = device_time_ms(erun, raw_d, prev, run_c, seen, runs=6)
        log(f"[encode win=2^{wpx_log}px] device-compute {wpx/t/1e3:.1f} "
            f"MPix/s ({t:.1f} ms/window)")

    # ---------------- encode: multi-lane window path ------------------------
    # Steady-state measurement: K windows chained in ONE jitted lax.scan
    # threading the carry, so the per-window dispatch cost amortizes like
    # a real streaming session.
    for wpx_log, lanes in ((18, 8), (18, 16), (20, 16), (20, 32)):
        wpx = 1 << wpx_log
        nbl = -(-wpx // (lanes * enc_ops.TILE)) * (lanes * enc_ops.TILE)
        K = max(n_px // wpx, 1)
        K = min(K, 64)
        wins = np.zeros((K, nbl * 3), np.uint8)
        for k in range(K):
            wins[k, : wpx * 3] = raw[k * wpx * 3 : (k + 1) * wpx * 3]
        wins_d = jax.device_put(jnp.asarray(wins), dev)
        prev = jnp.uint32(START_PIXEL_PACKED)
        run_c = jnp.uint32(0)
        seen = jnp.zeros(64, jnp.uint32)

        @jax.jit
        def echain(wins_d, prev, run_c, seen):
            def step(carry, w):
                p, r, s = carry
                out, lens, p2, r2, s2 = ds._encode_window_lanes(
                    w, jnp.int32(wpx), p, r, s, channels=3, nb=nbl,
                    lanes=lanes,
                )
                # checksum keeps the outputs live without K full buffers
                return (p2, r2, s2), (jnp.sum(lens),
                                      jnp.sum(out.astype(jnp.uint32)))
            carry, (lsum, osum) = jax.lax.scan(
                step, (prev, run_c, seen), wins_d
            )
            return carry, lsum, osum

        _ = jax.block_until_ready(echain(wins_d, prev, run_c, seen))
        t = device_time_ms(echain, wins_d, prev, run_c, seen, runs=4)
        log(f"[encode-lanes win=2^{wpx_log}px L={lanes}] device-compute "
            f"{K*wpx/t/1e3:.1f} MPix/s ({t:.1f} ms / {K} windows)")

        # single-window parity on the device at this exact geometry (a
        # vmapped table scan can miscompile on a device and pass on CPU)
        ence = ds.DeviceStreamEncoder(window_px=wpx, split_lanes=lanes)
        hdr = ence.initialize(desc)
        parts = [hdr.value()]
        for s in range(0, n_px, wpx):
            parts.append(ence.encode_window(
                raw[s * 3 : (s + wpx) * 3]).value().tobytes())
        parts.append(ence.finalize().value())
        got = np.frombuffer(b"".join(parts), np.uint8)
        ok = got.size == enc.size and np.array_equal(got, enc)
        log(f"[encode-lanes win=2^{wpx_log}px L={lanes}] full-image parity "
            f"{'100%' if ok else 'FAIL'}")
        ence.reset()


if __name__ == "__main__":
    main()

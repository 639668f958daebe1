#!/usr/bin/env python
"""Two-process jax.distributed simulation of the multi-host (DCN) path.

Spawns 2 local processes (4 virtual CPU devices each) that form one
8-device global mesh via jax.distributed, lay it out with
parallel.mesh.make_hybrid_mesh (host axis = process boundary), and run
the dp-sharded batched decode with a psum checksum across BOTH processes.
This exercises exactly what a 2-host deployment would: process-spanning collectives over the outer axis while the
codec body stays embarrassingly parallel.

Usage: python benchmarks/multiprocess_sim.py          # launcher
       (spawns itself twice with --proc N)
"""

import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PORT = 56789


def worker(proc_id: int, port: int = PORT) -> int:
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=4"
    ).strip()
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(
        coordinator_address=f"127.0.0.1:{port}",
        num_processes=2,
        process_id=proc_id,
    )
    assert jax.process_count() == 2
    assert len(jax.devices()) == 8, jax.devices()

    import numpy as np
    import jax.numpy as jnp

    sys.path.insert(0, str(ROOT))
    from qoipp_tpu import Channels, Desc, oracle
    from qoipp_tpu.models.pipeline import BatchPipeline
    from qoipp_tpu.parallel import mesh as mesh_mod
    from qoipp_tpu.parallel import sharded

    m = mesh_mod.make_hybrid_mesh()  # (2 hosts, data, seq)
    assert m.shape["host"] == 2

    desc = Desc(32, 16, Channels.RGB)
    pipe = BatchPipeline(desc)
    rng = np.random.default_rng(0)
    n = desc.width * desc.height
    raws, blobs = [], []
    for _ in range(16):
        palette = rng.integers(0, 256, (8, 3)).astype(np.uint8)
        raw = palette[rng.integers(0, 8, n)].reshape(-1)
        enc, _ = oracle.encode(raw, desc)
        raws.append(raw)
        blobs.append(enc)
    streams, sizes = pipe.pack_streams(blobs)

    dp = sharded.make_dp_decode(pipe, m, axis=("host", "data"))
    # jax.distributed single-controller: every process feeds the same
    # global arrays; jit shards them over the global mesh
    packed, checksum = dp(jnp.asarray(streams), jnp.asarray(sizes))
    checksum = int(checksum)

    # verify on process 0 (fetch of the global array gathers across
    # processes)
    from jax.experimental import multihost_utils

    from qoipp_tpu.ops.bitops import packed_to_pixels

    ok = True
    local = np.asarray(
        multihost_utils.process_allgather(packed, tiled=True)
    )
    for i in range(16):
        got = np.asarray(
            packed_to_pixels(jnp.asarray(local[i, : pipe.n_px]), 3)
        )
        if not np.array_equal(got, raws[i]):
            ok = False

    # SP decode with the seq axis spanning BOTH processes: the device-3 ->
    # device-4 seam ppermute crosses the process boundary — the genuinely
    # cross-process collective path of the sequence-parallel engine.
    from qoipp_tpu.ops import boundary
    from qoipp_tpu.ops import decode as dec_ops

    m_sp = mesh_mod.make_mesh((1, 8))
    desc_sp = Desc(256, 16, Channels.RGB)
    rng_sp = np.random.default_rng(5)
    palette = rng_sp.integers(0, 256, (16, 3)).astype(np.uint8)
    raw_sp = palette[rng_sp.integers(0, 16, 256 * 16)].reshape(-1)
    enc_sp, _ = oracle.encode(raw_sp, desc_sp)
    n_px = desc_sp.width * desc_sp.height
    qb = dec_ops._bucket(enc_sp.size - 14, boundary.BLOCK)
    while qb % (8 * 4) != 0:
        qb += boundary.BLOCK
    region = np.zeros(qb + 8, np.uint8)
    region[: enc_sp.size - 14] = enc_sp[14:]
    region_j = jnp.asarray(region)
    info = boundary.analyze_region(
        region_j[:qb], jnp.int32(enc_sp.size - 22), jnp.int32(n_px)
    )
    cls, val, nmask, arg = jax.jit(
        dec_ops.classify_dense, static_argnames=("qb",)
    )(region_j, qb, info["real"])
    sp = sharded.make_sp_decode(m_sp, qb, tiles_per_device=4)
    emits, prevs = sp(cls, val, nmask, arg)
    n_cap = dec_ops._bucket(n_px, 128)
    packed_sp = dec_ops.expand_pixels(
        np.asarray(multihost_utils.process_allgather(emits, tiled=True)),
        np.asarray(multihost_utils.process_allgather(prevs, tiled=True)),
        info["real"], info["produced"], info["pix_before"], n_cap,
    )
    got_sp = np.asarray(packed_to_pixels(packed_sp[:n_px], 3))
    sp_ok = bool(np.array_equal(got_sp, raw_sp))
    ok = ok and sp_ok

    print(f"[proc {proc_id}] devices={len(jax.devices())} "
          f"local={jax.local_device_count()} checksum={checksum} "
          f"sp={'100%' if sp_ok else 'FAILED'} "
          f"parity={'100%' if ok else 'FAILED'}", flush=True)
    jax.distributed.shutdown()
    return 0 if ok else 1


def main() -> int:
    if "--proc" in sys.argv:
        port = (int(sys.argv[sys.argv.index("--port") + 1])
                if "--port" in sys.argv else PORT)
        return worker(int(sys.argv[sys.argv.index("--proc") + 1]), port)
    # pick a free coordinator port (a fixed one collides with a stale or
    # concurrent run; the race between close and bind is acceptable here)
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [
        subprocess.Popen(
            [sys.executable, __file__, "--proc", str(i),
             "--port", str(port)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        )
        for i in range(2)
    ]
    rc = 0
    for i, p in enumerate(procs):
        out, _ = p.communicate(timeout=600)
        tail = [ln for ln in out.decode().splitlines()
                if "proc" in ln or "Error" in ln or "FAILED" in ln]
        print("\n".join(tail[-4:]))
        rc |= p.returncode
    print("multiprocess sim:", "OK" if rc == 0 else "FAILED")
    return rc


if __name__ == "__main__":
    sys.exit(main())

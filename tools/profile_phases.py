#!/usr/bin/env python3
"""Per-phase timing of the device decode path (unpacked upload)."""

import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tools"))


def main():
    import jax
    import jax.numpy as jnp
    import numpy as np
    from bench_common import bench_stream
    import broadway_tpu.core.decoder as DEC
    from broadway_tpu.core import recon_tpu as RT
    from broadway_tpu.utils.cache import ensure_compile_cache
    ensure_compile_cache()

    n_frames = 8
    w_mbs, h_mbs = 120, 68
    data = bench_stream(w_mbs, h_mbs, n_frames=n_frames)

    # ---- phase 1: parse only (native frontend, 8 threads) ----
    # the decoder's recon_strategy hook skips pixel reconstruction
    # while DPB/POC bookkeeping proceeds normally (SKIP_RECON)
    pics = []

    def collect(dec, pic):
        pics.append((pic, dec.pps))
        return DEC.SKIP_RECON

    d = DEC.Decoder(backend="device", parallel_slices=8,
                    recon_strategy=collect)
    t0 = time.perf_counter()
    d.decode_annexb(data)
    t_parse = time.perf_counter() - t0
    print(f"parse (native, 8 threads): {t_parse / len(pics) * 1e3:.1f} "
          f"ms/frame ({len(pics)} pics)", flush=True)

    pic, pps = pics[-1]

    # ---- phase 2: host_picture_arrays ----
    for _ in range(2):
        t0 = time.perf_counter()
        arrs = RT.host_picture_arrays(pic, pps.chroma_qp_index_offset,
                                      pps.constrained_intra_pred)
        t_host = time.perf_counter() - t0
    nbytes = sum(np.asarray(v).nbytes for v in arrs.values())
    print(f"host_picture_arrays: {t_host * 1e3:.1f} ms, "
          f"{len(arrs)} arrays, {nbytes / 1e6:.1f} MB", flush=True)

    # ---- phase 3: upload 28 arrays ----
    for _ in range(3):
        t0 = time.perf_counter()
        dev = {k: jnp.asarray(v) for k, v in arrs.items()}
        jax.block_until_ready(list(dev.values()))
        t_up = time.perf_counter() - t0
    print(f"upload {len(arrs)} arrays: {t_up * 1e3:.1f} ms", flush=True)

    # one big buffer for comparison
    big = np.concatenate([np.asarray(v).reshape(-1).view(np.uint8)
                          for v in arrs.values() if np.asarray(v).ndim])
    for _ in range(3):
        t0 = time.perf_counter()
        bd = jnp.asarray(big)
        jax.block_until_ready(bd)
        t_big = time.perf_counter() - t0
    print(f"upload 1 buffer ({big.nbytes / 1e6:.1f} MB): "
          f"{t_big * 1e3:.1f} ms", flush=True)
    # narrow-dtype single buffer estimate (u8/i16 where possible)
    t0 = time.perf_counter()
    bd = jnp.asarray(big[:big.nbytes // 3])
    jax.block_until_ready(bd)
    print(f"upload 1 buffer ({big.nbytes // 3 / 1e6:.1f} MB): "
          f"{(time.perf_counter() - t0) * 1e3:.1f} ms", flush=True)

    # ---- phase 4: ref_stacks ----
    W, H = w_mbs * 16, h_mbs * 16
    n_slots = 3
    frames = []
    for i in range(n_slots):
        y = jnp.zeros((H, W), jnp.int32)
        c = jnp.zeros((H // 2, W // 2), jnp.int32)
        frames.append(RT.DeviceFrame(y, c, c))

    class P:
        pass

    buf = []
    for f in frames:
        p = P()
        p.frame = f
        buf.append(p)
    jax.block_until_ready([f.y_pad for f in frames])
    for _ in range(3):
        t0 = time.perf_counter()
        ry, rc = RT.ref_stacks(buf, W, H)
        jax.block_until_ready((ry, rc))
        t_stack = time.perf_counter() - t0
    print(f"ref_stacks ({n_slots} slots): {t_stack * 1e3:.1f} ms, "
          f"{(ry.nbytes + rc.nbytes) / 1e6:.1f} MB", flush=True)

    # ---- phase 5: compute (steady state, inputs on device) ----
    steps = {k: jnp.asarray(v) for k, v in RT.step_tables(w_mbs,
                                                          h_mbs).items()}
    out = RT.decode_picture(dev, ry, rc, steps, w_mbs=w_mbs, h_mbs=h_mbs,
                            chroma_qp_offset=pps.chroma_qp_index_offset)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(8):
        out = RT.decode_picture(dev, ry, rc, steps, w_mbs=w_mbs,
                                h_mbs=h_mbs,
                                chroma_qp_offset=pps.chroma_qp_index_offset)
    jax.block_until_ready(out)
    t_comp = (time.perf_counter() - t0) / 8
    print(f"compute: {t_comp * 1e3:.1f} ms/frame", flush=True)

    # ---- phase 6: DeviceFrame ctor (pad) + readback ----
    t0 = time.perf_counter()
    fr = RT.DeviceFrame(out[0], out[1], out[2])
    jax.block_until_ready((fr.y_pad, fr.c_pad))
    print(f"pad ref planes: {(time.perf_counter() - t0) * 1e3:.1f} ms",
          flush=True)
    for _ in range(3):
        t0 = time.perf_counter()
        b = fr.tobytes()
        t_rb = time.perf_counter() - t0
    print(f"readback tobytes ({len(b) / 1e6:.1f} MB): "
          f"{t_rb * 1e3:.1f} ms", flush=True)


if __name__ == "__main__":
    main()

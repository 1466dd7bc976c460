#!/usr/bin/env python3
"""Profile the end-to-end device decode path: parse / upload / compute /
readback breakdown per frame. Round-2 diagnostic tool."""

import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tools"))


def main():
    import jax
    from bench_common import bench_stream
    from broadway_tpu.core.decoder import Decoder

    n_frames = int(os.environ.get("PROF_FRAMES", "8"))
    w_mbs = int(os.environ.get("PROF_W", "120"))
    h_mbs = int(os.environ.get("PROF_H", "68"))
    data = bench_stream(w_mbs, h_mbs, n_frames=n_frames)
    print(f"stream: {len(data)} bytes, {n_frames} frames, "
          f"{w_mbs}x{h_mbs} MBs", flush=True)

    # warm (compile)
    t0 = time.perf_counter()
    d = Decoder(backend="device", parallel_slices=8)
    outs = d.decode_annexb(data)
    for o in outs:
        o.frame.tobytes()
    print(f"cold: {time.perf_counter() - t0:.2f}s "
          f"({len(outs)} pics)", flush=True)

    # warm run, end-to-end
    t0 = time.perf_counter()
    d = Decoder(backend="device", parallel_slices=8)
    outs = d.decode_annexb(data)
    nb = 0
    for o in outs:
        nb += len(o.frame.tobytes())
    dt = time.perf_counter() - t0
    print(f"warm e2e: {dt:.3f}s = {len(outs) / dt:.2f} fps "
          f"({dt / len(outs) * 1e3:.1f} ms/frame), {nb} bytes out",
          flush=True)


if __name__ == "__main__":
    main()

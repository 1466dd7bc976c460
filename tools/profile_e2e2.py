#!/usr/bin/env python3
"""Round-4 e2e profiler: phase breakdown on the REALISTIC bench stream.

Instruments the decoder's per-picture device path via monkeypatched
timers: front-end parse, v2 pack, device_put, jit dispatch, and the
final device drain. Separates host-serial cost (what bounds e2e fps
when compute overlaps) from device compute.
"""

import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tools"))

from broadway_tpu.utils.cache import ensure_compile_cache  # noqa: E402
ensure_compile_cache()


def main():
    import jax
    from bench_common import realistic_bench_stream
    from broadway_tpu.core.decoder import Decoder
    from broadway_tpu.core import recon_tpu as RT
    from broadway_tpu.core import packed as PK

    n_frames = int(os.environ.get("PROF_FRAMES", "16"))
    data = realistic_bench_stream(120, 68, n_frames=n_frames)
    print(f"stream: {len(data)} bytes, {n_frames} frames", flush=True)

    # warm / compile
    d = Decoder(backend="device", parallel_slices=8)
    outs = d.decode_annexb(data)
    for o in outs:
        jax.block_until_ready(o.frame.y)

    # instrument
    stats = {"pack": 0.0, "put": 0.0, "jit": 0.0, "put_bytes": 0}
    orig_pack = PK.pack_picture_v2
    orig_put = jax.device_put
    orig_jit = RT.decode_picture_packed2

    def tpack(*a, **k):
        t = time.perf_counter()
        r = orig_pack(*a, **k)
        stats["pack"] += time.perf_counter() - t
        if r is not None:
            stats["put_bytes"] += len(r[0])
        return r

    def tput(x, *a, **k):
        t = time.perf_counter()
        r = orig_put(x, *a, **k)
        stats["put"] += time.perf_counter() - t
        return r

    def tjit(*a, **k):
        t = time.perf_counter()
        r = orig_jit(*a, **k)
        stats["jit"] += time.perf_counter() - t
        return r

    PK.pack_picture_v2 = tpack
    jax.device_put = tput
    RT.decode_picture_packed2 = tjit

    t0 = time.perf_counter()
    d = Decoder(backend="device", parallel_slices=8)
    outs = d.decode_annexb(data)
    t_host = time.perf_counter() - t0          # host-side loop done
    for o in outs:
        jax.block_until_ready(o.frame.y)
    t_all = time.perf_counter() - t0

    PK.pack_picture_v2 = orig_pack
    jax.device_put = orig_put
    RT.decode_picture_packed2 = orig_jit

    n = len(outs)
    print(f"e2e: {t_all:.3f}s = {n / t_all:.2f} fps "
          f"({t_all / n * 1e3:.1f} ms/frame)")
    print(f"host loop (parse+pack+put+dispatch): {t_host:.3f}s "
          f"({t_host / n * 1e3:.1f} ms/frame)")
    print(f"device drain after loop: {t_all - t_host:.3f}s")
    for k in ("pack", "put", "jit"):
        print(f"  {k}: {stats[k]:.3f}s ({stats[k] / n * 1e3:.2f} ms/frame)")
    print(f"  upload bytes: {stats['put_bytes']} "
          f"({stats['put_bytes'] / n / 1024:.0f} KiB/frame)")
    rest = t_host - stats["pack"] - stats["put"] - stats["jit"]
    print(f"  parse+python rest: {rest:.3f}s ({rest / n * 1e3:.2f} ms/frame)")

    # device-compute-only: block after every frame
    t0 = time.perf_counter()
    d = Decoder(backend="device", parallel_slices=8)
    outs = d.decode_annexb(data)
    for o in outs:
        jax.block_until_ready(o.frame.y)
    print(f"(repeat e2e: {n / (time.perf_counter() - t0):.2f} fps)")


if __name__ == "__main__":
    main()

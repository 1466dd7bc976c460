#!/usr/bin/env python3
"""Smoke test of the decoder's device path on a GPU, at full size.

    python chip_smoke.py               # one GPU: phases 1-4 below
    python chip_smoke.py --devices 4   # four GPUs: the multi-device paths

One GPU:
  1. main path: the realistic 1080p stream (16 frames) through
     Decoder(backend="device", parallel_slices=8) — native front-end,
     compact v2 upload, jitted pipeline, persistent device DPB. The
     first 6 delivered frames must be byte-identical to
     Decoder(backend="cpu"), the golden-validated NumPy path. Prints
     cold-pass and compile seconds, warm device-resident fps, warm
     fetch fps, approximate per-stage times (differences of separately
     compiled run_stages programs), the MC stage, the wavefront time
     per diagonal and the compiled step's memory analysis.
  2. lockstep batch: 4 realistic 1080p streams of 3 frames through
     decode_streams_lockstep; each stream byte-identical to its own
     single-stream device decode.
  3. 4K: a 240x135-MB stream of 3 frames; frames 1-2 byte-identical to
     the CPU backend.
  4. concealment: bytes cut from the middle of a 1080p P picture; the
     whole output byte-identical to the CPU backend.

Four GPUs (--devices 4), each byte-identical to the one-device decode:
  sp=4: parallel/slices.decode_stream_sliced over Mesh(4, ("sp",)) on a
        1080p stream of 4 band-aligned slices with cross-slice
        deblocking (idc 0);
  dp=4: parallel/slices.decode_streams_sliced_dp over a (4 x 1) dp x sp
        mesh, 4 realistic 1080p streams.

The script fails (non-zero exit, no result line) when JAX finds no GPU,
when the native front-end cannot be built, and on any mismatch. Streams
are generated and CPU references decoded in CPU-only worker processes
(JAX_PLATFORMS=cpu) while the one JAX process on the card decodes. The
last line of standard output is
  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import threading
import time

REPO = os.path.dirname(os.path.abspath(__file__))

HD = (120, 68)              # 1920x1088 coded, 1080p
UHD = (240, 135)            # 3840x2160
HD_FRAMES = 16
HD_CHECKED = 6
LOCK_STREAMS = 4
SHORT_FRAMES = 3
UHD_CHECKED = 2


def _paths() -> None:
    for p in (os.path.join(REPO, "tools"), REPO):
        if p not in sys.path:
            sys.path.insert(0, p)


def _worker_init() -> None:
    # workers generate streams and run the NumPy reference: never the card
    os.environ["JAX_PLATFORMS"] = "cpu"
    _paths()


def check(cond, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


# ---- stream generation and CPU references (worker processes) ------------

def gen_stream(spec: tuple) -> bytes:
    """spec = (kind, w_mbs, h_mbs, n_frames, seed)."""
    kind, w, h, n, seed = spec
    if kind == "real":
        from bench_common import realistic_bench_stream
        return realistic_bench_stream(w, h, n_frames=n, seed=seed)
    if kind == "band":
        import streams
        return streams.banded_stream(width_mbs=w, height_mbs=h, n_bands=4,
                                     n_frames=n, seed=seed,
                                     deblock_idc=0)[0]
    if kind == "conceal":
        from bench_common import realistic_bench_stream
        return cut_middle(realistic_bench_stream(w, h, n_frames=n,
                                                 seed=seed))
    raise ValueError(kind)


def cut_middle(data: bytes) -> bytes:
    """Drop a quarter of the bytes of the middle slice NAL of the middle
    picture (the concealment probe: that slice fails to parse, its MBs
    are concealed)."""
    from broadway_tpu.bitstream import bitreader as br
    slices = [(off, len(p)) for off, p in br.split_nal_units(data)
              if p[0] & 0x1F in (br.NAL_SLICE, br.NAL_SLICE_IDR)]
    off, n = slices[len(slices) // 2]
    a = off + n // 3
    return data[:a] + data[a + n // 4:]


def cpu_frames(data: bytes, n_pics: int = None) -> list:
    """Display-order YUV bytes from the NumPy backend; with n_pics, of
    the first n_pics pictures only (decode stops there and flushes —
    exact for streams whose display order is decode order)."""
    from broadway_tpu.bitstream import bitreader as br
    from broadway_tpu.core.decoder import Decoder
    d = Decoder(backend="cpu")
    if n_pics is None:
        return [o.frame.tobytes() for o in d.decode_annexb(data)]
    for _, payload in br.split_nal_units(data):
        try:
            nal = br.NalUnit(payload)
        except br.StreamError:
            continue
        d.decode_nal(nal)
        if d.pic_number >= n_pics:
            break
    d.flush()
    return [o.frame.tobytes() for o in d.outputs[:n_pics]]


class Jobs:
    """Streams and their CPU references, computed in worker processes
    while the main process uses the card."""

    def __init__(self, specs: dict, refs: dict) -> None:
        import multiprocessing as mp
        from concurrent.futures import ProcessPoolExecutor
        n = max(2, min(len(specs) + len(refs), (os.cpu_count() or 4) // 2))
        self.pool = ProcessPoolExecutor(
            n, mp_context=mp.get_context("spawn"), initializer=_worker_init)
        self.gen = {k: self.pool.submit(gen_stream, s)
                    for k, s in specs.items()}
        self.ref = {}
        self._refs = refs
        self._thread = threading.Thread(target=self._submit_refs,
                                        daemon=True)
        self._thread.start()

    def _submit_refs(self) -> None:
        for k, n_pics in self._refs.items():
            try:
                data = self.gen[k].result()
            except Exception:   # raised again by data() in the main thread
                return
            self.ref[k] = self.pool.submit(cpu_frames, data, n_pics)

    def data(self, k: str) -> bytes:
        return self.gen[k].result()

    def reference(self, k: str) -> list:
        self.gen[k].result()
        self._thread.join()
        return self.ref[k].result()

    def close(self) -> None:
        self.pool.shutdown(wait=True, cancel_futures=True)


# ---- device side (main process) -----------------------------------------

def smi_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def ensure_native() -> None:
    """Build build/libbwfe.so from the tracked sources if it is missing
    (before any worker starts, so no two processes build it at once)."""
    if not os.path.exists(os.path.join(REPO, "build", "libbwfe.so")):
        subprocess.run(["bash", os.path.join(REPO, "native", "build.sh")],
                       check=True)
    from broadway_tpu.bitstream import native
    check(native.pack2_available(),
          "native front-end (build/libbwfe.so) with the v2 packer is "
          "required")


def device_decode(data: bytes, fetch: bool = True):
    """Single-stream decode on the default device (the main path)."""
    import jax
    from broadway_tpu.core.decoder import Decoder
    d = Decoder(backend="device", parallel_slices=8,
                prefetch_outputs=fetch)
    try:
        outs = d.decode_annexb(data)
        if fetch:
            return [o.frame.tobytes() for o in outs]
        jax.block_until_ready([o.frame.y for o in outs])
        return outs
    finally:
        d.close()


def same_frames(got: list, want: list, what: str) -> None:
    check(len(got) == len(want),
          f"{what}: {len(got)} frames, expected {len(want)}")
    for i, (g, w) in enumerate(zip(got, want)):
        if g != w:
            off = next(j for j in range(len(g)) if g[j] != w[j])
            raise AssertionError(f"{what}: frame {i} differs at byte {off}")


def _timed(fn, *a, **k):
    t0 = time.perf_counter()
    out = fn(*a, **k)
    return out, time.perf_counter() - t0


def _median_time(fn, reps: int) -> float:
    import jax
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


def phase_main(data: bytes, ref6: list, tag: str) -> None:
    n = HD_FRAMES
    _, cold = _timed(device_decode, data, fetch=False)
    _, warm1 = _timed(device_decode, data, fetch=False)
    _, warm2 = _timed(device_decode, data, fetch=False)
    got, fetch_s = _timed(device_decode, data, fetch=True)
    warm = min(warm1, warm2)
    print(f"[1080p] cold pass {cold} s for {n} frames (compile + decode; "
          f"compile ~{cold - warm} s) {tag}")
    print(f"[1080p] warm device-resident: {n / warm1} fps, {n / warm2} fps "
          f"{tag}")
    print(f"[1080p] warm fetch (YUV to host): {n / fetch_s} fps {tag}")
    check(len(got) == n, f"1080p: {len(got)} frames, expected {n}")
    same_frames(got[:HD_CHECKED], ref6, "1080p vs CPU backend")
    print(f"[1080p] frames 0-{HD_CHECKED - 1} byte-identical to the CPU "
          f"backend")


def stage_times(data: bytes, tag: str) -> None:
    """Per-stage times at 1080p on one P picture, inputs device-resident:
    run_stages 0 (residual + assembly), 1 (+MC), 2 (+intra wavefront),
    3 (+deblock wavefront). Stage = difference of two separately
    compiled programs, so the split is approximate."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    import broadway_tpu.core.decoder as DEC
    from broadway_tpu.core import packed as PK
    from broadway_tpu.core import recon_tpu as RT
    from broadway_tpu.ops.tpu import inter as K_mc

    pics = []

    def collect(dec, pic):
        pics.append((pic, dec.pps, len(dec.dpb.buffer)))
        return DEC.SKIP_RECON

    DEC.Decoder(backend="cpu", recon_strategy=collect).decode_annexb(data)
    pic, pps, n_slots = pics[-1]
    w, h = pic.width_mbs, pic.height_mbs
    W, H = 16 * w, 16 * h
    co, ci = pps.chroma_qp_index_offset, pps.constrained_intra_pred
    arrs = {k: jnp.asarray(v) for k, v in
            RT.host_picture_arrays(pic, co, ci).items()}
    rng = np.random.RandomState(0)
    ry = jnp.asarray(rng.randint(0, 256, (n_slots,) +
                                 K_mc.luma_ext_dims(W, H)), jnp.int32)
    rc = jnp.asarray(rng.randint(0, 256, (n_slots,) +
                                 K_mc.chroma_ext_dims(W, H)), jnp.int32)
    steps = {k: jnp.asarray(v) for k, v in RT.step_tables(w, h).items()}
    S = RT.get_layout(w, h).S

    t = []
    for rs in range(4):
        def f(rs=rs):
            return RT.decode_picture(arrs, ry, rc, steps, w_mbs=w, h_mbs=h,
                                     chroma_qp_offset=co, run_stages=rs)
        _, c = _timed(lambda: jax.block_until_ready(f()))
        t.append(_median_time(f, 10))
        print(f"[stages] run_stages={rs}: {t[-1] * 1e3} ms/picture "
              f"(compile {c} s) {tag}")
    print(f"[stages] approx (differences of separately compiled programs)"
          f": residual+assembly {t[0] * 1e3} ms, MC {(t[1] - t[0]) * 1e3} "
          f"ms, intra wavefront {(t[2] - t[1]) * 1e3} ms = "
          f"{(t[2] - t[1]) / S * 1e6} us/diagonal, deblock wavefront "
          f"{(t[3] - t[2]) * 1e3} ms = {(t[3] - t[2]) / S * 1e6} "
          f"us/diagonal over {S} diagonals {tag}")

    mc = jax.jit(RT.mc_predict_xla, static_argnames=("w_mbs", "h_mbs"))

    def g():
        return mc(ry, rc, arrs["mv"], arrs["ref_blk"], w_mbs=w, h_mbs=h)
    jax.block_until_ready(g())
    print(f"[stages] MC alone (mc_predict_xla, {w * h * 16} 4x4 blocks): "
          f"{_median_time(g, 10) * 1e3} ms {tag}")

    lay = PK.get_packed_layout_v2(w, h)
    buf, bk = PK.pack_picture_v2(pic, lay, PK.PackScratchV2(lay))
    compiled = RT.decode_picture_packed2.lower(
        jnp.asarray(buf), ry, rc, 0, steps, lay=lay, bk=bk,
        constrained_intra=ci, chroma_qp_offset=co).compile()
    ma = compiled.memory_analysis()
    fields = ("argument_size_in_bytes", "output_size_in_bytes",
              "alias_size_in_bytes", "temp_size_in_bytes",
              "generated_code_size_in_bytes")
    print("[memory] 1080p decode_picture_packed2 step: " + ", ".join(
        f"{k}={getattr(ma, k, None)}" for k in fields) + f" {tag}")


def phase_lockstep(datas: list) -> None:
    from broadway_tpu.parallel.streams import decode_streams_lockstep
    (gots, dt) = _timed(decode_streams_lockstep, datas, parallel_slices=8)
    for i, d in enumerate(datas):
        same_frames(gots[i], device_decode(d),
                    f"lockstep stream {i} vs its single-stream decode")
    print(f"[lockstep] {len(datas)} x 1080p x {SHORT_FRAMES} frames "
          f"byte-identical to per-stream device decodes (cold pass "
          f"{dt} s)")


def phase_4k(data: bytes, ref: list, tag: str) -> None:
    got, cold = _timed(device_decode, data)
    _, warm = _timed(device_decode, data, fetch=False)
    check(len(got) == SHORT_FRAMES,
          f"4K: {len(got)} frames, expected {SHORT_FRAMES}")
    same_frames(got[:UHD_CHECKED], ref, "4K vs CPU backend")
    print(f"[4K] frames 0-{UHD_CHECKED - 1} byte-identical to the CPU "
          f"backend; cold pass {cold} s, warm device-resident "
          f"{SHORT_FRAMES / warm} fps ({SHORT_FRAMES} frames, short) {tag}")


def phase_conceal(data: bytes, ref: list) -> None:
    import broadway_tpu.core.decoder as DEC
    d = DEC.Decoder(backend="device", parallel_slices=8)
    try:
        outs = d.decode_annexb(data)
        got = [o.frame.tobytes() for o in outs]
    finally:
        d.close()
    n_err = sum(o.num_err_mbs for o in outs)
    check(n_err > 0, "concealment probe concealed no MB")
    same_frames(got, ref, "concealed stream vs CPU backend")
    print(f"[conceal] {len(got)} frames with {n_err} concealed MBs "
          f"byte-identical to the CPU backend")


def phase_multi(datas: dict, devices: list, tag: str) -> None:
    import numpy as np
    from jax.sharding import Mesh

    from broadway_tpu.parallel.slices import (decode_stream_sliced,
                                              decode_streams_sliced_dp)
    n = len(devices)
    band = datas["band"]
    want = device_decode(band)
    got, dt = _timed(decode_stream_sliced, band,
                     Mesh(np.array(devices), ("sp",)), n_bands=n)
    same_frames(got, want, f"sp={n} vs one-device decode")
    print(f"[sp={n}] band-sharded 1080p idc-0 decode ({len(got)} frames) "
          f"byte-identical to the one-device decode (cold pass {dt} s) "
          f"{tag}")

    streams = [datas[f"dp{i}"] for i in range(n)]
    wants = [device_decode(d) for d in streams]
    gots, dt = _timed(decode_streams_sliced_dp, streams,
                      Mesh(np.array(devices).reshape(n, 1), ("dp", "sp")),
                      n_bands=1)
    for i in range(n):
        same_frames(gots[i], wants[i], f"dp={n} stream {i} vs one-device")
    print(f"[dp={n}] {n} x 1080p streams byte-identical to one-device "
          f"decodes (cold pass {dt} s) {tag}")

    peaks = [dv.memory_stats()["peak_bytes_in_use"] for dv in devices]
    print(f"[multi] peak bytes in use per device: {peaks}")
    check(min(peaks) > 64 << 20,
          f"work not spread over the {n} devices: {peaks}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--devices", type=int, choices=(1, 4), default=1,
                    help="4: run only the four-device paths (sp=4, dp=4)")
    args = ap.parse_args(argv)

    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: needs a GPU; JAX found {devs[0].platform}",
              file=sys.stderr)
        return 2
    if len(devs) < args.devices:
        print(f"chip_smoke: needs {args.devices} GPUs, found {len(devs)}",
              file=sys.stderr)
        return 2
    _paths()
    from broadway_tpu.utils.cache import ensure_compile_cache
    ensure_compile_cache()

    smi = smi_line()
    tag = f"({devs[0].device_kind}; {smi})"
    print(f"device: {devs[0].device_kind} x{len(devs)}; nvidia-smi: {smi}",
          flush=True)
    ensure_native()

    w, h = HD
    if args.devices == 4:
        specs = {"band": ("band", w, h, SHORT_FRAMES, 701)}
        specs.update({f"dp{i}": ("real", w, h, SHORT_FRAMES, 5100 + i)
                      for i in range(4)})
        refs = {}
    else:
        specs = {"hd": ("real", w, h, HD_FRAMES, 4242),
                 "uhd": ("real", *UHD, SHORT_FRAMES, 7777),
                 "conceal": ("conceal", w, h, SHORT_FRAMES, 6000)}
        specs.update({f"lock{i}": ("real", w, h, SHORT_FRAMES, 5000 + i)
                      for i in range(LOCK_STREAMS)})
        refs = {"hd": HD_CHECKED, "uhd": UHD_CHECKED, "conceal": None}

    t0 = time.perf_counter()
    jobs = Jobs(specs, refs)
    try:
        if args.devices == 4:
            phase_multi({k: jobs.data(k) for k in specs}, devs[:4], tag)
        else:
            hd = jobs.data("hd")
            phase_main(hd, jobs.reference("hd"), tag)
            stage_times(hd, tag)
            phase_lockstep([jobs.data(f"lock{i}")
                            for i in range(LOCK_STREAMS)])
            phase_4k(jobs.data("uhd"), jobs.reference("uhd"), tag)
            phase_conceal(jobs.data("conceal"), jobs.reference("conceal"))
        peak = devs[0].memory_stats()["peak_bytes_in_use"]
        print(f"peak bytes in use on device 0: {peak}; total "
              f"{time.perf_counter() - t0} s")
    finally:
        jobs.close()

    print(f"nvidia-smi: {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

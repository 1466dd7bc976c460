#!/usr/bin/env python3
"""Benchmark: H.264 Baseline END-TO-END decode, frames/sec/device.

Headline: the full decoder (`Decoder(backend="device")`) driven with
real Annex-B bitstream bytes at 1080p — native entropy front-end,
compact packed upload, jitted device pixel pipeline, persistent device
DPB — on the realistic-statistics bench stream (multi-slice, idc 0,
multi-ref, sparse residuals; tools/streams.realistic_stream). Frames
are decoded into device memory (the serving contract: display/RGB
consume them there, like the reference hands frames to a WebGL
texture); completion is established with ONE batched device sync over
all output frames.

Details additionally report:
  - fps_e2e_fetch: same run but every frame's packed YUV delivered to
    host bytes (the DecTestBench contract), with the device->host copy
    of frame N overlapped with the decode of N+1 (Decoder
    prefetch_outputs + the async pump; the reference's transferable
    frame post-back, Player/Decoder.js:856-872). The measured D2H
    link budget is printed beside it, with the overlap and serial
    delivery bounds it implies.
  - fps_pipeline: steady-state jitted pixel pipeline alone
    (pre-parsed dense-stream tensors resident on device).
  - dense_e2e: end-to-end on the dense synthetic stream (adversarial
    entropy/upload load). A failure is recorded IN the JSON detail.
  - batch: aggregate lockstep fps for B concurrent 1080p streams
    (BASELINE config 4 evidence; reference analogue
    TestBenchMultipleInstance.c / storyDemo.html).

The reference publishes no numbers (BASELINE.md); the clip recipe is
29.97 fps video (reference README.markdown:35), so vs_baseline is
reported relative to 30 fps real-time single-stream playback.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "frames/s", "vs_baseline": N}
"""

import json
import os
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tools"))

from broadway_tpu.utils.cache import ensure_compile_cache
ensure_compile_cache()

W_MBS = int(os.environ.get("BENCH_W_MBS", "120"))
H_MBS = int(os.environ.get("BENCH_H_MBS", "68"))
N_FRAMES = int(os.environ.get("BENCH_FRAMES", "16"))
REPS = int(os.environ.get("BENCH_REPS", "16"))
# overall wall budget: optional sections are skipped (and say so in
# the JSON) once exceeded, so the headline always gets printed even
# under a driver timeout; compile caches persist, so a later run
# fills in skipped sections
BUDGET_S = float(os.environ.get("BENCH_TIME_BUDGET", "420"))
_T_START = time.time()


def _over_budget():
    return time.time() - _T_START > BUDGET_S


def _bench_e2e(data, fetch: bool, parallel_slices: int = 8):
    """One warm end-to-end pass: bitstream bytes -> decoded frames.
    fetch=False leaves frames device-resident (ONE batched sync over
    all outputs); fetch=True additionally pulls every frame's YUV
    bytes to the host, overlapped with decode via prefetch."""
    import jax
    from broadway_tpu.core.decoder import Decoder

    d = Decoder(backend="device", parallel_slices=parallel_slices,
                prefetch_outputs=fetch)
    t0 = time.perf_counter()
    outs = d.decode_annexb(data)
    nb = 0
    if fetch:
        for o in outs:
            nb += len(o.frame.tobytes())
    else:
        jax.block_until_ready([o.frame.y for o in outs])
    dt = time.perf_counter() - t0
    return len(outs) / dt, len(outs), nb


def _measure_d2h_mbps():
    """Pipelined device->host link budget on one YUV-frame-sized
    buffer batch (computed arrays — uploads keep a host mirror and
    would measure nothing)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    sz = W_MBS * 16 * H_MBS * 16 * 3 // 2
    base = jax.device_put(np.zeros((sz,), np.uint8))
    gen = jax.jit(lambda x, k: x + k)
    xs = [gen(base, np.uint8(i + 1)) for i in range(4)]
    jax.block_until_ready(xs)
    t0 = time.perf_counter()
    for a in xs:
        a.copy_to_host_async()
    for a in xs:
        np.asarray(a)
    return 4 * sz / (time.perf_counter() - t0) / 1e6


def main():
    import jax
    import jax.numpy as jnp
    import numpy as np

    from bench_common import (bench_stream, parse_pictures,
                              realistic_bench_stream)
    from broadway_tpu.core import recon_tpu as RT
    from broadway_tpu.ops.tpu import inter as K_mc

    dev = jax.devices()[0]
    if dev.platform == "cpu":
        sys.exit("bench.py measures an accelerator; JAX found only CPU")
    detail = {"device": {"platform": dev.platform,
                         "kind": dev.device_kind,
                         "count": len(jax.devices())}}

    # ---- headline: end-to-end on the realistic stream ------------------
    # warm with fetch=False (identical compiled programs — fetch only
    # changes host-side delivery)
    real = realistic_bench_stream(W_MBS, H_MBS, n_frames=N_FRAMES)
    _bench_e2e(real, fetch=False)         # warm / compile
    fps_e2e = max(_bench_e2e(real, fetch=False)[0] for _ in range(2))
    detail["fps_e2e_device"] = round(fps_e2e, 2)
    detail["frames"] = N_FRAMES
    detail["stream_bytes"] = len(real)

    # ---- multi-stream lockstep batch (BASELINE config 4) ---------------
    # All streams come from the disk cache (generation is pure Python);
    # warm runs use cached 2-frame streams covering the I/P jit
    # signatures, so the timed region only measures decode.
    if not os.environ.get("BENCH_SKIP_BATCH"):
        from broadway_tpu.parallel.streams import \
            decode_streams_lockstep
        batch_detail = {}
        nfb = int(os.environ.get("BENCH_BATCH_FRAMES", "8"))
        for B in (2, 4, 8):
            try:
                if _over_budget():
                    raise TimeoutError("bench time budget exceeded")
                datas = [realistic_bench_stream(
                    W_MBS, H_MBS, n_frames=nfb, seed=5000 + s)
                    for s in range(B)]
                warm = [realistic_bench_stream(
                    W_MBS, H_MBS, n_frames=2, seed=5000 + s)
                    for s in range(B)]
                decode_streams_lockstep(warm, fetch=False)
                t0 = time.perf_counter()
                outs = decode_streams_lockstep(datas, fetch=False)
                dt = time.perf_counter() - t0
                batch_detail[str(B)] = round(sum(len(o) for o in outs)
                                             / dt, 2)
            except Exception as e:
                batch_detail[str(B)] = \
                    f"FAILED: {type(e).__name__}: {e}"[:200]
        detail["fps_batch_aggregate"] = batch_detail

    # ---- 4K (3840x2160) end-to-end (BASELINE config 5 resolution axis) -
    try:
        if _over_budget():
            raise TimeoutError("bench time budget exceeded")
        data4k = realistic_bench_stream(240, 135, n_frames=8, seed=7777)
        _bench_e2e(data4k, fetch=False)   # warm / compile
        fps4k, n4k, _ = _bench_e2e(data4k, fetch=False)
        detail["fps_4k_e2e"] = round(fps4k, 2)
    except Exception as e:
        detail["fps_4k_e2e"] = f"FAILED: {type(e).__name__}: {e}"[:300]

    # ---- pipeline-only (kernel steady state, dense tensors) ------------
    try:
        if _over_budget():
            raise TimeoutError("bench time budget exceeded")
        pics = parse_pictures(bench_stream(W_MBS, H_MBS, n_frames=3),
                              max_pics=2)
        arrs, w, h, cqo, n_slots = pics[-1]
        arrs = {k: jnp.asarray(v) for k, v in arrs.items()}
        steps = {k: jnp.asarray(v) for k, v in RT.step_tables(w, h).items()}
        H, W = h * 16, w * 16
        hy, wy = K_mc.luma_ext_dims(W, H)
        hc, wc = K_mc.chroma_ext_dims(W, H)
        rng = np.random.RandomState(0)
        ref_y = jnp.asarray(rng.randint(0, 256, (n_slots, hy, wy)),
                            jnp.int32)
        ref_c = jnp.asarray(rng.randint(0, 256, (n_slots, hc, wc)),
                            jnp.int32)
        out = RT.decode_picture(arrs, ref_y, ref_c, steps, w_mbs=w,
                                h_mbs=h, chroma_qp_offset=cqo)
        jax.block_until_ready(out)
        t0 = time.perf_counter()
        for _ in range(REPS):
            out = RT.decode_picture(arrs, ref_y, ref_c, steps, w_mbs=w,
                                    h_mbs=h, chroma_qp_offset=cqo)
        jax.block_until_ready(out)
        detail["fps_pipeline"] = round(
            REPS / (time.perf_counter() - t0), 2)
    except Exception as e:
        detail["fps_pipeline"] = f"FAILED: {type(e).__name__}"

    # ---- dense synthetic stream, end-to-end (adversarial load) ---------
    try:
        if _over_budget():
            raise TimeoutError("bench time budget exceeded")
        dense = bench_stream(W_MBS, H_MBS, n_frames=8)
        _bench_e2e(dense, fetch=False)    # warm / compile
        fps_dense, _, _ = _bench_e2e(dense, fetch=False)
        detail["fps_dense_e2e"] = round(fps_dense, 2)
        # breakdown so the number is explained: host front-end parse
        # vs the rest (device graph + upload bubbles). Own try: a
        # breakdown failure must not clobber the measured
        # fps_dense_e2e above.
        try:
            import broadway_tpu.core.decoder as DECm
            t0 = time.perf_counter()
            npic = []
            DECm.Decoder(backend="cpu", recon_strategy=lambda dec, pic: (
                npic.append(1), DECm.SKIP_RECON)[1]).decode_annexb(dense)
            detail["dense_parse_ms_per_frame"] = round(
                (time.perf_counter() - t0) / len(npic) * 1e3, 1)
            # remainder after the (overlapped) host parse
            detail["dense_e2e_minus_parse_ms"] = round(
                1e3 / fps_dense
                - detail["dense_parse_ms_per_frame"], 1)
        except Exception as e:
            detail["dense_parse_ms_per_frame"] = \
                f"FAILED: {type(e).__name__}"
    except Exception as e:
        detail["fps_dense_e2e"] = f"FAILED: {type(e).__name__}: {e}"[:300]

    # ---- host YUV delivery (link-bound; last) ---------------------------
    try:
        if _over_budget():
            raise TimeoutError("bench time budget exceeded")
        real6 = realistic_bench_stream(W_MBS, H_MBS, n_frames=6)
        fps_fetch, n, nb = _bench_e2e(real6, fetch=True)
        detail["fps_e2e_fetch"] = round(fps_fetch, 2)
        detail["fetch_frames"] = n
        detail["fetched_bytes"] = nb
        link = _measure_d2h_mbps()
        detail["link_d2h_mbps"] = round(link, 1)
        # delivery bounds: the pump issues each frame's D2H right
        # after its compute, so delivery tracks min(link, decode); the
        # serial bound is the floor when transfer and decode serialize
        fb = W_MBS * 16 * H_MBS * 16 * 3 / 2
        link_fps = link * 1e6 / fb
        detail["fetch_bound_overlap_fps"] = round(
            min(link_fps, fps_e2e), 2)
        detail["fetch_bound_serial_fps"] = round(
            1.0 / (1.0 / link_fps + 1.0 / fps_e2e), 2)
    except Exception as e:
        detail["fps_e2e_fetch"] = f"FAILED: {type(e).__name__}: {e}"[:200]

    print(json.dumps({
        "metric": f"frames/sec/device {W_MBS * 16}x{H_MBS * 16} Baseline "
                  f"END-TO-END decode (bitstream in -> decoded frames "
                  f"in device memory; realistic multi-slice idc-0 "
                  f"stream)",
        "value": round(fps_e2e, 2),
        "unit": "frames/s",
        "vs_baseline": round(fps_e2e / 30.0, 3),
        "detail": detail,
    }))


if __name__ == "__main__":
    main()

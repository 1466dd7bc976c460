#!/usr/bin/env python3
"""Per-phase timing of the packed (v1) device fast path.
Single process; reuses one Decoder so jit compiles once."""

import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tools"))


def main():
    import jax
    import numpy as np
    from bench_common import bench_stream
    import broadway_tpu.core.decoder as DEC
    from broadway_tpu.core import packed as PK
    from broadway_tpu.core import recon_tpu as RT

    w_mbs, h_mbs = (int(os.environ.get("PROF_W", "120")),
                    int(os.environ.get("PROF_H", "68")))
    n_frames = int(os.environ.get("PROF_FRAMES", "8"))
    data = bench_stream(w_mbs, h_mbs, n_frames=n_frames)

    t = {"parse": 0.0, "pack": 0.0, "upload": 0.0, "dispatch": 0.0,
         "sync": 0.0}
    counts = {"frames": 0}
    kbs = []

    orig = DEC.Decoder._reconstruct_device

    def timed(self, pic):
        import jax.numpy as jnp
        t0 = time.perf_counter()
        sps, pps = self.sps, self.pps
        w, h = sps.width_mbs, sps.height_mbs
        key = (w, h)
        if getattr(self, "_steps_key", None) != key:
            self._steps = {k: jnp.asarray(v)
                           for k, v in RT.step_tables(w, h).items()}
            self._steps_key = key
        lay = PK.get_packed_layout(w, h)
        if getattr(self, "_pack_scratch", None) is None:
            self._pack_scratch = PK.PackScratch(lay)
        self._ensure_stacks()
        t1 = time.perf_counter()
        buf, kb = PK.pack_picture(pic, lay, self._pack_scratch)
        kbs.append(kb)
        t2 = time.perf_counter()
        dbuf = jax.device_put(buf)
        t3 = time.perf_counter()
        slot = self.dpb.current.slot
        y, cb, cr, self._stack_y, self._stack_c = \
            RT.decode_picture_packed(
                dbuf, self._stack_y, self._stack_c, slot, self._steps,
                lay=lay, kb=kb,
                constrained_intra=pps.constrained_intra_pred,
                chroma_qp_offset=pps.chroma_qp_index_offset)
        t4 = time.perf_counter()
        t["pack"] += t2 - t1
        t["upload"] += t3 - t2
        t["dispatch"] += t4 - t3
        counts["frames"] += 1
        return RT.DeviceFrame(y, cb, cr, pad=False)

    DEC.Decoder._reconstruct_device = timed
    try:
        # cold
        d = DEC.Decoder(backend="device")
        t0 = time.perf_counter()
        outs = d.decode_annexb(data)
        for o in outs:
            o.frame.tobytes()
        print(f"cold: {time.perf_counter() - t0:.1f}s", flush=True)

        for k in t:
            t[k] = 0.0
        counts["frames"] = 0
        d = DEC.Decoder(backend="device")
        t0 = time.perf_counter()
        outs = d.decode_annexb(data)
        t_decode = time.perf_counter() - t0
        ts = time.perf_counter()
        nb = sum(len(o.frame.tobytes()) for o in outs)
        t["sync"] = time.perf_counter() - ts
        total = time.perf_counter() - t0
        n = counts["frames"]
        print(f"warm: {total:.3f}s = {n / total:.2f} fps; "
              f"decode loop {t_decode:.3f}s", flush=True)
        for k, v in t.items():
            print(f"  {k:9s} {v / n * 1e3:7.1f} ms/frame", flush=True)
        other = (t_decode - t["pack"] - t["upload"] - t["dispatch"]) / n
        print(f"  parse+etc {other * 1e3:7.1f} ms/frame", flush=True)
        print(f"  kb buckets: {sorted(set(kbs))}", flush=True)
    finally:
        DEC.Decoder._reconstruct_device = orig


if __name__ == "__main__":
    main()

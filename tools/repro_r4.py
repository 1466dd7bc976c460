"""Round-4 repro: v2+Pallas fused-jit miscompute (VERDICT r3 weak #1).

Decodes the failing stream (multislice idc=0, alpha_off=2, beta_off=-2)
through the device path and diffs vs the CPU oracle, printing
per-frame / per-plane first-diff info. Exit 0 = bit-exact.
"""
import sys
import os
import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tests"))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import streams  # noqa: E402
from broadway_tpu.core.decoder import Decoder  # noqa: E402


def main():
    data = streams.multislice_stream(width_mbs=4, height_mbs=3,
                                     seed=815, deblock_idc=0,
                                     alpha_off=2, beta_off=-2)[0]
    cpu = Decoder(backend="cpu").decode_annexb(data)
    dev = Decoder(backend="device").decode_annexb(data)
    bad = 0
    for i, (a, b) in enumerate(zip(cpu, dev)):
        w, h = a.width, a.height
        ya = np.frombuffer(a.frame.tobytes(), np.uint8)
        yb = np.frombuffer(b.frame.tobytes(), np.uint8)
        if np.array_equal(ya, yb):
            print(f"frame {i}: OK")
            continue
        bad += 1
        ny = w * h
        nc = ny // 4
        for name, s in (("y", slice(0, ny)), ("cb", slice(ny, ny + nc)),
                        ("cr", slice(ny + nc, ny + 2 * nc))):
            pa, pb = ya[s], yb[s]
            d = np.nonzero(pa != pb)[0]
            if len(d):
                pw = w if name == "y" else w // 2
                coords = [(int(o) // pw, int(o) % pw) for o in d[:40]]
                print(f"frame {i} {name}: {len(d)} diffs (r,c): {coords}")
    print("RESULT:", "FAIL" if bad else "PASS")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())

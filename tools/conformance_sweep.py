#!/usr/bin/env python3
"""Randomized conformance sweep: N generated streams across the
feature matrix (geometries, wild MVs, multi-ref, multi-slice, FMO,
deblock offsets, QP extremes), each decoded by the reference C
decoder (build/oracle/dectest) and by our CLI on the requested
backend, outputs byte-compared. Exit 0 = every stream byte-identical.

Usage: conformance_sweep.py [-B device|cpu] [-N count] [--seed S]
"""

import os
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tools"))


def gen_streams(rng, count):
    """Yield (name, bytes) covering the decode feature matrix."""
    import streams
    geoms = [(4, 3), (5, 4), (11, 7), (16, 9), (6, 5), (9, 2), (3, 8)]
    for i in range(count):
        w, h = geoms[rng.randrange(len(geoms))]
        kind = i % 6
        seed = rng.randrange(1 << 30)
        if kind == 0:       # wild out-of-picture MVs, multi-ref
            yield (f"wildmv-{w}x{h}-s{seed}",
                   streams.inter_stream(
                       width_mbs=w, height_mbs=h, n_frames=5, seed=seed,
                       deblock=True, mvd_range=rng.choice([200, 400, 700]),
                       num_ref_frames=2, multi_ref_idx=True)[0])
        elif kind == 1:     # multi-slice idc 0 with offsets
            yield (f"mslice-{w}x{h}-s{seed}",
                   streams.multislice_stream(
                       width_mbs=w, height_mbs=h, seed=seed,
                       n_slices=rng.randrange(2, 5), deblock_idc=0,
                       alpha_off=rng.randrange(-6, 7),
                       beta_off=rng.randrange(-6, 7))[0])
        elif kind == 2:     # intra mix, QP extremes
            yield (f"intra-{w}x{h}-s{seed}",
                   streams.intra_mixed_stream(
                       width_mbs=w, height_mbs=h, seed=seed,
                       deblock=True,
                       qp=rng.choice([0, 10, 28, 45, 51]))[0])
        elif kind == 3:     # FMO
            yield (f"fmo-{w}x{h}-s{seed}",
                   streams.fmo_stream(map_type=rng.randrange(7),
                                      width_mbs=w, height_mbs=h,
                                      seed=seed)[0])
        elif kind == 4:     # plain inter, long
            yield (f"inter-{w}x{h}-s{seed}",
                   streams.inter_stream(
                       width_mbs=w, height_mbs=h, n_frames=8, seed=seed,
                       deblock=True, mvd_range=60)[0])
        else:               # IPCM
            yield (f"ipcm-{w}x{h}-s{seed}",
                   streams.ipcm_stream(width_mbs=w, height_mbs=h,
                                       seed=seed)[0])


def main():
    import random
    backend = "device"
    count = 12
    seed = 20260821
    args = sys.argv[1:]
    i = 0
    while i < len(args):
        if args[i] == "-B":
            i += 1
            backend = args[i]
        elif args[i] == "-N":
            i += 1
            count = int(args[i])
        elif args[i] == "--seed":
            i += 1
            seed = int(args[i])
        i += 1

    oracle = os.path.join(REPO, "build", "oracle", "dectest")
    if not os.path.exists(oracle):
        subprocess.run([os.path.join(REPO, "tools", "build_oracle.sh")],
                       check=True, capture_output=True)

    rng = random.Random(seed)
    bad = 0
    tmp = tempfile.mkdtemp(prefix="bwsweep-")
    for name, data in gen_streams(rng, count):
        sp = os.path.join(tmp, name + ".h264")
        with open(sp, "wb") as f:
            f.write(data)
        ref = os.path.join(tmp, name + ".ref.yuv")
        got = os.path.join(tmp, name + ".got.yuv")
        subprocess.run([oracle, "-O" + ref, sp],
                       capture_output=True)   # rc 1 = concealed frames, ok
        r = subprocess.run(
            [sys.executable, os.path.join(REPO, "tools", "dectest.py"),
             "-B", backend, "-O" + got, sp],
            capture_output=True, text=True)
        refb = open(ref, "rb").read() if os.path.exists(ref) else None
        gotb = open(got, "rb").read() if os.path.exists(got) else None
        ok = refb is not None and refb == gotb
        print(f"{'OK ' if ok else 'FAIL'} {name} "
              f"({len(refb) if refb else 0} B)", flush=True)
        if not ok:
            bad += 1
            if r.returncode != 0:
                print(r.stderr[-1000:])
    print(f"{count - bad}/{count} streams byte-identical vs oracle "
          f"({backend} backend)")
    sys.exit(1 if bad else 0)


if __name__ == "__main__":
    main()

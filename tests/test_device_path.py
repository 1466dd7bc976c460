"""The device backend: one XLA route with no platform branches and no
kernel left to interpret, byte-exact padding at picture edges, and the
smoke script that refuses to run without a GPU."""

import os
import re
import subprocess
import sys

import numpy as np
import pytest

import streams
from broadway_tpu.core.decoder import Decoder

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _program_files():
    for root in ("broadway_tpu", "tools"):
        for dp, _, fs in os.walk(os.path.join(REPO, root)):
            for f in fs:
                if f.endswith(".py"):
                    yield os.path.join(dp, f)
    for f in os.listdir(REPO):
        if f.endswith(".py"):
            yield os.path.join(REPO, f)


def test_no_route_names_pallas_or_interpret():
    bad = re.compile(r"pallas|interpret\s*=|pltpu|platform\s*==\s*.tpu"
                     r"|default_backend\(\)\s*==\s*.tpu|backend=.tpu")
    hits = []
    for path in _program_files():
        with open(path) as f:
            for i, line in enumerate(f, 1):
                if bad.search(line):
                    hits.append(f"{os.path.relpath(path, REPO)}:{i}: "
                                f"{line.strip()}")
    assert not hits, "\n".join(hits)


def test_unknown_backend_is_refused():
    with pytest.raises(ValueError):
        Decoder(backend="tpu")


def test_device_matches_cpu_wild_mv_padding():
    # out-of-picture MVs on every edge: the padded reference planes
    # (ops/tpu/inter.pad_luma / pad_chroma) must clamp like FillBlock
    data, _ = streams.inter_stream(width_mbs=7, height_mbs=5, n_frames=5,
                                   seed=4711, deblock=True, mvd_range=400,
                                   num_ref_frames=2, multi_ref_idx=True)
    cpu = [o.frame.tobytes() for o in Decoder(backend="cpu")
           .decode_annexb(data)]
    dev = [o.frame.tobytes() for o in Decoder(backend="device")
           .decode_annexb(data)]
    assert len(cpu) == len(dev) == 5
    for i, (a, b) in enumerate(zip(cpu, dev)):
        assert a == b, f"frame {i}"


def test_padded_plane_dims():
    from broadway_tpu.ops.tpu import inter as K_mc
    y = np.arange(32 * 48, dtype=np.int32).reshape(32, 48)
    c = np.arange(16 * 24, dtype=np.int32).reshape(16, 24)
    py = np.asarray(K_mc.pad_luma(y))
    pc = np.asarray(K_mc.pad_chroma(c, -c))
    assert py.shape == K_mc.luma_ext_dims(48, 32)
    assert pc.shape == K_mc.chroma_ext_dims(48, 32)
    P = K_mc.PAD
    assert np.array_equal(py[P:-P, P:-P], y)
    assert np.array_equal(py[0, :P], np.full(P, y[0, 0]))
    assert np.array_equal(pc[P:-P, 2 * P:-2 * P:2], c)
    assert np.array_equal(pc[P:-P, 2 * P + 1:-2 * P:2], -c)
    assert np.array_equal(pc[-1, -2:], [c[-1, -1], -c[-1, -1]])


def test_chip_smoke_refuses_cpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                       capture_output=True, text=True, timeout=300,
                       env=env, cwd=REPO)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


@pytest.mark.gpu
def test_device_backend_decodes_on_gpu(gpu):
    data, _ = streams.inter_stream(width_mbs=6, height_mbs=4, n_frames=4,
                                   seed=4712, deblock=True, mvd_range=60)
    dev = Decoder(backend="device").decode_annexb(data)
    assert all(d.platform == "gpu" for o in dev
               for d in o.frame.y.devices())
    cpu = Decoder(backend="cpu").decode_annexb(data)
    assert [o.frame.tobytes() for o in dev] == \
        [o.frame.tobytes() for o in cpu]

"""Player layer: MP4 demux, YUV->RGB converters, player orchestration."""

import numpy as np
import pytest

import streams
import mp4mux
from broadway_tpu.core.decoder import Decoder


def test_mp4_roundtrip_decode():
    from broadway_tpu.player.player import MP4Player
    data, info = streams.inter_stream(n_frames=4, seed=941, deblock=True)
    mp4 = mp4mux.mux(data, info["width"], info["height"])
    want = [o.frame.tobytes() for o in Decoder().decode_annexb(data)]
    p = MP4Player(mp4).play()
    got = [f["yuv"] for f in p.frames]
    assert got == want
    assert p.stats.total_frames == len(want)


def test_mp4_demux_metadata():
    from broadway_tpu.player.mp4 import MP4Reader
    data, info = streams.intra_mixed_stream(seed=942)
    mp4 = mp4mux.mux(data, info["width"], info["height"])
    r = MP4Reader(mp4).read()
    t = r.video_track
    assert t is not None
    assert t.width == info["width"] and t.height == info["height"]
    assert t.avcc is not None and len(t.avcc.sps) == 1
    assert t.sample_count == info["n_frames"]
    assert t.avcc.nal_length_size == 4


def test_yuv2rgb_int_matches_reference_math():
    from broadway_tpu.player.yuv2rgb import yuv420_to_rgba_int
    rng = np.random.RandomState(3)
    y = rng.randint(0, 256, (16, 16)).astype(np.uint8)
    cb = rng.randint(0, 256, (8, 8)).astype(np.uint8)
    cr = rng.randint(0, 256, (8, 8)).astype(np.uint8)
    got = np.asarray(yuv420_to_rgba_int(y, cb, cr))
    # scalar mirror of Decoder.js yuv2rgbcalc
    for yy in range(16):
        for xx in range(16):
            Y = int(y[yy, xx])
            U = int(cb[yy // 2, xx // 2])
            V = int(cr[yy // 2, xx // 2])
            a0 = 1192 * (Y - 16)
            r = min(255, max(0, (a0 + 1634 * (V - 128)) >> 10))
            g = min(255, max(0, (a0 - 832 * (V - 128) - 400 * (U - 128))
                             >> 10))
            b = min(255, max(0, (a0 + 2066 * (U - 128)) >> 10))
            assert tuple(got[yy, xx]) == (r, g, b, 255), (yy, xx)


@pytest.mark.parametrize("name", ["rec601", "rec709"])
def test_yuv2rgb_matrix_matches_float64(name):
    """The float shader-matrix path vs a NumPy float64 conversion: at
    most 1 LSB apart (the final rounding to u8). Catches a reduced-
    precision (TF32) contraction."""
    from broadway_tpu.player import yuv2rgb as Y
    rng = np.random.RandomState(4)
    y = rng.randint(0, 256, (32, 48)).astype(np.uint8)
    cb = rng.randint(0, 256, (16, 24)).astype(np.uint8)
    cr = rng.randint(0, 256, (16, 24)).astype(np.uint8)
    got = np.asarray(getattr(Y, "yuv_to_rgb_" + name)(y, cb, cr))
    m = getattr(Y, name.upper()).astype(np.float64)
    up = lambda c: np.repeat(np.repeat(c, 2, 0), 2, 1).astype(np.float64)
    yuv1 = np.stack([y / 255.0, up(cb) / 255.0, up(cr) / 255.0,
                     np.ones(y.shape)], axis=-1)
    want = np.clip(np.floor(yuv1 @ m.T * 255.0 + 0.5), 0, 255)
    assert got.shape == y.shape + (3,) and got.dtype == np.uint8
    assert np.abs(got.astype(np.int64) - want.astype(np.int64)).max() <= 1


def test_fps_stats():
    from broadway_tpu.player.player import FpsStats
    s = FpsStats()
    t = 100.0
    for i in range(90):
        s.tick(t)
        t += 1.0 / 30.0
    assert s.total_frames == 90
    assert 29.0 < s.fps < 31.0
    assert 29.0 < s.fps_since_start < 31.0

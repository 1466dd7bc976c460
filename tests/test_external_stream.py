"""Golden decode of externally encoded (libx264) streams — breaks the
self-referential fixture loop (every other fixture comes from our own
tools/h264enc.py). Recipe parity with the reference's clips
(README.markdown:35: baseline profile == CAVLC, no B, no wpred)."""

import pytest

import ext_encoder
from broadway_tpu.core.decoder import Decoder
from conftest import run_oracle

pytestmark = pytest.mark.skipif(
    not ext_encoder.available(),
    reason="system libavcodec/libx264 not available")


def _golden(tmp_path, oracle_dectest, data, backend):
    sp = tmp_path / "x.h264"
    sp.write_bytes(data)
    ref, _ = run_oracle(oracle_dectest, str(sp), str(tmp_path / "ref.yuv"))
    d = Decoder(backend=backend)
    got = b"".join(o.frame.tobytes() for o in d.decode_annexb(data))
    assert got == ref


def test_x264_natural_cpu(tmp_path, oracle_dectest):
    data = ext_encoder.encode_natural(192, 160, 20, seed=3, slices=2,
                                      keyint=8, refs=3)
    _golden(tmp_path, oracle_dectest, data, "cpu")


def test_x264_natural_tpu(tmp_path, oracle_dectest):
    """Same stream through the device packed fast path (multi-slice,
    deblock idc 0, multi-ref — x264 defaults)."""
    data = ext_encoder.encode_natural(176, 144, 8, seed=4, slices=2,
                                      keyint=8)
    _golden(tmp_path, oracle_dectest, data, "device")


def test_x264_through_mp4_player(tmp_path, oracle_dectest):
    """Mux the x264 stream into MP4, demux + decode through the
    MP4Player path — external content end-to-end."""
    import mp4mux
    from broadway_tpu.player.player import MP4Player

    data = ext_encoder.encode_natural(192, 160, 6, seed=5, keyint=6)
    sp = tmp_path / "x.h264"
    sp.write_bytes(data)
    ref, _ = run_oracle(oracle_dectest, str(sp), str(tmp_path / "ref.yuv"))

    mp4 = mp4mux.mux(data, 192, 160, fps=30)
    p = MP4Player(mp4, render="yuv").play()
    assert b"".join(f["yuv"] for f in p.frames) == ref

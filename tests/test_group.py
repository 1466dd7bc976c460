"""Frame-group fast path (Decoder(group_frames=G)): G consecutive
pictures decoded per jit call with lazy output frames
(recon_tpu.decode_pictures_packed_group). Opt-in — per-picture
dispatch pipelines better on low-latency links — but must stay
bit-exact, including remainder groups, mid-stream resolution changes
(group flushes before the layout re-keys) and concealment (group
flushes so refs are current)."""

import pytest

import streams
from broadway_tpu.core.decoder import Decoder


def _cross(data, g=4):
    want = [o.frame.tobytes()
            for o in Decoder(backend="cpu").decode_annexb(data)]
    got = [o.frame.tobytes()
           for o in Decoder(backend="device",
                            group_frames=g).decode_annexb(data)]
    assert got == want


def test_group_remainder():
    # 5 frames at G=4: one full group + a remainder single
    _cross(streams.inter_stream(width_mbs=4, height_mbs=3, n_frames=5,
                                seed=99, deblock=True)[0])


def test_group_resolution_change():
    a, _ = streams.inter_stream(width_mbs=4, height_mbs=3, n_frames=3,
                                seed=61, deblock=True)
    b, _ = streams.inter_stream(width_mbs=6, height_mbs=5, n_frames=3,
                                seed=62, deblock=True)
    _cross(a + b)


def test_group_conceal_flush():
    _cross(streams.gaps_stream(width_mbs=4, height_mbs=3)[0])

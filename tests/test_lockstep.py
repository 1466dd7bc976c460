"""Lockstep multi-stream batched decode (one device, the single-picture
pipeline vmapped over streams) must be bit-exact vs per-stream decode."""

import numpy as np

import streams
from broadway_tpu.core import packed as PK
from broadway_tpu.core.decoder import Decoder
from broadway_tpu.parallel.streams import decode_streams_lockstep


def _inter(seed, n_frames=3):
    return streams.inter_stream(width_mbs=4, height_mbs=3,
                                n_frames=n_frames, seed=seed,
                                deblock=True, mvd_range=30)[0]


def _cpu(datas):
    return [[o.frame.tobytes() for o in Decoder().decode_annexb(d)]
            for d in datas]


def _check(gots, wants):
    assert gots == wants, [i for i, (g, w) in enumerate(zip(gots, wants))
                           if g != w]


def test_lockstep_batched_decode():
    datas = [_inter(s) for s in (11, 12, 13)]
    _check(decode_streams_lockstep(datas, parallel_slices=2), _cpu(datas))


def test_lockstep_chunked_device_batch(monkeypatch):
    # 3 streams with a 2-wide device chunk: rounds run as a full=False
    # 2-chunk (ref-stack gather/scatter) + a 1-chunk
    monkeypatch.setenv("BW_LOCKSTEP_SUB", "2")
    datas = [_inter(s) for s in (41, 42, 43)]
    _check(decode_streams_lockstep(datas, parallel_slices=2), _cpu(datas))


def test_lockstep_pack_decline_fallback(monkeypatch):
    datas = [_inter(s) for s in (31, 32)]
    wants = _cpu(datas)
    # force the v2 packer to decline every third picture: the lockstep
    # must fall back to a per-stream pipeline round, not abort
    orig = PK.pack_picture_v2
    calls = [0]

    def flaky(*a, **k):
        calls[0] += 1
        if calls[0] % 3 == 0:
            return None
        return orig(*a, **k)

    monkeypatch.setattr(PK, "pack_picture_v2", flaky)
    gots = decode_streams_lockstep(datas, parallel_slices=2)
    assert calls[0] >= 3
    _check(gots, wants)


def test_lockstep_unequal_lengths():
    # legal unequal picture counts: streams that end leave the lockstep
    # and the rest continue at a smaller batch
    datas = [_inter(s, n) for s, n in ((21, 2), (22, 4), (23, 3))]
    gots = decode_streams_lockstep(datas, parallel_slices=2)
    assert [len(g) for g in gots] == [2, 4, 3]
    _check(gots, _cpu(datas))


def test_lockstep_unequal_lengths_matches_device_decode():
    # device-resident outputs (fetch=False) of a shrinking batch equal
    # each stream's own single-stream device decode, frame by frame
    datas = [_inter(s, n) for s, n in ((51, 4), (52, 2), (53, 3))]
    gots = decode_streams_lockstep(datas, parallel_slices=2, fetch=False)
    for d, got in zip(datas, gots):
        want = Decoder(backend="device").decode_annexb(d)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            for plane in ("y", "cb", "cr"):
                assert np.array_equal(np.asarray(getattr(g.frame, plane)),
                                      np.asarray(getattr(w.frame, plane)))

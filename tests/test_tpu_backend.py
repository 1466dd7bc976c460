"""Device (jitted JAX) backend vs CPU (NumPy oracle) backend on every
stream scenario — the CPU backend itself is golden-validated vs the
reference."""

import pytest

import streams
from broadway_tpu.core.decoder import Decoder


def cross_check(data):
    cpu = Decoder(backend="cpu").decode_annexb(data)
    dev = Decoder(backend="device").decode_annexb(data)
    assert len(cpu) == len(dev)
    for i, (a, b) in enumerate(zip(cpu, dev)):
        ba, bb = a.frame.tobytes(), b.frame.tobytes()
        if ba != bb:
            off = next(j for j in range(len(ba)) if ba[j] != bb[j])
            raise AssertionError(
                f"frame {i} differs at byte {off}: cpu={ba[off]} "
                f"device={bb[off]} (y plane {a.width}x{a.height})")


def test_tpu_ipcm():
    cross_check(streams.ipcm_stream(width_mbs=4, height_mbs=3)[0])


def test_tpu_intra_mixed():
    cross_check(streams.intra_mixed_stream(width_mbs=4, height_mbs=3, seed=811)[0])


def test_tpu_intra_deblock():
    cross_check(streams.intra_mixed_stream(width_mbs=4, height_mbs=3, seed=812, deblock=True)[0])


def test_tpu_inter():
    cross_check(streams.inter_stream(width_mbs=4, height_mbs=3, n_frames=5, seed=813, deblock=True)[0])


def test_tpu_inter_multi_ref():
    cross_check(streams.inter_stream(width_mbs=4, height_mbs=3,
                                     n_frames=6, seed=814,
                                     num_ref_frames=2, multi_ref_idx=True,
                                     deblock=True, mvd_range=50)[0])


def test_tpu_inter_wild_mv():
    # uniform MVs whose reference windows clamp at the picture edge
    # (mvd_range=400 quarter-pel walks MVs far outside the 176x112
    # picture): the padded-plane clip must reproduce FillBlock exactly
    cross_check(streams.inter_stream(width_mbs=11, height_mbs=7,
                                     n_frames=6, seed=20260821,
                                     deblock=True, mvd_range=400,
                                     num_ref_frames=2,
                                     multi_ref_idx=True)[0])


def test_tpu_inter_wild_mv_small():
    # second geometry for the clamped-uniform class (5x4 MBs, wilder MVs)
    cross_check(streams.inter_stream(width_mbs=5, height_mbs=4,
                                     n_frames=5, seed=818,
                                     deblock=True, mvd_range=700)[0])


def test_tpu_4k_shape():
    # 16:9 picture with ODD MB height (the 4K 240x135 grid's shape
    # class: an odd-height wavefront). The full-size 4K stream is
    # checked by chip_smoke.py on the GPU.
    cross_check(streams.inter_stream(width_mbs=16, height_mbs=9,
                                     n_frames=4, seed=819,
                                     deblock=True, mvd_range=120)[0])


def test_tpu_multislice():
    cross_check(streams.multislice_stream(width_mbs=4, height_mbs=3,
                                          seed=815, deblock_idc=0,
                                          alpha_off=2, beta_off=-2)[0])


def test_tpu_fmo():
    cross_check(streams.fmo_stream(map_type=1, width_mbs=4, height_mbs=3, seed=816)[0])

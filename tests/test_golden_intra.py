"""End-to-end golden tests: this decoder (CPU backend) vs the
reference decoder on generated streams (bit-exact YUV)."""

import os
import sys

import pytest

import streams
from conftest import run_oracle

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from broadway_tpu.core.decoder import Decoder  # noqa: E402


def golden_compare(tmp_path, dectest, data, name):
    sp = os.path.join(str(tmp_path), name + ".h264")
    op = os.path.join(str(tmp_path), name + ".yuv")
    with open(sp, "wb") as f:
        f.write(data)
    golden, log = run_oracle(dectest, sp, op)

    dec = Decoder()
    outs = dec.decode_annexb(data)
    mine = b"".join(o.frame.tobytes() for o in outs)
    assert len(mine) == len(golden), \
        f"frame count mismatch: mine={len(mine)} golden={len(golden)}\n{log}"
    if mine != golden:
        # locate first differing frame/byte for debugging
        fs = outs[0].width * outs[0].height * 3 // 2
        for i in range(0, len(mine), fs):
            if mine[i:i + fs] != golden[i:i + fs]:
                a = mine[i:i + fs]
                b = golden[i:i + fs]
                off = next(j for j in range(len(a)) if a[j] != b[j])
                raise AssertionError(
                    f"frame {i // fs} differs first at byte {off} "
                    f"(mine={a[off]} golden={b[off]})")
    return outs


def test_ipcm_golden(oracle_dectest, tmp_path):
    data, info = streams.ipcm_stream()
    golden_compare(tmp_path, oracle_dectest, data, "ipcm")


def test_i4x4_golden(oracle_dectest, tmp_path):
    data, info = streams.i4x4_flat_stream()
    golden_compare(tmp_path, oracle_dectest, data, "i4")


def test_i4x4_larger_golden(oracle_dectest, tmp_path):
    data, info = streams.i4x4_flat_stream(width_mbs=6, height_mbs=5,
                                          n_frames=3, seed=11)
    golden_compare(tmp_path, oracle_dectest, data, "i4b")


def test_intra_mixed_golden(oracle_dectest, tmp_path):
    data, info = streams.intra_mixed_stream()
    golden_compare(tmp_path, oracle_dectest, data, "imix")


def test_intra_mixed_qp_extremes(oracle_dectest, tmp_path):
    for qp, seed in ((6, 31), (12, 32), (40, 33), (51, 34), (0, 35)):
        data, info = streams.intra_mixed_stream(width_mbs=3, height_mbs=3,
                                                n_frames=2, seed=seed, qp=qp)
        golden_compare(tmp_path, oracle_dectest, data, f"imixq{qp}")

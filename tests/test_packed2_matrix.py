"""Regression matrix for the compact-v2 fused fast path.

Root cause being pinned: when the v2 unpack's
bitcast/scatter chains fused INTO the deblock boundary-strength compare
chain inside decode_picture_packed2's single jit, XLA miscompiled the
internal copy of bs_left (one MB's left-edge strengths dropped to 0 —
wrong chroma pixels on legal streams) even though the identical values
exported as jit outputs were bit-correct. Fixed by an
optimization_barrier between unpack and consumers (core/recon_tpu.py).

These tests run the DEFAULT device path (packed v2) against both the
v1 packed path and the CPU oracle, end-to-end over the matrix:
deblock offsets x idc x FMO x multi-ref.
Oracle semantics: /root/reference/Decoder/src/h264bsd_deblocking.c:574
(bS + threshold derivation 636-1530) via the golden-validated CPU
backend.
"""

import os

import pytest

import streams
from broadway_tpu.core.decoder import Decoder


def _decode(data, backend, pack_v1=False):
    old = os.environ.get("BW_PACK_V1")
    try:
        if pack_v1:
            os.environ["BW_PACK_V1"] = "1"
        else:
            os.environ.pop("BW_PACK_V1", None)
        return [p.frame.tobytes()
                for p in Decoder(backend=backend).decode_annexb(data)]
    finally:
        if old is None:
            os.environ.pop("BW_PACK_V1", None)
        else:
            os.environ["BW_PACK_V1"] = old


def _cross(data):
    cpu = _decode(data, "cpu")
    v2 = _decode(data, "device")
    v1 = _decode(data, "device", pack_v1=True)
    assert len(cpu) == len(v2) == len(v1)
    for i, (a, b, c) in enumerate(zip(cpu, v2, v1)):
        assert b == c, f"frame {i}: packed-v2 differs from packed-v1"
        assert a == b, f"frame {i}: packed-v2 differs from CPU oracle"


@pytest.mark.parametrize("idc,alpha,beta", [
    (0, 2, -2),
    (0, -4, 4),
    (1, 2, -2),   # filtering disabled: offsets must be inert
    (2, 6, -6),   # slice-boundary gating with extreme offsets
    (2, -6, 6),
])
def test_offsets_idc_matrix(idc, alpha, beta):
    _cross(streams.multislice_stream(width_mbs=4, height_mbs=3,
                                     seed=900 + idc * 10 + alpha,
                                     deblock_idc=idc,
                                     alpha_off=alpha, beta_off=beta)[0])


def test_fmo_with_offsets():
    _cross(streams.fmo_stream(map_type=1, width_mbs=4, height_mbs=3,
                              seed=917)[0])


def test_multi_ref_with_offsets():
    _cross(streams.inter_stream(width_mbs=4, height_mbs=3, n_frames=6,
                                seed=918, num_ref_frames=2,
                                multi_ref_idx=True, deblock=True,
                                mvd_range=50)[0])

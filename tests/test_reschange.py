"""Mid-stream resolution change + EOS drain conformance (round-3
VERDICT ask #7; reference analogue: SoftAVC's port-settings-change on
resolution events and EOS output drain, SoftAVC.cpp:289/:536, and the
engine's SPS re-activation h264bsd_storage.c:298).

The reference decoder (oracle binary) decodes a stream whose SPS
changes dimensions at an IDR and emits every picture of both
sequences; both our backends must match it byte-for-byte — on the device
path this exercises re-activation through the cached packed layouts
and persistent device DPB stacks (core/decoder.py _ensure_stacks
keying)."""

import os

import pytest

import streams
from broadway_tpu.core.decoder import Decoder
from conftest import run_oracle


def _oracle(tmp_path, dectest, data, name):
    sp = os.path.join(str(tmp_path), name + ".h264")
    op = os.path.join(str(tmp_path), name + ".yuv")
    with open(sp, "wb") as f:
        f.write(data)
    return run_oracle(dectest, sp, op)[0]


def _res_change_stream():
    a, _ = streams.inter_stream(width_mbs=4, height_mbs=3, n_frames=3,
                                seed=61, deblock=True)
    b, _ = streams.inter_stream(width_mbs=6, height_mbs=5, n_frames=3,
                                seed=62, deblock=True)
    return a + b


@pytest.mark.parametrize("backend", ["cpu", "device"])
def test_resolution_change_at_idr(backend, oracle_dectest, tmp_path):
    data = _res_change_stream()
    ref = _oracle(tmp_path, oracle_dectest, data, "rc")
    outs = Decoder(backend=backend).decode_annexb(data)
    assert len(outs) == 6
    assert (outs[0].width, outs[0].height) == (64, 48)
    assert (outs[3].width, outs[3].height) == (96, 80)
    got = b"".join(o.frame.tobytes() for o in outs)
    assert got == ref


@pytest.mark.parametrize("backend", ["cpu", "device"])
def test_eos_drain_reordered(backend, oracle_dectest, tmp_path):
    """Pictures buffered for display reordering must be emitted by the
    EOS flush (h264bsd_decoder.c:750 flushBuffer -> flushDpb), in the
    same order the oracle writes them."""
    data, _ = streams.poc_reorder_stream(poc_type=0, width_mbs=4,
                                         height_mbs=3)
    ref = _oracle(tmp_path, oracle_dectest, data, "drain")
    d = Decoder(backend=backend)
    undrained = d.decode_annexb(data, flush=False)
    d.flush()
    drained = d.outputs
    assert len(drained) > 0, "EOS flush emitted nothing — stream " \
        "does not exercise reorder buffering"
    got = b"".join(o.frame.tobytes() for o in undrained + drained)
    assert got == ref


def test_resolution_change_then_eos_drain(oracle_dectest, tmp_path):
    """Both behaviors composed: change resolution at IDR, end the
    stream with pictures still buffered; flush must drain them at the
    new resolution."""
    a, _ = streams.inter_stream(width_mbs=4, height_mbs=3, n_frames=2,
                                seed=63, deblock=True)
    b, _ = streams.poc_reorder_stream(poc_type=0, width_mbs=6,
                                      height_mbs=4)
    data = a + b
    ref = _oracle(tmp_path, oracle_dectest, data, "rcdrain")
    for backend in ("cpu", "device"):
        outs = Decoder(backend=backend).decode_annexb(data)
        got = b"".join(o.frame.tobytes() for o in outs)
        assert got == ref, backend

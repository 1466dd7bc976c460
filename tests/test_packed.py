"""Packed single-upload path (core/packed.py + native bw_pack_picture):
the device-side unpack must reproduce host_picture_arrays bit-for-bit,
and the packed end-to-end decode must stay golden vs the C oracle."""

import numpy as np
import pytest

import streams
from broadway_tpu.bitstream import native as nat


def _collect_pics(data):
    """Parse a stream (native front-end), collecting each finished
    picture's PictureData + active PPS without reconstructing."""
    import broadway_tpu.core.decoder as DEC

    pics = []

    def collect(dec, pic):
        pics.append((pic, dec.pps))
        return DEC.SKIP_RECON

    d = DEC.Decoder(backend="cpu", recon_strategy=collect)
    d.decode_annexb(data)
    return pics


STREAMS = {
    "inter": lambda: streams.inter_stream(width_mbs=6, height_mbs=5,
                                          n_frames=4, seed=42,
                                          deblock=True, mvd_range=30)[0],
    "ipcm": lambda: streams.ipcm_stream(width_mbs=4, height_mbs=3,
                                        n_frames=3, seed=7)[0],
    "intra": lambda: streams.intra_mixed_stream(width_mbs=5, height_mbs=4,
                                                n_frames=3, seed=21)[0],
    "multislice": lambda: streams.multislice_stream(width_mbs=5,
                                                    height_mbs=4,
                                                    n_frames=4,
                                                    seed=201)[0],
}


@pytest.mark.skipif(not nat.pack_available(), reason="native packer absent")
@pytest.mark.parametrize("name", sorted(STREAMS))
def test_unpack_matches_host_arrays(name):
    import jax

    from broadway_tpu.core import packed as PK
    from broadway_tpu.core import recon_tpu as RT

    data = STREAMS[name]()
    pics = _collect_pics(data)
    assert pics
    for pic, pps in pics:
        lay = PK.get_packed_layout(pic.width_mbs, pic.height_mbs)
        scratch = PK.PackScratch(lay)
        buf, kb = PK.pack_picture(pic, lay, scratch)

        cqo = pps.chroma_qp_index_offset
        ci = pps.constrained_intra_pred
        got = jax.jit(
            lambda b: PK.unpack_arrs(b, lay, kb, ci, cqo))(buf)
        want = RT.host_picture_arrays(pic, cqo, ci)
        assert set(got) == set(want)
        for k in want:
            g = np.asarray(got[k]).astype(np.int64)
            w = np.asarray(want[k]).astype(np.int64)
            assert g.shape == w.shape, (name, k, g.shape, w.shape)
            assert np.array_equal(g, w), (
                name, k, np.argwhere(g != w)[:4])


@pytest.mark.skipif(not nat.pack2_available(),
                    reason="native v2 packer absent")
@pytest.mark.parametrize("name", sorted(STREAMS))
def test_unpack_v2_matches_host_arrays(name):
    """The COMPACT (v2) upload format must reproduce host_picture_arrays
    bit-for-bit — except total_coeff, where only tc>0 is shipped (the
    pipeline only tests > 0, for deblock boundary strengths)."""
    import jax

    from broadway_tpu.core import packed as PK
    from broadway_tpu.core import recon_tpu as RT

    data = STREAMS[name]()
    pics = _collect_pics(data)
    assert pics
    for pic, pps in pics:
        lay = PK.get_packed_layout_v2(pic.width_mbs, pic.height_mbs)
        scratch = PK.PackScratchV2(lay)
        buf, bk = PK.pack_picture_v2(pic, lay, scratch)

        cqo = pps.chroma_qp_index_offset
        ci = pps.constrained_intra_pred
        got = jax.jit(
            lambda b: PK.unpack_arrs_v2(b, lay, bk, ci, cqo))(buf)
        want = RT.host_picture_arrays(pic, cqo, ci)
        assert set(got) == set(want)
        for k in want:
            g = np.asarray(got[k]).astype(np.int64)
            w = np.asarray(want[k]).astype(np.int64)
            if k == "total_coeff":
                g, w = g > 0, w > 0
            assert g.shape == w.shape, (name, k, g.shape, w.shape)
            assert np.array_equal(g, w), (
                name, k, np.argwhere(g != w)[:4])


@pytest.mark.skipif(not nat.pack_available(), reason="native packer absent")
def test_packed_e2e_golden(tmp_path, oracle_dectest):
    """End-to-end device-backend decode through the packed path vs
    oracle."""
    import jax

    from conftest import run_oracle
    from broadway_tpu.core.decoder import Decoder

    data, _ = streams.inter_stream(width_mbs=5, height_mbs=4, n_frames=5,
                                   seed=99, deblock=True, mvd_range=25)
    sp = tmp_path / "s.h264"
    sp.write_bytes(data)
    ref, _ = run_oracle(oracle_dectest, str(sp), str(tmp_path / "ref.yuv"))

    d = Decoder(backend="device")
    out = b"".join(o.frame.tobytes() for o in d.decode_annexb(data))
    assert out == ref

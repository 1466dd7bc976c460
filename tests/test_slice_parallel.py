"""Slice-parallel sharded decode on a virtual CPU mesh vs single-chip."""

import numpy as np
import pytest

import streams


def test_sliced_decode_matches_single():
    import jax
    cpus = jax.devices("cpu")
    if len(cpus) < 4:
        pytest.skip("need 4 virtual cpu devices")
    from jax.sharding import Mesh
    from broadway_tpu.core.decoder import Decoder
    from broadway_tpu.parallel.slices import decode_stream_sliced

    data, _ = streams.banded_stream(n_bands=4, height_mbs=4, n_frames=3,
                                    seed=702)
    want = [o.frame.tobytes() for o in Decoder().decode_annexb(data)]
    mesh = Mesh(np.array(cpus[:4]), ("sp",))
    got = decode_stream_sliced(data, mesh, n_bands=4)
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a == b, f"frame {i} differs"


def test_sliced_decode_cross_deblock_idc0():
    """idc 0 (the real-world default): deblocking crosses slice
    boundaries -> the chained ppermute-halo deblock must be bit-exact
    (reference semantics h264bsd_deblocking.c:574-637: full-picture
    raster filtering across slice boundaries)."""
    import jax
    cpus = jax.devices("cpu")
    if len(cpus) < 4:
        pytest.skip("need 4 virtual cpu devices")
    from jax.sharding import Mesh
    from broadway_tpu.core.decoder import Decoder
    from broadway_tpu.parallel.slices import decode_stream_sliced

    data, _ = streams.banded_stream(n_bands=4, height_mbs=8, n_frames=3,
                                    seed=703, deblock_idc=0)
    want = [o.frame.tobytes() for o in Decoder().decode_annexb(data)]
    mesh = Mesh(np.array(cpus[:4]), ("sp",))
    got = decode_stream_sliced(data, mesh, n_bands=4)
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a == b, f"frame {i} differs"


def test_sliced_decode_unaligned_falls_back():
    """Slices that don't align with bands must not crash: the sliced
    path declines per picture and the built-in backend reconstructs."""
    import jax
    cpus = jax.devices("cpu")
    if len(cpus) < 4:
        pytest.skip("need 4 virtual cpu devices")
    from jax.sharding import Mesh
    from broadway_tpu.core.decoder import Decoder
    from broadway_tpu.parallel.slices import decode_stream_sliced

    # 3 slices over 4 bands / height 6 not divisible by 4
    data, _ = streams.multislice_stream(width_mbs=4, height_mbs=6,
                                        n_frames=2, n_slices=3, seed=704)
    want = [o.frame.tobytes() for o in Decoder().decode_annexb(data)]
    mesh = Mesh(np.array(cpus[:4]), ("sp",))
    got = decode_stream_sliced(data, mesh, n_bands=4)
    assert got == want


def test_sliced_dp_streams_match_single():
    """4 streams, one per dp row of a (4 x 1) mesh: every multi-device
    launch of a round comes from the leader thread (concurrent launches
    from the per-stream threads deadlocked in the collectives)."""
    import jax
    cpus = jax.devices("cpu")
    if len(cpus) < 4:
        pytest.skip("need 4 virtual cpu devices")
    from jax.sharding import Mesh
    from broadway_tpu.core.decoder import Decoder
    from broadway_tpu.parallel.slices import decode_streams_sliced_dp

    datas = [streams.inter_stream(width_mbs=4, height_mbs=3, n_frames=3,
                                  seed=710 + s, deblock=True,
                                  mvd_range=30)[0] for s in range(4)]
    wants = [[o.frame.tobytes() for o in Decoder().decode_annexb(d)]
             for d in datas]
    mesh = Mesh(np.array(cpus[:4]).reshape(4, 1), ("dp", "sp"))
    assert decode_streams_sliced_dp(datas, mesh, n_bands=1) == wants

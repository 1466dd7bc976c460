"""Slice-parallel decode: shard a picture's MB-row bands over a device
mesh — the device analogue of the reference's multi-worker sliceMode
(SURVEY.md §2.5 P2: each Web Worker decodes its own slices, then workers
ring-exchange decoded slice regions to rebuild full reference frames,
Player/Decoder.js:677-727 copySlice).

Here: each device runs the full pixel pipeline on its band (the band's
slices are entropy- and prediction-independent by construction), then an
`all_gather` over the "sp" mesh axis rebuilds full reference frames on
every device — the collective version of copySlice.

Exactness domain: streams whose slices align with the bands.
 - idc in {1, 2}: bands deblock independently (no filtering across
   slice boundaries) — the same independence Broadway's sliceMode
   relies on. One all_gather rebuilds full frames.
 - idc 0 (the default): deblocking crosses slice boundaries AND is
   order-sequential — the reference filters the picture in raster order
   (h264bsd_deblocking.c:574-637) and every filtered edge feeds the
   next edge's input, so boundary changes cascade downward through the
   whole picture. The bit-exact sharded form is therefore a CHAIN: band
   k deblocks only after receiving band k-1's final bottom MB row
   (pixels) via `ppermute` — the collective version of sliceMode's copySlice
   ring (Player/Decoder.js:677-727) with deblock-order semantics.
   Reconstruction (stages 1-4) still runs fully parallel across bands;
   only the deblock stage serializes, matching the reference's own
   sequential semantics.
"""

from __future__ import annotations

import functools
from typing import Dict, List

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core import recon_tpu as RT
from ..bitstream.mb_layer import PictureData


def band_host_arrays(pic: PictureData, n_bands: int, chroma_qp_offset: int,
                     constrained_intra: bool) -> Dict[str, np.ndarray]:
    """Stacked per-band packed arrays [n_bands, S_band, LS, ...]."""
    h = pic.height_mbs
    assert h % n_bands == 0, "height_mbs must divide into equal bands"
    hb = h // n_bands
    per = [RT.host_picture_arrays(pic, chroma_qp_offset, constrained_intra,
                                  band=(b * hb, hb))
           for b in range(n_bands)]
    return {k: np.stack([p[k] for p in per]) for k in per[0]}


def band_host_arrays_ghost(pic: PictureData, n_bands: int,
                           chroma_qp_offset: int,
                           constrained_intra: bool) -> Dict[str, np.ndarray]:
    """Stacked per-band arrays with a GHOST MB row prepended: entry k
    holds MB rows [k*hb - 1, (k+1)*hb) of the full picture ((hb+1) rows;
    band 0 gets an all-disabled dummy row). The ghost row carries the
    up-neighbour metadata for the cross-band deblock edge; its own
    deblock flags are forced off so band k never re-filters band k-1's
    interior edges."""
    h, w = pic.height_mbs, pic.width_mbs
    assert h % n_bands == 0, "height_mbs must divide into equal bands"
    hb = h // n_bands
    full = RT.host_picture_arrays(pic, chroma_qp_offset, constrained_intra)
    out = {}
    for k, v in full.items():
        if k == "whole_conceal":
            out[k] = np.broadcast_to(v, (n_bands,)).copy()
            continue
        g = v.reshape((h * w,) + v.shape[1:])
        bands = []
        for b in range(n_bands):
            lo = b * hb * w
            ghost = g[lo - w:lo] if b > 0 else np.zeros_like(g[:w])
            bands.append(np.concatenate([ghost, g[lo:lo + hb * w]]))
        out[k] = np.stack(bands)
    # ghost row: only the row-1 top edge may touch it
    for k in ("enable", "FT", "FL"):
        out[k][:, :w] = False
    return out


def _plane_to_blocks(pl: jnp.ndarray, mb: int) -> jnp.ndarray:
    """[h*mb, w*mb] raster plane -> [h*w, mb, mb] MB blocks."""
    h, w = pl.shape[0] // mb, pl.shape[1] // mb
    return pl.reshape(h, mb, w, mb).transpose(0, 2, 1, 3) \
        .reshape(h * w, mb, mb)


def _deblock_band_ghost(y, cb, cr, gy, gcb, gcr, parrs, steps_g,
                        w_mbs: int, hb_mbs: int):
    """Deblock one band given the up-neighbour halo: ghost pixel MB row
    (gy [16,W], gcb/gcr [8,W/2]) + (hb+1)-row packed metadata `parrs`.
    Returns (band planes, modified ghost rows)."""
    lay_g = RT.get_layout(w_mbs, hb_mbs + 1)
    Yg = lay_g.pack_dev(_plane_to_blocks(
        jnp.concatenate([gy, y], axis=0), 16))
    CBg = lay_g.pack_dev(_plane_to_blocks(
        jnp.concatenate([gcb, cb], axis=0), 8))
    CRg = lay_g.pack_dev(_plane_to_blocks(
        jnp.concatenate([gcr, cr], axis=0), 8))
    Yg, CBg, CRg = RT.deblock_scan(Yg, CBg, CRg, parrs, steps_g)
    fy = RT._unpack_to_plane(Yg, lay_g, 16)
    fcb = RT._unpack_to_plane(CBg, lay_g, 8)
    fcr = RT._unpack_to_plane(CRg, lay_g, 8)
    return (fy[16:], fcb[8:], fcr[8:],
            fy[:16], fcb[:8], fcr[:8])


def _sliced_x_body(garrs, ref_y, ref_c, steps, steps_g,
                   w_mbs, hb_mbs, chroma_qp_offset,
                   axis: str, h_mbs_full: int, n_bands: int):
    """Shared idc-0 band body (inside shard_map): parallel band
    reconstruction, then the chained band deblock with ppermute halos.
    garrs: THIS band's ghost-augmented arrays ((hb+1)*w MBs, row 0 =
    ghost)."""
    band = jax.lax.axis_index(axis)
    w = w_mbs
    # recon arrays = ghost bundle minus the ghost row
    rarrs = {k: (v if k == "whole_conceal" else v[w:])
             for k, v in garrs.items()}
    y, cb, cr = RT.decode_picture_impl(
        rarrs, ref_y, ref_c, steps,
        w_mbs=w_mbs, h_mbs=hb_mbs, chroma_qp_offset=chroma_qp_offset,
        mb0=band * hb_mbs * w_mbs, ref_h_mbs=h_mbs_full,
        run_stages=2)                      # stages 1-4, no deblock yet

    # packed (hb+1)-row metadata for the ghost deblock
    lay_g = RT.get_layout(w_mbs, hb_mbs + 1)
    parrs = {k: lay_g.pack_dev(garrs[k]) for k in
             ("total_coeff", "mv", "ref_blk", "is_inter", "FT", "FL",
              "enable", "qp", "offA", "offB", "chroma_off_mb")}

    W, Wc = w_mbs * 16, w_mbs * 8
    perm = [(i, i + 1) for i in range(n_bands - 1)]

    def chain_step(s, carry):
        (ghy, ghcb, ghcr, oy, ocb, ocr, my, mcb, mcr) = carry
        dy, dcb, dcr, gy2, gcb2, gcr2 = _deblock_band_ghost(
            y, cb, cr, ghy, ghcb, ghcr, parrs, steps_g, w_mbs, hb_mbs)
        mine = band == s
        oy = jnp.where(mine, dy, oy)
        ocb = jnp.where(mine, dcb, ocb)
        ocr = jnp.where(mine, dcr, ocr)
        my = jnp.where(mine, gy2, my)
        mcb = jnp.where(mine, gcb2, mcb)
        mcr = jnp.where(mine, gcr2, mcr)
        # halo: my final bottom MB row -> next band (copySlice)
        ghy = jax.lax.ppermute(oy[-16:], axis, perm)
        ghcb = jax.lax.ppermute(ocb[-8:], axis, perm)
        ghcr = jax.lax.ppermute(ocr[-8:], axis, perm)
        return (ghy, ghcb, ghcr, oy, ocb, ocr, my, mcb, mcr)

    z = jnp.zeros
    carry = (z((16, W), y.dtype), z((8, Wc), y.dtype), z((8, Wc), y.dtype),
             y, cb, cr,
             z((16, W), y.dtype), z((8, Wc), y.dtype), z((8, Wc), y.dtype))
    carry = jax.lax.fori_loop(0, n_bands, chain_step, carry)
    _, _, _, oy, ocb, ocr, my, mcb, mcr = carry

    # rebuild full planes; band k's modified ghost row overwrites the
    # bottom MB row of band k-1 (its rows 13..15 changed)
    fy = jax.lax.all_gather(oy, axis)          # [n_bands, Hb, W]
    fcb = jax.lax.all_gather(ocb, axis)
    fcr = jax.lax.all_gather(ocr, axis)
    gmy = jax.lax.all_gather(my, axis)         # [n_bands, 16, W]
    gmcb = jax.lax.all_gather(mcb, axis)
    gmcr = jax.lax.all_gather(mcr, axis)
    Hb, Hbc = hb_mbs * 16, hb_mbs * 8
    fy = fy.reshape(n_bands * Hb, W)
    fcb = fcb.reshape(n_bands * Hbc, Wc)
    fcr = fcr.reshape(n_bands * Hbc, Wc)
    for k in range(1, n_bands):
        fy = jax.lax.dynamic_update_slice(fy, gmy[k], (k * Hb - 16, 0))
        fcb = jax.lax.dynamic_update_slice(fcb, gmcb[k], (k * Hbc - 8, 0))
        fcr = jax.lax.dynamic_update_slice(fcr, gmcr[k], (k * Hbc - 8, 0))
    return fy, fcb, fcr


def decode_picture_sliced_x_impl(garrs, ref_y, ref_c, steps, steps_g,
                                 w_mbs, hb_mbs, chroma_qp_offset,
                                 axis: str = "sp",
                                 h_mbs_full: int = None,
                                 n_bands: int = 1):
    """shard_map body, idc 0, fat-host-array upload (leading axis
    sharded over `axis`)."""
    garrs = jax.tree_util.tree_map(lambda x: x[0], garrs)
    return _sliced_x_body(garrs, ref_y, ref_c, steps, steps_g, w_mbs,
                          hb_mbs, chroma_qp_offset, axis,
                          h_mbs_full, n_bands)


def _cut_band_ghost_v2(arrs, band, w, hb_mbs):
    """Slice one band's ghost-augmented MB rows out of a full-picture
    v2-unpacked bundle ON DEVICE (the v2 twin of band_host_arrays_ghost
    minus the host banding): rows [band*hb - 1, (band+1)*hb), band 0's
    ghost row zeroed; the ghost row's deblock flags forced off so the
    band never re-filters its up-neighbour's interior edges."""
    nb = hb_mbs * w
    out = {}
    for k, v in arrs.items():
        if k == "whole_conceal":
            out[k] = v
            continue
        own = jax.lax.dynamic_slice_in_dim(v, band * nb, nb, axis=0)
        gh = jax.lax.dynamic_slice_in_dim(
            v, jnp.maximum(band * nb - w, 0), w, axis=0)
        gh = jnp.where(
            jnp.reshape(band > 0, (1,) * v.ndim), gh,
            jnp.zeros_like(gh))
        if k in ("enable", "FT", "FL"):
            gh = jnp.zeros_like(gh)
        out[k] = jnp.concatenate([gh, own], axis=0)
    return out


def decode_picture_sliced_x_v2_impl(buf, ref_y, ref_c, steps, steps_g,
                                    lay, bk, w_mbs, hb_mbs,
                                    constrained_intra,
                                    chroma_qp_offset,
                                    axis: str = "sp",
                                    h_mbs_full: int = None,
                                    n_bands: int = 1):
    """shard_map body, idc 0, COMPACT v2 upload: the picture's single
    packed buffer is replicated over sp (~0.6 MB at 1080p instead of
    the fat stacked int32 ghost bundles); each band unpacks on device
    and cuts its own ghost-augmented rows."""
    from ..core.packed import unpack_arrs_v2

    band = jax.lax.axis_index(axis)
    arrs = unpack_arrs_v2(buf, lay, bk, constrained_intra,
                          chroma_qp_offset)
    arrs = jax.lax.optimization_barrier(arrs)   # see recon_tpu note
    garrs = _cut_band_ghost_v2(arrs, band, w_mbs, hb_mbs)
    return _sliced_x_body(garrs, ref_y, ref_c, steps, steps_g, w_mbs,
                          hb_mbs, chroma_qp_offset, axis,
                          h_mbs_full, n_bands)


def make_sliced_decoder_x_v2(mesh: Mesh, w_mbs: int, h_mbs: int,
                             n_bands: int, constrained_intra: bool,
                             chroma_qp_offset: int, lay, bk,
                             axis: str = "sp"):
    """idc-0 band-sharded decoder with compact v2 upload:
    jitted fn(buf [size] u8, ref_y, ref_c, steps, steps_g) -> planes."""
    from jax import shard_map

    hb = h_mbs // n_bands
    fn = functools.partial(decode_picture_sliced_x_v2_impl,
                           lay=lay, bk=bk, w_mbs=w_mbs, hb_mbs=hb,
                           constrained_intra=constrained_intra,
                           chroma_qp_offset=chroma_qp_offset,
                           axis=axis, h_mbs_full=h_mbs, n_bands=n_bands)
    sharded = shard_map(
        fn, mesh=mesh,
        in_specs=(P(), P(), P(), P(), P()),
        out_specs=(P(), P(), P()), check_vma=False)
    return jax.jit(sharded)


def decode_picture_sliced_v2_impl(buf, ref_y, ref_c, steps,
                                  lay, bk, w_mbs, hb_mbs,
                                  constrained_intra, chroma_qp_offset,
                                  axis: str = "sp",
                                  h_mbs_full: int = None,
                                  gather: bool = True):
    """shard_map body, idc 1/2 (independent bands), COMPACT v2 upload.
    gather=False skips the reference-rebuild all_gather and returns
    band-local planes — the measurement twin used to split per-chip
    compute time from collective time."""
    from ..core.packed import unpack_arrs_v2

    band = jax.lax.axis_index(axis)
    arrs = unpack_arrs_v2(buf, lay, bk, constrained_intra,
                          chroma_qp_offset)
    arrs = jax.lax.optimization_barrier(arrs)
    nb = hb_mbs * w_mbs
    arrs = {k: (v if k == "whole_conceal"
                else jax.lax.dynamic_slice_in_dim(v, band * nb, nb,
                                                  axis=0))
            for k, v in arrs.items()}
    y, cb, cr = RT.decode_picture_impl(
        arrs, ref_y, ref_c, steps,
        w_mbs=w_mbs, h_mbs=hb_mbs, chroma_qp_offset=chroma_qp_offset,
        mb0=band * nb, ref_h_mbs=h_mbs_full)
    if not gather:
        return y[None], cb[None], cr[None]
    fy = jax.lax.all_gather(y, axis)
    fcb = jax.lax.all_gather(cb, axis)
    fcr = jax.lax.all_gather(cr, axis)
    H = fy.shape[0] * fy.shape[1]
    return (fy.reshape(H, -1), fcb.reshape(H // 2, -1),
            fcr.reshape(H // 2, -1))


def make_sliced_decoder_v2(mesh: Mesh, w_mbs: int, h_mbs: int,
                           n_bands: int, constrained_intra: bool,
                           chroma_qp_offset: int, lay, bk,
                           axis: str = "sp", gather: bool = True):
    """Independent-band decoder (idc 1/2) with compact v2 upload:
    jitted fn(buf [size] u8, ref_y, ref_c, steps) -> full planes
    (gather=False: band-sharded planes, no collective)."""
    from jax import shard_map

    hb = h_mbs // n_bands
    fn = functools.partial(decode_picture_sliced_v2_impl,
                           lay=lay, bk=bk, w_mbs=w_mbs, hb_mbs=hb,
                           constrained_intra=constrained_intra,
                           chroma_qp_offset=chroma_qp_offset,
                           axis=axis, h_mbs_full=h_mbs, gather=gather)
    sharded = shard_map(
        fn, mesh=mesh,
        in_specs=(P(), P(), P(), P()),
        out_specs=((P(), P(), P()) if gather
                   else (P(axis), P(axis), P(axis))), check_vma=False)
    return jax.jit(sharded)


def make_sliced_decoder_x(mesh: Mesh, w_mbs: int, h_mbs: int,
                          n_bands: int, chroma_qp_offset: int,
                          axis: str = "sp"):
    """Cross-slice-deblocking (idc 0) band-sharded decoder:
    jitted fn(ghost_arrs, ref_y, ref_c, steps, steps_g) -> full planes."""
    from jax import shard_map

    hb = h_mbs // n_bands
    fn = functools.partial(decode_picture_sliced_x_impl, w_mbs=w_mbs,
                           hb_mbs=hb, chroma_qp_offset=chroma_qp_offset,
                           axis=axis, h_mbs_full=h_mbs, n_bands=n_bands)
    sharded = shard_map(
        fn, mesh=mesh,
        in_specs=(P(axis), P(), P(), P(), P()),
        out_specs=(P(), P(), P()), check_vma=False)
    return jax.jit(sharded)


def decode_picture_sliced_impl(barrs, ref_y, ref_c, steps,
                               w_mbs, hb_mbs, chroma_qp_offset,
                               axis: str = "sp",
                               h_mbs_full: int = None):
    """shard_map body: decode own band, all-gather to full planes."""
    band = jax.lax.axis_index(axis)
    y, cb, cr = RT.decode_picture_impl(
        jax.tree_util.tree_map(lambda x: x[0], barrs),
        ref_y, ref_c, steps,
        w_mbs=w_mbs, h_mbs=hb_mbs, chroma_qp_offset=chroma_qp_offset,
        mb0=band * hb_mbs * w_mbs, ref_h_mbs=h_mbs_full)
    # copySlice: every device receives every band
    fy = jax.lax.all_gather(y, axis)        # [n_bands, Hb, W]
    fcb = jax.lax.all_gather(cb, axis)
    fcr = jax.lax.all_gather(cr, axis)
    H = fy.shape[0] * fy.shape[1]
    return (fy.reshape(H, -1), fcb.reshape(H // 2, -1),
            fcr.reshape(H // 2, -1))


def make_sliced_decoder(mesh: Mesh, w_mbs: int, h_mbs: int, n_bands: int,
                        chroma_qp_offset: int, axis: str = "sp"):
    """Returns jitted fn(banded_arrs, ref_y, ref_c, steps) ->
    full-frame planes (replicated)."""
    from jax import shard_map

    hb = h_mbs // n_bands

    fn = functools.partial(decode_picture_sliced_impl, w_mbs=w_mbs,
                           hb_mbs=hb, chroma_qp_offset=chroma_qp_offset,
                           axis=axis, h_mbs_full=h_mbs)
    sharded = shard_map(
        fn, mesh=mesh,
        in_specs=(P(axis), P(), P(), P()),
        out_specs=(P(), P(), P()), check_vma=False)
    return jax.jit(sharded)


def decode_picture_sliced2d_impl(barrs, ref_y, ref_c, steps,
                                 w_mbs, hb_mbs, chroma_qp_offset,
                                 dp_axis: str = "dp", sp_axis: str = "sp",
                                 h_mbs_full: int = None):
    """shard_map body over a 2-D (dp x sp) mesh: dp shards independent
    STREAMS (the multi-host analogue — no cross-stream comm at all),
    sp shards each picture's MB-row bands (an all_gather rebuilds full
    reference frames per stream)."""
    band = jax.lax.axis_index(sp_axis)
    arrs = jax.tree_util.tree_map(lambda x: x[0, 0], barrs)
    y, cb, cr = RT.decode_picture_impl(
        arrs, ref_y[0], ref_c[0], steps,
        w_mbs=w_mbs, h_mbs=hb_mbs, chroma_qp_offset=chroma_qp_offset,
        mb0=band * hb_mbs * w_mbs, ref_h_mbs=h_mbs_full)
    # copySlice within the stream; nothing crosses dp rows
    fy = jax.lax.all_gather(y, sp_axis)
    fcb = jax.lax.all_gather(cb, sp_axis)
    fcr = jax.lax.all_gather(cr, sp_axis)
    H = fy.shape[0] * fy.shape[1]
    return (fy.reshape(H, -1)[None], fcb.reshape(H // 2, -1)[None],
            fcr.reshape(H // 2, -1)[None])


def make_sliced_decoder_2d(mesh: Mesh, w_mbs: int, h_mbs: int,
                           n_bands: int, chroma_qp_offset: int,
                           dp_axis: str = "dp", sp_axis: str = "sp"):
    """jitted fn(banded_arrs [S, n_bands, ...], ref_y [S, ...],
    ref_c [S, ...], steps) -> full planes [S, H, W] (dp-sharded)."""
    from jax import shard_map

    hb = h_mbs // n_bands
    fn = functools.partial(decode_picture_sliced2d_impl, w_mbs=w_mbs,
                           hb_mbs=hb, chroma_qp_offset=chroma_qp_offset,
                           dp_axis=dp_axis, sp_axis=sp_axis,
                           h_mbs_full=h_mbs)
    sharded = shard_map(
        fn, mesh=mesh,
        in_specs=(P(dp_axis, sp_axis), P(dp_axis), P(dp_axis), P()),
        out_specs=(P(dp_axis), P(dp_axis), P(dp_axis)), check_vma=False)
    return jax.jit(sharded)


def decode_picture_sliced2d_v2_impl(bufs, ref_y, ref_c, steps,
                                    lay, bk, w_mbs, hb_mbs,
                                    constrained_intra,
                                    chroma_qp_offset,
                                    dp_axis: str = "dp",
                                    sp_axis: str = "sp",
                                    h_mbs_full: int = None):
    """shard_map body over a 2-D (dp x sp) mesh with COMPACT v2
    uploads: each dp row receives its stream's single packed buffer
    (replicated over sp — ~0.6 MB instead of the fat stacked int32
    band bundles), unpacks it on device, and slices out its own band's
    MB rows. Availability/deblock flags come out of the unpack
    computed from the full-picture slice ids, so cross-band gating is
    identical to the host banding path."""
    from ..core.packed import unpack_arrs_v2

    band = jax.lax.axis_index(sp_axis)
    buf = bufs[0]           # local dp shard: [1, size] u8
    arrs = unpack_arrs_v2(buf, lay, bk, constrained_intra,
                          chroma_qp_offset)
    arrs = jax.lax.optimization_barrier(arrs)   # see recon_tpu note
    w = w_mbs
    nb = hb_mbs * w

    def cut(v):
        return jax.lax.dynamic_slice_in_dim(v, band * nb, nb, axis=0)

    arrs = {k: (v if k == "whole_conceal" else cut(v))
            for k, v in arrs.items()}
    y, cb, cr = RT.decode_picture_impl(
        arrs, ref_y[0], ref_c[0], steps,
        w_mbs=w_mbs, h_mbs=hb_mbs, chroma_qp_offset=chroma_qp_offset,
        mb0=band * nb, ref_h_mbs=h_mbs_full)
    fy = jax.lax.all_gather(y, sp_axis)
    fcb = jax.lax.all_gather(cb, sp_axis)
    fcr = jax.lax.all_gather(cr, sp_axis)
    H = fy.shape[0] * fy.shape[1]
    return (fy.reshape(H, -1)[None], fcb.reshape(H // 2, -1)[None],
            fcr.reshape(H // 2, -1)[None])


def make_sliced_decoder_2d_v2(mesh: Mesh, w_mbs: int, h_mbs: int,
                              n_bands: int, constrained_intra: bool,
                              chroma_qp_offset: int, lay, bk,
                              dp_axis: str = "dp", sp_axis: str = "sp"):
    """jitted fn(bufs [S, size] u8, ref_y [S,...], ref_c [S,...],
    steps) -> full planes [S, H, W] (dp-sharded), v2 compact upload."""
    from jax import shard_map

    hb = h_mbs // n_bands
    fn = functools.partial(decode_picture_sliced2d_v2_impl,
                           lay=lay, bk=bk, w_mbs=w_mbs, hb_mbs=hb,
                           constrained_intra=constrained_intra,
                           chroma_qp_offset=chroma_qp_offset,
                           dp_axis=dp_axis, sp_axis=sp_axis,
                           h_mbs_full=h_mbs)
    sharded = shard_map(
        fn, mesh=mesh,
        in_specs=(P(dp_axis), P(dp_axis), P(dp_axis), P()),
        out_specs=(P(dp_axis), P(dp_axis), P(dp_axis)), check_vma=False)
    return jax.jit(sharded)


def decode_streams_sliced_dp(datas: List[bytes], mesh: Mesh,
                             n_bands: int) -> List[List[bytes]]:
    """Lockstep end-to-end decode of N same-geometry streams on a 2-D
    (dp x sp) mesh: stream i owns dp row i, its pictures band-sharded
    over sp. The device analogue of the reference's multi-worker,
    multi-player matrix (storyDemo.html) with sliceMode inside each
    player. Returns per-stream display-order YUV bytes; per-axis comm
    volume comes from comm_volume_2d().

    Every device computation of a round (reference stacks, the sharded
    decode, the per-stream output frames) is launched from the leader
    thread: programs that span several devices, launched concurrently
    from several threads, can reach the devices in different orders
    and deadlock in their collectives."""
    import threading

    import broadway_tpu.core.decoder as DEC

    S = len(datas)
    assert S == mesh.shape["dp"], (S, dict(mesh.shape))
    barrier = threading.Barrier(S)
    staging = [None] * S
    results = [None] * S
    decoder_fn = {}
    errors = []

    from ..bitstream import native as nat
    from ..core import packed as PK
    use_v2 = nat.pack2_available()
    scratch = {}

    def make_recon(i):
        def recon(self, pic):
            sps, pps = self.sps, self.pps
            w, h = sps.width_mbs, sps.height_mbs
            refs = (list(self.dpb.buffer), sps.width, sps.height)
            res = None
            if use_v2:
                lay = PK.get_packed_layout_v2(w, h)
                if scratch.get(i) is None or scratch[i].lay is not lay:
                    scratch[i] = PK.PackScratchV2(lay)
                res = PK.pack_picture_v2(pic, lay, scratch[i])
            if res is not None:
                # compact v2 single-buffer upload per stream
                staging[i] = ("v2", res[0], res[1], refs, None, w, h,
                              pps.constrained_intra_pred,
                              pps.chroma_qp_index_offset)
            else:
                barrs = band_host_arrays(pic, n_bands,
                                         pps.chroma_qp_index_offset,
                                         pps.constrained_intra_pred)
                staging[i] = ("v1", barrs, None, refs, None, w, h,
                              pps.constrained_intra_pred,
                              pps.chroma_qp_index_offset)
            barrier.wait()
            if i == 0:
                stacks = [RT.ref_stacks(*staging[s][3]) for s in range(S)]
                sry = jnp.stack([st[0] for st in stacks])
                src = jnp.stack([st[1] for st in stacks])
                steps = {k: jnp.asarray(v)
                         for k, v in RT.step_tables(
                             w, h // n_bands).items()}
                all_v2 = all(staging[s][0] == "v2" for s in range(S))
                if all_v2:
                    lay = PK.get_packed_layout_v2(w, h)
                    BK = tuple(max(staging[s][2][j] for s in range(S))
                               for j in range(3))
                    bufs = jnp.asarray(np.stack(
                        [PK.expand_buf_v2(staging[s][1], lay,
                                          staging[s][2], BK)
                         for s in range(S)]))
                    key = (w, h, "v2", BK)
                    if key not in decoder_fn:
                        decoder_fn[key] = make_sliced_decoder_2d_v2(
                            mesh, w, h, n_bands, staging[0][7],
                            staging[0][8], lay, BK)
                    y, cb, cr = decoder_fn[key](bufs, sry, src, steps)
                else:
                    barrs_all = {k: jnp.stack([staging[s][1][k]
                                               for s in range(S)])
                                 for k in staging[0][1]}
                    key = (w, h, "v1")
                    if key not in decoder_fn:
                        decoder_fn[key] = make_sliced_decoder_2d(
                            mesh, w, h, n_bands, staging[0][8])
                    y, cb, cr = decoder_fn[key](barrs_all, sry, src,
                                                steps)
                for s in range(S):
                    results[s] = RT.DeviceFrame(y[s], cb[s], cr[s])
            barrier.wait()
            return results[i]
        return recon

    outs = [None] * S

    def run(i):
        try:
            dec = DEC.Decoder(backend="cpu", recon_strategy=make_recon(i))
            outs[i] = [o.frame.tobytes()
                       for o in dec.decode_annexb(datas[i])]
        except Exception as e:           # release peers on failure
            errors.append(e)
            barrier.abort()

    threads = [threading.Thread(target=run, args=(i,)) for i in range(S)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return outs


def comm_volume_2d(w_mbs: int, h_mbs: int, n_bands: int,
                   n_streams: int) -> dict:
    """Per-picture communication volume by mesh axis (bytes, int32
    planes): sp carries the band all_gather; dp carries nothing
    (streams are independent — the cross-host-friendly axis)."""
    H, W = h_mbs * 16, w_mbs * 16
    plane = H * W + 2 * (H // 2) * (W // 2)
    gathered = plane * 4 * (n_bands - 1) // n_bands   # recv per chip
    return {"sp_bytes_per_pic_per_chip": gathered,
            "dp_bytes_per_pic": 0,
            "streams": n_streams, "bands": n_bands}


def _bands_aligned(pic: PictureData, n_bands: int) -> bool:
    """True if every slice lies within one MB-row band (the recon
    independence precondition for band sharding)."""
    h, w = pic.height_mbs, pic.width_mbs
    if h % n_bands:
        return False
    hb = h // n_bands
    sid = pic.slice_id.reshape(n_bands, hb * w)
    for b in range(n_bands):
        own = set(np.unique(sid[b]).tolist())
        for b2 in range(n_bands):
            if b2 != b and own & set(np.unique(sid[b2]).tolist()):
                return False
    return True


def decode_stream_sliced(data: bytes, mesh: Mesh, n_bands: int,
                         backend_decoder=None,
                         decoder_cache: dict = None) -> List[bytes]:
    """End-to-end band-sharded decode of an Annex-B stream on `mesh`.
    Returns display-order YUV bytes. Host front-end parses; the pixel
    pipeline runs sharded via the decoder's recon_strategy hook; DPB
    frames stay replicated device arrays.

    Per picture the path is chosen automatically:
      - slices band-aligned, idc in {1,2}: independent band decode
      - slices band-aligned, idc 0: chained deblock with ppermute halos
      - otherwise (unaligned slices / errors): single-device fallback

    decoder_cache: optional dict shared across calls so repeated
    same-geometry streams reuse the jitted sharded programs."""
    import broadway_tpu.core.decoder as DEC
    from ..bitstream import native as nat
    from ..core import packed as PK

    decoder_fn = decoder_cache if decoder_cache is not None else {}
    use_v2 = nat.pack2_available()
    scratch = [None]

    def sliced_recon(self, pic):
        sps, pps = self.sps, self.pps
        w, h = sps.width_mbs, sps.height_mbs
        if not _bands_aligned(pic, n_bands):
            return None                     # decoder falls back
        cross = any(sp.disable_deblocking_idc == 0
                    for sp in pic.slice_params)
        steps = {k: jnp.asarray(v)
                 for k, v in RT.step_tables(w, h // n_bands).items()}
        ref_y, ref_c = RT.ref_stacks(self.dpb.buffer, sps.width,
                                     sps.height)
        res = None
        if use_v2:
            lay = PK.get_packed_layout_v2(w, h)
            if scratch[0] is None or scratch[0].lay is not lay:
                scratch[0] = PK.PackScratchV2(lay)
            res = PK.pack_picture_v2(pic, lay, scratch[0])
        if res is not None:
            # compact v2 single-buffer upload, replicated over sp
            buf, bk = res
            dbuf = jnp.asarray(buf)
            # ci/cqo are baked into the compiled fn as constants — a
            # mid-stream PPS switch must not reuse a stale program
            key = (w, h, cross, "v2", bk, pps.constrained_intra_pred,
                   pps.chroma_qp_index_offset)
            if cross:
                if key not in decoder_fn:
                    decoder_fn[key] = make_sliced_decoder_x_v2(
                        mesh, w, h, n_bands,
                        pps.constrained_intra_pred,
                        pps.chroma_qp_index_offset, lay, bk)
                steps_g = {k: jnp.asarray(v)
                           for k, v in RT.step_tables(
                               w, h // n_bands + 1).items()}
                y, cb, cr = decoder_fn[key](dbuf, ref_y, ref_c, steps,
                                            steps_g)
            else:
                if key not in decoder_fn:
                    decoder_fn[key] = make_sliced_decoder_v2(
                        mesh, w, h, n_bands,
                        pps.constrained_intra_pred,
                        pps.chroma_qp_index_offset, lay, bk)
                y, cb, cr = decoder_fn[key](dbuf, ref_y, ref_c, steps)
            return RT.DeviceFrame(y, cb, cr)
        key = (w, h, cross)
        if cross:
            if key not in decoder_fn:
                decoder_fn[key] = make_sliced_decoder_x(
                    mesh, w, h, n_bands, pps.chroma_qp_index_offset)
            garrs = band_host_arrays_ghost(
                pic, n_bands, pps.chroma_qp_index_offset,
                pps.constrained_intra_pred)
            garrs = {k: jnp.asarray(v) for k, v in garrs.items()}
            steps_g = {k: jnp.asarray(v)
                       for k, v in RT.step_tables(
                           w, h // n_bands + 1).items()}
            y, cb, cr = decoder_fn[key](garrs, ref_y, ref_c, steps,
                                        steps_g)
        else:
            if key not in decoder_fn:
                decoder_fn[key] = make_sliced_decoder(
                    mesh, w, h, n_bands, pps.chroma_qp_index_offset)
            barrs = band_host_arrays(pic, n_bands,
                                     pps.chroma_qp_index_offset,
                                     pps.constrained_intra_pred)
            barrs = {k: jnp.asarray(v) for k, v in barrs.items()}
            y, cb, cr = decoder_fn[key](barrs, ref_y, ref_c, steps)
        return RT.DeviceFrame(y, cb, cr)

    dec = DEC.Decoder(backend="cpu", recon_strategy=sliced_recon)
    outs = dec.decode_annexb(data)
    return [o.frame.tobytes() for o in outs]

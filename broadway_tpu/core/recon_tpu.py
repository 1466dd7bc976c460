"""Device pixel backend: whole-picture reconstruction as one jitted JAX
pipeline (compiled once per (resolution, dpb-size); SPS change retraces).

Dataflow (SURVEY.md §7 Stage B):
  - stages 1-3 run data-parallel in raster MB space [nMB, ...]:
    residual dequant+IDCT, quarter-pel MC (XLA gather, ops/tpu/inter),
    base assembly (inter + I_PCM).
  - the per-MB tensors are then packed ON DEVICE (one row-gather) into a
    DIAGONAL-MAJOR grid [n_steps, lanes]: step d holds the MBs of
    wavefront anti-diagonal x + 2*y == d, lane = y - ymin(d) + LP.
    Neighbour MBs (A,B,C,D) of a whole diagonal live at fixed lane
    shifts in rows d-1/d-2/d-3, so the sequential wavefront stages need
    only row dynamic-slices and lane rolls inside lax.scan.
  - stages 4/5 (intra prediction, deblocking): lax.scan wavefronts over
    the diagonals (table-driven predictors ops/tpu/intra, edge filters
    ops/tpu/deblock).
  - unpack once at the end to raster planes.

Reference frames are held device-resident as edge-replicated padded
planes: luma, and lane-interleaved chroma (ops/tpu/inter.pad_luma /
pad_chroma).

Bit-exactness oracle: core/recon_cpu.py + core/deblock_impl.py (NumPy),
themselves validated against the reference C decoder.
"""

from __future__ import annotations

import functools
from typing import Dict

import numpy as np
import jax
import jax.numpy as jnp

from ..bitstream.mb_layer import (MB_I4x4, MB_I16x16, MB_IPCM, MB_P,
                                  PictureData)
from ..ops.tpu import deblock as K_db
from ..ops.tpu import inter as K_mc
from ..ops.tpu import intra as K_in
from ..ops.tpu import residual as K_res

LP = 2   # lane padding on each side of a diagonal row

# (bx,by) -> up-right availability inside the MB (z-order decode)
_UR_OK = np.ones((4, 4), bool)
for (_bx, _by) in K_in.NO_UPRIGHT:
    _UR_OK[_by, _bx] = False

# per-z-block static tables for the fori_loop body
_BX4 = np.array([bx * 4 for bx, by in K_in.BLK_ORDER], np.int32)
_BY4 = np.array([by * 4 for bx, by in K_in.BLK_ORDER], np.int32)
_Z_PERM = np.array([by * 4 + bx for bx, by in K_in.BLK_ORDER], np.int32)
_AVU_CODE = np.array([0 if by == 0 else 2
                      for bx, by in K_in.BLK_ORDER], np.int32)
_AVL_CODE = np.array([0 if bx == 0 else 2
                      for bx, by in K_in.BLK_ORDER], np.int32)
_AVUR_CODE = np.array(
    [(0 if bx < 3 else 1) if by == 0 else (2 if _UR_OK[by, bx] else 3)
     for bx, by in K_in.BLK_ORDER], np.int32)

_BX4_J = jnp.asarray(_BX4)
_BY4_J = jnp.asarray(_BY4)
_Z_PERM_J = jnp.asarray(_Z_PERM)
_AVU_CODE_J = jnp.asarray(_AVU_CODE)
_AVL_CODE_J = jnp.asarray(_AVL_CODE)
_AVUR_CODE_J = jnp.asarray(_AVUR_CODE)


class WavefrontLayout:
    """Static diagonal-major packing tables for a (w_mbs, h_mbs) grid."""

    def __init__(self, w_mbs: int, h_mbs: int) -> None:
        self.w = w_mbs
        self.h = h_mbs
        self.S = (w_mbs - 1) + 2 * (h_mbs - 1) + 1
        ymin = np.zeros(self.S, np.int32)
        ymax = np.zeros(self.S, np.int32)
        for d in range(self.S):
            # x = d - 2y must satisfy 0 <= x < w, 0 <= y < h
            lo = max(0, -((w_mbs - 1 - d) // 2)) if d > w_mbs - 1 else 0
            lo = max(0, (d - (w_mbs - 1) + 1) // 2)
            hi = min(h_mbs - 1, d // 2)
            ymin[d] = lo
            ymax[d] = hi
        self.ymin = ymin
        # lane = y + LP (uncompacted): neighbour lane shifts are the
        # CONSTANTS shA=0 (left, d-1), shB=shC=shD=-1 (up row, d-2 /
        # up-right d-1 / up-left d-3) — no per-step dynamic rolls.
        self.LS = h_mbs + 2 * LP
        # addr -> (row d, lane)
        self.slot_row = np.zeros(w_mbs * h_mbs, np.int32)
        self.slot_lane = np.zeros(w_mbs * h_mbs, np.int32)
        for y in range(h_mbs):
            for x in range(w_mbs):
                d = x + 2 * y
                a = y * w_mbs + x
                self.slot_row[a] = d
                self.slot_lane[a] = y + LP
        self.shA = np.zeros(self.S, np.int32)
        self.shC = np.full(self.S, -1, np.int32)
        self.shB = np.full(self.S, -1, np.int32)
        self.shD = np.full(self.S, -1, np.int32)
        # device-side pack map: packed slot -> mb addr (n = dummy row)
        n = w_mbs * h_mbs
        slot_addr = np.full(self.S * self.LS, n, np.int64)
        slot_addr[self.slot_row.astype(np.int64) * self.LS
                  + self.slot_lane] = np.arange(n)
        self.slot_addr = slot_addr.astype(np.int32)

    def pack(self, arr: np.ndarray, fill=0) -> np.ndarray:
        """[n, ...] addr-order -> [S, LS, ...] packed (host/NumPy)."""
        out = np.full((self.S, self.LS) + arr.shape[1:], fill, arr.dtype)
        out[self.slot_row, self.slot_lane] = arr
        return out

    def pack_dev(self, a: jnp.ndarray) -> jnp.ndarray:
        """[n, ...] -> [S, LS, ...] on device (row-gather, 0 fill)."""
        fill = jnp.zeros((1,) + a.shape[1:], a.dtype)
        flat = jnp.take(jnp.concatenate([a, fill], axis=0),
                        jnp.asarray(self.slot_addr), axis=0)
        return flat.reshape((self.S, self.LS) + a.shape[1:])


_LAYOUTS: Dict[tuple, WavefrontLayout] = {}


def get_layout(w_mbs: int, h_mbs: int) -> WavefrontLayout:
    key = (w_mbs, h_mbs)
    if key not in _LAYOUTS:
        _LAYOUTS[key] = WavefrontLayout(w_mbs, h_mbs)
    return _LAYOUTS[key]


class DeviceFrame:
    """Device-resident decoded picture: int32 planes + the MC
    reference-plane copies (padded luma, interleaved chroma).
    When the decode emitted a packed u8 YUV buffer (yuv_u8), tobytes()
    fetches that single buffer — one 1.5 B/pixel transfer instead of
    three int32 planes (4x fewer bytes over the host link)."""

    __slots__ = ("y", "cb", "cr", "y_pad", "c_pad", "yuv_u8")

    def __init__(self, y, cb, cr, pad=True, yuv_u8=None):
        self.y, self.cb, self.cr = y, cb, cr
        self.yuv_u8 = yuv_u8
        if pad:
            self.y_pad = K_mc.pad_luma(y)
            self.c_pad = K_mc.pad_chroma(cb, cr)

    def start_fetch(self) -> None:
        """Begin the device->host copy of this frame's YUV without
        blocking, so delivery overlaps the next pictures' decode (the
        reference posts each decoded frame back to the main thread
        while the wasm side decodes the next chunk,
        Player/Decoder.js:856-872). tobytes() then completes the
        already-running transfer instead of starting a blocking one;
        measured 3x on the host link."""
        arrs = (self.yuv_u8,) if self.yuv_u8 is not None else \
            (self.y, self.cb, self.cr)
        for a in arrs:
            f = getattr(a, "copy_to_host_async", None)
            if f is not None:
                f()

    def tobytes(self) -> bytes:
        if self.yuv_u8 is not None:
            return np.asarray(self.yuv_u8).tobytes()
        return (np.asarray(self.y).astype(np.uint8).tobytes() +
                np.asarray(self.cb).astype(np.uint8).tobytes() +
                np.asarray(self.cr).astype(np.uint8).tobytes())


class LazyDeviceFrame:
    """Placeholder frame for the frame-group fast path and the async
    dispatch pump: planes materialize when the pending group/pump job
    runs. Any pixel access forces it, so consumers never observe the
    deferral. _set may run on the pump worker while the feed thread
    calls start_fetch, so the pair is lock-guarded (an unguarded
    interleaving would silently drop the D2H prefetch overlap)."""

    __slots__ = ("_force", "_planes", "_want_fetch", "_lock")

    def __init__(self, force) -> None:
        import threading
        self._force = force
        self._planes = None
        self._want_fetch = False
        self._lock = threading.Lock()

    def _set(self, y, cb, cr, yuv) -> None:
        fr = DeviceFrame(y, cb, cr, pad=False, yuv_u8=yuv)
        with self._lock:
            self._planes = fr
            want = self._want_fetch
        if want:
            fr.start_fetch()

    def _ensure(self) -> "DeviceFrame":
        if self._planes is None:
            self._force()
        return self._planes

    @property
    def y(self):
        return self._ensure().y

    @property
    def cb(self):
        return self._ensure().cb

    @property
    def cr(self):
        return self._ensure().cr

    @property
    def yuv_u8(self):
        return self._ensure().yuv_u8

    def start_fetch(self) -> None:
        # deferred until the group flush / pump job assigns planes
        # (forcing here would collapse every group to size 1 under
        # prefetch)
        with self._lock:
            fr = self._planes
            if fr is None:
                self._want_fetch = True
        if fr is not None:
            fr.start_fetch()

    def tobytes(self) -> bytes:
        return self._ensure().tobytes()


def host_picture_arrays(pic: PictureData, chroma_qp_offset: int,
                        constrained_intra: bool,
                        band: tuple = None) -> Dict[str, np.ndarray]:
    """Assemble the raster per-MB tensor bundle for one picture (host).
    Packing into the wavefront layout happens on device (pack_dev).

    band=(row0, n_rows): emit only the given MB-row band —
    availability/deblock flags are still computed globally
    (slice-aligned bands make cross-band flags false), and MC window
    origins stay global so MC reads full reference frames. Used by the
    slice-parallel sharded decode (parallel/slices.py)."""
    n = pic.n_mbs
    w, h = pic.width_mbs, pic.height_mbs
    cls = pic.mb_class
    sid = pic.slice_id
    dec = pic.decoded

    grid = lambda a: a.reshape(h, w)
    decg, sidg = grid(dec), grid(sid)
    clsg = grid(cls)

    def nb_ok(dy, dx, constrained_block):
        # current MBs at (y, x), neighbour at (y+dy, x+dx)
        ok = np.zeros((h, w), bool)
        ys = slice(max(-dy, 0), h + min(-dy, 0))
        xs = slice(max(-dx, 0), w + min(-dx, 0))
        nys = slice(max(dy, 0), h + min(dy, 0))
        nxs = slice(max(dx, 0), w + min(dx, 0))
        valid = decg[nys, nxs] & (sidg[nys, nxs] == sidg[ys, xs])
        if constrained_block and constrained_intra:
            valid = valid & (clsg[nys, nxs] != MB_P)
        ok[ys, xs] = valid
        return ok.reshape(n)

    av_a = nb_ok(0, -1, True)
    av_b = nb_ok(-1, 0, True)
    av_c = nb_ok(-1, 1, True)
    av_d = nb_ok(-1, -1, True)

    # deblock params per MB (concealed MBs: qp 40, offsets 0, idc 0)
    concealed = getattr(pic, "concealed", None)
    n_sp = len(pic.slice_params)
    sp_idc = np.array([sp.disable_deblocking_idc
                       for sp in pic.slice_params] + [0], np.int32)
    sp_a = np.array([sp.alpha_c0_offset
                     for sp in pic.slice_params] + [0], np.int32)
    sp_b = np.array([sp.beta_offset
                     for sp in pic.slice_params] + [0], np.int32)
    sidx = np.where(pic.slice_id >= 0, pic.slice_id, n_sp)
    valid = np.ones(n, bool) if concealed is None else ~concealed
    idc = np.where(valid, sp_idc[sidx], 0).astype(np.int32)
    offA = np.where(valid, sp_a[sidx], 0).astype(np.int32)
    offB = np.where(valid, sp_b[sidx], 0).astype(np.int32)
    coff = np.where(valid, chroma_qp_offset, 0).astype(np.int32)
    enable = dec & (idc != 1)
    idcg = grid(idc)

    def db_nb(dy, dx):
        ok = np.zeros((h, w), bool)
        ys = slice(max(-dy, 0), h + min(-dy, 0))
        xs = slice(max(-dx, 0), w + min(-dx, 0))
        nys = slice(max(dy, 0), h + min(dy, 0))
        nxs = slice(max(dx, 0), w + min(dx, 0))
        ok[ys, xs] = decg[nys, nxs] & \
            ((idcg[ys, xs] != 2) | (sidg[nys, nxs] == sidg[ys, xs]))
        return ok.reshape(n)

    FT = enable & db_nb(-1, 0)
    FL = enable & db_nb(0, -1)

    ref_blk = np.repeat(np.repeat(pic.ref_slot, 2, axis=1), 2, axis=2)

    if band is None:
        P = lambda a: np.ascontiguousarray(a)
        mb0 = 0
    else:
        r0, nr = band
        sel = slice(r0 * w, (r0 + nr) * w)
        P = lambda a: np.ascontiguousarray(a[sel])
        mb0 = r0 * w

    mv_b = P(pic.mv.astype(np.int32))
    ref_b = P(ref_blk.astype(np.int32))
    out = {
        "mb_class": P(cls.astype(np.int32)),
        "qp": P(pic.qp.astype(np.int32)),
        "cbp": P(pic.cbp.astype(np.int32)),
        "is_i16": P(cls == MB_I16x16),
        "i16_mode": P(pic.i16_mode.astype(np.int32)),
        "chroma_mode": P(pic.chroma_mode.astype(np.int32)),
        "i4_modes": P(pic.i4_modes.astype(np.int32)),
        "luma_coeffs": P(pic.luma_coeffs.astype(np.int32)),
        "luma_dc": P(pic.luma_dc.astype(np.int32)),
        "chroma_dc": P(pic.chroma_dc.astype(np.int32)),
        "chroma_ac": P(pic.chroma_ac.reshape(n, 2, 2, 2, 16)
                       .astype(np.int32)),
        "total_coeff": P(pic.total_coeff.astype(np.int32)),
        "mv": mv_b,
        "ref_blk": ref_b,
        "ipcm": P(pic.ipcm),
        "av_a": P(av_a), "av_b": P(av_b), "av_c": P(av_c), "av_d": P(av_d),
        "offA": P(offA), "offB": P(offB), "chroma_off_mb": P(coff),
        "FT": P(FT), "FL": P(FL), "enable": P(enable),
        "is_inter": P((cls == MB_P) & ~(concealed
                                        if concealed is not None
                                        else np.zeros(n, bool))),
        "is_pcm": P(cls == MB_IPCM),
        "whole_conceal": np.array(
            getattr(pic, "whole_pic_concealed", False)),
    }
    return out


def step_tables(w_mbs: int, h_mbs: int) -> Dict[str, np.ndarray]:
    lay = get_layout(w_mbs, h_mbs)
    return {"shA": lay.shA, "shB": lay.shB, "shC": lay.shC, "shD": lay.shD,
            "d": np.arange(lay.S, dtype=np.int32)}


def _unpack_to_plane(blocks: jnp.ndarray, lay: WavefrontLayout,
                     mb_size: int) -> jnp.ndarray:
    """[S, LS, mb, mb] packed -> [h*mb, w*mb] raster plane."""
    flat = blocks.reshape(lay.S * lay.LS, mb_size, mb_size)
    idx = jnp.asarray(lay.slot_row * lay.LS + lay.slot_lane)
    mb = jnp.take(flat, idx, axis=0)                    # [n, mb, mb]
    return mb.reshape(lay.h, lay.w, mb_size, mb_size) \
        .transpose(0, 2, 1, 3).reshape(lay.h * mb_size, lay.w * mb_size)


def _row(x: jnp.ndarray, d) -> jnp.ndarray:
    d = jnp.maximum(d, 0)
    return jax.lax.dynamic_index_in_dim(x, d, axis=0, keepdims=False)


def _roll(x: jnp.ndarray, sh) -> jnp.ndarray:
    """Lane shift: out[l] = x[l + sh] (wrap lanes are masked by callers)."""
    return jnp.roll(x, -sh, axis=0)


def mc_predict_xla(ref_y, ref_c, mv, ref_blk, w_mbs, h_mbs, mb0=0):
    """Quarter-pel MC of every 4x4 block as one XLA gather:
    pred_y [n,16,16], pred_c [n,8,16] (cb/cr lane-interleaved).
    h_mbs must be the FULL picture height (clip bounds and positions
    are plane-global even when decoding an MB-row band)."""
    n = mv.shape[0]
    W, H = w_mbs * 16, h_mbs * 16
    hp0, wp0 = K_mc.luma_ext_dims(W, H)
    hc0, wc0 = K_mc.chroma_ext_dims(W, H)
    wc0 //= 2

    mb = mb0 + jnp.arange(n) % (w_mbs * h_mbs)
    pxv = (mb % w_mbs).astype(jnp.int32) * 16
    pyv = (mb // w_mbs).astype(jnp.int32) * 16
    bx = jnp.arange(4)[None, None, :]
    by = jnp.arange(4)[None, :, None]
    bpx = jnp.broadcast_to(pxv[:, None, None] + bx * 4, (n, 4, 4)) \
        .reshape(-1)
    bpy = jnp.broadcast_to(pyv[:, None, None] + by * 4, (n, 4, 4)) \
        .reshape(-1)
    mvx = mv[..., 0].reshape(-1)
    mvy = mv[..., 1].reshape(-1)
    ridx = jnp.maximum(ref_blk, 0).reshape(-1)

    pred_y = K_mc.mc_luma_blocks(ref_y, ridx, bpx, bpy, mvx, mvy,
                                 hp0=hp0, wp0=wp0)
    pred_y = pred_y.reshape(n, 4, 4, 4, 4).transpose(0, 1, 3, 2, 4) \
        .reshape(n, 16, 16)
    cpx = jnp.broadcast_to((pxv // 2)[:, None, None] + bx * 2,
                           (n, 4, 4)).reshape(-1)
    cpy = jnp.broadcast_to((pyv // 2)[:, None, None] + by * 2,
                           (n, 4, 4)).reshape(-1)
    pred_c = K_mc.mc_chroma_blocks_il(ref_c, ridx, cpx, cpy, mvx, mvy,
                                      hc0=hc0, wc0=wc0)   # [n*16, 2, 4]
    pred_c = pred_c.reshape(n, 4, 4, 2, 4).transpose(0, 1, 3, 2, 4) \
        .reshape(n, 8, 16)
    return pred_y, pred_c


def decode_picture_impl(arrs: Dict[str, jnp.ndarray],
                        ref_y: jnp.ndarray, ref_c: jnp.ndarray,
                        steps: Dict[str, jnp.ndarray],
                        w_mbs: int, h_mbs: int, chroma_qp_offset: int,
                        run_stages: int = 3,
                        mb0: int = 0, ref_h_mbs: int = None):
    lay = get_layout(w_mbs, h_mbs)
    LS = lay.LS
    N = arrs["qp"].shape[0]     # raster MB count (band or full)

    # ---- stage 1: residuals (raster MB space) -------------------------
    qp = arrs["qp"]
    cbp = arrs["cbp"]
    is_i16 = arrs["is_i16"]
    dc = K_res.luma_dc_transform(arrs["luma_dc"], qp)            # [N,4,4]
    coeffs = arrs["luma_coeffs"]                                 # [N,4,4,16]
    qp_b = jnp.broadcast_to(qp[:, None, None], (N, 4, 4))
    # ONE idct pass: for I16x16 MBs the DC position is replaced by the
    # Hadamard-transformed DC; for others by the value dequant would
    # produce anyway (coeff[scan 0] * scale[pos 0]) — bit-identical to
    # the two-variant form at half the cost.
    scale0 = (K_res._LS[qp % 6, K_res._PC[0]] << (qp // 6)) \
        .astype(jnp.int32)
    dc0 = coeffs[..., 0] * scale0[:, None, None]
    dc_m = jnp.where(is_i16[:, None, None], dc, dc0)
    res_m = K_res.dequant_idct(coeffs, qp_b, dc=dc_m)
    blk8 = (np.arange(4) // 2)[:, None] * 2 + (np.arange(4) // 2)[None, :]
    has = ((cbp[:, None, None] >> jnp.asarray(blk8)[None]) & 1) != 0
    res = jnp.where((is_i16[:, None, None] | has)[..., None, None],
                    res_m, 0)
    res_y_mb = res.transpose(0, 1, 3, 2, 4).reshape(N, 16, 16)

    qpc = K_res.QP_C_J[jnp.clip(qp + chroma_qp_offset, 0, 51)]
    cdc = K_res.chroma_dc_transform(arrs["chroma_dc"], qpc[:, None])
    cbp_c = cbp >> 4
    cdc = jnp.where((cbp_c > 0)[:, None, None, None],
                    cdc.reshape(N, 2, 2, 2), 0)
    qpc_b = jnp.broadcast_to(qpc[:, None, None, None], (N, 2, 2, 2))
    cac = arrs["chroma_ac"]
    # chroma AC rows exist only when cbp_c == 2 (parser invariant), so
    # the DC-only variant equals this one with cac == 0 — one pass.
    cres_ac = K_res.dequant_idct(cac, qpc_b, dc=cdc)
    has_any = (cbp_c > 0)[:, None, None, None, None, None]
    cres = jnp.where(has_any, cres_ac, 0)
    res_cb_mb = cres[:, 0].transpose(0, 1, 3, 2, 4).reshape(N, 8, 8)
    res_cr_mb = cres[:, 1].transpose(0, 1, 3, 2, 4).reshape(N, 8, 8)

    # ---- stage 2: inter MC --------------------------------------------
    if run_stages == 0:
        pred_y = jnp.zeros((N, 16, 16), jnp.int32)
        pred_c = jnp.zeros((N, 8, 16), jnp.int32)
    else:
        pred_y, pred_c = mc_predict_xla(ref_y, ref_c, arrs["mv"],
                                        arrs["ref_blk"], w_mbs,
                                        ref_h_mbs or h_mbs, mb0=mb0)
    pred_cb = pred_c[:, :, 0::2]
    pred_cr = pred_c[:, :, 1::2]

    # ---- stage 3: base assembly ---------------------------------------
    pcm = arrs["ipcm"].astype(jnp.int32)
    is_p = arrs["is_inter"][:, None, None]
    is_pcm = arrs["is_pcm"][:, None, None]
    base_y = jnp.where(is_pcm, pcm[:, :256].reshape(N, 16, 16),
                       jnp.where(is_p, jnp.clip(pred_y + res_y_mb, 0, 255),
                                 0))
    base_cb = jnp.where(is_pcm, pcm[:, 256:320].reshape(N, 8, 8),
                        jnp.where(is_p,
                                  jnp.clip(pred_cb + res_cb_mb, 0, 255), 0))
    base_cr = jnp.where(is_pcm, pcm[:, 320:384].reshape(N, 8, 8),
                        jnp.where(is_p,
                                  jnp.clip(pred_cr + res_cr_mb, 0, 255), 0))

    # ---- device-side pack into the wavefront layout -------------------
    pk = lay.pack_dev
    Y = pk(base_y)
    CB = pk(base_cb)
    CR = pk(base_cr)
    resY = pk(res_y_mb)
    resCB = pk(res_cb_mb)
    resCR = pk(res_cr_mb)
    arrs = {k: pk(arrs[k]) for k in
            ("mb_class", "i4_modes", "i16_mode", "chroma_mode",
             "av_a", "av_b", "av_c", "av_d", "total_coeff", "mv",
             "ref_blk", "is_inter", "FT", "FL", "enable", "qp",
             "offA", "offB", "chroma_off_mb")} | {
                 "whole_conceal": arrs["whole_conceal"]}

    cls = arrs["mb_class"]
    steps_x = {k: jnp.asarray(v) for k, v in steps.items()}

    if run_stages <= 1:   # profiling: base assembly only (0: no MC)
        return (_unpack_to_plane(Y, lay, 16), _unpack_to_plane(CB, lay, 8),
                _unpack_to_plane(CR, lay, 8))

    # ---- stage 4: intra wavefront -------------------------------------
    def intra_step(carry, xs):
        Y, CB, CR = carry
        d, shA, shB, shC, shD = (xs["d"], xs["shA"], xs["shB"], xs["shC"],
                                 xs["shD"])
        own = _row(Y, d)                       # [LS,16,16]
        A = _roll(_row(Y, d - 1), shA)
        C = _roll(_row(Y, d - 1), shC)
        B = _roll(_row(Y, d - 2), shB)
        D = _roll(_row(Y, d - 3), shD)

        av_a = _row(arrs["av_a"], d)
        av_b = _row(arrs["av_b"], d)
        av_c = _row(arrs["av_c"], d)
        av_d = _row(arrs["av_d"], d)

        up_row = jnp.concatenate(
            [D[:, 15, 15][:, None], B[:, 15, :], C[:, 15, 0:4]], axis=1)
        left_col = A[:, :, 15]                 # [LS,16]
        lane_ix = jnp.arange(21)[None]
        up_row = jnp.where(av_b[:, None], up_row,
                           jnp.where(lane_ix == 0, up_row, 0))
        up_row = up_row.at[:, 0].set(jnp.where(av_d, up_row[:, 0], 0))
        left_masked = jnp.where(av_a[:, None], left_col, 0)

        res_mb = _row(resY, d)

        loc = jnp.zeros((LS, 17, 25), jnp.int32)
        loc = loc.at[:, 0, :21].set(up_row)
        loc = loc.at[:, 1:17, 0].set(left_masked)
        i4_modes = _row(arrs["i4_modes"], d)
        i4_modes_z = i4_modes.reshape(LS, 16)[:, _Z_PERM_J]

        def blk_body(z, loc):
            bx4 = _BX4_J[z]
            by4 = _BY4_J[z]
            nb = jax.lax.dynamic_slice(loc, (0, by4, bx4), (LS, 5, 9))
            ul = nb[:, 0, 0]
            up8 = nb[:, 0, 1:9]
            left4 = nb[:, 1:5, 0]
            code_ur = _AVUR_CODE_J[z]
            b_av_u = jnp.where(_AVU_CODE_J[z] == 0, av_b, True)
            b_av_ur = jnp.where(code_ur == 0, av_b,
                                jnp.where(code_ur == 1, av_c, code_ur == 2))
            b_av_l = jnp.where(_AVL_CODE_J[z] == 0, av_a, True)
            ur = jnp.where(b_av_ur[:, None], up8[:, 4:8], up8[:, 3:4])
            up8 = jnp.concatenate([up8[:, :4], ur], axis=1)
            v = jnp.concatenate([ul[:, None], up8, left4], axis=1)
            mode = i4_modes_z[:, z]
            pred = K_in.predict_i4x4_batch(v, mode, b_av_u, b_av_l)
            res_b = jax.lax.dynamic_slice(res_mb, (0, by4, bx4), (LS, 4, 4))
            blk = jnp.clip(pred + res_b, 0, 255)
            return jax.lax.dynamic_update_slice(loc, blk,
                                                (0, by4 + 1, bx4 + 1))

        loc = jax.lax.fori_loop(0, 16, blk_body, loc)
        i4_out = loc[:, 1:17, 1:17]

        i16_mode = _row(arrs["i16_mode"], d)
        pred16 = K_in.predict_i16_batch(up_row[:, 1:17], left_masked,
                                        up_row[:, 0], i16_mode, av_b, av_a)
        i16_out = jnp.clip(pred16 + res_mb, 0, 255)

        mb_cls = _row(cls, d)
        new_y = jnp.where((mb_cls == MB_I4x4)[:, None, None], i4_out,
                          jnp.where((mb_cls == MB_I16x16)[:, None, None],
                                    i16_out, own))
        Y = jax.lax.dynamic_update_index_in_dim(Y, new_y, jnp.maximum(d, 0),
                                                axis=0)

        cmode = _row(arrs["chroma_mode"], d)
        is_intra_c = (mb_cls == MB_I4x4) | (mb_cls == MB_I16x16)
        for plane_i, (PL, resC) in enumerate(((CB, resCB), (CR, resCR))):
            ownc = _row(PL, d)
            Ac = _roll(_row(PL, d - 1), shA)
            Bc = _roll(_row(PL, d - 2), shB)
            Dc = _roll(_row(PL, d - 3), shD)
            upc = jnp.where(av_b[:, None], Bc[:, 7, :], 0)
            ulc = jnp.where(av_d, Dc[:, 7, 7], 0)
            leftc = jnp.where(av_a[:, None], Ac[:, :, 7], 0)
            predc = K_in.predict_chroma_batch(upc, leftc, ulc, cmode,
                                              av_b, av_a)
            outc = jnp.clip(predc + _row(resC, d), 0, 255)
            newc = jnp.where(is_intra_c[:, None, None], outc, ownc)
            if plane_i == 0:
                CB = jax.lax.dynamic_update_index_in_dim(
                    CB, newc, jnp.maximum(d, 0), axis=0)
            else:
                CR = jax.lax.dynamic_update_index_in_dim(
                    CR, newc, jnp.maximum(d, 0), axis=0)
        return (Y, CB, CR), None

    (Y, CB, CR), _ = jax.lax.scan(intra_step, (Y, CB, CR), steps_x)

    if run_stages <= 2:   # profiling: skip deblock
        return (_unpack_to_plane(Y, lay, 16), _unpack_to_plane(CB, lay, 8),
                _unpack_to_plane(CR, lay, 8))

    # ---- stage 5: deblock wavefront ------------------------------------
    def run_deblock(args):
        return deblock_scan(args[0], args[1], args[2], arrs, steps_x)

    Y, CB, CR = jax.lax.cond(arrs["whole_conceal"],
                             lambda a: a, run_deblock, (Y, CB, CR))

    out_y = _unpack_to_plane(Y, lay, 16)
    out_cb = _unpack_to_plane(CB, lay, 8)
    out_cr = _unpack_to_plane(CR, lay, 8)
    return out_y, out_cb, out_cr


def deblock_scan(Y, CB, CR, arrs, steps_x):
    """In-loop deblocking as a lax.scan over wavefront diagonals
    (bit-exact vs core/deblock_impl.py, which mirrors
    h264bsd_deblocking.c:574).

    Y [S,LS,16,16], CB/CR [S,LS,8,8] packed planes; arrs: packed per-MB
    dict (total_coeff, mv, ref_blk, is_inter, FT, FL, enable, qp, offA,
    offB, chroma_off_mb); steps_x: step_tables as device arrays."""
    LS = Y.shape[1]
    tc4 = arrs["total_coeff"]          # [S,LS,4,4] raster
    mvp = arrs["mv"]
    refp = arrs["ref_blk"]
    intra_mb = ~arrs["is_inter"]
    FT = arrs["FT"]
    FL = arrs["FL"]
    EN = arrs["enable"]
    qp_p = arrs["qp"]
    offA_p = arrs["offA"]
    offB_p = arrs["offB"]
    coff_p = arrs["chroma_off_mb"]

    def bs_pair(tc_q, tc_p, mv_q, mv_p, rf_q, rf_p):
        coeff = (tc_q > 0) | (tc_p > 0)
        mvd = (jnp.abs(mv_q[..., 0] - mv_p[..., 0]) >= 4) | \
              (jnp.abs(mv_q[..., 1] - mv_p[..., 1]) >= 4)
        return jnp.where(coeff, 2, jnp.where(mvd | (rf_q != rf_p), 1, 0))

    def db_step(carry, xs):
        Y, CB, CR = carry
        d, shA, shB = xs["d"], xs["shA"], xs["shB"]
        dm1 = jnp.maximum(d - 1, 0)
        dm2 = jnp.maximum(d - 2, 0)
        own = _row(Y, d)
        left = _roll(_row(Y, d - 1), shA)
        up = _roll(_row(Y, d - 2), shB)

        tc_o = _row(tc4, d)
        tc_a = _roll(_row(tc4, d - 1), shA)
        tc_b = _roll(_row(tc4, d - 2), shB)
        mv_o = _row(mvp, d)
        mv_a = _roll(_row(mvp, d - 1), shA)
        mv_b = _roll(_row(mvp, d - 2), shB)
        rf_o = _row(refp, d)
        rf_a = _roll(_row(refp, d - 1), shA)
        rf_b = _roll(_row(refp, d - 2), shB)
        in_o = _row(intra_mb, d)
        in_a = _roll(_row(intra_mb, d - 1), shA)
        in_b = _roll(_row(intra_mb, d - 2), shB)
        ft = _row(FT, d)
        fl = _row(FL, d)
        en = _row(EN, d)

        # boundary strengths (raster block coords)
        it = bs_pair(tc_o[:, 1:, :], tc_o[:, :3, :],
                     mv_o[:, 1:, :], mv_o[:, :3, :],
                     rf_o[:, 1:, :], rf_o[:, :3, :])
        il = bs_pair(tc_o[:, :, 1:], tc_o[:, :, :3],
                     mv_o[:, :, 1:], mv_o[:, :, :3],
                     rf_o[:, :, 1:], rf_o[:, :, :3])
        it = jnp.where(in_o[:, None, None], 3, it)
        il = jnp.where(in_o[:, None, None], 3, il)
        te = bs_pair(tc_o[:, 0, :], tc_b[:, 3, :], mv_o[:, 0, :],
                     mv_b[:, 3, :], rf_o[:, 0, :], rf_b[:, 3, :])
        te = jnp.where((in_o | in_b)[:, None], 4, te)
        te = jnp.where(ft[:, None], te, 0)
        le = bs_pair(tc_o[:, :, 0], tc_a[:, :, 3], mv_o[:, :, 0],
                     mv_a[:, :, 3], rf_o[:, :, 0], rf_a[:, :, 3])
        le = jnp.where((in_o | in_a)[:, None], 4, le)
        le = jnp.where(fl[:, None], le, 0)
        bt = jnp.concatenate([te[:, None, :], it], axis=1)   # [LS,4,4]
        bl = jnp.concatenate([le[:, :, None], il], axis=2)
        bt = jnp.where(en[:, None, None], bt, 0)
        bl = jnp.where(en[:, None, None], bl, 0)

        qp_o = _row(qp_p, d)
        qp_a = _roll(_row(qp_p, d - 1), shA)
        qp_b2 = _roll(_row(qp_p, d - 2), shB)
        oA = _row(offA_p, d)
        oB = _row(offB_p, d)
        co = _row(coff_p, d)

        def thr(qo, qa, qb, cmap):
            def mk(q):
                ia = jnp.clip(q + oA, 0, 51)
                ib = jnp.clip(q + oB, 0, 51)
                return (K_db.ALPHAS_J[ia], K_db.BETAS_J[ib], ia)
            qm = cmap(qo)
            inner = mk(qm)
            topq = jnp.where(qb != qo, (qm + cmap(qb) + 1) >> 1, qm)
            leftq = jnp.where(qa != qo, (qm + cmap(qa) + 1) >> 1, qm)
            return inner, mk(topq), mk(leftq)

        l_in, l_tp, l_lf = thr(qp_o, qp_a, qp_b2, lambda q: q)
        c_in, c_tp, c_lf = thr(
            qp_o, qp_a, qp_b2,
            lambda q: K_res.QP_C_J[jnp.clip(q + co, 0, 51)])

        # assemble 20x20 window: own + left 4 cols + up 4 rows
        win = jnp.zeros((LS, 20, 20), jnp.int32)
        win = win.at[:, 4:20, 4:20].set(own)
        win = win.at[:, 4:20, 0:4].set(left[:, :, 12:16])
        win = win.at[:, 0:4, 4:20].set(up[:, 12:16, :])

        def pick_thr(e, i, k):
            return tuple(jnp.where(k == 0, a, b) for a, b in zip(e, i))

        def v_body(k, win):
            c = 4 + 4 * k
            alpha, beta, ia = pick_thr(l_lf, l_in, k)
            bs4 = jax.lax.dynamic_index_in_dim(bl, k, axis=2,
                                               keepdims=False)
            bs_col = jnp.repeat(bs4, 4, axis=1)
            cols = jax.lax.dynamic_slice(win, (0, 4, c - 4), (LS, 16, 8))
            p3, p2, p1, p0 = (cols[..., 0], cols[..., 1], cols[..., 2],
                              cols[..., 3])
            q0, q1, q2, q3 = (cols[..., 4], cols[..., 5], cols[..., 6],
                              cols[..., 7])
            o = K_db.filter_lines_luma(p3, p2, p1, p0, q0, q1, q2, q3,
                                       bs_col, alpha[:, None],
                                       beta[:, None], ia[:, None])
            out = jnp.stack(o, axis=-1)
            return jax.lax.dynamic_update_slice(win, out, (0, 4, c - 3))

        win = jax.lax.fori_loop(0, 4, v_body, win)

        def h_body(k, win):
            r = 4 + 4 * k
            alpha, beta, ia = pick_thr(l_tp, l_in, k)
            bs4 = jax.lax.dynamic_index_in_dim(bt, k, axis=1,
                                               keepdims=False)
            bs_row = jnp.repeat(bs4, 4, axis=1)
            rows = jax.lax.dynamic_slice(win, (0, r - 4, 4), (LS, 8, 16))
            p3, p2, p1, p0 = (rows[:, 0], rows[:, 1], rows[:, 2],
                              rows[:, 3])
            q0, q1, q2, q3 = (rows[:, 4], rows[:, 5], rows[:, 6],
                              rows[:, 7])
            o = K_db.filter_lines_luma(p3, p2, p1, p0, q0, q1, q2, q3,
                                       bs_row, alpha[:, None],
                                       beta[:, None], ia[:, None])
            out = jnp.stack(o, axis=1)
            return jax.lax.dynamic_update_slice(win, out, (0, r - 3, 4))

        win = jax.lax.fori_loop(0, 4, h_body, win)

        # write back: own, left cols 13:15, up rows 13:15
        own2 = win[:, 4:20, 4:20]
        left2 = left.at[:, :, 13:16].set(win[:, 4:20, 1:4])
        up2 = up.at[:, 13:16, :].set(win[:, 1:4, 4:20])

        def unroll_write(P2, d_idx, sh, modified, original_row):
            back = jnp.roll(modified, sh, axis=0)
            orig = _row(P2, d_idx)
            lane = jnp.arange(LS)
            wrapped = jnp.where(sh >= 0, lane < sh, lane >= LS + sh)
            back = jnp.where(wrapped[:, None, None], orig, back)
            return jax.lax.dynamic_update_index_in_dim(
                P2, back, jnp.maximum(d_idx, 0), axis=0)

        Y = jax.lax.dynamic_update_index_in_dim(Y, own2,
                                                jnp.maximum(d, 0), axis=0)
        # guard: steps 0/1 have no left/up rows; shifts there are 0 and
        # bs gating leaves the rows unchanged, so write-back is a no-op
        Y = jax.lax.cond(d >= 1,
                         lambda Y: unroll_write(Y, d - 1, shA, left2, None),
                         lambda Y: Y, Y)
        Y = jax.lax.cond(d >= 2,
                         lambda Y: unroll_write(Y, d - 2, shB, up2, None),
                         lambda Y: Y, Y)

        # chroma
        ownc = {0: _row(CB, d), 1: _row(CR, d)}
        leftc = {0: _roll(_row(CB, d - 1), shA),
                 1: _roll(_row(CR, d - 1), shA)}
        upc = {0: _roll(_row(CB, d - 2), shB),
               1: _roll(_row(CR, d - 2), shB)}
        newPL = {}
        for ci in (0, 1):
            cwin = jnp.zeros((LS, 12, 12), jnp.int32)
            cwin = cwin.at[:, 4:12, 4:12].set(ownc[ci])
            cwin = cwin.at[:, 4:12, 0:4].set(leftc[ci][:, :, 4:8])
            cwin = cwin.at[:, 0:4, 4:12].set(upc[ci][:, 4:8, :])
            for k, (cc, t) in enumerate(((4, c_lf), (8, c_in))):
                alpha, beta, ia = t
                col = 0 if k == 0 else 2
                bs_rows = jnp.repeat(bl[:, :, col], 2, axis=1)
                colsl = cwin[:, 4:12, cc - 2:cc + 2]
                p1, p0 = colsl[..., 0], colsl[..., 1]
                q0, q1 = colsl[..., 2], colsl[..., 3]
                p0o, q0o = K_db.filter_lines_chroma(
                    p1, p0, q0, q1, bs_rows, alpha[:, None],
                    beta[:, None], ia[:, None])
                cwin = cwin.at[:, 4:12, cc - 1].set(p0o)
                cwin = cwin.at[:, 4:12, cc].set(q0o)
            for k, (rr, t) in enumerate(((4, c_tp), (8, c_in))):
                alpha, beta, ia = t
                rowi = 0 if k == 0 else 2
                bs_cols = jnp.repeat(bt[:, rowi, :], 2, axis=1)
                rowsl = cwin[:, rr - 2:rr + 2, 4:12]
                p1, p0 = rowsl[:, 0], rowsl[:, 1]
                q0, q1 = rowsl[:, 2], rowsl[:, 3]
                p0o, q0o = K_db.filter_lines_chroma(
                    p1, p0, q0, q1, bs_cols, alpha[:, None],
                    beta[:, None], ia[:, None])
                cwin = cwin.at[:, rr - 1, 4:12].set(p0o)
                cwin = cwin.at[:, rr, 4:12].set(q0o)
            newPL[ci] = (cwin[:, 4:12, 4:12],
                         leftc[ci].at[:, :, 5:8].set(cwin[:, 4:12, 1:4]),
                         upc[ci].at[:, 5:8, :].set(cwin[:, 1:4, 4:12]))

        def apply_chroma(PL, trip):
            o2, l2, u2 = trip
            PL = jax.lax.dynamic_update_index_in_dim(
                PL, o2, jnp.maximum(d, 0), axis=0)
            PL = jax.lax.cond(
                d >= 1, lambda P2: unroll_write(P2, d - 1, shA, l2, None),
                lambda P2: P2, PL)
            PL = jax.lax.cond(
                d >= 2, lambda P2: unroll_write(P2, d - 2, shB, u2, None),
                lambda P2: P2, PL)
            return PL

        CB = apply_chroma(CB, newPL[0])
        CR = apply_chroma(CR, newPL[1])
        return (Y, CB, CR), None

    (Y, CB, CR), _ = jax.lax.scan(db_step, (Y, CB, CR), steps_x)
    return Y, CB, CR


decode_picture = functools.partial(
    jax.jit, static_argnames=("w_mbs", "h_mbs", "chroma_qp_offset",
                              "run_stages", "mb0", "ref_h_mbs"))(
                                  decode_picture_impl)


@functools.partial(jax.jit, donate_argnums=(0, 1))
def update_stack_slot(ref_y, ref_c, slot, y, cb, cr):
    """Write one decoded frame into the persistent device ref-plane
    stacks (padded MC plane format) at its DPB frame-store slot."""
    ref_y = jax.lax.dynamic_update_index_in_dim(
        ref_y, K_mc.pad_luma(y), slot, axis=0)
    ref_c = jax.lax.dynamic_update_index_in_dim(
        ref_c, K_mc.pad_chroma(cb, cr), slot, axis=0)
    return ref_y, ref_c


@functools.partial(
    jax.jit,
    static_argnames=("lay", "kb", "constrained_intra", "chroma_qp_offset"),
    donate_argnums=(1, 2))
def decode_picture_packed(buf, ref_y, ref_c, slot, steps, *,
                          lay, kb: int, constrained_intra: bool,
                          chroma_qp_offset: int):
    """End-to-end fast path: single packed upload in, persistent DPB
    ref-plane stacks updated in place (donated), decoded planes out.
    One jit call per picture — no other per-frame device traffic."""
    from .packed import unpack_arrs
    arrs = unpack_arrs(buf, lay, kb, constrained_intra, chroma_qp_offset)
    y, cb, cr = decode_picture_impl(
        arrs, ref_y, ref_c, steps, w_mbs=lay.w, h_mbs=lay.h,
        chroma_qp_offset=chroma_qp_offset)
    ref_y = jax.lax.dynamic_update_index_in_dim(
        ref_y, K_mc.pad_luma(y), slot, axis=0)
    ref_c = jax.lax.dynamic_update_index_in_dim(
        ref_c, K_mc.pad_chroma(cb, cr), slot, axis=0)
    return y, cb, cr, ref_y, ref_c


def _decode_packed2_step(buf, ref_y, ref_c, slot, steps, lay, bk,
                         constrained_intra, chroma_qp_offset):
    """One picture of the compact v2 path (shared by the single-stream
    and the vmapped multi-stream jits)."""
    from .packed import unpack_arrs_v2
    arrs = unpack_arrs_v2(buf, lay, bk, constrained_intra,
                          chroma_qp_offset)
    # XLA workaround (root cause of an old multislice failure): when
    # the v2 unpack (bitcast/scatter chains) fuses INTO the deblock
    # boundary-strength computation, XLA miscompiled the internal copy
    # of the mv/ref compare chain (bs_left of one MB dropped to 0) even
    # though the same values exported as jit outputs were correct. A
    # barrier between unpack and consumers splits those fusions while
    # keeping ONE jit dispatch per picture.
    arrs = jax.lax.optimization_barrier(arrs)
    y, cb, cr = decode_picture_impl(
        arrs, ref_y, ref_c, steps, w_mbs=lay.w, h_mbs=lay.h,
        chroma_qp_offset=chroma_qp_offset)
    ref_y = jax.lax.dynamic_update_index_in_dim(
        ref_y, K_mc.pad_luma(y), slot, axis=0)
    ref_c = jax.lax.dynamic_update_index_in_dim(
        ref_c, K_mc.pad_chroma(cb, cr), slot, axis=0)
    yuv = jnp.concatenate(
        [y.astype(jnp.uint8).reshape(-1),
         cb.astype(jnp.uint8).reshape(-1),
         cr.astype(jnp.uint8).reshape(-1)])
    return y, cb, cr, yuv, ref_y, ref_c


@functools.partial(
    jax.jit,
    static_argnames=("lay", "bk", "constrained_intra",
                     "chroma_qp_offset"),
    donate_argnums=(1, 2))
def decode_picture_packed2(buf, ref_y, ref_c, slot, steps, *,
                           lay, bk: tuple, constrained_intra: bool,
                           chroma_qp_offset: int):
    """End-to-end fast path, COMPACT v2 upload (core/packed.py v2):
    one small packed buffer in, persistent DPB ref-plane stacks updated
    in place (donated), decoded planes out — plus a single u8 YUV
    buffer so host delivery is one minimal-size fetch."""
    return _decode_packed2_step(buf, ref_y, ref_c, slot, steps, lay, bk,
                                constrained_intra, chroma_qp_offset)


@functools.partial(
    jax.jit,
    static_argnames=("lay", "bk", "constrained_intra",
                     "chroma_qp_offset", "group"),
    donate_argnums=(1, 2))
def decode_pictures_packed_group(bufs, ref_y, ref_c, slots, steps, *,
                                 lay, bk: tuple,
                                 constrained_intra: bool,
                                 chroma_qp_offset: int, group: int):
    """Frame-group fast path: G consecutive pictures of ONE stream
    decoded inside a single jit call (python-unrolled — picture g+1's
    MC reads the DPB stacks updated by picture g). Amortizes the
    per-execution dispatch/RPC overhead that a per-picture jit pays G
    times; the reference analogue is the worker decoding a whole
    input chunk of NALs per postMessage (Decoder.js:344-354
    playStream loop). bufs [G, size] u8 (common bk via expand_buf_v2),
    slots [G] i32."""
    ys, cbs, crs, yuvs = [], [], [], []
    for g in range(group):
        y, cb, cr, yuv, ref_y, ref_c = _decode_packed2_step(
            bufs[g], ref_y, ref_c, slots[g], steps, lay, bk,
            constrained_intra, chroma_qp_offset)
        ys.append(y)
        cbs.append(cb)
        crs.append(cr)
        yuvs.append(yuv)
    return (jnp.stack(ys), jnp.stack(cbs), jnp.stack(crs),
            jnp.stack(yuvs), ref_y, ref_c)


@functools.partial(
    jax.jit,
    static_argnames=("lay", "bk", "constrained_intra",
                     "chroma_qp_offset"),
    donate_argnums=(1, 2))
def decode_pictures_packed_batch(bufs, ref_y, ref_c, slots, steps, *,
                                 lay, bk: tuple,
                                 constrained_intra: bool,
                                 chroma_qp_offset: int):
    """Lockstep multi-stream fast path: B compact v2 buffers in, the
    single-picture pipeline vmapped over streams (each diagonal step of
    the wavefronts covers all B streams), persistent per-stream DPB
    stacks updated in place. bufs [B, size] u8, ref_y/ref_c
    [B, R, ...], slots [B]."""
    step = functools.partial(_decode_packed2_step, steps=steps, lay=lay,
                             bk=bk, constrained_intra=constrained_intra,
                             chroma_qp_offset=chroma_qp_offset)
    return jax.vmap(step)(bufs, ref_y, ref_c, slots)


def ref_stacks(dpb_buffer, width: int, height: int):
    """Build device ref-plane stacks [R,...] from a DPB buffer of
    DeviceFrames (None slots -> zero planes) in the padded MC format.
    Stack position = the picture's stable frame-store slot (pic.ref_slot
    values refer to these)."""
    hy, wy = K_mc.luma_ext_dims(width, height)
    hc, wc = K_mc.chroma_ext_dims(width, height)
    zero_y = jnp.zeros((hy, wy), jnp.int32)
    zero_c = jnp.zeros((hc, wc), jnp.int32)
    buf = list(dpb_buffer)
    if all(getattr(p, "slot", -1) >= 0 for p in buf):
        buf.sort(key=lambda p: p.slot)
    ys, cs = [], []
    for p in buf:
        f = p.frame
        ys.append(f.y_pad if f is not None else zero_y)
        cs.append(f.c_pad if f is not None else zero_c)
    return jnp.stack(ys), jnp.stack(cs)

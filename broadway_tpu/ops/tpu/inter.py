"""Inter prediction stage — batched quarter-pel MC in JAX (XLA gather).

Twin of ops/inter.py (NumPy oracle). All 4x4 luma blocks (and their 2x2
chroma blocks) are predicted in one batched pass: per-block edge-clamped
10x10 window gather from pre-padded reference planes (edge-replicated
padding == h264bsdFillBlock semantics, h264bsd_reconstruct.c:2222), 6-tap
(1,-5,20,20,-5,1) half-pel filters, branchless selection over the 16
fractional positions (lumaFracPos dispatch, h264bsd_reconstruct.c:1819).

Reference planes are stored edge-replicated by PAD on every side
(pad_luma / pad_chroma); window origins are clipped into the padded
plane, which reproduces FillBlock's per-pixel clamp exactly. Chroma
planes are cb/cr lane-interleaved (lane 2x = cb, 2x+1 = cr) so one
gather serves both planes.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

PAD = 24          # edge-replication pad (>= 10x10 window => clamp-exact)


def luma_ext_dims(width: int, height: int):
    """Padded luma plane dims (rows, cols)."""
    return height + 2 * PAD, width + 2 * PAD


def chroma_ext_dims(width: int, height: int):
    """Padded interleaved chroma plane dims (rows, lanes) for a picture
    of luma size width x height."""
    return height // 2 + 2 * PAD, 2 * (width // 2 + 2 * PAD)


def pad_luma(y: jnp.ndarray) -> jnp.ndarray:
    """[H, W] -> edge-replicated [H+2*PAD, W+2*PAD] int32."""
    return jnp.pad(y, PAD, mode="edge").astype(jnp.int32)


def pad_chroma(cb: jnp.ndarray, cr: jnp.ndarray) -> jnp.ndarray:
    """[Hc, Wc] x2 -> interleaved edge-replicated
    [Hc+2*PAD, 2*(Wc+2*PAD)] int32: lane 2*x = cb column x, lane
    2*x+1 = cr column x (after PAD)."""
    Hc, Wc = cb.shape
    cbp = jnp.pad(cb, PAD, mode="edge")
    crp = jnp.pad(cr, PAD, mode="edge")
    return jnp.stack([cbp, crp], axis=-1).reshape(
        Hc + 2 * PAD, 2 * (Wc + 2 * PAD)).astype(jnp.int32)


def _tap6(a, axis):
    n = a.shape[axis] - 5
    sl = [slice(None)] * a.ndim

    def s(i):
        t = list(sl)
        t[axis] = slice(i, i + n)
        return a[tuple(t)]
    return s(0) - 5 * s(1) + 20 * s(2) + 20 * s(3) - 5 * s(4) + s(5)


def _clip8(a):
    return jnp.clip(a, 0, 255)


def mc_luma_blocks(ref_stack: jnp.ndarray, ref_idx: jnp.ndarray,
                   px: jnp.ndarray, py: jnp.ndarray,
                   mvx: jnp.ndarray, mvy: jnp.ndarray,
                   hp0: int, wp0: int) -> jnp.ndarray:
    """Predict N 4x4 luma blocks -> [N, 4, 4] int32 in [0,255].

    ref_stack: [R, hp0, wp0] int32 (pad_luma format);
    ref_idx/px/py/mvx/mvy: [N]; hp0/wp0: real padded plane dims."""
    xi = px + (mvx >> 2)
    yi = py + (mvy >> 2)
    fx = mvx & 3
    fy = mvy & 3
    x0 = jnp.clip(xi - 2 + PAD, 0, wp0 - 10)
    y0 = jnp.clip(yi - 2 + PAD, 0, hp0 - 10)

    def gather(r, yy, xx):
        return jax.lax.dynamic_slice(ref_stack, (r, yy, xx),
                                     (1, 10, 10))[0]

    win = jax.vmap(gather)(ref_idx, y0, x0)              # [N,10,10]

    raw_h = _tap6(win, 2)                                # [N,10,5]
    b = _clip8((raw_h[:, 2:7, :] + 16) >> 5)             # [N,5,5]
    hh = _clip8((_tap6(win[:, :, 2:7], 1) + 16) >> 5)    # [N,5,5]
    jj = _clip8((_tap6(raw_h, 1) + 512) >> 10)           # [N,5,5]
    g = win[:, 2:7, 2:7]                                 # [N,5,5]

    g00, g01, g10 = g[:, :4, :4], g[:, :4, 1:5], g[:, 1:5, :4]
    b0, b1 = b[:, :4, :4], b[:, 1:5, :4]
    h0, h1 = hh[:, :4, :4], hh[:, :4, 1:5]
    j0 = jj[:, :4, :4]

    def avg(a, c):
        return (a + c + 1) >> 1

    cand = jnp.stack([
        g00, avg(g00, b0), b0, avg(g01, b0),
        avg(g00, h0), avg(b0, h0), avg(j0, b0), avg(b0, h1),
        h0, avg(j0, h0), j0, avg(j0, h1),
        avg(g10, h0), avg(b1, h0), avg(j0, b1), avg(b1, h1),
    ], axis=0)                                          # [16,N,4,4]
    case = fy * 4 + fx                                  # [N]
    out = jnp.take_along_axis(
        cand, case[None, :, None, None], axis=0)[0]
    return out.astype(jnp.int32)


def mc_chroma_blocks_il(ref_stack_il: jnp.ndarray, ref_idx: jnp.ndarray,
                        px: jnp.ndarray, py: jnp.ndarray,
                        mvx: jnp.ndarray, mvy: jnp.ndarray,
                        hc0: int, wc0: int) -> jnp.ndarray:
    """Predict N 2x2 chroma block pairs from interleaved planes ->
    [N, 2, 4] int32 (lanes 0/2 = cb cols, 1/3 = cr cols).

    ref_stack_il: [R, hc0, 2*wc0] (pad_chroma format); px/py are
    chroma-plane block positions; hc0/wc0 real padded per-plane dims."""
    xi = px + (mvx >> 3)
    yi = py + (mvy >> 3)
    dx = mvx & 7
    dy = mvy & 7
    x0 = 2 * jnp.clip(xi + PAD, 0, wc0 - 3)
    y0 = jnp.clip(yi + PAD, 0, hc0 - 3)

    def gather(r, yy, xx):
        return jax.lax.dynamic_slice(ref_stack_il, (r, yy, xx),
                                     (1, 3, 6))[0]

    win = jax.vmap(gather)(ref_idx, y0, x0)              # [N,3,6]
    A = win[:, :2, 0:4]
    B = win[:, :2, 2:6]
    C = win[:, 1:3, 0:4]
    D = win[:, 1:3, 2:6]
    dx = dx[:, None, None]
    dy = dy[:, None, None]
    return (((8 - dx) * (8 - dy) * A + dx * (8 - dy) * B +
             (8 - dx) * dy * C + dx * dy * D + 32) >> 6).astype(jnp.int32)

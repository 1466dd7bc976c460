"""YUV420 -> RGB conversion — device analogue of the reference's two
converters:

- `yuv420_to_rgba_int`: bit-exact mirror of the hand-written asm.js
  converter (Player/Decoder.js:427-638 asmFactory / yuv2rgbcalc):
  r = (1192(y-16) + 1634(v-128)) >> 10, etc., clipped, RGBA output.
  (The reference also keeps a 2^24-entry result cache — pointless on a
  vector machine, the arithmetic is cheaper than the gather.)
- `yuv_to_rgb_matrix`: float path matching the WebGL fragment shader
  (Player/YUVCanvas.js:247-339) with rec601/rec709 matrices.

Both run as one fused jnp expression (XLA fuses the upsample+matmul into
a single pass; this is the P4 "GPU color conversion offload" analogue,
SURVEY.md §2.5).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

REC601 = np.array([
    [1.16438, 0.00000, 1.59603, -0.87079],
    [1.16438, -0.39176, -0.81297, 0.52959],
    [1.16438, 2.01723, 0.00000, -1.08139],
], np.float32)

REC709 = np.array([
    [1.16438, 0.00000, 1.79274, -0.97295],
    [1.16438, -0.21325, -0.53291, 0.30148],
    [1.16438, 2.11240, 0.00000, -1.13340],
], np.float32)


def _upsample_chroma(c: jnp.ndarray) -> jnp.ndarray:
    """Nearest-neighbour 2x upsample (matches both reference paths)."""
    return jnp.repeat(jnp.repeat(c, 2, axis=0), 2, axis=1)


@jax.jit
def yuv420_to_rgba_int(y: jnp.ndarray, cb: jnp.ndarray,
                       cr: jnp.ndarray) -> jnp.ndarray:
    """[H,W]+[H/2,W/2]x2 uint8/int32 -> [H,W,4] uint8 RGBA (asm.js math)."""
    yv = y.astype(jnp.int32)
    u = _upsample_chroma(cb.astype(jnp.int32))
    v = _upsample_chroma(cr.astype(jnp.int32))
    a0 = 1192 * (yv - 16)
    a1 = 1634 * (v - 128)
    a2 = 832 * (v - 128)
    a3 = 400 * (u - 128)
    a4 = 2066 * (u - 128)
    r = jnp.clip((a0 + a1) >> 10, 0, 255)
    g = jnp.clip((a0 - a2 - a3) >> 10, 0, 255)
    b = jnp.clip((a0 + a4) >> 10, 0, 255)
    a = jnp.full_like(r, 255)
    return jnp.stack([r, g, b, a], axis=-1).astype(jnp.uint8)


@jax.jit
def yuv_to_rgb_rec601(y, cb, cr):
    return _matrix_convert(y, cb, cr, jnp.asarray(REC601))


@jax.jit
def yuv_to_rgb_rec709(y, cb, cr):
    return _matrix_convert(y, cb, cr, jnp.asarray(REC709))


def _matrix_convert(y, cb, cr, m):
    yf = y.astype(jnp.float32) / 255.0
    uf = _upsample_chroma(cb.astype(jnp.float32)) / 255.0
    vf = _upsample_chroma(cr.astype(jnp.float32)) / 255.0
    ones = jnp.ones_like(yf)
    yuv1 = jnp.stack([yf, uf, vf, ones], axis=-1)       # [H,W,4]
    # HIGHEST: a float32 contraction may otherwise run in TF32 (about
    # three decimal digits) on GPUs, enough to move the rounded u8
    rgb = jnp.einsum("hwc,rc->hwr", yuv1, m,
                     precision=jax.lax.Precision.HIGHEST)
    return jnp.clip(rgb * 255.0 + 0.5, 0, 255).astype(jnp.uint8)

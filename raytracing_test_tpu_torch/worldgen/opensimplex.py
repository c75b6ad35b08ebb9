"""Seed-exact 2D OpenSimplex noise.

The reference vendors a C++ OpenSimplex port (include/OpenSimplexNoise.{h,cpp})
and uses only its 2D eval for terrain (src/world_gen.cpp:15-22). This module
re-expresses the same public algorithm:

  - the permutation table is built from the seed by three warm-up rounds of the
    64-bit LCG  seed*6364136223846793005 + 1442695040888963407  followed by a
    Fisher-Yates shuffle driven by further LCG draws
    (ref: OpenSimplexNoise.cpp:52-75) — bit-exact here, so equal seeds give
    worlds identical to the reference;
  - eval(x, y) skews the input onto a stretched grid (stretch constant
    -0.211324865405187, squish 0.366025403784439), accumulates the classic
    (2 - d^2)^4 corner-attenuated gradient contributions for up to four
    vertices, and normalizes by 47 (ref: OpenSimplexNoise.cpp:77-209).

Two implementations are provided:
  - ``OpenSimplex2D.eval`` — scalar, straight-line transcription of the
    algorithm; the parity/golden-test oracle.
  - ``OpenSimplex2D.eval_vec`` — fully vectorized over arrays of sample points,
    used by worldgen to evaluate whole heightmaps in one shot instead of the
    reference's per-column scalar calls.

This port's own copy of the 2D part of
``raytracing_test_tpu/worldgen/opensimplex.py`` (``_lcg``, ``build_perm``,
``OpenSimplex2D``): terrain needs nothing else, and the port imports nothing
of the JAX package.
"""

from __future__ import annotations

import numpy as np

STRETCH_2D = -0.211324865405187  # (1/sqrt(2+1)-1)/2
SQUISH_2D = 0.366025403784439  # (sqrt(2+1)-1)/2
NORM_2D = 47.0

GRADIENTS_2D = np.array(
    [5, 2, 2, 5, -5, 2, -2, 5, 5, -2, 2, -5, -5, -2, -2, -5], dtype=np.float64
)

_LCG_MUL = 6364136223846793005
_LCG_ADD = 1442695040888963407
_U64 = (1 << 64) - 1


def _lcg(seed: int) -> int:
    """One signed-64-bit LCG step with wrap-around."""
    s = (seed * _LCG_MUL + _LCG_ADD) & _U64
    return s - (1 << 64) if s >= (1 << 63) else s


def build_perm(seed: int) -> np.ndarray:
    """Seeded 256-entry permutation, bit-exact with the reference ctor."""
    source = list(range(256))
    perm = np.zeros(256, dtype=np.int64)
    for _ in range(3):
        seed = _lcg(seed)
    for i in range(255, -1, -1):
        seed = _lcg(seed)
        # C computes (seed+31) % (i+1) with trunc semantics then fixes the sign;
        # the combined result equals python's floored modulo.
        r = (seed + 31) % (i + 1)
        perm[i] = source[r]
        source[r] = source[i]
    return perm


class OpenSimplex2D:
    def __init__(self, seed: int):
        self.perm = build_perm(seed)

    # ------------------------------------------------------------- scalar path

    def _extrapolate(self, xsb: int, ysb: int, dx: float, dy: float) -> float:
        perm = self.perm
        index = perm[(perm[xsb & 0xFF] + ysb) & 0xFF] & 0x0E
        return GRADIENTS_2D[index] * dx + GRADIENTS_2D[index + 1] * dy

    def eval(self, x: float, y: float) -> float:
        """Scalar 2D OpenSimplex noise in [-1, 1]."""
        stretch_offset = (x + y) * STRETCH_2D
        xs, ys = x + stretch_offset, y + stretch_offset
        xsb, ysb = int(np.floor(xs)), int(np.floor(ys))
        squish_offset = (xsb + ysb) * SQUISH_2D
        dx0, dy0 = x - (xsb + squish_offset), y - (ysb + squish_offset)
        xins, yins = xs - xsb, ys - ysb
        in_sum = xins + yins

        value = 0.0
        # contribution (1, 0)
        dx1, dy1 = dx0 - 1 - SQUISH_2D, dy0 - 0 - SQUISH_2D
        attn1 = 2 - dx1 * dx1 - dy1 * dy1
        if attn1 > 0:
            attn1 *= attn1
            value += attn1 * attn1 * self._extrapolate(xsb + 1, ysb, dx1, dy1)
        # contribution (0, 1)
        dx2, dy2 = dx0 - 0 - SQUISH_2D, dy0 - 1 - SQUISH_2D
        attn2 = 2 - dx2 * dx2 - dy2 * dy2
        if attn2 > 0:
            attn2 *= attn2
            value += attn2 * attn2 * self._extrapolate(xsb, ysb + 1, dx2, dy2)

        if in_sum <= 1:  # inside the (0,0) simplex
            zins = 1 - in_sum
            if zins > xins or zins > yins:
                if xins > yins:
                    xsv_ext, ysv_ext = xsb + 1, ysb - 1
                    dx_ext, dy_ext = dx0 - 1, dy0 + 1
                else:
                    xsv_ext, ysv_ext = xsb - 1, ysb + 1
                    dx_ext, dy_ext = dx0 + 1, dy0 - 1
            else:
                xsv_ext, ysv_ext = xsb + 1, ysb + 1
                dx_ext, dy_ext = dx0 - 1 - 2 * SQUISH_2D, dy0 - 1 - 2 * SQUISH_2D
        else:  # inside the (1,1) simplex
            zins = 2 - in_sum
            if zins < xins or zins < yins:
                if xins > yins:
                    xsv_ext, ysv_ext = xsb + 2, ysb
                    dx_ext, dy_ext = dx0 - 2 - 2 * SQUISH_2D, dy0 - 2 * SQUISH_2D
                else:
                    xsv_ext, ysv_ext = xsb, ysb + 2
                    dx_ext, dy_ext = dx0 - 2 * SQUISH_2D, dy0 - 2 - 2 * SQUISH_2D
            else:
                xsv_ext, ysv_ext = xsb, ysb
                dx_ext, dy_ext = dx0, dy0
            xsb += 1
            ysb += 1
            dx0 = dx0 - 1 - 2 * SQUISH_2D
            dy0 = dy0 - 1 - 2 * SQUISH_2D

        # contribution (0,0) or (1,1)
        attn0 = 2 - dx0 * dx0 - dy0 * dy0
        if attn0 > 0:
            attn0 *= attn0
            value += attn0 * attn0 * self._extrapolate(xsb, ysb, dx0, dy0)
        # extra vertex
        attn_ext = 2 - dx_ext * dx_ext - dy_ext * dy_ext
        if attn_ext > 0:
            attn_ext *= attn_ext
            value += attn_ext * attn_ext * self._extrapolate(xsv_ext, ysv_ext, dx_ext, dy_ext)

        return value / NORM_2D

    # --------------------------------------------------------- vectorized path

    def eval_vec(self, x, y, xp=np):
        """Vectorized eval over same-shaped arrays ``x``/``y``.

        ``xp`` may be numpy or jax.numpy; all branches become selects, so the
        function traces cleanly under jit and is differentiable w.r.t. x/y.
        """
        perm = xp.asarray(self.perm)
        grads = xp.asarray(GRADIENTS_2D)

        def extrap(xsb, ysb, dx, dy):
            i0 = perm[xsb & 0xFF]
            index = perm[(i0 + ysb) & 0xFF] & 0x0E
            return grads[index] * dx + grads[index + 1] * dy

        ftype = xp.float64 if xp is np else xp.float32  # jax defaults to x32
        itype = xp.int64 if xp is np else xp.int32
        x = xp.asarray(x, dtype=ftype)
        y = xp.asarray(y, dtype=ftype)
        stretch_offset = (x + y) * STRETCH_2D
        xs, ys = x + stretch_offset, y + stretch_offset
        xsb = xp.floor(xs).astype(itype)
        ysb = xp.floor(ys).astype(itype)
        squish_offset = (xsb + ysb) * SQUISH_2D
        dx0, dy0 = x - (xsb + squish_offset), y - (ysb + squish_offset)
        xins, yins = xs - xsb, ys - ysb
        in_sum = xins + yins

        def contrib(attn, val):
            a = xp.maximum(attn, 0.0)
            a *= a
            return a * a * val

        dx1, dy1 = dx0 - 1 - SQUISH_2D, dy0 - SQUISH_2D
        v1 = contrib(2 - dx1 * dx1 - dy1 * dy1, extrap(xsb + 1, ysb, dx1, dy1))
        dx2, dy2 = dx0 - SQUISH_2D, dy0 - 1 - SQUISH_2D
        v2 = contrib(2 - dx2 * dx2 - dy2 * dy2, extrap(xsb, ysb + 1, dx2, dy2))

        lo = in_sum <= 1
        zins = xp.where(lo, 1 - in_sum, 2 - in_sum)
        # scalar logic: lo: (zins > xins or zins > yins) == zins > min(xins, yins)
        #               hi: (zins < xins or zins < yins) == zins < max(xins, yins)
        corner = xp.where(lo, zins > xp.minimum(xins, yins), zins < xp.maximum(xins, yins))
        xgty = xins > yins

        # extra-vertex offsets relative to (xsb, ysb), by case
        xoff = xp.where(
            lo,
            xp.where(corner, xp.where(xgty, 1, -1), 1),
            xp.where(corner, xp.where(xgty, 2, 0), 0),
        )
        yoff = xp.where(
            lo,
            xp.where(corner, xp.where(xgty, -1, 1), 1),
            xp.where(corner, xp.where(xgty, 0, 2), 0),
        )
        sq = xp.where(lo, xp.where(corner, 0.0, 2 * SQUISH_2D), xp.where(corner, 2 * SQUISH_2D, 0.0))
        xsv_ext = xsb + xoff
        ysv_ext = ysb + yoff
        dx_ext = dx0 - xoff - sq
        dy_ext = dy0 - yoff - sq

        # (1,1)-simplex re-anchoring of the (0,0)/(1,1) contribution
        xsb2 = xp.where(lo, xsb, xsb + 1)
        ysb2 = xp.where(lo, ysb, ysb + 1)
        dx0b = xp.where(lo, dx0, dx0 - 1 - 2 * SQUISH_2D)
        dy0b = xp.where(lo, dy0, dy0 - 1 - 2 * SQUISH_2D)

        v0 = contrib(2 - dx0b * dx0b - dy0b * dy0b, extrap(xsb2, ysb2, dx0b, dy0b))
        ve = contrib(
            2 - dx_ext * dx_ext - dy_ext * dy_ext, extrap(xsv_ext, ysv_ext, dx_ext, dy_ext)
        )

        return (v0 + v1 + v2 + ve) / NORM_2D

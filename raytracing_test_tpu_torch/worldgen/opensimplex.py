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

This port's own copy of ``raytracing_test_tpu/worldgen/opensimplex.py``,
with the arithmetic unchanged: ``_lcg``, ``build_perm``, ``OpenSimplex2D``
(terrain), and the scalar ``OpenSimplex3D`` / ``OpenSimplex4D`` of the
vendored component, which the world generator does not call. The port
imports nothing of the JAX package.
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


# ---------------------------------------------------------------------------
# 3D / 4D eval — completing the vendored component's surface (C6).
#
# The reference vendors full 2D/3D/4D OpenSimplex (include/OpenSimplexNoise.cpp,
# 3D eval :211-520 + m_permGradIndex3d ctor :64-72, 4D eval :713-2516) although
# its world generator only calls the 2D eval. As with the 2D scalar path above,
# these are straight-line transcriptions of the public-domain algorithm the
# reference vendors — the per-region vertex-selection logic is SEMANTIC (an
# all-candidates attenuation sum measurably diverges by ~1e-5, so the exact
# branch structure is the spec). Golden tests (tests/golden/opensimplex34.npz,
# values generated from the vendored port at fixed seeds) pin them to ~1e-12.

STRETCH_3D = -1.0 / 6.0
SQUISH_3D = 1.0 / 3.0
NORM_3D = 103.0
STRETCH_4D = -0.138196601125011
SQUISH_4D = 0.309016994374947
NORM_4D = 30.0

GRADIENTS_3D = np.array(
    [-11, 4, 4, -4, 11, 4, -4, 4, 11, 11, 4, 4, 4, 11, 4, 4, 4, 11,
     -11, -4, 4, -4, -11, 4, -4, -4, 11, 11, -4, 4, 4, -11, 4, 4, -4, 11,
     -11, 4, -4, -4, 11, -4, -4, 4, -11, 11, 4, -4, 4, 11, -4, 4, 4, -11,
     -11, -4, -4, -4, -11, -4, -4, -4, -11, 11, -4, -4, 4, -11, -4, 4, -4, -11],
    dtype=np.float64,
)

GRADIENTS_4D = np.array(
    [3, 1, 1, 1, 1, 3, 1, 1, 1, 1, 3, 1, 1, 1, 1, 3,
     -3, 1, 1, 1, -1, 3, 1, 1, -1, 1, 3, 1, -1, 1, 1, 3,
     3, -1, 1, 1, 1, -3, 1, 1, 1, -1, 3, 1, 1, -1, 1, 3,
     -3, -1, 1, 1, -1, -3, 1, 1, -1, -1, 3, 1, -1, -1, 1, 3,
     3, 1, -1, 1, 1, 3, -1, 1, 1, 1, -3, 1, 1, 1, -1, 3,
     -3, 1, -1, 1, -1, 3, -1, 1, -1, 1, -3, 1, -1, 1, -1, 3,
     3, -1, -1, 1, 1, -3, -1, 1, 1, -1, -3, 1, 1, -1, -1, 3,
     -3, -1, -1, 1, -1, -3, -1, 1, -1, -1, -3, 1, -1, -1, -1, 3,
     3, 1, 1, -1, 1, 3, 1, -1, 1, 1, 3, -1, 1, 1, 1, -3,
     -3, 1, 1, -1, -1, 3, 1, -1, -1, 1, 3, -1, -1, 1, 1, -3,
     3, -1, 1, -1, 1, -3, 1, -1, 1, -1, 3, -1, 1, -1, 1, -3,
     -3, -1, 1, -1, -1, -3, 1, -1, -1, -1, 3, -1, -1, -1, 1, -3,
     3, 1, -1, -1, 1, 3, -1, -1, 1, 1, -3, -1, 1, 1, -1, -3,
     -3, 1, -1, -1, -1, 3, -1, -1, -1, 1, -3, -1, -1, 1, -1, -3,
     3, -1, -1, -1, 1, -3, -1, -1, 1, -1, -3, -1, 1, -1, -1, -3,
     -3, -1, -1, -1, -1, -3, -1, -1, -1, -1, -3, -1, -1, -1, -1, -3],
    dtype=np.float64,
)


class OpenSimplex3D:
    """Scalar 3D OpenSimplex (ref OpenSimplexNoise.cpp:211-520)."""

    def __init__(self, seed: int):
        self.perm = build_perm(seed)
        # m_permGradIndex3d (ctor :72): perm value -> gradient triple offset
        self.perm_grad3 = (self.perm % (GRADIENTS_3D.shape[0] // 3)) * 3

    def _extrap(self, xsb, ysb, zsb, dx, dy, dz):
        perm = self.perm
        idx = self.perm_grad3[(perm[(perm[xsb & 0xFF] + ysb) & 0xFF] + zsb) & 0xFF]
        return GRADIENTS_3D[idx] * dx + GRADIENTS_3D[idx + 1] * dy + GRADIENTS_3D[idx + 2] * dz

    def eval(self, x: float, y: float, z: float) -> float:
        sq = SQUISH_3D
        so = (x + y + z) * STRETCH_3D
        xs, ys, zs = x + so, y + so, z + so
        xsb, ysb, zsb = int(np.floor(xs)), int(np.floor(ys)), int(np.floor(zs))
        qo = (xsb + ysb + zsb) * sq
        xb, yb, zb = xsb + qo, ysb + qo, zsb + qo
        xins, yins, zins = xs - xsb, ys - ysb, zs - zsb
        in_sum = xins + yins + zins
        dx0, dy0, dz0 = x - xb, y - yb, z - zb
        value = 0.0

        def contrib(dx, dy, dz, xv, yv, zv):
            attn = 2 - dx * dx - dy * dy - dz * dz
            if attn > 0:
                attn *= attn
                return attn * attn * self._extrap(xv, yv, zv, dx, dy, dz)
            return 0.0

        if in_sum <= 1:  # inside the (0,0,0) tetrahedron
            a_point, a_score = 0x01, xins
            b_point, b_score = 0x02, yins
            if a_score >= b_score and zins > b_score:
                b_score, b_point = zins, 0x04
            elif a_score < b_score and zins > a_score:
                a_score, a_point = zins, 0x04
            wins = 1 - in_sum
            if wins > a_score or wins > b_score:  # (0,0,0) among closest two
                c = b_point if b_score > a_score else a_point
                if (c & 0x01) == 0:
                    xsv0, xsv1 = xsb - 1, xsb
                    dxe0, dxe1 = dx0 + 1, dx0
                else:
                    xsv0 = xsv1 = xsb + 1
                    dxe0 = dxe1 = dx0 - 1
                if (c & 0x02) == 0:
                    ysv0 = ysv1 = ysb
                    dye0 = dye1 = dy0
                    if (c & 0x01) == 0:
                        ysv1 -= 1
                        dye1 += 1
                    else:
                        ysv0 -= 1
                        dye0 += 1
                else:
                    ysv0 = ysv1 = ysb + 1
                    dye0 = dye1 = dy0 - 1
                if (c & 0x04) == 0:
                    zsv0, zsv1 = zsb, zsb - 1
                    dze0, dze1 = dz0, dz0 + 1
                else:
                    zsv0 = zsv1 = zsb + 1
                    dze0 = dze1 = dz0 - 1
            else:  # (0,0,0) not among closest two
                c = a_point | b_point
                if (c & 0x01) == 0:
                    xsv0, xsv1 = xsb, xsb - 1
                    dxe0, dxe1 = dx0 - 2 * sq, dx0 + 1 - sq
                else:
                    xsv0 = xsv1 = xsb + 1
                    dxe0, dxe1 = dx0 - 1 - 2 * sq, dx0 - 1 - sq
                if (c & 0x02) == 0:
                    ysv0, ysv1 = ysb, ysb - 1
                    dye0, dye1 = dy0 - 2 * sq, dy0 + 1 - sq
                else:
                    ysv0 = ysv1 = ysb + 1
                    dye0, dye1 = dy0 - 1 - 2 * sq, dy0 - 1 - sq
                if (c & 0x04) == 0:
                    zsv0, zsv1 = zsb, zsb - 1
                    dze0, dze1 = dz0 - 2 * sq, dz0 + 1 - sq
                else:
                    zsv0 = zsv1 = zsb + 1
                    dze0, dze1 = dz0 - 1 - 2 * sq, dz0 - 1 - sq
            value += contrib(dx0, dy0, dz0, xsb, ysb, zsb)
            dx1, dy1, dz1 = dx0 - 1 - sq, dy0 - sq, dz0 - sq
            value += contrib(dx1, dy1, dz1, xsb + 1, ysb, zsb)
            dx2, dy2, dz2 = dx0 - sq, dy0 - 1 - sq, dz1
            value += contrib(dx2, dy2, dz2, xsb, ysb + 1, zsb)
            dx3, dy3, dz3 = dx2, dy1, dz0 - 1 - sq
            value += contrib(dx3, dy3, dz3, xsb, ysb, zsb + 1)
        elif in_sum >= 2:  # inside the (1,1,1) tetrahedron
            a_point, a_score = 0x06, xins
            b_point, b_score = 0x05, yins
            if a_score <= b_score and zins < b_score:
                b_score, b_point = zins, 0x03
            elif a_score > b_score and zins < a_score:
                a_score, a_point = zins, 0x03
            wins = 3 - in_sum
            if wins < a_score or wins < b_score:  # (1,1,1) among closest two
                c = b_point if b_score < a_score else a_point
                if (c & 0x01) != 0:
                    xsv0, xsv1 = xsb + 2, xsb + 1
                    dxe0, dxe1 = dx0 - 2 - 3 * sq, dx0 - 1 - 3 * sq
                else:
                    xsv0 = xsv1 = xsb
                    dxe0 = dxe1 = dx0 - 3 * sq
                if (c & 0x02) != 0:
                    ysv0 = ysv1 = ysb + 1
                    dye0 = dye1 = dy0 - 1 - 3 * sq
                    if (c & 0x01) != 0:
                        ysv1 += 1
                        dye1 -= 1
                    else:
                        ysv0 += 1
                        dye0 -= 1
                else:
                    ysv0 = ysv1 = ysb
                    dye0 = dye1 = dy0 - 3 * sq
                if (c & 0x04) != 0:
                    zsv0, zsv1 = zsb + 1, zsb + 2
                    dze0, dze1 = dz0 - 1 - 3 * sq, dz0 - 2 - 3 * sq
                else:
                    zsv0 = zsv1 = zsb
                    dze0 = dze1 = dz0 - 3 * sq
            else:  # (1,1,1) not among closest two
                c = a_point & b_point
                if (c & 0x01) != 0:
                    xsv0, xsv1 = xsb + 1, xsb + 2
                    dxe0, dxe1 = dx0 - 1 - sq, dx0 - 2 - 2 * sq
                else:
                    xsv0 = xsv1 = xsb
                    dxe0, dxe1 = dx0 - sq, dx0 - 2 * sq
                if (c & 0x02) != 0:
                    ysv0, ysv1 = ysb + 1, ysb + 2
                    dye0, dye1 = dy0 - 1 - sq, dy0 - 2 - 2 * sq
                else:
                    ysv0 = ysv1 = ysb
                    dye0, dye1 = dy0 - sq, dy0 - 2 * sq
                if (c & 0x04) != 0:
                    zsv0, zsv1 = zsb + 1, zsb + 2
                    dze0, dze1 = dz0 - 1 - sq, dz0 - 2 - 2 * sq
                else:
                    zsv0 = zsv1 = zsb
                    dze0, dze1 = dz0 - sq, dz0 - 2 * sq
            dx3, dy3, dz3 = dx0 - 1 - 2 * sq, dy0 - 1 - 2 * sq, dz0 - 2 * sq
            value += contrib(dx3, dy3, dz3, xsb + 1, ysb + 1, zsb)
            dx2, dy2, dz2 = dx3, dy0 - 2 * sq, dz0 - 1 - 2 * sq
            value += contrib(dx2, dy2, dz2, xsb + 1, ysb, zsb + 1)
            dx1, dy1, dz1 = dx0 - 2 * sq, dy3, dz2
            value += contrib(dx1, dy1, dz1, xsb, ysb + 1, zsb + 1)
            dx0, dy0, dz0 = dx0 - 1 - 3 * sq, dy0 - 1 - 3 * sq, dz0 - 1 - 3 * sq
            value += contrib(dx0, dy0, dz0, xsb + 1, ysb + 1, zsb + 1)
        else:  # inside the middle octahedron
            p1 = xins + yins
            if p1 > 1:
                a_score, a_point, a_far = p1 - 1, 0x03, True
            else:
                a_score, a_point, a_far = 1 - p1, 0x04, False
            p2 = xins + zins
            if p2 > 1:
                b_score, b_point, b_far = p2 - 1, 0x05, True
            else:
                b_score, b_point, b_far = 1 - p2, 0x02, False
            p3 = yins + zins
            if p3 > 1:
                score = p3 - 1
                if a_score <= b_score and a_score < score:
                    a_score, a_point, a_far = score, 0x06, True
                elif a_score > b_score and b_score < score:
                    b_score, b_point, b_far = score, 0x06, True
            else:
                score = 1 - p3
                if a_score <= b_score and a_score < score:
                    a_score, a_point, a_far = score, 0x01, False
                elif a_score > b_score and b_score < score:
                    b_score, b_point, b_far = score, 0x01, False
            if a_far == b_far:
                if a_far:  # both closest on the (1,1,1) side
                    dxe0, dye0, dze0 = dx0 - 1 - 3 * sq, dy0 - 1 - 3 * sq, dz0 - 1 - 3 * sq
                    xsv0, ysv0, zsv0 = xsb + 1, ysb + 1, zsb + 1
                    c = a_point & b_point
                    if (c & 0x01) != 0:
                        dxe1, dye1, dze1 = dx0 - 2 - 2 * sq, dy0 - 2 * sq, dz0 - 2 * sq
                        xsv1, ysv1, zsv1 = xsb + 2, ysb, zsb
                    elif (c & 0x02) != 0:
                        dxe1, dye1, dze1 = dx0 - 2 * sq, dy0 - 2 - 2 * sq, dz0 - 2 * sq
                        xsv1, ysv1, zsv1 = xsb, ysb + 2, zsb
                    else:
                        dxe1, dye1, dze1 = dx0 - 2 * sq, dy0 - 2 * sq, dz0 - 2 - 2 * sq
                        xsv1, ysv1, zsv1 = xsb, ysb, zsb + 2
                else:  # both closest on the (0,0,0) side
                    dxe0, dye0, dze0 = dx0, dy0, dz0
                    xsv0, ysv0, zsv0 = xsb, ysb, zsb
                    c = a_point | b_point
                    if (c & 0x01) == 0:
                        dxe1, dye1, dze1 = dx0 + 1 - sq, dy0 - 1 - sq, dz0 - 1 - sq
                        xsv1, ysv1, zsv1 = xsb - 1, ysb + 1, zsb + 1
                    elif (c & 0x02) == 0:
                        dxe1, dye1, dze1 = dx0 - 1 - sq, dy0 + 1 - sq, dz0 - 1 - sq
                        xsv1, ysv1, zsv1 = xsb + 1, ysb - 1, zsb + 1
                    else:
                        dxe1, dye1, dze1 = dx0 - 1 - sq, dy0 - 1 - sq, dz0 + 1 - sq
                        xsv1, ysv1, zsv1 = xsb + 1, ysb + 1, zsb - 1
            else:  # one on each side
                c1, c2 = (a_point, b_point) if a_far else (b_point, a_point)
                if (c1 & 0x01) == 0:
                    dxe0, dye0, dze0 = dx0 + 1 - sq, dy0 - 1 - sq, dz0 - 1 - sq
                    xsv0, ysv0, zsv0 = xsb - 1, ysb + 1, zsb + 1
                elif (c1 & 0x02) == 0:
                    dxe0, dye0, dze0 = dx0 - 1 - sq, dy0 + 1 - sq, dz0 - 1 - sq
                    xsv0, ysv0, zsv0 = xsb + 1, ysb - 1, zsb + 1
                else:
                    dxe0, dye0, dze0 = dx0 - 1 - sq, dy0 - 1 - sq, dz0 + 1 - sq
                    xsv0, ysv0, zsv0 = xsb + 1, ysb + 1, zsb - 1
                dxe1, dye1, dze1 = dx0 - 2 * sq, dy0 - 2 * sq, dz0 - 2 * sq
                xsv1, ysv1, zsv1 = xsb, ysb, zsb
                if (c2 & 0x01) != 0:
                    dxe1 -= 2
                    xsv1 += 2
                elif (c2 & 0x02) != 0:
                    dye1 -= 2
                    ysv1 += 2
                else:
                    dze1 -= 2
                    zsv1 += 2
            dx1, dy1, dz1 = dx0 - 1 - sq, dy0 - sq, dz0 - sq
            value += contrib(dx1, dy1, dz1, xsb + 1, ysb, zsb)
            dx2, dy2, dz2 = dx0 - sq, dy0 - 1 - sq, dz1
            value += contrib(dx2, dy2, dz2, xsb, ysb + 1, zsb)
            dx3, dy3, dz3 = dx2, dy1, dz0 - 1 - sq
            value += contrib(dx3, dy3, dz3, xsb, ysb, zsb + 1)
            dx4, dy4, dz4 = dx0 - 1 - 2 * sq, dy0 - 1 - 2 * sq, dz0 - 2 * sq
            value += contrib(dx4, dy4, dz4, xsb + 1, ysb + 1, zsb)
            dx5, dy5, dz5 = dx4, dy0 - 2 * sq, dz0 - 1 - 2 * sq
            value += contrib(dx5, dy5, dz5, xsb + 1, ysb, zsb + 1)
            dx6, dy6, dz6 = dx0 - 2 * sq, dy4, dz5
            value += contrib(dx6, dy6, dz6, xsb, ysb + 1, zsb + 1)

        value += contrib(dxe0, dye0, dze0, xsv0, ysv0, zsv0)
        value += contrib(dxe1, dye1, dze1, xsv1, ysv1, zsv1)
        return value / NORM_3D


class OpenSimplex4D:
    """Scalar 4D OpenSimplex (ref OpenSimplexNoise.cpp:889-2516).

    The region-dispatch body is a mechanical transcription of the vendored
    public-domain port (variable names kept so the golden diff is auditable);
    bit-exactness vs the port is asserted by tests/golden/opensimplex34.npz.
    """

    def __init__(self, seed: int):
        self.perm = build_perm(seed)

    def _extrap(self, xsb, ysb, zsb, wsb, dx, dy, dz, dw):
        perm = self.perm
        idx = perm[(perm[(perm[(perm[xsb & 0xFF] + ysb) & 0xFF] + zsb) & 0xFF] + wsb) & 0xFF] & 0xFC
        return (GRADIENTS_4D[idx] * dx + GRADIENTS_4D[idx + 1] * dy
                + GRADIENTS_4D[idx + 2] * dz + GRADIENTS_4D[idx + 3] * dw)

    def eval(self, x: float, y: float, z: float, w: float) -> float:
        sq = SQUISH_4D
        so = (x + y + z + w) * STRETCH_4D
        xs, ys, zs, ws = x + so, y + so, z + so, w + so
        xsb, ysb, zsb = int(np.floor(xs)), int(np.floor(ys)), int(np.floor(zs))
        wsb = int(np.floor(ws))
        qo = (xsb + ysb + zsb + wsb) * sq
        xb, yb, zb, wb = xsb + qo, ysb + qo, zsb + qo, wsb + qo
        xins, yins, zins, wins = xs - xsb, ys - ysb, zs - zsb, ws - wsb
        inSum = xins + yins + zins + wins
        dx0, dy0, dz0, dw0 = x - xb, y - yb, z - zb, w - wb
        value = 0.0
        if inSum <= 1:
            # Determine which two of (0,0,0,1), (0,0,1,0), (0,1,0,0), (1,0,0,0) are closest.
            aPoint = 0x01
            aScore = xins
            bPoint = 0x02
            bScore = yins
            if aScore >= bScore and zins > bScore:
                bScore = zins
                bPoint = 0x04
            elif aScore < bScore and zins > aScore:
                aScore = zins
                aPoint = 0x04
            if aScore >= bScore and wins > bScore:
                bScore = wins
                bPoint = 0x08
            elif aScore < bScore and wins > aScore:
                aScore = wins
                aPoint = 0x08
            # Now we determine the three lattice points not part of the pentachoron that may contribute.
            # This depends on the closest two pentachoron vertices, including (0,0,0,0)
            uins = 1 - inSum
            if uins > aScore or uins > bScore:
                c = ((bPoint) if (bScore > aScore) else (aPoint))  # Our other closest vertex is the closest out of a and b.
                if (c & 0x01) == 0:
                    xsv_ext0 = xsb - 1
                    xsv_ext1 = xsv_ext2 = xsb
                    dx_ext0 = dx0 + 1
                    dx_ext1 = dx_ext2 = dx0
                else:
                    xsv_ext0 = xsv_ext1 = xsv_ext2 = xsb + 1
                    dx_ext0 = dx_ext1 = dx_ext2 = dx0 - 1
                if (c & 0x02) == 0:
                    ysv_ext0 = ysv_ext1 = ysv_ext2 = ysb
                    dy_ext0 = dy_ext1 = dy_ext2 = dy0
                    if (c & 0x01) == 0x01:
                        ysv_ext0 -= 1
                        dy_ext0 += 1
                    else:
                        ysv_ext1 -= 1
                        dy_ext1 += 1
                else:
                    ysv_ext0 = ysv_ext1 = ysv_ext2 = ysb + 1
                    dy_ext0 = dy_ext1 = dy_ext2 = dy0 - 1
                if (c & 0x04) == 0:
                    zsv_ext0 = zsv_ext1 = zsv_ext2 = zsb
                    dz_ext0 = dz_ext1 = dz_ext2 = dz0
                    if (c & 0x03) != 0:
                        if (c & 0x03) == 0x03:
                            zsv_ext0 -= 1
                            dz_ext0 += 1
                        else:
                            zsv_ext1 -= 1
                            dz_ext1 += 1
                    else:
                        zsv_ext2 -= 1
                        dz_ext2 += 1
                else:
                    zsv_ext0 = zsv_ext1 = zsv_ext2 = zsb + 1
                    dz_ext0 = dz_ext1 = dz_ext2 = dz0 - 1
                if (c & 0x08) == 0:
                    wsv_ext0 = wsv_ext1 = wsb
                    wsv_ext2 = wsb - 1
                    dw_ext0 = dw_ext1 = dw0
                    dw_ext2 = dw0 + 1
                else:
                    wsv_ext0 = wsv_ext1 = wsv_ext2 = wsb + 1
                    dw_ext0 = dw_ext1 = dw_ext2 = dw0 - 1
            else:
                c = (aPoint | bPoint)  # Our three extra vertices are determined by the closest two.
                if (c & 0x01) == 0:
                    xsv_ext0 = xsv_ext2 = xsb
                    xsv_ext1 = xsb - 1
                    dx_ext0 = dx0 - 2 * sq
                    dx_ext1 = dx0 + 1 - sq
                    dx_ext2 = dx0 - sq
                else:
                    xsv_ext0 = xsv_ext1 = xsv_ext2 = xsb + 1
                    dx_ext0 = dx0 - 1 - 2 * sq
                    dx_ext1 = dx_ext2 = dx0 - 1 - sq
                if (c & 0x02) == 0:
                    ysv_ext0 = ysv_ext1 = ysv_ext2 = ysb
                    dy_ext0 = dy0 - 2 * sq
                    dy_ext1 = dy_ext2 = dy0 - sq
                    if (c & 0x01) == 0x01:
                        ysv_ext1 -= 1
                        dy_ext1 += 1
                    else:
                        ysv_ext2 -= 1
                        dy_ext2 += 1
                else:
                    ysv_ext0 = ysv_ext1 = ysv_ext2 = ysb + 1
                    dy_ext0 = dy0 - 1 - 2 * sq
                    dy_ext1 = dy_ext2 = dy0 - 1 - sq
                if (c & 0x04) == 0:
                    zsv_ext0 = zsv_ext1 = zsv_ext2 = zsb
                    dz_ext0 = dz0 - 2 * sq
                    dz_ext1 = dz_ext2 = dz0 - sq
                    if (c & 0x03) == 0x03:
                        zsv_ext1 -= 1
                        dz_ext1 += 1
                    else:
                        zsv_ext2 -= 1
                        dz_ext2 += 1
                else:
                    zsv_ext0 = zsv_ext1 = zsv_ext2 = zsb + 1
                    dz_ext0 = dz0 - 1 - 2 * sq
                    dz_ext1 = dz_ext2 = dz0 - 1 - sq
                if (c & 0x08) == 0:
                    wsv_ext0 = wsv_ext1 = wsb
                    wsv_ext2 = wsb - 1
                    dw_ext0 = dw0 - 2 * sq
                    dw_ext1 = dw0 - sq
                    dw_ext2 = dw0 + 1 - sq
                else:
                    wsv_ext0 = wsv_ext1 = wsv_ext2 = wsb + 1
                    dw_ext0 = dw0 - 1 - 2 * sq
                    dw_ext1 = dw_ext2 = dw0 - 1 - sq
            # Contribution (0,0,0,0)
            attn0 = 2 - dx0 * dx0 - dy0 * dy0 - dz0 * dz0 - dw0 * dw0
            if attn0 > 0:
                attn0 *= attn0
                value += attn0 * attn0 * self._extrap(xsb + 0, ysb + 0, zsb + 0, wsb + 0, dx0, dy0, dz0, dw0)
            # Contribution (1,0,0,0)
            dx1 = dx0 - 1 - sq
            dy1 = dy0 - 0 - sq
            dz1 = dz0 - 0 - sq
            dw1 = dw0 - 0 - sq
            attn1 = 2 - dx1 * dx1 - dy1 * dy1 - dz1 * dz1 - dw1 * dw1
            if attn1 > 0:
                attn1 *= attn1
                value += attn1 * attn1 * self._extrap(xsb + 1, ysb + 0, zsb + 0, wsb + 0, dx1, dy1, dz1, dw1)
            # Contribution (0,1,0,0)
            dx2 = dx0 - 0 - sq
            dy2 = dy0 - 1 - sq
            dz2 = dz1
            dw2 = dw1
            attn2 = 2 - dx2 * dx2 - dy2 * dy2 - dz2 * dz2 - dw2 * dw2
            if attn2 > 0:
                attn2 *= attn2
                value += attn2 * attn2 * self._extrap(xsb + 0, ysb + 1, zsb + 0, wsb + 0, dx2, dy2, dz2, dw2)
            # Contribution (0,0,1,0)
            dx3 = dx2
            dy3 = dy1
            dz3 = dz0 - 1 - sq
            dw3 = dw1
            attn3 = 2 - dx3 * dx3 - dy3 * dy3 - dz3 * dz3 - dw3 * dw3
            if attn3 > 0:
                attn3 *= attn3
                value += attn3 * attn3 * self._extrap(xsb + 0, ysb + 0, zsb + 1, wsb + 0, dx3, dy3, dz3, dw3)
            # Contribution (0,0,0,1)
            dx4 = dx2
            dy4 = dy1
            dz4 = dz1
            dw4 = dw0 - 1 - sq
            attn4 = 2 - dx4 * dx4 - dy4 * dy4 - dz4 * dz4 - dw4 * dw4
            if attn4 > 0:
                attn4 *= attn4
                value += attn4 * attn4 * self._extrap(xsb + 0, ysb + 0, zsb + 0, wsb + 1, dx4, dy4, dz4, dw4)
        elif inSum >= 3:
            # Determine which two of (1,1,1,0), (1,1,0,1), (1,0,1,1), (0,1,1,1) are closest.
            aPoint = 0x0E
            aScore = xins
            bPoint = 0x0D
            bScore = yins
            if aScore <= bScore and zins < bScore:
                bScore = zins
                bPoint = 0x0B
            elif aScore > bScore and zins < aScore:
                aScore = zins
                aPoint = 0x0B
            if aScore <= bScore and wins < bScore:
                bScore = wins
                bPoint = 0x07
            elif aScore > bScore and wins < aScore:
                aScore = wins
                aPoint = 0x07
            # Now we determine the three lattice points not part of the pentachoron that may contribute.
            # This depends on the closest two pentachoron vertices, including (0,0,0,0)
            uins = 4 - inSum
            if uins < aScore or uins < bScore:
                c = ((bPoint) if (bScore < aScore) else (aPoint))  # Our other closest vertex is the closest out of a and b.
                if (c & 0x01) != 0:
                    xsv_ext0 = xsb + 2
                    xsv_ext1 = xsv_ext2 = xsb + 1
                    dx_ext0 = dx0 - 2 - 4 * sq
                    dx_ext1 = dx_ext2 = dx0 - 1 - 4 * sq
                else:
                    xsv_ext0 = xsv_ext1 = xsv_ext2 = xsb
                    dx_ext0 = dx_ext1 = dx_ext2 = dx0 - 4 * sq
                if (c & 0x02) != 0:
                    ysv_ext0 = ysv_ext1 = ysv_ext2 = ysb + 1
                    dy_ext0 = dy_ext1 = dy_ext2 = dy0 - 1 - 4 * sq
                    if (c & 0x01) != 0:
                        ysv_ext1 += 1
                        dy_ext1 -= 1
                    else:
                        ysv_ext0 += 1
                        dy_ext0 -= 1
                else:
                    ysv_ext0 = ysv_ext1 = ysv_ext2 = ysb
                    dy_ext0 = dy_ext1 = dy_ext2 = dy0 - 4 * sq
                if (c & 0x04) != 0:
                    zsv_ext0 = zsv_ext1 = zsv_ext2 = zsb + 1
                    dz_ext0 = dz_ext1 = dz_ext2 = dz0 - 1 - 4 * sq
                    if (c & 0x03) != 0x03:
                        if (c & 0x03) == 0:
                            zsv_ext0 += 1
                            dz_ext0 -= 1
                        else:
                            zsv_ext1 += 1
                            dz_ext1 -= 1
                    else:
                        zsv_ext2 += 1
                        dz_ext2 -= 1
                else:
                    zsv_ext0 = zsv_ext1 = zsv_ext2 = zsb
                    dz_ext0 = dz_ext1 = dz_ext2 = dz0 - 4 * sq
                if (c & 0x08) != 0:
                    wsv_ext0 = wsv_ext1 = wsb + 1
                    wsv_ext2 = wsb + 2
                    dw_ext0 = dw_ext1 = dw0 - 1 - 4 * sq
                    dw_ext2 = dw0 - 2 - 4 * sq
                else:
                    wsv_ext0 = wsv_ext1 = wsv_ext2 = wsb
                    dw_ext0 = dw_ext1 = dw_ext2 = dw0 - 4 * sq
            else:
                c = (aPoint & bPoint)  # Our three extra vertices are determined by the closest two.
                if (c & 0x01) != 0:
                    xsv_ext0 = xsv_ext2 = xsb + 1
                    xsv_ext1 = xsb + 2
                    dx_ext0 = dx0 - 1 - 2 * sq
                    dx_ext1 = dx0 - 2 - 3 * sq
                    dx_ext2 = dx0 - 1 - 3 * sq
                else:
                    xsv_ext0 = xsv_ext1 = xsv_ext2 = xsb
                    dx_ext0 = dx0 - 2 * sq
                    dx_ext1 = dx_ext2 = dx0 - 3 * sq
                if (c & 0x02) != 0:
                    ysv_ext0 = ysv_ext1 = ysv_ext2 = ysb + 1
                    dy_ext0 = dy0 - 1 - 2 * sq
                    dy_ext1 = dy_ext2 = dy0 - 1 - 3 * sq
                    if (c & 0x01) != 0:
                        ysv_ext2 += 1
                        dy_ext2 -= 1
                    else:
                        ysv_ext1 += 1
                        dy_ext1 -= 1
                else:
                    ysv_ext0 = ysv_ext1 = ysv_ext2 = ysb
                    dy_ext0 = dy0 - 2 * sq
                    dy_ext1 = dy_ext2 = dy0 - 3 * sq
                if (c & 0x04) != 0:
                    zsv_ext0 = zsv_ext1 = zsv_ext2 = zsb + 1
                    dz_ext0 = dz0 - 1 - 2 * sq
                    dz_ext1 = dz_ext2 = dz0 - 1 - 3 * sq
                    if (c & 0x03) != 0:
                        zsv_ext2 += 1
                        dz_ext2 -= 1
                    else:
                        zsv_ext1 += 1
                        dz_ext1 -= 1
                else:
                    zsv_ext0 = zsv_ext1 = zsv_ext2 = zsb
                    dz_ext0 = dz0 - 2 * sq
                    dz_ext1 = dz_ext2 = dz0 - 3 * sq
                if (c & 0x08) != 0:
                    wsv_ext0 = wsv_ext1 = wsb + 1
                    wsv_ext2 = wsb + 2
                    dw_ext0 = dw0 - 1 - 2 * sq
                    dw_ext1 = dw0 - 1 - 3 * sq
                    dw_ext2 = dw0 - 2 - 3 * sq
                else:
                    wsv_ext0 = wsv_ext1 = wsv_ext2 = wsb
                    dw_ext0 = dw0 - 2 * sq
                    dw_ext1 = dw_ext2 = dw0 - 3 * sq
            # Contribution (1,1,1,0)
            dx4 = dx0 - 1 - 3 * sq
            dy4 = dy0 - 1 - 3 * sq
            dz4 = dz0 - 1 - 3 * sq
            dw4 = dw0 - 3 * sq
            attn4 = 2 - dx4 * dx4 - dy4 * dy4 - dz4 * dz4 - dw4 * dw4
            if attn4 > 0:
                attn4 *= attn4
                value += attn4 * attn4 * self._extrap(xsb + 1, ysb + 1, zsb + 1, wsb + 0, dx4, dy4, dz4, dw4)
            # Contribution (1,1,0,1)
            dx3 = dx4
            dy3 = dy4
            dz3 = dz0 - 3 * sq
            dw3 = dw0 - 1 - 3 * sq
            attn3 = 2 - dx3 * dx3 - dy3 * dy3 - dz3 * dz3 - dw3 * dw3
            if attn3 > 0:
                attn3 *= attn3
                value += attn3 * attn3 * self._extrap(xsb + 1, ysb + 1, zsb + 0, wsb + 1, dx3, dy3, dz3, dw3)
            # Contribution (1,0,1,1)
            dx2 = dx4
            dy2 = dy0 - 3 * sq
            dz2 = dz4
            dw2 = dw3
            attn2 = 2 - dx2 * dx2 - dy2 * dy2 - dz2 * dz2 - dw2 * dw2
            if attn2 > 0:
                attn2 *= attn2
                value += attn2 * attn2 * self._extrap(xsb + 1, ysb + 0, zsb + 1, wsb + 1, dx2, dy2, dz2, dw2)
            # Contribution (0,1,1,1)
            dx1 = dx0 - 3 * sq
            dz1 = dz4
            dy1 = dy4
            dw1 = dw3
            attn1 = 2 - dx1 * dx1 - dy1 * dy1 - dz1 * dz1 - dw1 * dw1
            if attn1 > 0:
                attn1 *= attn1
                value += attn1 * attn1 * self._extrap(xsb + 0, ysb + 1, zsb + 1, wsb + 1, dx1, dy1, dz1, dw1)
            # Contribution (1,1,1,1)
            dx0 = dx0 - 1 - 4 * sq
            dy0 = dy0 - 1 - 4 * sq
            dz0 = dz0 - 1 - 4 * sq
            dw0 = dw0 - 1 - 4 * sq
            attn0 = 2 - dx0 * dx0 - dy0 * dy0 - dz0 * dz0 - dw0 * dw0
            if attn0 > 0:
                attn0 *= attn0
                value += attn0 * attn0 * self._extrap(xsb + 1, ysb + 1, zsb + 1, wsb + 1, dx0, dy0, dz0, dw0)
        elif inSum <= 2:
            aIsBiggerSide = True
            bIsBiggerSide = True
            # Decide between (1,1,0,0) and (0,0,1,1)
            if xins + yins > zins + wins:
                aScore = xins + yins
                aPoint = 0x03
            else:
                aScore = zins + wins
                aPoint = 0x0C
            # Decide between (1,0,1,0) and (0,1,0,1)
            if xins + zins > yins + wins:
                bScore = xins + zins
                bPoint = 0x05
            else:
                bScore = yins + wins
                bPoint = 0x0A
            # Closer between (1,0,0,1) and (0,1,1,0) will replace the further of a and b, if closer.
            if xins + wins > yins + zins:
                score = xins + wins
                if aScore >= bScore and score > bScore:
                    bScore = score
                    bPoint = 0x09
                elif aScore < bScore and score > aScore:
                    aScore = score
                    aPoint = 0x09
            else:
                score = yins + zins
                if aScore >= bScore and score > bScore:
                    bScore = score
                    bPoint = 0x06
                elif aScore < bScore and score > aScore:
                    aScore = score
                    aPoint = 0x06
            # Decide if (1,0,0,0) is closer.
            p1 = 2 - inSum + xins
            if aScore >= bScore and p1 > bScore:
                bScore = p1
                bPoint = 0x01
                bIsBiggerSide = False
            elif aScore < bScore and p1 > aScore:
                aScore = p1
                aPoint = 0x01
                aIsBiggerSide = False
            # Decide if (0,1,0,0) is closer.
            p2 = 2 - inSum + yins
            if aScore >= bScore and p2 > bScore:
                bScore = p2
                bPoint = 0x02
                bIsBiggerSide = False
            elif aScore < bScore and p2 > aScore:
                aScore = p2
                aPoint = 0x02
                aIsBiggerSide = False
            # Decide if (0,0,1,0) is closer.
            p3 = 2 - inSum + zins
            if aScore >= bScore and p3 > bScore:
                bScore = p3
                bPoint = 0x04
                bIsBiggerSide = False
            elif aScore < bScore and p3 > aScore:
                aScore = p3
                aPoint = 0x04
                aIsBiggerSide = False
            # Decide if (0,0,0,1) is closer.
            p4 = 2 - inSum + wins
            if aScore >= bScore and p4 > bScore:
                bScore = p4
                bPoint = 0x08
                bIsBiggerSide = False
            elif aScore < bScore and p4 > aScore:
                aScore = p4
                aPoint = 0x08
                aIsBiggerSide = False
            # Where each of the two closest points are determines how the extra three vertices are calculated.
            if aIsBiggerSide == bIsBiggerSide:
                if aIsBiggerSide:
                    c1 = (aPoint | bPoint)
                    c2 = (aPoint & bPoint)
                    if (c1 & 0x01) == 0:
                        xsv_ext0 = xsb
                        xsv_ext1 = xsb - 1
                        dx_ext0 = dx0 - 3 * sq
                        dx_ext1 = dx0 + 1 - 2 * sq
                    else:
                        xsv_ext0 = xsv_ext1 = xsb + 1
                        dx_ext0 = dx0 - 1 - 3 * sq
                        dx_ext1 = dx0 - 1 - 2 * sq
                    if (c1 & 0x02) == 0:
                        ysv_ext0 = ysb
                        ysv_ext1 = ysb - 1
                        dy_ext0 = dy0 - 3 * sq
                        dy_ext1 = dy0 + 1 - 2 * sq
                    else:
                        ysv_ext0 = ysv_ext1 = ysb + 1
                        dy_ext0 = dy0 - 1 - 3 * sq
                        dy_ext1 = dy0 - 1 - 2 * sq
                    if (c1 & 0x04) == 0:
                        zsv_ext0 = zsb
                        zsv_ext1 = zsb - 1
                        dz_ext0 = dz0 - 3 * sq
                        dz_ext1 = dz0 + 1 - 2 * sq
                    else:
                        zsv_ext0 = zsv_ext1 = zsb + 1
                        dz_ext0 = dz0 - 1 - 3 * sq
                        dz_ext1 = dz0 - 1 - 2 * sq
                    if (c1 & 0x08) == 0:
                        wsv_ext0 = wsb
                        wsv_ext1 = wsb - 1
                        dw_ext0 = dw0 - 3 * sq
                        dw_ext1 = dw0 + 1 - 2 * sq
                    else:
                        wsv_ext0 = wsv_ext1 = wsb + 1
                        dw_ext0 = dw0 - 1 - 3 * sq
                        dw_ext1 = dw0 - 1 - 2 * sq
                    # One combination is a permutation of (0,0,0,2) based on c2
                    xsv_ext2 = xsb
                    ysv_ext2 = ysb
                    zsv_ext2 = zsb
                    wsv_ext2 = wsb
                    dx_ext2 = dx0 - 2 * sq
                    dy_ext2 = dy0 - 2 * sq
                    dz_ext2 = dz0 - 2 * sq
                    dw_ext2 = dw0 - 2 * sq
                    if (c2 & 0x01) != 0:
                        xsv_ext2 += 2
                        dx_ext2 -= 2
                    elif (c2 & 0x02) != 0:
                        ysv_ext2 += 2
                        dy_ext2 -= 2
                    elif (c2 & 0x04) != 0:
                        zsv_ext2 += 2
                        dz_ext2 -= 2
                    else:
                        wsv_ext2 += 2
                        dw_ext2 -= 2
                else:
                    # One of the two extra points is (0,0,0,0)
                    xsv_ext2 = xsb
                    ysv_ext2 = ysb
                    zsv_ext2 = zsb
                    wsv_ext2 = wsb
                    dx_ext2 = dx0
                    dy_ext2 = dy0
                    dz_ext2 = dz0
                    dw_ext2 = dw0
                    # Other two points are based on the omitted axes.
                    c = (aPoint | bPoint)
                    if (c & 0x01) == 0:
                        xsv_ext0 = xsb - 1
                        xsv_ext1 = xsb
                        dx_ext0 = dx0 + 1 - sq
                        dx_ext1 = dx0 - sq
                    else:
                        xsv_ext0 = xsv_ext1 = xsb + 1
                        dx_ext0 = dx_ext1 = dx0 - 1 - sq
                    if (c & 0x02) == 0:
                        ysv_ext0 = ysv_ext1 = ysb
                        dy_ext0 = dy_ext1 = dy0 - sq
                        if (c & 0x01) == 0x01:
                            ysv_ext0 -= 1
                            dy_ext0 += 1
                        else:
                            ysv_ext1 -= 1
                            dy_ext1 += 1
                    else:
                        ysv_ext0 = ysv_ext1 = ysb + 1
                        dy_ext0 = dy_ext1 = dy0 - 1 - sq
                    if (c & 0x04) == 0:
                        zsv_ext0 = zsv_ext1 = zsb
                        dz_ext0 = dz_ext1 = dz0 - sq
                        if (c & 0x03) == 0x03:
                            zsv_ext0 -= 1
                            dz_ext0 += 1
                        else:
                            zsv_ext1 -= 1
                            dz_ext1 += 1
                    else:
                        zsv_ext0 = zsv_ext1 = zsb + 1
                        dz_ext0 = dz_ext1 = dz0 - 1 - sq
                    if (c & 0x08) == 0:
                        wsv_ext0 = wsb
                        wsv_ext1 = wsb - 1
                        dw_ext0 = dw0 - sq
                        dw_ext1 = dw0 + 1 - sq
                    else:
                        wsv_ext0 = wsv_ext1 = wsb + 1
                        dw_ext0 = dw_ext1 = dw0 - 1 - sq
            else:
                if aIsBiggerSide:
                    c1 = aPoint
                    c2 = bPoint
                else:
                    c1 = bPoint
                    c2 = aPoint
                # Two contributions are the bigger-sided point with each 0 replaced with -1.
                if (c1 & 0x01) == 0:
                    xsv_ext0 = xsb - 1
                    xsv_ext1 = xsb
                    dx_ext0 = dx0 + 1 - sq
                    dx_ext1 = dx0 - sq
                else:
                    xsv_ext0 = xsv_ext1 = xsb + 1
                    dx_ext0 = dx_ext1 = dx0 - 1 - sq
                if (c1 & 0x02) == 0:
                    ysv_ext0 = ysv_ext1 = ysb
                    dy_ext0 = dy_ext1 = dy0 - sq
                    if (c1 & 0x01) == 0x01:
                        ysv_ext0 -= 1
                        dy_ext0 += 1
                    else:
                        ysv_ext1 -= 1
                        dy_ext1 += 1
                else:
                    ysv_ext0 = ysv_ext1 = ysb + 1
                    dy_ext0 = dy_ext1 = dy0 - 1 - sq
                if (c1 & 0x04) == 0:
                    zsv_ext0 = zsv_ext1 = zsb
                    dz_ext0 = dz_ext1 = dz0 - sq
                    if (c1 & 0x03) == 0x03:
                        zsv_ext0 -= 1
                        dz_ext0 += 1
                    else:
                        zsv_ext1 -= 1
                        dz_ext1 += 1
                else:
                    zsv_ext0 = zsv_ext1 = zsb + 1
                    dz_ext0 = dz_ext1 = dz0 - 1 - sq
                if (c1 & 0x08) == 0:
                    wsv_ext0 = wsb
                    wsv_ext1 = wsb - 1
                    dw_ext0 = dw0 - sq
                    dw_ext1 = dw0 + 1 - sq
                else:
                    wsv_ext0 = wsv_ext1 = wsb + 1
                    dw_ext0 = dw_ext1 = dw0 - 1 - sq
                # One contribution is a permutation of (0,0,0,2) based on the smaller-sided point
                xsv_ext2 = xsb
                ysv_ext2 = ysb
                zsv_ext2 = zsb
                wsv_ext2 = wsb
                dx_ext2 = dx0 - 2 * sq
                dy_ext2 = dy0 - 2 * sq
                dz_ext2 = dz0 - 2 * sq
                dw_ext2 = dw0 - 2 * sq
                if (c2 & 0x01) != 0:
                    xsv_ext2 += 2
                    dx_ext2 -= 2
                elif (c2 & 0x02) != 0:
                    ysv_ext2 += 2
                    dy_ext2 -= 2
                elif (c2 & 0x04) != 0:
                    zsv_ext2 += 2
                    dz_ext2 -= 2
                else:
                    wsv_ext2 += 2
                    dw_ext2 -= 2
            # Contribution (1,0,0,0)
            dx1 = dx0 - 1 - sq
            dy1 = dy0 - 0 - sq
            dz1 = dz0 - 0 - sq
            dw1 = dw0 - 0 - sq
            attn1 = 2 - dx1 * dx1 - dy1 * dy1 - dz1 * dz1 - dw1 * dw1
            if attn1 > 0:
                attn1 *= attn1
                value += attn1 * attn1 * self._extrap(xsb + 1, ysb + 0, zsb + 0, wsb + 0, dx1, dy1, dz1, dw1)
            # Contribution (0,1,0,0)
            dx2 = dx0 - 0 - sq
            dy2 = dy0 - 1 - sq
            dz2 = dz1
            dw2 = dw1
            attn2 = 2 - dx2 * dx2 - dy2 * dy2 - dz2 * dz2 - dw2 * dw2
            if attn2 > 0:
                attn2 *= attn2
                value += attn2 * attn2 * self._extrap(xsb + 0, ysb + 1, zsb + 0, wsb + 0, dx2, dy2, dz2, dw2)
            # Contribution (0,0,1,0)
            dx3 = dx2
            dy3 = dy1
            dz3 = dz0 - 1 - sq
            dw3 = dw1
            attn3 = 2 - dx3 * dx3 - dy3 * dy3 - dz3 * dz3 - dw3 * dw3
            if attn3 > 0:
                attn3 *= attn3
                value += attn3 * attn3 * self._extrap(xsb + 0, ysb + 0, zsb + 1, wsb + 0, dx3, dy3, dz3, dw3)
            # Contribution (0,0,0,1)
            dx4 = dx2
            dy4 = dy1
            dz4 = dz1
            dw4 = dw0 - 1 - sq
            attn4 = 2 - dx4 * dx4 - dy4 * dy4 - dz4 * dz4 - dw4 * dw4
            if attn4 > 0:
                attn4 *= attn4
                value += attn4 * attn4 * self._extrap(xsb + 0, ysb + 0, zsb + 0, wsb + 1, dx4, dy4, dz4, dw4)
            # Contribution (1,1,0,0)
            dx5 = dx0 - 1 - 2 * sq
            dy5 = dy0 - 1 - 2 * sq
            dz5 = dz0 - 0 - 2 * sq
            dw5 = dw0 - 0 - 2 * sq
            attn5 = 2 - dx5 * dx5 - dy5 * dy5 - dz5 * dz5 - dw5 * dw5
            if attn5 > 0:
                attn5 *= attn5
                value += attn5 * attn5 * self._extrap(xsb + 1, ysb + 1, zsb + 0, wsb + 0, dx5, dy5, dz5, dw5)
            # Contribution (1,0,1,0)
            dx6 = dx0 - 1 - 2 * sq
            dy6 = dy0 - 0 - 2 * sq
            dz6 = dz0 - 1 - 2 * sq
            dw6 = dw0 - 0 - 2 * sq
            attn6 = 2 - dx6 * dx6 - dy6 * dy6 - dz6 * dz6 - dw6 * dw6
            if attn6 > 0:
                attn6 *= attn6
                value += attn6 * attn6 * self._extrap(xsb + 1, ysb + 0, zsb + 1, wsb + 0, dx6, dy6, dz6, dw6)
            # Contribution (1,0,0,1)
            dx7 = dx0 - 1 - 2 * sq
            dy7 = dy0 - 0 - 2 * sq
            dz7 = dz0 - 0 - 2 * sq
            dw7 = dw0 - 1 - 2 * sq
            attn7 = 2 - dx7 * dx7 - dy7 * dy7 - dz7 * dz7 - dw7 * dw7
            if attn7 > 0:
                attn7 *= attn7
                value += attn7 * attn7 * self._extrap(xsb + 1, ysb + 0, zsb + 0, wsb + 1, dx7, dy7, dz7, dw7)
            # Contribution (0,1,1,0)
            dx8 = dx0 - 0 - 2 * sq
            dy8 = dy0 - 1 - 2 * sq
            dz8 = dz0 - 1 - 2 * sq
            dw8 = dw0 - 0 - 2 * sq
            attn8 = 2 - dx8 * dx8 - dy8 * dy8 - dz8 * dz8 - dw8 * dw8
            if attn8 > 0:
                attn8 *= attn8
                value += attn8 * attn8 * self._extrap(xsb + 0, ysb + 1, zsb + 1, wsb + 0, dx8, dy8, dz8, dw8)
            # Contribution (0,1,0,1)
            dx9 = dx0 - 0 - 2 * sq
            dy9 = dy0 - 1 - 2 * sq
            dz9 = dz0 - 0 - 2 * sq
            dw9 = dw0 - 1 - 2 * sq
            attn9 = 2 - dx9 * dx9 - dy9 * dy9 - dz9 * dz9 - dw9 * dw9
            if attn9 > 0:
                attn9 *= attn9
                value += attn9 * attn9 * self._extrap(xsb + 0, ysb + 1, zsb + 0, wsb + 1, dx9, dy9, dz9, dw9)
            # Contribution (0,0,1,1)
            dx10 = dx0 - 0 - 2 * sq
            dy10 = dy0 - 0 - 2 * sq
            dz10 = dz0 - 1 - 2 * sq
            dw10 = dw0 - 1 - 2 * sq
            attn10 = 2 - dx10 * dx10 - dy10 * dy10 - dz10 * dz10 - dw10 * dw10
            if attn10 > 0:
                attn10 *= attn10
                value += attn10 * attn10 * self._extrap(xsb + 0, ysb + 0, zsb + 1, wsb + 1, dx10, dy10, dz10, dw10)
        else:
            aIsBiggerSide = True
            bIsBiggerSide = True
            # Decide between (0,0,1,1) and (1,1,0,0)
            if xins + yins < zins + wins:
                aScore = xins + yins
                aPoint = 0x0C
            else:
                aScore = zins + wins
                aPoint = 0x03
            # Decide between (0,1,0,1) and (1,0,1,0)
            if xins + zins < yins + wins:
                bScore = xins + zins
                bPoint = 0x0A
            else:
                bScore = yins + wins
                bPoint = 0x05
            # Closer between (0,1,1,0) and (1,0,0,1) will replace the further of a and b, if closer.
            if xins + wins < yins + zins:
                score = xins + wins
                if aScore <= bScore and score < bScore:
                    bScore = score
                    bPoint = 0x06
                elif aScore > bScore and score < aScore:
                    aScore = score
                    aPoint = 0x06
            else:
                score = yins + zins
                if aScore <= bScore and score < bScore:
                    bScore = score
                    bPoint = 0x09
                elif aScore > bScore and score < aScore:
                    aScore = score
                    aPoint = 0x09
            # Decide if (0,1,1,1) is closer.
            p1 = 3 - inSum + xins
            if aScore <= bScore and p1 < bScore:
                bScore = p1
                bPoint = 0x0E
                bIsBiggerSide = False
            elif aScore > bScore and p1 < aScore:
                aScore = p1
                aPoint = 0x0E
                aIsBiggerSide = False
            # Decide if (1,0,1,1) is closer.
            p2 = 3 - inSum + yins
            if aScore <= bScore and p2 < bScore:
                bScore = p2
                bPoint = 0x0D
                bIsBiggerSide = False
            elif aScore > bScore and p2 < aScore:
                aScore = p2
                aPoint = 0x0D
                aIsBiggerSide = False
            # Decide if (1,1,0,1) is closer.
            p3 = 3 - inSum + zins
            if aScore <= bScore and p3 < bScore:
                bScore = p3
                bPoint = 0x0B
                bIsBiggerSide = False
            elif aScore > bScore and p3 < aScore:
                aScore = p3
                aPoint = 0x0B
                aIsBiggerSide = False
            # Decide if (1,1,1,0) is closer.
            p4 = 3 - inSum + wins
            if aScore <= bScore and p4 < bScore:
                bScore = p4
                bPoint = 0x07
                bIsBiggerSide = False
            elif aScore > bScore and p4 < aScore:
                aScore = p4
                aPoint = 0x07
                aIsBiggerSide = False
            # Where each of the two closest points are determines how the extra three vertices are calculated.
            if aIsBiggerSide == bIsBiggerSide:
                if aIsBiggerSide:
                    c1 = (aPoint & bPoint)
                    c2 = (aPoint | bPoint)
                    # Two contributions are permutations of (0,0,0,1) and (0,0,0,2) based on c1
                    xsv_ext0 = xsv_ext1 = xsb
                    ysv_ext0 = ysv_ext1 = ysb
                    zsv_ext0 = zsv_ext1 = zsb
                    wsv_ext0 = wsv_ext1 = wsb
                    dx_ext0 = dx0 - sq
                    dy_ext0 = dy0 - sq
                    dz_ext0 = dz0 - sq
                    dw_ext0 = dw0 - sq
                    dx_ext1 = dx0 - 2 * sq
                    dy_ext1 = dy0 - 2 * sq
                    dz_ext1 = dz0 - 2 * sq
                    dw_ext1 = dw0 - 2 * sq
                    if (c1 & 0x01) != 0:
                        xsv_ext0 += 1
                        dx_ext0 -= 1
                        xsv_ext1 += 2
                        dx_ext1 -= 2
                    elif (c1 & 0x02) != 0:
                        ysv_ext0 += 1
                        dy_ext0 -= 1
                        ysv_ext1 += 2
                        dy_ext1 -= 2
                    elif (c1 & 0x04) != 0:
                        zsv_ext0 += 1
                        dz_ext0 -= 1
                        zsv_ext1 += 2
                        dz_ext1 -= 2
                    else:
                        wsv_ext0 += 1
                        dw_ext0 -= 1
                        wsv_ext1 += 2
                        dw_ext1 -= 2
                    # One contribution is a permutation of (1,1,1,-1) based on c2
                    xsv_ext2 = xsb + 1
                    ysv_ext2 = ysb + 1
                    zsv_ext2 = zsb + 1
                    wsv_ext2 = wsb + 1
                    dx_ext2 = dx0 - 1 - 2 * sq
                    dy_ext2 = dy0 - 1 - 2 * sq
                    dz_ext2 = dz0 - 1 - 2 * sq
                    dw_ext2 = dw0 - 1 - 2 * sq
                    if (c2 & 0x01) == 0:
                        xsv_ext2 -= 2
                        dx_ext2 += 2
                    elif (c2 & 0x02) == 0:
                        ysv_ext2 -= 2
                        dy_ext2 += 2
                    elif (c2 & 0x04) == 0:
                        zsv_ext2 -= 2
                        dz_ext2 += 2
                    else:
                        wsv_ext2 -= 2
                        dw_ext2 += 2
                else:
                    # One of the two extra points is (1,1,1,1)
                    xsv_ext2 = xsb + 1
                    ysv_ext2 = ysb + 1
                    zsv_ext2 = zsb + 1
                    wsv_ext2 = wsb + 1
                    dx_ext2 = dx0 - 1 - 4 * sq
                    dy_ext2 = dy0 - 1 - 4 * sq
                    dz_ext2 = dz0 - 1 - 4 * sq
                    dw_ext2 = dw0 - 1 - 4 * sq
                    # Other two points are based on the shared axes.
                    c = (aPoint & bPoint)
                    if (c & 0x01) != 0:
                        xsv_ext0 = xsb + 2
                        xsv_ext1 = xsb + 1
                        dx_ext0 = dx0 - 2 - 3 * sq
                        dx_ext1 = dx0 - 1 - 3 * sq
                    else:
                        xsv_ext0 = xsv_ext1 = xsb
                        dx_ext0 = dx_ext1 = dx0 - 3 * sq
                    if (c & 0x02) != 0:
                        ysv_ext0 = ysv_ext1 = ysb + 1
                        dy_ext0 = dy_ext1 = dy0 - 1 - 3 * sq
                        if (c & 0x01) == 0:
                            ysv_ext0 += 1
                            dy_ext0 -= 1
                        else:
                            ysv_ext1 += 1
                            dy_ext1 -= 1
                    else:
                        ysv_ext0 = ysv_ext1 = ysb
                        dy_ext0 = dy_ext1 = dy0 - 3 * sq
                    if (c & 0x04) != 0:
                        zsv_ext0 = zsv_ext1 = zsb + 1
                        dz_ext0 = dz_ext1 = dz0 - 1 - 3 * sq
                        if (c & 0x03) == 0:
                            zsv_ext0 += 1
                            dz_ext0 -= 1
                        else:
                            zsv_ext1 += 1
                            dz_ext1 -= 1
                    else:
                        zsv_ext0 = zsv_ext1 = zsb
                        dz_ext0 = dz_ext1 = dz0 - 3 * sq
                    if (c & 0x08) != 0:
                        wsv_ext0 = wsb + 1
                        wsv_ext1 = wsb + 2
                        dw_ext0 = dw0 - 1 - 3 * sq
                        dw_ext1 = dw0 - 2 - 3 * sq
                    else:
                        wsv_ext0 = wsv_ext1 = wsb
                        dw_ext0 = dw_ext1 = dw0 - 3 * sq
            else:
                if aIsBiggerSide:
                    c1 = aPoint
                    c2 = bPoint
                else:
                    c1 = bPoint
                    c2 = aPoint
                # Two contributions are the bigger-sided point with each 1 replaced with 2.
                if (c1 & 0x01) != 0:
                    xsv_ext0 = xsb + 2
                    xsv_ext1 = xsb + 1
                    dx_ext0 = dx0 - 2 - 3 * sq
                    dx_ext1 = dx0 - 1 - 3 * sq
                else:
                    xsv_ext0 = xsv_ext1 = xsb
                    dx_ext0 = dx_ext1 = dx0 - 3 * sq
                if (c1 & 0x02) != 0:
                    ysv_ext0 = ysv_ext1 = ysb + 1
                    dy_ext0 = dy_ext1 = dy0 - 1 - 3 * sq
                    if (c1 & 0x01) == 0:
                        ysv_ext0 += 1
                        dy_ext0 -= 1
                    else:
                        ysv_ext1 += 1
                        dy_ext1 -= 1
                else:
                    ysv_ext0 = ysv_ext1 = ysb
                    dy_ext0 = dy_ext1 = dy0 - 3 * sq
                if (c1 & 0x04) != 0:
                    zsv_ext0 = zsv_ext1 = zsb + 1
                    dz_ext0 = dz_ext1 = dz0 - 1 - 3 * sq
                    if (c1 & 0x03) == 0:
                        zsv_ext0 += 1
                        dz_ext0 -= 1
                    else:
                        zsv_ext1 += 1
                        dz_ext1 -= 1
                else:
                    zsv_ext0 = zsv_ext1 = zsb
                    dz_ext0 = dz_ext1 = dz0 - 3 * sq
                if (c1 & 0x08) != 0:
                    wsv_ext0 = wsb + 1
                    wsv_ext1 = wsb + 2
                    dw_ext0 = dw0 - 1 - 3 * sq
                    dw_ext1 = dw0 - 2 - 3 * sq
                else:
                    wsv_ext0 = wsv_ext1 = wsb
                    dw_ext0 = dw_ext1 = dw0 - 3 * sq
                # One contribution is a permutation of (1,1,1,-1) based on the smaller-sided point
                xsv_ext2 = xsb + 1
                ysv_ext2 = ysb + 1
                zsv_ext2 = zsb + 1
                wsv_ext2 = wsb + 1
                dx_ext2 = dx0 - 1 - 2 * sq
                dy_ext2 = dy0 - 1 - 2 * sq
                dz_ext2 = dz0 - 1 - 2 * sq
                dw_ext2 = dw0 - 1 - 2 * sq
                if (c2 & 0x01) == 0:
                    xsv_ext2 -= 2
                    dx_ext2 += 2
                elif (c2 & 0x02) == 0:
                    ysv_ext2 -= 2
                    dy_ext2 += 2
                elif (c2 & 0x04) == 0:
                    zsv_ext2 -= 2
                    dz_ext2 += 2
                else:
                    wsv_ext2 -= 2
                    dw_ext2 += 2
            # Contribution (1,1,1,0)
            dx4 = dx0 - 1 - 3 * sq
            dy4 = dy0 - 1 - 3 * sq
            dz4 = dz0 - 1 - 3 * sq
            dw4 = dw0 - 3 * sq
            attn4 = 2 - dx4 * dx4 - dy4 * dy4 - dz4 * dz4 - dw4 * dw4
            if attn4 > 0:
                attn4 *= attn4
                value += attn4 * attn4 * self._extrap(xsb + 1, ysb + 1, zsb + 1, wsb + 0, dx4, dy4, dz4, dw4)
            # Contribution (1,1,0,1)
            dx3 = dx4
            dy3 = dy4
            dz3 = dz0 - 3 * sq
            dw3 = dw0 - 1 - 3 * sq
            attn3 = 2 - dx3 * dx3 - dy3 * dy3 - dz3 * dz3 - dw3 * dw3
            if attn3 > 0:
                attn3 *= attn3
                value += attn3 * attn3 * self._extrap(xsb + 1, ysb + 1, zsb + 0, wsb + 1, dx3, dy3, dz3, dw3)
            # Contribution (1,0,1,1)
            dx2 = dx4
            dy2 = dy0 - 3 * sq
            dz2 = dz4
            dw2 = dw3
            attn2 = 2 - dx2 * dx2 - dy2 * dy2 - dz2 * dz2 - dw2 * dw2
            if attn2 > 0:
                attn2 *= attn2
                value += attn2 * attn2 * self._extrap(xsb + 1, ysb + 0, zsb + 1, wsb + 1, dx2, dy2, dz2, dw2)
            # Contribution (0,1,1,1)
            dx1 = dx0 - 3 * sq
            dz1 = dz4
            dy1 = dy4
            dw1 = dw3
            attn1 = 2 - dx1 * dx1 - dy1 * dy1 - dz1 * dz1 - dw1 * dw1
            if attn1 > 0:
                attn1 *= attn1
                value += attn1 * attn1 * self._extrap(xsb + 0, ysb + 1, zsb + 1, wsb + 1, dx1, dy1, dz1, dw1)
            # Contribution (1,1,0,0)
            dx5 = dx0 - 1 - 2 * sq
            dy5 = dy0 - 1 - 2 * sq
            dz5 = dz0 - 0 - 2 * sq
            dw5 = dw0 - 0 - 2 * sq
            attn5 = 2 - dx5 * dx5 - dy5 * dy5 - dz5 * dz5 - dw5 * dw5
            if attn5 > 0:
                attn5 *= attn5
                value += attn5 * attn5 * self._extrap(xsb + 1, ysb + 1, zsb + 0, wsb + 0, dx5, dy5, dz5, dw5)
            # Contribution (1,0,1,0)
            dx6 = dx0 - 1 - 2 * sq
            dy6 = dy0 - 0 - 2 * sq
            dz6 = dz0 - 1 - 2 * sq
            dw6 = dw0 - 0 - 2 * sq
            attn6 = 2 - dx6 * dx6 - dy6 * dy6 - dz6 * dz6 - dw6 * dw6
            if attn6 > 0:
                attn6 *= attn6
                value += attn6 * attn6 * self._extrap(xsb + 1, ysb + 0, zsb + 1, wsb + 0, dx6, dy6, dz6, dw6)
            # Contribution (1,0,0,1)
            dx7 = dx0 - 1 - 2 * sq
            dy7 = dy0 - 0 - 2 * sq
            dz7 = dz0 - 0 - 2 * sq
            dw7 = dw0 - 1 - 2 * sq
            attn7 = 2 - dx7 * dx7 - dy7 * dy7 - dz7 * dz7 - dw7 * dw7
            if attn7 > 0:
                attn7 *= attn7
                value += attn7 * attn7 * self._extrap(xsb + 1, ysb + 0, zsb + 0, wsb + 1, dx7, dy7, dz7, dw7)
            # Contribution (0,1,1,0)
            dx8 = dx0 - 0 - 2 * sq
            dy8 = dy0 - 1 - 2 * sq
            dz8 = dz0 - 1 - 2 * sq
            dw8 = dw0 - 0 - 2 * sq
            attn8 = 2 - dx8 * dx8 - dy8 * dy8 - dz8 * dz8 - dw8 * dw8
            if attn8 > 0:
                attn8 *= attn8
                value += attn8 * attn8 * self._extrap(xsb + 0, ysb + 1, zsb + 1, wsb + 0, dx8, dy8, dz8, dw8)
            # Contribution (0,1,0,1)
            dx9 = dx0 - 0 - 2 * sq
            dy9 = dy0 - 1 - 2 * sq
            dz9 = dz0 - 0 - 2 * sq
            dw9 = dw0 - 1 - 2 * sq
            attn9 = 2 - dx9 * dx9 - dy9 * dy9 - dz9 * dz9 - dw9 * dw9
            if attn9 > 0:
                attn9 *= attn9
                value += attn9 * attn9 * self._extrap(xsb + 0, ysb + 1, zsb + 0, wsb + 1, dx9, dy9, dz9, dw9)
            # Contribution (0,0,1,1)
            dx10 = dx0 - 0 - 2 * sq
            dy10 = dy0 - 0 - 2 * sq
            dz10 = dz0 - 1 - 2 * sq
            dw10 = dw0 - 1 - 2 * sq
            attn10 = 2 - dx10 * dx10 - dy10 * dy10 - dz10 * dz10 - dw10 * dw10
            if attn10 > 0:
                attn10 *= attn10
                value += attn10 * attn10 * self._extrap(xsb + 0, ysb + 0, zsb + 1, wsb + 1, dx10, dy10, dz10, dw10)
        # First extra vertex
        attn_ext0 = 2 - dx_ext0 * dx_ext0 - dy_ext0 * dy_ext0 - dz_ext0 * dz_ext0 - dw_ext0 * dw_ext0
        if attn_ext0 > 0:
            attn_ext0 *= attn_ext0
            value += attn_ext0 * attn_ext0 * self._extrap(xsv_ext0, ysv_ext0, zsv_ext0, wsv_ext0, dx_ext0, dy_ext0, dz_ext0, dw_ext0)
        # Second extra vertex
        attn_ext1 = 2 - dx_ext1 * dx_ext1 - dy_ext1 * dy_ext1 - dz_ext1 * dz_ext1 - dw_ext1 * dw_ext1
        if attn_ext1 > 0:
            attn_ext1 *= attn_ext1
            value += attn_ext1 * attn_ext1 * self._extrap(xsv_ext1, ysv_ext1, zsv_ext1, wsv_ext1, dx_ext1, dy_ext1, dz_ext1, dw_ext1)
        # Third extra vertex
        attn_ext2 = 2 - dx_ext2 * dx_ext2 - dy_ext2 * dy_ext2 - dz_ext2 * dz_ext2 - dw_ext2 * dw_ext2
        if attn_ext2 > 0:
            attn_ext2 *= attn_ext2
            value += attn_ext2 * attn_ext2 * self._extrap(xsv_ext2, ysv_ext2, zsv_ext2, wsv_ext2, dx_ext2, dy_ext2, dz_ext2, dw_ext2)
        return value / NORM_4D

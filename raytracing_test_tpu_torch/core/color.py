"""21-bit-per-channel color packing, bit-exact with the reference.

Reference parity:
  - packing:   RGB_TO_U64 / convertScale (src/types.hpp:6-9):
        chan21 = u64(float(byte)/255 * ((1<<21)-1)) & ((1<<21)-1)
        packed = r21 << 42 | g21 << 21 | b21
  - unpacking: color_int_to_vec3 (src/shaders/low_res.frag:137-147):
        float = chan21 / 2^21      (note: divides by RANGE, not MASK)

TPU note: we avoid u64 on device entirely. The packed u64 exists only on the host
(python ints / numpy uint64) for tree storage and parity tests; device arrays carry
unpacked float32 albedo (see core/flatten.py). ``u64_to_unit_f32`` defines the
canonical float albedo a packed color maps to — identical to what the reference's
shader computes per pixel.

This port's own copy of ``raytracing_test_tpu/core/color.py``: the port imports nothing of
the JAX package. The arithmetic is unchanged, so worlds and palettes
come out bit for bit the same (tests/test_torch_host.py).
"""

from __future__ import annotations

import numpy as np

BITS_PER_COLOR = 21
COLOR_RANGE = 1 << BITS_PER_COLOR
COLOR_MASK = COLOR_RANGE - 1
SCALED_COLOR = 1.0 / COLOR_RANGE


def _convert_scale(byte_val) -> np.ndarray:
    """convertScale(x) = u64(float32(x)/255 * RGB_RANGE) & RGB_MASK (src/types.hpp:8).

    The reference computes the scale in float (single precision C float literal
    math: (float)x/255.0 * RGB_RANGE) then truncates toward zero via the u64 cast.
    """
    x = np.asarray(byte_val, dtype=np.float32)
    scaled = x / np.float32(255.0) * np.float32(COLOR_MASK)
    return np.uint64(np.trunc(scaled).astype(np.int64)) & np.uint64(COLOR_MASK)


def rgb_to_u64(r, g, b) -> np.uint64:
    """Pack 8-bit RGB into the 63-bit reference format (src/types.hpp:9)."""
    return (
        (_convert_scale(r) << np.uint64(42))
        | (_convert_scale(g) << np.uint64(21))
        | _convert_scale(b)
    )


def u64_channels(packed) -> tuple:
    """Split a packed color into its three 21-bit integer channels (r, g, b)."""
    p = np.asarray(packed, dtype=np.uint64)
    r = (p >> np.uint64(42)) & np.uint64(COLOR_MASK)
    g = (p >> np.uint64(21)) & np.uint64(COLOR_MASK)
    b = p & np.uint64(COLOR_MASK)
    return r, g, b


def u64_to_unit_f32(packed) -> np.ndarray:
    """Packed u64 -> float32 [r, g, b] in [0, 1), exactly as the shader's
    color_int_to_vec3 (src/shaders/low_res.frag:142-147).

    Note the shader's red channel uses ``color >> 42`` WITHOUT masking; packed
    colors only occupy 63 bits so this is equivalent to masking for valid colors.
    """
    r, g, b = u64_channels(packed)
    out = np.stack(
        [np.asarray(c, dtype=np.float64) * SCALED_COLOR for c in (r, g, b)], axis=-1
    )
    return out.astype(np.float32)


def rgb_to_unit_f32(r, g, b) -> np.ndarray:
    """8-bit RGB -> the canonical float albedo (pack + unpack round trip)."""
    return u64_to_unit_f32(rgb_to_u64(r, g, b))

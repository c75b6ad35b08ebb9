"""Morton (Z-order) encoding utilities.

Port of ``raytracing_test_tpu/ops/morton.py``, with the arithmetic unchanged.
Reference parity: getMortonPos (src/main.cpp:45-66) spreads each coordinate's
low 10 bits with the parallel-prefix masks 0x030000FF / 0x0300F00F /
0x030C30C3 and interleaves as z<<4 | y<<2 | x per 2-bit digit — i.e. each
6-bit Morton digit is the reference tree's child index (z2<<4 | y2<<2 | x2,
tetrahexa_tree.cpp:85).

The renderers do not descend the tree by Morton code (the device-side
structure is a dense grid, core/flatten.py); the encoder is kept bit-exact
for parity tests and for the host tree. Works on Python ints, numpy arrays
(as uint32) and torch tensors (as int64: the 30-bit codes fit, and torch's
bit operations on uint32 are limited).
"""

from __future__ import annotations

import numpy as np
import torch

_M0 = 0x030000FF
_M1 = 0x0300F00F
_M2 = 0x030C30C3


def spread2(n):
    """Spread the low 10 bits of n into 2-bit groups at 6-bit stride.

    Bit-exact with the shader/main.cpp bit cascade:
        n = (n | (n << 16)) & 0x030000FF
        n = (n | (n <<  8)) & 0x0300F00F
        n = (n | (n <<  4)) & 0x030C30C3
    """
    if isinstance(n, int):
        n = n & 0x3FF
    elif isinstance(n, torch.Tensor):
        n = n.to(torch.int64) & 0x3FF
    else:
        n = n.astype(np.uint32) & np.uint32(0x3FF)
    n = (n | (n << 16)) & _M0
    n = (n | (n << 8)) & _M1
    n = (n | (n << 4)) & _M2
    return n


def morton_encode(x, y, z):
    """(x, y, z) -> 30-bit Morton code, digit layout z<<4 | y<<2 | x per level."""
    return (spread2(z) << 4) | (spread2(y) << 2) | spread2(x)


def morton_digits(code: int, max_depth: int = 5):
    """Split a 30-bit Morton code into 6-bit child indices, root-first.

    Digit k (k=0 is the first child selection below the root) is
    (code >> ((max_depth - 1 - k) * 6)) & 0x3f, matching the shader's descent
    (src/shaders/low_res.frag:506-518 uses posOffset = (MAX_DEPTH-1-depth)*6).
    """
    return [(code >> ((max_depth - 1 - k) * 6)) & 0x3F for k in range(max_depth)]


def child_index(x: int, y: int, z: int, depth: int, max_depth: int = 5) -> int:
    """Child slot (0..63) selected at ``depth`` when descending to (x,y,z).

    depth=0 is the root's child selection, consuming address bits
    [2*(max_depth-1-depth), +2) of each axis (ref: tetrahexa_tree.cpp:127-129).
    """
    shift = 2 * (max_depth - 1 - depth)
    cx = (x >> shift) & 0b11
    cy = (y >> shift) & 0b11
    cz = (z >> shift) & 0b11
    return cz << 4 | cy << 2 | cx

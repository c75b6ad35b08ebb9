"""PyTorch port, end to end: the CLI's render against the JAX WorldSession.

The port's ``render`` verb at --world 48, 32x32 (the port's WorldSession:
pick for the looked-at highlight on the host tree, then the fused march,
which runs its plain version on CPU) against ``WorldSession(...).render(
mode="fast")`` of the JAX package with the same camera. Contract:
``assert_images_close``.
"""

import struct
import zlib

import numpy as np
import torch

from raytracing_test_tpu.app.session import WorldSession
from raytracing_test_tpu.config import RenderConfig, world_for_size
from raytracing_test_tpu_torch.app import cli
from raytracing_test_tpu_torch.kernels import fused_march as tfm
from tests.test_render_parity import assert_images_close

torch.set_num_threads(1)


def _read_png(path):
    """Decode the CLI's own PNG layout (8-bit RGB, filter 0 rows)."""
    data = open(path, "rb").read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, idat, hdr = 8, b"", None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        assert crc == zlib.crc32(tag + body) & 0xFFFFFFFF
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    W, H = hdr[0], hdr[1]
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(H, 1 + 3 * W)
    assert (raw[:, 0] == 0).all()
    return raw[:, 1:].reshape(H, W, 3)


def test_cli_render_matches_jax_session(tmp_path):
    argv = ["--device", "cpu", "--world", "48", "--width", "32", "--height", "32"]
    args = cli.build_parser().parse_args(argv + ["render"])
    session = cli.make_session(args)
    got = session.render(cli._rcfg(args)).numpy()

    s = WorldSession(world_for_size(48), use_native=False)
    s.yaw, s.pitch = args.yaw, args.pitch
    want = s.render(RenderConfig(width=32, height=32), mode="fast")

    assert got.shape == want.shape == (32, 32, 3)
    assert np.isfinite(got).all()
    assert_images_close(got, want)
    assert got.max() > 1.0  # the looked-at highlight is drawn

    out = tmp_path / "frame.png"
    cli.main(argv + ["render", "--out", str(out)])
    px = _read_png(out)
    np.testing.assert_array_equal(px, (np.clip(got, 0, 1) * 255).astype(np.uint8))
    assert tfm.LAUNCHES == 0


def test_cli_animate_writes_frames(tmp_path):
    cli.main(["--device", "cpu", "--world", "16", "--width", "8", "--height", "8", "--no-shadows",
              "animate", "--frames", "2", "--out-dir", str(tmp_path)])
    for i in range(2):
        assert _read_png(tmp_path / f"frame_{i:04d}.png").shape == (8, 8, 3)


def test_write_png_refuses_nan(tmp_path):
    img = np.zeros((2, 2, 3), np.float32)
    img[1, 1, 0] = np.nan
    try:
        cli.write_png(img, str(tmp_path / "x.png"))
    except ValueError:
        return
    raise AssertionError("write_png accepted a NaN frame")

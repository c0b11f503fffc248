"""Stdlib PNG codec (utils/imageio.py): round trip, every scanline filter
type, every supported color type, and the headline texture pinned to a
checksum."""

import hashlib
import struct
import zlib
from pathlib import Path

import numpy as np
import pytest

from curry_pbrt_tpu.utils.imageio import (
    encode_png,
    png_to_rgb,
    read_image,
    read_png,
    write_png,
)

REPO = Path(__file__).resolve().parents[1]
# sha256 of the decoded (128, 128, 3) uint8 pixels of scenes/box-texture.png
BOX_TEXTURE_SHA256 = "787bcb5ce11d984c12a53ae18e9a9b2fddf35fc88735b0e72645be5f37fc0426"


def _image(h=13, w=17, c=3, seed=0):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (h, w, c), dtype=np.uint8)
    img[: h // 2, :, 0] = np.arange(w, dtype=np.uint8)[None, :] * 7  # gradients
    return img


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _filter_row(ftype, row, prev, bpp):
    """Straight transcription of the PNG spec's filter (encoder side)."""
    out = bytearray(len(row))
    for i, x in enumerate(row):
        a = row[i - bpp] if i >= bpp else 0
        b = prev[i]
        c = prev[i - bpp] if i >= bpp else 0
        pred = (0, a, b, (a + b) // 2, _paeth(a, b, c))[ftype]
        out[i] = (x - pred) & 0xFF
    return bytes(out)


def _png_with_filters(img, filters):
    """PNG bytes of img whose scanline y uses filters[y % len(filters)]."""
    h, w, c = img.shape
    color = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    raw, prev = b"", bytes(w * c)
    for y in range(h):
        row = img[y].tobytes()
        f = filters[y % len(filters)]
        raw += bytes([f]) + _filter_row(f, row, prev, c)
        prev = row

    def chunk(t, d):
        return struct.pack(">I", len(d)) + t + d + struct.pack(
            ">I", zlib.crc32(t + d) & 0xFFFFFFFF)

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw))
            + chunk(b"IEND", b""))


def test_write_read_round_trip(tmp_path):
    img = _image()
    path = tmp_path / "sub" / "out.png"
    write_png(path, img)
    np.testing.assert_array_equal(read_png(path), img)
    np.testing.assert_allclose(read_image(path), img / 255.0, atol=1e-7)


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4],
                         ids=["none", "sub", "up", "average", "paeth"])
def test_each_filter_type_decodes(tmp_path, ftype):
    img = _image(seed=ftype)
    path = tmp_path / "f.png"
    path.write_bytes(_png_with_filters(img, [ftype]))
    np.testing.assert_array_equal(read_png(path), img)


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_color_types_and_mixed_filters(tmp_path, channels):
    img = _image(h=11, w=6, c=channels, seed=channels)
    path = tmp_path / "c.png"
    path.write_bytes(_png_with_filters(img, [4, 0, 3, 1, 2]))
    got = read_png(path)
    np.testing.assert_array_equal(got, img)
    rgb = png_to_rgb(got)
    assert rgb.shape == (11, 6, 3)
    if channels <= 2:
        np.testing.assert_array_equal(rgb[..., 2], img[..., 0])
    else:
        np.testing.assert_array_equal(rgb, img[..., :3])
    (tmp_path / "e.png").write_bytes(encode_png(img))
    np.testing.assert_array_equal(read_png(tmp_path / "e.png"), img)


def test_headline_texture_checksum():
    px = read_png(REPO / "scenes" / "box-texture.png")
    assert px.shape == (128, 128, 3) and px.dtype == np.uint8
    assert hashlib.sha256(px.tobytes()).hexdigest() == BOX_TEXTURE_SHA256


def test_rejects_unsupported(tmp_path):
    img = _image()
    data = bytearray(encode_png(img))
    data[24] = 16  # IHDR bit depth → 16 (CRC no longer checked by reader)
    path = tmp_path / "deep.png"
    path.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="unsupported PNG"):
        read_png(path)
    with pytest.raises(ValueError, match="not a PNG"):
        (tmp_path / "x.png").write_bytes(b"nope")
        read_png(tmp_path / "x.png")

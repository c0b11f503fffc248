"""Host-side image IO: a stdlib PNG codec and a minimal EXR reader.

Mirrors the reference's readers (/root/reference/src/texture/image/png.rs:
8-bit RGB → float in [0,1]; image/exr.rs: R/G/B channels, F16/F32/U32) and
the PNG writer with gamma + 0.5 rounding (texture/image.rs:108-127). PNG is
coded with zlib + struct alone: 8-bit gray, gray+alpha, RGB and RGBA,
non-interlaced, all five scanline filter types.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # PNG color type -> samples per pixel


def read_image(path) -> np.ndarray:
    """→ (H, W, 3) f32 linear-file values (no gamma applied here; the
    texture map applies inverse gamma for spectrum textures, matching
    scene/texture_map.rs:42-46)."""
    path = Path(path)
    ext = path.suffix.lower()
    if ext == ".png":
        return png_to_rgb(read_png(path)).astype(np.float32) / 255.0
    if ext == ".exr":
        return read_exr(path)
    raise ValueError(f"unsupported image extension {ext!r}")


def png_to_rgb(px: np.ndarray) -> np.ndarray:
    """(H, W, C) uint8 from read_png → (H, W, 3): gray is replicated,
    alpha dropped."""
    c = px.shape[-1]
    if c in (1, 2):
        return np.repeat(px[..., :1], 3, axis=-1)
    return px[..., :3]


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(ftype: int, line: bytearray, prev: bytes, bpp: int) -> None:
    """Undo one scanline's filter in place (PNG spec §9)."""
    n = len(line)
    if ftype == 0:
        return
    if ftype == 1:  # Sub
        for i in range(bpp, n):
            line[i] = (line[i] + line[i - bpp]) & 0xFF
    elif ftype == 2:  # Up
        line[:] = ((np.frombuffer(line, np.uint8).astype(np.uint16)
                    + np.frombuffer(prev, np.uint8)) & 0xFF).astype(np.uint8).tobytes()
    elif ftype == 3:  # Average
        for i in range(n):
            left = line[i - bpp] if i >= bpp else 0
            line[i] = (line[i] + ((left + prev[i]) >> 1)) & 0xFF
    elif ftype == 4:  # Paeth
        for i in range(n):
            left = line[i - bpp] if i >= bpp else 0
            up_left = prev[i - bpp] if i >= bpp else 0
            line[i] = (line[i] + _paeth(left, prev[i], up_left)) & 0xFF
    else:
        raise ValueError(f"bad PNG filter type {ftype}")


def read_png(path) -> np.ndarray:
    """Decode an 8-bit, non-interlaced gray / gray+alpha / RGB / RGBA PNG
    → (H, W, C) uint8."""
    buf = Path(path).read_bytes()
    if buf[:8] != _PNG_SIG:
        raise ValueError(f"{path}: not a PNG file")
    off, header, idat = 8, None, []
    while off < len(buf):
        (length,) = struct.unpack(">I", buf[off:off + 4])
        ctype = buf[off + 4:off + 8]
        data = buf[off + 8:off + 8 + length]
        off += 12 + length
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", data)
        elif ctype == b"IDAT":
            idat.append(data)
        elif ctype == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: PNG without IHDR")
    w, h, depth, color, _comp, _filt, interlace = header
    if depth != 8 or color not in _CHANNELS or interlace != 0:
        raise ValueError(
            f"{path}: unsupported PNG (bit depth {depth}, color type "
            f"{color}, interlace {interlace})")
    bpp = _CHANNELS[color]
    stride = w * bpp
    raw = zlib.decompress(b"".join(idat))
    if len(raw) != h * (stride + 1):
        raise ValueError(f"{path}: truncated PNG image data")
    out = np.empty((h, stride), np.uint8)
    prev = bytes(stride)
    for y in range(h):
        start = y * (stride + 1)
        line = bytearray(raw[start + 1:start + 1 + stride])
        _unfilter(raw[start], line, prev, bpp)
        out[y] = np.frombuffer(line, np.uint8)
        prev = bytes(line)
    return out.reshape(h, w, bpp)


def _chunk(ctype: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + ctype + data
            + struct.pack(">I", zlib.crc32(ctype + data) & 0xFFFFFFFF))


def encode_png(px: np.ndarray) -> bytes:
    """(H, W) or (H, W, C) uint8, C in 1-4 → PNG bytes (filter type 0)."""
    px = np.asarray(px, dtype=np.uint8)
    if px.ndim == 2:
        px = px[..., None]
    h, w, c = px.shape
    color = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    rows = np.concatenate([np.zeros((h, 1), np.uint8), px.reshape(h, w * c)],
                          axis=1)
    return (_PNG_SIG
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))


def write_png(path, rgb_u8: np.ndarray) -> None:
    """rgb_u8: (H, W, 3) uint8."""
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_bytes(encode_png(rgb_u8))


# ---------------------------------------------------------------------------
# minimal EXR reader: single-part scanline files, NONE/ZIP/ZIPS compression,
# HALF/FLOAT/UINT channels — the subset the reference's exr crate usage needs.

_PIXTYPE_SIZES = {0: 4, 1: 2, 2: 4}  # UINT, HALF, FLOAT


def _read_cstr(buf, off):
    end = buf.index(b"\0", off)
    return buf[off:end].decode("latin-1"), end + 1


def read_exr(path) -> np.ndarray:
    buf = Path(path).read_bytes()
    if buf[:4] != b"\x76\x2f\x31\x01":
        raise ValueError("not an EXR file")
    version = struct.unpack("<I", buf[4:8])[0]
    if version & 0x200:
        raise ValueError("tiled/deep EXR not supported")
    off = 8
    attrs = {}
    while True:
        if buf[off] == 0:
            off += 1
            break
        name, off = _read_cstr(buf, off)
        atype, off = _read_cstr(buf, off)
        size = struct.unpack("<I", buf[off : off + 4])[0]
        off += 4
        attrs[name] = (atype, buf[off : off + size])
        off += size

    # channels
    chans = []
    cbuf = attrs["channels"][1]
    coff = 0
    while cbuf[coff] != 0:
        cname, coff = _read_cstr(cbuf, coff)
        ptype, _plin, _resx, _resy = struct.unpack("<IIII", cbuf[coff : coff + 16])
        coff += 16
        chans.append((cname, ptype))
    chans_sorted = sorted(chans)  # EXR stores channels alphabetically per scanline

    x0, y0, x1, y1 = struct.unpack("<iiii", attrs["dataWindow"][1])
    width, height = x1 - x0 + 1, y1 - y0 + 1
    comp = attrs["compression"][1][0]
    if comp not in (0, 2, 3):  # NONE, ZIPS, ZIP
        raise ValueError(f"unsupported EXR compression {comp}")
    lines_per_block = 1 if comp in (0, 2) else 16

    n_blocks = (height + lines_per_block - 1) // lines_per_block
    offsets = struct.unpack("<%dQ" % n_blocks, buf[off : off + 8 * n_blocks])

    out = {c: np.zeros((height, width), np.float32) for c, _ in chans}
    bytes_per_line = sum(_PIXTYPE_SIZES[t] for _, t in chans) * width
    for bo in offsets:
        y = struct.unpack("<i", buf[bo : bo + 4])[0] - y0
        dsize = struct.unpack("<I", buf[bo + 4 : bo + 8])[0]
        data = buf[bo + 8 : bo + 8 + dsize]
        n_lines = min(lines_per_block, height - y)
        raw_size = bytes_per_line * n_lines
        if comp != 0 and dsize < raw_size:
            data = zlib.decompress(data)
            # EXR zip predictor: delta-decode then de-interleave
            d = bytearray(data)
            for i in range(1, len(d)):
                d[i] = (d[i] + d[i - 1] - 128) & 0xFF
            half = (len(d) + 1) // 2
            inter = bytearray(len(d))
            inter[0::2] = d[:half]
            inter[1::2] = d[half : half + len(d) - half]
            data = bytes(inter)
        pos = 0
        for line in range(n_lines):
            for cname, ptype in chans_sorted:
                sz = _PIXTYPE_SIZES[ptype] * width
                seg = data[pos : pos + sz]
                pos += sz
                if ptype == 1:
                    vals = np.frombuffer(seg, dtype=np.float16).astype(np.float32)
                elif ptype == 2:
                    vals = np.frombuffer(seg, dtype="<f4").astype(np.float32)
                else:
                    vals = np.frombuffer(seg, dtype="<u4").astype(np.float32)
                out[cname][y + line] = vals

    rgb = np.zeros((height, width, 3), np.float32)
    for i, c in enumerate("RGB"):
        if c in out:
            rgb[..., i] = out[c]
        elif "Y" in out:
            rgb[..., i] = out["Y"]
    return rgb

"""Float image codecs: Radiance RGBE (.hdr) with adaptive RLE scanlines,
OpenEXR (single-part, uncompressed scanlines, float32 or half channels) and
16-bit PNG (through PIL, imported only there).  A copy of
``d3d12renderer_tpu/assets/image_io.py``, which is numpy only: the port
imports nothing of the JAX package.  Everything returns and accepts float32
linear RGB numpy arrays of shape (H, W, 3).
"""

from __future__ import annotations

import struct

import numpy as np

# --------------------------------------------------------------------------
# Radiance RGBE (.hdr)
# --------------------------------------------------------------------------


def _rgbe_to_float(rgbe):
    """(..., 4) uint8 RGBE -> (..., 3) float32 linear."""
    rgbe = rgbe.astype(np.int32)
    e = rgbe[..., 3]
    scale = np.where(e == 0, 0.0, np.ldexp(1.0, e - 136)).astype(np.float32)
    return rgbe[..., :3].astype(np.float32) * scale[..., None]


def _float_to_rgbe(rgb):
    """(..., 3) float32 -> (..., 4) uint8 RGBE."""
    rgb = np.maximum(np.asarray(rgb, np.float32), 0.0)
    v = rgb.max(axis=-1)
    m, e = np.frexp(v)
    scale = np.where(v < 1e-32, 0.0, m * 256.0 / np.maximum(v, 1e-32))
    out = np.zeros(rgb.shape[:-1] + (4,), np.uint8)
    out[..., :3] = np.clip(rgb * scale[..., None] + 0.5, 0, 255).astype(np.uint8)
    out[..., 3] = np.where(v < 1e-32, 0, e + 128).astype(np.uint8)
    return out


def _rle_encode_component(row):
    """Adaptive RLE for one (W,) uint8 component stream (Radiance new-style):
    run packets (count+128, byte) for runs >= 4, literal packets (count,
    bytes) otherwise; counts <= 127/run <= 127."""
    out = bytearray()
    w = len(row)
    i = 0
    while i < w:
        # Find run length at i.
        run = 1
        while i + run < w and run < 127 and row[i + run] == row[i]:
            run += 1
        if run >= 4:
            out.append(128 + run)
            out.append(int(row[i]))
            i += run
        else:
            # Literal until the next run of >= 4 (or 128 bytes).
            j = i + 1
            while j < w and j - i < 128:
                r = 1
                while j + r < w and r < 4 and row[j + r] == row[j]:
                    r += 1
                if r >= 4:
                    break
                j += 1
            out.append(j - i)
            out.extend(int(x) for x in row[i:j])
            i = j
    return bytes(out)


def save_hdr(path: str, rgb):
    """Write (H, W, 3) float32 linear RGB as a Radiance RGBE file."""
    rgb = np.asarray(rgb, np.float32)
    h, w, _ = rgb.shape
    rgbe = _float_to_rgbe(rgb)
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {h} +X {w}\n".encode())
        if 8 <= w < 32768:
            for y in range(h):
                f.write(bytes([2, 2, (w >> 8) & 0xFF, w & 0xFF]))
                for c in range(4):
                    f.write(_rle_encode_component(rgbe[y, :, c]))
        else:  # flat scanlines for widths outside the RLE-encodable range
            f.write(rgbe.tobytes())


def _rle_decode_component(data, pos, w):
    out = np.empty(w, np.uint8)
    i = 0
    while i < w:
        count = data[pos]
        pos += 1
        if count > 128:          # run
            out[i:i + count - 128] = data[pos]
            pos += 1
            i += count - 128
        else:                    # literal
            out[i:i + count] = np.frombuffer(data, np.uint8, count, pos)
            pos += count
            i += count
    return out, pos


def load_hdr(path: str) -> np.ndarray:
    """Read a Radiance RGBE file -> (H, W, 3) float32 linear RGB."""
    with open(path, "rb") as f:
        raw = f.read()
    if not raw.startswith(b"#?"):
        raise ValueError(f"{path}: not a Radiance file")
    # Header: lines until the blank line, then the resolution line.
    pos = 0
    exposure = 1.0
    while True:
        nl = raw.index(b"\n", pos)
        line = raw[pos:nl]
        pos = nl + 1
        if line.startswith(b"EXPOSURE="):
            exposure *= float(line.split(b"=", 1)[1])
        if line == b"":
            break
    nl = raw.index(b"\n", pos)
    res = raw[pos:nl].split()
    pos = nl + 1
    if res[0] != b"-Y" or res[2] != b"+X":
        raise ValueError(f"{path}: unsupported orientation {res}")
    h, w = int(res[1]), int(res[3])

    rgbe = np.empty((h, w, 4), np.uint8)
    for y in range(h):
        if (w >= 8 and w < 32768 and raw[pos] == 2 and raw[pos + 1] == 2
                and ((raw[pos + 2] << 8) | raw[pos + 3]) == w):
            pos += 4                               # new-style RLE scanline
            for c in range(4):
                rgbe[y, :, c], pos = _rle_decode_component(raw, pos, w)
        else:                                      # flat scanline
            rgbe[y] = np.frombuffer(raw, np.uint8, w * 4, pos).reshape(w, 4)
            pos += w * 4
    rgb = _rgbe_to_float(rgbe)
    if exposure != 1.0:
        rgb /= exposure
    return rgb


# --------------------------------------------------------------------------
# OpenEXR (single-part scanline, no compression, half/float channels)
# --------------------------------------------------------------------------

_EXR_MAGIC = 0x01312F76
_PT_HALF, _PT_FLOAT = 1, 2


def save_exr(path: str, rgb, half: bool = False):
    """Write (H, W, 3) float32 as an uncompressed scanline EXR (RGB).

    half=True stores float16 channels (half the size, ~3 decimal digits) —
    the reference's HDR16F intermediate format (src/rendering/render_utils.h)."""
    rgb = np.asarray(rgb, np.float32)
    h, w, _ = rgb.shape
    ptype = _PT_HALF if half else _PT_FLOAT
    cdtype = np.float16 if half else np.float32

    def attr(name, typ, data):
        return (name.encode() + b"\0" + typ.encode() + b"\0"
                + struct.pack("<i", len(data)) + data)

    # chlist: alphabetical (B, G, R), each: name\0 type pLinear+pad xs ys.
    ch = b""
    for cname in ("B", "G", "R"):
        ch += cname.encode() + b"\0" + struct.pack("<i", ptype)
        ch += b"\0\0\0\0" + struct.pack("<ii", 1, 1)
    ch += b"\0"

    box = struct.pack("<iiii", 0, 0, w - 1, h - 1)
    header = b""
    header += attr("channels", "chlist", ch)
    header += attr("compression", "compression", b"\0")      # NO_COMPRESSION
    header += attr("dataWindow", "box2i", box)
    header += attr("displayWindow", "box2i", box)
    header += attr("lineOrder", "lineOrder", b"\0")          # INCREASING_Y
    header += attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
    header += attr("screenWindowCenter", "v2f", struct.pack("<ff", 0.0, 0.0))
    header += attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
    header += b"\0"

    px_size = 2 if half else 4
    row_bytes = 8 + 3 * w * px_size       # y + size prefix + 3 channel rows
    table_start = 8 + len(header)
    data_start = table_start + 8 * h

    with open(path, "wb") as f:
        f.write(struct.pack("<ii", _EXR_MAGIC, 2))
        f.write(header)
        for y in range(h):
            f.write(struct.pack("<Q", data_start + y * row_bytes))
        bgr = rgb[:, :, ::-1].astype(cdtype)       # channel order B, G, R
        for y in range(h):
            f.write(struct.pack("<ii", y, 3 * w * px_size))
            f.write(bgr[y].T.tobytes())            # per-channel rows


def load_exr(path: str) -> np.ndarray:
    """Read an uncompressed single-part scanline EXR -> (H, W, 3) float32.

    Supports half/float RGB(A) channels written by save_exr or any writer
    using NO_COMPRESSION."""
    with open(path, "rb") as f:
        raw = f.read()
    magic, version = struct.unpack_from("<ii", raw, 0)
    if magic != _EXR_MAGIC:
        raise ValueError(f"{path}: not an EXR file")
    if version & 0x200:
        raise ValueError(f"{path}: multi-part EXR unsupported")
    pos = 8

    def read_cstr():
        nonlocal pos
        end = raw.index(b"\0", pos)
        s = raw[pos:end]
        pos = end + 1
        return s

    channels = []       # (name, pixel_type)
    compression = None
    data_window = None
    while True:
        if raw[pos] == 0:
            pos += 1
            break
        name = read_cstr().decode()
        typ = read_cstr().decode()
        (size,) = struct.unpack_from("<i", raw, pos)
        pos += 4
        val = raw[pos:pos + size]
        pos += size
        if name == "channels":
            cpos = 0
            while val[cpos] != 0:
                cend = val.index(b"\0", cpos)
                cname = val[cpos:cend].decode()
                cpos = cend + 1
                (pt,) = struct.unpack_from("<i", val, cpos)
                cpos += 16          # type + pLinear/pad + xSampling + ySampling
                channels.append((cname, pt))
        elif name == "compression":
            compression = val[0]
        elif name == "dataWindow":
            data_window = struct.unpack("<iiii", val)
    if compression != 0:
        raise ValueError(f"{path}: only NO_COMPRESSION EXRs supported "
                         f"(got compression={compression})")
    x0, y0, x1, y1 = data_window
    w, h = x1 - x0 + 1, y1 - y0 + 1

    pos += 8 * h                    # skip the scanline offset table
    rows = {name: [] for name, _ in channels}
    for _ in range(h):
        y, _size = struct.unpack_from("<ii", raw, pos)
        pos += 8
        for cname, pt in channels:  # stored in chlist (alphabetical) order
            if pt == _PT_HALF:
                rows[cname].append(np.frombuffer(raw, np.float16, w, pos)
                                   .astype(np.float32))
                pos += 2 * w
            elif pt == _PT_FLOAT:
                rows[cname].append(np.frombuffer(raw, np.float32, w, pos))
                pos += 4 * w
            else:
                rows[cname].append(np.frombuffer(raw, np.uint32, w, pos)
                                   .astype(np.float32))
                pos += 4 * w
    have = {n for n, _ in channels}
    if {"R", "G", "B"} <= have:
        return np.stack([np.stack(rows[c]) for c in ("R", "G", "B")], -1)
    # Grayscale (e.g. "Y") -> replicate.
    first = channels[0][0]
    g = np.stack(rows[first])
    return np.stack([g, g, g], -1)


# --------------------------------------------------------------------------
# 16-bit PNG
# --------------------------------------------------------------------------


def load_png16(path: str) -> np.ndarray:
    """16-bit PNG -> float32 in [0, 1], linear (no sRGB decode — 16-bit
    sources are heightmaps / linear data)."""
    from PIL import Image

    img = Image.open(path)
    arr = np.asarray(img)
    if arr.dtype != np.uint16:
        raise ValueError(f"{path}: not a 16-bit PNG (dtype {arr.dtype})")
    out = arr.astype(np.float32) / 65535.0
    if out.ndim == 2:
        out = np.stack([out, out, out], -1)
    return out[..., :3]


def save_png16(path: str, arr):
    """float32 [0, 1] single-channel (H, W) -> 16-bit grayscale PNG.

    PIL has no portable 16-bit RGB PNG writer; 16-bit sources here are
    heightmaps / single-channel linear data.  Use save_exr/save_hdr for
    float color."""
    from PIL import Image

    a = np.clip(np.asarray(arr, np.float32), 0, 1)
    if a.ndim != 2:
        raise ValueError("save_png16 writes single-channel images; "
                         "use save_exr/save_hdr for color")
    # fromarray(..., "I;16") is deprecated in Pillow 13; go via I;16 directly.
    u16 = (a * 65535.0 + 0.5).astype(np.uint16)
    img = Image.new("I;16", (u16.shape[1], u16.shape[0]))
    img.frombytes(u16.tobytes())
    img.save(path)

"""PNG decoding for the dataset readers, on the standard library and numpy.

The JAX package reads frames with PIL (``Image.open(p).convert("L")``); the
machine with the card has no PIL, so the port decodes PNG itself, and its
result equals PIL's to the bit:

- the chunks are walked (each CRC checked), the IDAT stream is inflated
  with ``zlib`` and the five row filters (None, Sub, Up, Average, Paeth)
  are undone by a compiled loop (``csrc/png_unfilter.cpp``, built by g++
  into ``_build/`` at first use; a failed build raises, there is no
  fallback).  ``unfilter_plain`` is its numpy/Python twin for the tests;
- colour goes to grey as PIL's ``convert("L")`` does: the fixed-point
  ITU-R 601-2 luma ``(R*19595 + G*38470 + B*7471 + 0x8000) >> 16`` (not the
  float BT.601 of ``System.process_image``), palette entries through the
  same luma, alpha dropped.

Decoded: bit depth 8, colour types 0 (grey), 2 (RGB), 3 (palette), 4 (grey
+ alpha) and 6 (RGBA), not interlaced; TUM ``rgb/`` frames are 8-bit RGB
and KITTI ``image_0/`` frames 8-bit grey.  Anything else raises ValueError
naming the feature.
"""
from __future__ import annotations

import struct
import threading
import zlib

import numpy as np

from .. import _build

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> samples per pixel
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}

_lock = threading.Lock()
_mod = None


def _compiled():
    """The g++-built unfilter module (built on first use; raises if the
    build fails)."""
    global _mod
    with _lock:
        if _mod is None:
            _mod = _build.load_host_extension("png_unfilter")
        return _mod


def unfilter(data, height: int, stride: int, bpp: int) -> np.ndarray:
    """The [height, stride] uint8 rows reconstructed from the inflated
    stream `data` (each row its filter-type byte, then `stride` bytes);
    `bpp` bytes per pixel."""
    out = np.empty((height, stride), np.uint8)
    _compiled().unfilter(data, out, height, stride, bpp)
    return out


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def unfilter_plain(data, height: int, stride: int, bpp: int) -> np.ndarray:
    """`unfilter` in numpy (None, Sub, Up) and Python loops (Average,
    Paeth): the tests' reference for the compiled version."""
    src = np.frombuffer(data, np.uint8)[: height * (stride + 1)]
    src = src.reshape(height, stride + 1)
    out = np.empty((height, stride), np.uint8)
    prior = np.zeros(stride, np.int64)
    for y in range(height):
        ft, f = int(src[y, 0]), src[y, 1:].astype(np.int64)
        if ft == 0:
            row = f
        elif ft == 1:
            row = np.cumsum(f.reshape(-1, bpp), axis=0).reshape(-1) & 255
        elif ft == 2:
            row = (f + prior) & 255
        elif ft in (3, 4):
            r, b = f.tolist(), prior.tolist()
            for i in range(stride):
                a = r[i - bpp] if i >= bpp else 0
                if ft == 3:
                    r[i] = (r[i] + ((a + b[i]) >> 1)) & 255
                else:
                    c = b[i - bpp] if i >= bpp else 0
                    r[i] = (r[i] + _paeth(a, b[i], c)) & 255
            row = np.asarray(r, np.int64)
        else:
            raise ValueError(f"PNG row {y}: filter type {ft} is not one of "
                             "0-4")
        out[y] = row
        prior = row
    return out


def _header(body, path: str):
    if len(body) != 13:
        raise ValueError(f"{path}: IHDR of {len(body)} bytes")
    w, h, depth, ctype, comp, filt, interlace = struct.unpack(
        ">IIBBBBB", body)
    if ctype not in CHANNELS:
        raise ValueError(f"{path}: colour type {ctype} is not a PNG colour "
                         "type")
    if interlace != 0:
        raise ValueError(f"{path}: interlaced (Adam7) PNG is not supported")
    if depth == 16:
        raise ValueError(f"{path}: 16-bit PNG is not supported")
    if depth != 8:
        raise ValueError(f"{path}: bit depth {depth} is not supported "
                         "(only 8)")
    if comp != 0 or filt != 0:
        raise ValueError(f"{path}: compression method {comp} / filter "
                         f"method {filt} is not PNG's 0")
    if w == 0 or h == 0:
        raise ValueError(f"{path}: empty image {w}x{h}")
    return w, h, ctype


def read_png(path: str):
    """(pixels [H, W, C] uint8, colour type, palette [n, 3] uint8 or None)
    of an 8-bit non-interlaced PNG file."""
    with open(path, "rb") as fh:
        buf = memoryview(fh.read())
    if bytes(buf[:8]) != SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, hdr, palette, idat = 8, None, None, []
    while True:
        if pos + 8 > len(buf):
            raise ValueError(f"{path}: truncated before IEND")
        n, ctype = struct.unpack(">I4s", buf[pos:pos + 8])
        body, end = buf[pos + 8:pos + 8 + n], pos + 8 + n
        if end + 4 > len(buf):
            raise ValueError(f"{path}: truncated {ctype!r} chunk")
        if zlib.crc32(body, zlib.crc32(ctype)) != struct.unpack(
                ">I", buf[end:end + 4])[0]:
            raise ValueError(f"{path}: CRC mismatch in {ctype!r} chunk")
        pos = end + 4
        if ctype == b"IHDR":
            hdr = _header(body, path)
        elif ctype == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"IEND":
            break
        elif not ctype[0] & 0x20:       # an unknown critical chunk
            raise ValueError(f"{path}: critical chunk {ctype!r} is not "
                             "supported")
    if hdr is None or not idat:
        raise ValueError(f"{path}: no IHDR or no IDAT chunk")
    w, h, ctype = hdr
    ch = CHANNELS[ctype]
    data = zlib.decompress(b"".join(idat))
    if len(data) < h * (w * ch + 1):
        raise ValueError(f"{path}: {len(data)} bytes of image data for "
                         f"{h} rows of {w * ch + 1}")
    px = unfilter(data, h, w * ch, ch).reshape(h, w, ch)
    if ctype == 3 and palette is None:
        raise ValueError(f"{path}: palette image without a PLTE chunk")
    return px, ctype, palette


_LUMA = np.asarray([19595, 38470, 7471], np.float32)


def luma(rgb: np.ndarray) -> np.ndarray:
    """PIL's RGB -> L, (R*19595 + G*38470 + B*7471 + 0x8000) >> 16, as
    float32 [...] from uint8 [..., 3].  Exact in float32: every product
    and partial sum is an integer below 255 * 65536 + 0x8000 < 2**24, and
    the shift is a division by a power of two and a floor."""
    y = rgb.astype(np.float32) @ _LUMA
    y += np.float32(0x8000)
    y *= np.float32(1.0 / 65536.0)
    return np.floor(y, out=y)


def decode_gray(path: str) -> np.ndarray:
    """float32 [H, W] grey in [0, 255], equal to
    ``np.asarray(Image.open(path).convert("L"), np.float32)``."""
    px, ctype, palette = read_png(path)
    if ctype in (0, 4):
        return px[..., 0].astype(np.float32)
    if ctype in (2, 6):
        return luma(px[..., :3])
    idx = px[..., 0]
    if int(idx.max()) >= len(palette):
        raise ValueError(f"{path}: palette index {int(idx.max())} past the "
                         f"{len(palette)} PLTE entries")
    return luma(palette)[idx]

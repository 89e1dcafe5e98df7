"""PNG reading and writing and the nearest-neighbour resize, in numpy,
``zlib`` and a small C++ unfilter: what the DTU loaders and the validate
artifacts need of ``PIL`` and ``cv2``, neither of which the port depends
on.

* ``read_png(path)`` returns what ``np.array(PIL.Image.open(path))``
  returns for an 8-bit, non-interlaced greyscale (``(H, W)``), grey +
  alpha (``(H, W, 2)``), RGB (``(H, W, 3)``) or RGBA (``(H, W, 4)``)
  PNG: uint8, every scanline filter (none, sub, up, average, Paeth),
  undone row by row by ``csrc/png_unfilter.cpp`` (built with g++ at
  first use, as the marching cubes are).  Any other bit depth, colour
  type or interlace raises ``ValueError`` naming what it met.
* ``write_png(path, array)`` writes a uint8 (H, W), (H, W, 3) or
  (H, W, 4) array as an 8-bit L, RGB or RGBA PNG, each row under the
  filter libpng's default heuristic picks: of the five, the one whose
  filtered bytes, read as signed, have the least sum of magnitudes.
* ``to_luma(img)`` is ``Image.open(path).convert("L")`` of what
  ``read_png`` gives: L as it is, LA's L channel, RGB and RGBA by
  Pillow's integer luma ``(19595 R + 38470 G + 7471 B + 0x8000) >> 16``
  (alpha ignored).
* ``resize_nearest(img, (w, h))`` is ``cv2.resize(img, (w, h),
  interpolation=cv2.INTER_NEAREST)``: source index ``floor(i * s)``
  with ``s = 1 / (dst / src)`` in double, clamped to the last row or
  column.
"""

from __future__ import annotations

import ctypes
import struct
import zlib

import numpy as np

from .._build import host_lib

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> (channels, mode name)
_COLOR_TYPES = {0: (1, "L"), 2: (3, "RGB"), 4: (2, "LA"), 6: (4, "RGBA")}
_COLOR_NAMES = {0: "greyscale", 2: "RGB", 3: "palette", 4: "grey+alpha", 6: "RGBA"}


def _chunks(buf, path):
    if buf[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos = 8
    while pos + 12 <= len(buf):
        n, = struct.unpack(">I", buf[pos:pos + 4])
        kind = buf[pos + 4:pos + 8]
        data = buf[pos + 8:pos + 8 + n]
        crc, = struct.unpack(">I", buf[pos + 8 + n:pos + 12 + n])
        if len(data) != n or zlib.crc32(kind + data) != crc:
            raise ValueError(f"{path}: corrupt {kind!r} chunk")
        yield kind, data
        if kind == b"IEND":
            return
        pos += 12 + n
    raise ValueError(f"{path}: truncated PNG (no IEND chunk)")


def _unfilter_lib():
    lib = host_lib("png_unfilter", "png_unfilter.cpp")
    if not getattr(lib, "_surf_typed", False):
        lib.png_unfilter.restype = ctypes.c_int64
        lib.png_unfilter.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                                     ctypes.c_int64, ctypes.c_void_p]
        lib._surf_typed = True
    return lib


def read_png(path):
    """The pixels of an 8-bit, non-interlaced L, LA, RGB or RGBA PNG, as
    ``np.array(PIL.Image.open(path))`` gives them."""
    with open(path, "rb") as fh:
        buf = fh.read()
    header, idat = None, []
    for kind, data in _chunks(buf, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", data)
        elif kind == b"IDAT":
            idat.append(data)
        elif kind[:1].isupper() and kind not in (b"IEND", b"PLTE"):
            raise ValueError(f"{path}: unknown critical chunk {kind!r}")
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, color, compression, filtering, interlace = header
    if color not in _COLOR_TYPES:
        raise ValueError(f"{path}: colour type {color} "
                         f"({_COLOR_NAMES.get(color, 'invalid')}) is not supported "
                         f"(only L, LA, RGB and RGBA)")
    if depth != 8:
        raise ValueError(f"{path}: bit depth {depth} is not supported (only 8)")
    if interlace != 0:
        raise ValueError(f"{path}: interlace method {interlace} (Adam7) is not "
                         f"supported")
    if compression != 0 or filtering != 0:
        raise ValueError(f"{path}: compression {compression} / filter method "
                         f"{filtering} is not PNG's")
    if w == 0 or h == 0:
        raise ValueError(f"{path}: empty image ({w}x{h})")
    bpp = _COLOR_TYPES[color][0]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (1 + w * bpp):
        raise ValueError(f"{path}: {raw.size} bytes of image data, expected "
                         f"{h * (1 + w * bpp)}")
    img = np.empty((h, w, bpp), np.uint8)
    bad = _unfilter_lib().png_unfilter(raw.ctypes.data, h, w * bpp, bpp, img.ctypes.data)
    if bad:
        raise ValueError(f"{path}: scanline filter {raw[(bad - 1) * (1 + w * bpp)]} "
                         f"is not PNG's")
    return img[..., 0] if bpp == 1 else img


def _chunk(kind, data):
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data)))


def _filter_rows(cur, bpp):
    """The filtered scanlines, (h, 1 + row bytes) uint8, of the (h, row
    bytes) uint8 rows ``cur``: each row under the filter of least sum of
    |signed byte|, the first such of none, sub, up, average, Paeth."""
    cur = cur.astype(np.int16)
    h, n = cur.shape
    up = np.zeros_like(cur)
    up[1:] = cur[:-1]
    left = np.zeros_like(cur)
    left[:, bpp:] = cur[:, :-bpp]
    upleft = np.zeros_like(cur)
    upleft[:, bpp:] = up[:, :-bpp]
    p = left + up - upleft
    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
    paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
    preds = (0, left, up, (left + up) >> 1, paeth)
    best = np.zeros((h, 1 + n), np.uint8)
    best_cost = np.full(h, np.iinfo(np.int64).max)
    for t, pred in enumerate(preds):
        res = ((cur - pred) & 255).astype(np.uint8)
        cost = np.minimum(res, 256 - res.astype(np.int16)).sum(1, dtype=np.int64)
        take = cost < best_cost
        best[take, 0], best[take, 1:] = t, res[take]
        best_cost = np.where(take, cost, best_cost)
    return best


def write_png(path, array):
    """Write a uint8 (H, W) / (H, W, 3) / (H, W, 4) array as an 8-bit L /
    RGB / RGBA PNG (each row's filter as libpng's heuristic picks it)."""
    a = np.asarray(array)
    if a.dtype != np.uint8:
        raise ValueError(f"write_png takes uint8 pixels, not {a.dtype}")
    if a.ndim == 2:
        color = 0
    elif a.ndim == 3 and a.shape[2] in (3, 4):
        color = 2 if a.shape[2] == 3 else 6
    else:
        raise ValueError(f"write_png takes (H, W), (H, W, 3) or (H, W, 4), not {a.shape}")
    rows = _filter_rows(a.reshape(a.shape[0], -1), 1 if a.ndim == 2 else a.shape[2])
    h, w = a.shape[:2]
    ihdr = struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0)
    with open(path, "wb") as fh:
        fh.write(_SIGNATURE + _chunk(b"IHDR", ihdr)
                 + _chunk(b"IDAT", zlib.compress(rows.tobytes()))
                 + _chunk(b"IEND", b""))


def to_luma(img):
    """The uint8 (H, W) greyscale of an (H, W) L, (H, W, 2) LA, (H, W, 3)
    RGB or (H, W, 4) RGBA uint8 image, as Pillow's ``convert("L")`` gives
    it."""
    a = np.asarray(img)
    if a.dtype != np.uint8:
        raise ValueError(f"to_luma takes uint8 pixels, not {a.dtype}")
    if a.ndim == 2:
        return a
    if a.ndim != 3 or a.shape[2] not in (2, 3, 4):
        raise ValueError(f"to_luma takes L, LA, RGB or RGBA pixels, not shape {a.shape}")
    if a.shape[2] == 2:
        return np.ascontiguousarray(a[..., 0])
    c = a[..., :3].astype(np.uint32)
    return ((c[..., 0] * 19595 + c[..., 1] * 38470 + c[..., 2] * 7471 + 0x8000)
            >> 16).astype(np.uint8)


def _nearest_index(src, dst):
    """cv2's INTER_NEAREST source index of each of ``dst`` outputs."""
    inv = 1.0 / (dst / src)
    return np.minimum(np.floor(np.arange(dst) * inv).astype(np.int64), src - 1)


def resize_nearest(img, dsize):
    """``cv2.resize(img, dsize, interpolation=cv2.INTER_NEAREST)`` with
    ``dsize = (width, height)``, for 2-D and 3-D arrays."""
    img = np.asarray(img)
    w, h = int(dsize[0]), int(dsize[1])
    ys = _nearest_index(img.shape[0], h)
    xs = _nearest_index(img.shape[1], w)
    return img[ys[:, None], xs[None, :]]

"""PNG reading and writing and the nearest-neighbour resize, in numpy,
``zlib`` and a small C++ unfilter: what the DTU loaders and the validate
artifacts need of ``PIL`` and ``cv2``, neither of which the port depends
on.

* ``read_png(path)`` returns what ``np.array(PIL.Image.open(path))``
  returns for every PNG the specification defines, bit for bit, with
  Pillow's dtype and shape: greyscale at depth 1 (Pillow's mode "1":
  bool ``(H, W)``), 2 and 4 (mode "L": uint8, scaled to 0-255 as Pillow's
  ``L;2`` / ``L;4`` unpackers scale them), 8 (uint8 ``(H, W)``) and 16
  (mode "I;16": uint16 ``(H, W)``, native byte order); palette images at
  depths 1, 2, 4 and 8 (mode "P": the uint8 indices, ``(H, W)``); grey +
  alpha (``(H, W, 2)``), RGB (``(H, W, 3)``) and RGBA (``(H, W, 4)``) at
  depth 8, and at depth 16 as Pillow gives them, 8-bit from each sample's
  high byte (grey + alpha then as RGBA, ``(H, W, 4)``); non-interlaced or
  Adam7-interlaced, every scanline filter (none, sub, up, average,
  Paeth), undone pass by pass and row by row by ``csrc/png_unfilter.cpp``
  (built with g++ at first use, as the marching cubes are).  A colour
  type or bit depth the specification forbids, an interlace method other
  than 0 and 1, a palette image without PLTE, corrupt chunks, unknown
  critical chunks, a wrong amount of image data and filter types above 4
  raise ``ValueError`` naming what was met.
* ``write_png(path, array, interlace=False)`` writes a uint8 (H, W),
  (H, W, 3) or (H, W, 4) array as an 8-bit L, RGB or RGBA PNG, each row
  under the filter libpng's default heuristic picks: of the five, the one
  whose filtered bytes, read as signed, have the least sum of magnitudes;
  with ``interlace`` in Adam7's seven passes (a fixture).
* ``to_luma(img, palette=None)`` is ``Image.open(path).convert("L")`` of
  what ``read_png`` gives: L as it is, LA's L channel, RGB and RGBA by
  Pillow's integer luma ``(19595 R + 38470 G + 7471 B + 0x8000) >> 16``
  (alpha ignored), mode "1" as 0 / 255, "I;16" clipped at 255, and a
  palette image's indices (with ``palette``, its PLTE entries) through
  the luma of their entries.  ``read_png_luma(path)`` is the two in one,
  the palette taken from the file.
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
# colour type -> (channels, the bit depths the PNG specification allows)
_COLOR_TYPES = {0: (1, (1, 2, 4, 8, 16)), 2: (3, (8, 16)), 3: (1, (1, 2, 4, 8)),
                4: (2, (8, 16)), 6: (4, (8, 16))}
_COLOR_NAMES = {0: "greyscale", 2: "RGB", 3: "palette", 4: "grey+alpha", 6: "RGBA"}
# Adam7's passes: (first row, first column, row step, column step)
_ADAM7 = ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4), (2, 0, 4, 2),
          (0, 1, 2, 2), (1, 0, 2, 1))


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


def _unpack(rows, width, channels, depth):
    """The (h, width, channels) samples of unfiltered rows (h, row bytes):
    bytes at depth 8, big-endian pairs at 16, and at 1, 2 and 4 one
    channel packed most significant bits first."""
    h = rows.shape[0]
    if depth == 8:
        return rows.reshape(h, width, channels)
    if depth == 16:
        return rows.view(">u2").reshape(h, width, channels)
    per = 8 // depth
    shifts = (8 - depth - depth * np.arange(per)).astype(np.uint8)
    vals = (rows[:, :, None] >> shifts) & ((1 << depth) - 1)
    return vals.reshape(h, -1)[:, :width, None]


def _read_png(path):
    """(pixels as ``np.array(PIL.Image.open(path))`` gives them, the PLTE
    entries as (n, 3) uint8 for a palette image or None)."""
    with open(path, "rb") as fh:
        buf = fh.read()
    header, idat, plte = None, [], None
    for kind, data in _chunks(buf, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", data)
        elif kind == b"IDAT":
            idat.append(data)
        elif kind == b"PLTE":
            plte = data
        elif kind[:1].isupper() and kind != b"IEND":
            raise ValueError(f"{path}: unknown critical chunk {kind!r}")
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, color, compression, filtering, interlace = header
    if color not in _COLOR_TYPES:
        raise ValueError(f"{path}: colour type {color} is not PNG's")
    channels, depths = _COLOR_TYPES[color]
    if depth not in depths:
        raise ValueError(f"{path}: bit depth {depth} is not allowed for colour type "
                         f"{color} ({_COLOR_NAMES[color]}): only {depths}")
    if interlace not in (0, 1):
        raise ValueError(f"{path}: interlace method {interlace} is not PNG's (0: none, "
                         f"1: Adam7)")
    if compression != 0 or filtering != 0:
        raise ValueError(f"{path}: compression {compression} / filter method "
                         f"{filtering} is not PNG's")
    if w == 0 or h == 0:
        raise ValueError(f"{path}: empty image ({w}x{h})")
    palette = None
    if color == 3:
        if plte is None:
            raise ValueError(f"{path}: a palette image without a PLTE chunk")
        if len(plte) % 3 or not 3 <= len(plte) <= 768:
            raise ValueError(f"{path}: a PLTE chunk of {len(plte)} bytes")
        palette = np.frombuffer(plte, np.uint8).reshape(-1, 3)
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    bits = depth * channels
    bpp = max(1, bits // 8)          # the unfilter's distance to the "left" byte
    passes = []                      # (first row, first col, steps, rows, cols, row bytes)
    for r0, c0, dr, dc in (_ADAM7 if interlace else ((0, 0, 1, 1),)):
        ph, pw = max(0, -(-(h - r0) // dr)), max(0, -(-(w - c0) // dc))
        if ph and pw:                # an empty pass has no bytes
            passes.append((r0, c0, dr, dc, ph, pw, (pw * bits + 7) // 8))
    expected = sum(p[4] * (1 + p[6]) for p in passes)
    if raw.size != expected:
        raise ValueError(f"{path}: {raw.size} bytes of image data, expected {expected}")
    lib = _unfilter_lib()
    samples = np.empty((h, w, channels), np.uint16 if depth == 16 else np.uint8)
    off = 0
    for r0, c0, dr, dc, ph, pw, row_bytes in passes:
        part = raw[off:off + ph * (1 + row_bytes)]
        # a non-interlaced 8-bit image is unfiltered in place
        whole = depth == 8 and not interlace
        rows = samples.reshape(h, -1) if whole else np.empty((ph, row_bytes), np.uint8)
        bad = lib.png_unfilter(part.ctypes.data, ph, row_bytes, bpp, rows.ctypes.data)
        if bad:
            raise ValueError(f"{path}: scanline filter {part[(bad - 1) * (1 + row_bytes)]} "
                             f"is not PNG's")
        if not whole:
            samples[r0::dr, c0::dc] = _unpack(rows, pw, channels, depth)
        off += part.size
    if depth == 16 and color == 0:   # mode "I;16"
        return samples[..., 0], None
    if depth == 16:                  # Pillow's RGB;16B, RGBA;16B, LA;16B: high bytes
        hi = (samples >> 8).astype(np.uint8)
        return (hi[..., [0, 0, 0, 1]] if color == 4 else hi), None
    if color == 3:                   # mode "P"
        return samples[..., 0], palette
    if color == 0 and depth == 1:    # mode "1"
        return samples[..., 0] != 0, None
    if color == 0 and depth < 8:     # mode "L" (Pillow's L;2 and L;4 scaled up)
        return samples[..., 0] * np.uint8(255 // ((1 << depth) - 1)), None
    return (samples[..., 0] if channels == 1 else samples), None


def read_png(path):
    """The pixels of a PNG, as ``np.array(PIL.Image.open(path))`` gives
    them (see the module's docstring for each form)."""
    return _read_png(path)[0]


def read_png_luma(path):
    """``np.array(PIL.Image.open(path).convert("L"))``: uint8 (H, W)."""
    return to_luma(*_read_png(path))


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


def write_png(path, array, interlace=False):
    """Write a uint8 (H, W) / (H, W, 3) / (H, W, 4) array as an 8-bit L /
    RGB / RGBA PNG (each row's filter as libpng's heuristic picks it; with
    ``interlace``, in Adam7's passes, each filtered on its own)."""
    a = np.asarray(array)
    if a.dtype != np.uint8:
        raise ValueError(f"write_png takes uint8 pixels, not {a.dtype}")
    if a.ndim == 2:
        color = 0
    elif a.ndim == 3 and a.shape[2] in (3, 4):
        color = 2 if a.shape[2] == 3 else 6
    else:
        raise ValueError(f"write_png takes (H, W), (H, W, 3) or (H, W, 4), not {a.shape}")
    bpp = 1 if a.ndim == 2 else a.shape[2]
    parts = [a[r0::dr, c0::dc] for r0, c0, dr, dc in _ADAM7] if interlace else [a]
    data = b"".join(_filter_rows(p.reshape(p.shape[0], -1), bpp).tobytes()
                    for p in parts if p.size)
    h, w = a.shape[:2]
    ihdr = struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 1 if interlace else 0)
    with open(path, "wb") as fh:
        fh.write(_SIGNATURE + _chunk(b"IHDR", ihdr)
                 + _chunk(b"IDAT", zlib.compress(data))
                 + _chunk(b"IEND", b""))


def _luma(rgb):
    """Pillow's integer luma of uint8 (..., 3) RGB."""
    c = rgb.astype(np.uint32)
    return ((c[..., 0] * 19595 + c[..., 1] * 38470 + c[..., 2] * 7471 + 0x8000)
            >> 16).astype(np.uint8)


def to_luma(img, palette=None):
    """The uint8 (H, W) greyscale of what ``read_png`` returns, as
    Pillow's ``convert("L")`` gives it: an (H, W) L, (H, W, 2) LA, (H, W,
    3) RGB or (H, W, 4) RGBA uint8 image, an (H, W) bool ("1") or uint16
    ("I;16") one, or with ``palette`` ((n, 3) uint8 PLTE entries) the
    (H, W) uint8 indices of a palette image."""
    a = np.asarray(img)
    if palette is not None:
        pal = np.asarray(palette, np.uint8).reshape(-1, 3)
        if a.dtype != np.uint8 or a.ndim != 2:
            raise ValueError(f"to_luma takes (H, W) uint8 palette indices, not "
                             f"{a.dtype} {a.shape}")
        if a.size and int(a.max()) >= len(pal):
            raise ValueError(f"palette index {int(a.max())} beyond the palette's "
                             f"{len(pal)} entries")
        return _luma(pal)[a]
    if a.dtype == np.bool_ and a.ndim == 2:
        return np.where(a, np.uint8(255), np.uint8(0))
    if a.dtype == np.uint16 and a.ndim == 2:
        return np.minimum(a, 255).astype(np.uint8)
    if a.dtype != np.uint8:
        raise ValueError(f"to_luma takes uint8 pixels (or (H, W) bool or uint16), not "
                         f"{a.dtype}")
    if a.ndim == 2:
        return a
    if a.ndim != 3 or a.shape[2] not in (2, 3, 4):
        raise ValueError(f"to_luma takes L, LA, RGB or RGBA pixels, not shape {a.shape}")
    if a.shape[2] == 2:
        return np.ascontiguousarray(a[..., 0])
    return _luma(a[..., :3])


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

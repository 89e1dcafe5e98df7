"""JPEG reading (and, for fixtures, writing) without ``PIL``: ctypes over
``csrc/jpeg_decode.cpp``, built with g++ at first use as the PNG unfilter
is.

* ``read_jpeg(path)`` returns what ``np.array(PIL.Image.open(path))``
  returns for a baseline or extended sequential (SOF0/SOF1) or a
  progressive (SOF2) JPEG with 8-bit samples and Huffman coding, bit for
  bit: uint8 ``(H, W, 3)`` for a colour image, ``(H, W)`` for greyscale.
  The decoder repeats libjpeg-turbo's integer arithmetic as Pillow calls
  it: the accurate integer IDCT (``jpeg_idct_islow``), the fancy
  (triangle) chroma upsampling of ``jdsample.c`` with its box fallback at
  a downsampled width of 2 or less (not the merged upsampler of
  ``jdmerge.c``: Pillow leaves ``do_fancy_upsampling`` on), and
  ``jdcolor.c``'s YCbCr -> RGB tables.  Restart intervals, any number of
  DHT/DQT/DRI segments (optimized Huffman tables, 16-bit quantization
  tables; between progressive scans too), APPn/COM segments,
  non-interleaved scans and every progression libjpeg accepts without a
  warning (spectral selection, successive approximation, EOB runs) are
  read.  Lossless, hierarchical and arithmetic-coded files, other sample
  precisions (12-bit), CMYK/YCCK, DNL, progressions that are bad, bogus
  (an AC scan before the DC scan, a refinement of the wrong bit) or
  incomplete at EOI (a coefficient short of its last bit, which libjpeg
  would smooth), corrupt codes and truncated data raise ``ValueError``
  naming what the decoder met.
* ``write_jpeg(path, array, quality=75, subsampling="4:2:0",
  progressive=False)`` writes a uint8 ``(H, W)`` or ``(H, W, 3)`` array
  as a JFIF JPEG with the Annex K tables scaled as libjpeg scales them
  for ``quality``, at 4:4:4, 4:2:2 or 4:2:0, baseline or progressive (a
  fixture for tests and ``data.mvs_scene``: no loader calls it).
"""

from __future__ import annotations

import ctypes

import numpy as np

from .._build import host_lib

_SUBSAMPLING = {"4:4:4": 0, "4:2:2": 1, "4:2:0": 2}
_ERR_LEN = 256


def _lib():
    lib = host_lib("jpeg_decode", "jpeg_decode.cpp")
    if not getattr(lib, "_surf_typed", False):
        i64, p = ctypes.c_int64, ctypes.c_void_p
        lib.jpeg_header.restype = i64
        lib.jpeg_header.argtypes = [p, i64, ctypes.POINTER(i64), ctypes.c_char_p, i64]
        lib.jpeg_decode.restype = i64
        lib.jpeg_decode.argtypes = [p, i64, p, i64, ctypes.c_char_p, i64]
        lib.jpeg_encode.restype = p
        lib.jpeg_encode.argtypes = [p, i64, i64, i64, i64, i64, i64, ctypes.POINTER(i64),
                                    ctypes.c_char_p, i64]
        lib.jpeg_free.restype = None
        lib.jpeg_free.argtypes = [p]
        lib._surf_typed = True
    return lib


def read_jpeg(path):
    """The pixels of a sequential or progressive JPEG, as
    ``np.array(PIL.Image.open(path))`` gives them."""
    with open(path, "rb") as fh:
        buf = np.frombuffer(fh.read(), np.uint8)
    lib, err = _lib(), ctypes.create_string_buffer(_ERR_LEN)
    dims = (ctypes.c_int64 * 3)()
    if lib.jpeg_header(buf.ctypes.data, buf.size, dims, err, _ERR_LEN) != 0:
        raise ValueError(f"{path}: {err.value.decode()}")
    h, w, c = dims
    out = np.empty((h, w, c), np.uint8)
    if lib.jpeg_decode(buf.ctypes.data, buf.size, out.ctypes.data, out.size, err,
                       _ERR_LEN) != 0:
        raise ValueError(f"{path}: {err.value.decode()}")
    return out[..., 0] if c == 1 else out


def write_jpeg(path, array, quality=75, subsampling="4:2:0", progressive=False):
    """Write a uint8 (H, W) / (H, W, 3) array as a JFIF JPEG (Annex K
    tables at ``quality``; ``subsampling`` "4:4:4", "4:2:2" or "4:2:0").

    ``progressive``: libjpeg's ``jpeg_simple_progression`` script (colour:
    10 scans, the DC with Al 1 then 0, the luma AC in bands 1-5 and 6-63
    at Al 2 then refined to 1 and 0, each chroma AC at Al 1 then 0;
    greyscale: its 6 scans) in place of one sequential scan.  The same
    quantization and DCT as the baseline file, so the two files of one
    array hold the same coefficients and decode to the same pixels.  The
    Huffman tables stay Annex K's, which have no EOBn symbols for runs of
    more than one block, so no EOB run is longer than 1 (each band ending
    in zeros ends in EOB0), as an unoptimized table allows."""
    a = np.ascontiguousarray(array)
    if a.dtype != np.uint8:
        raise ValueError(f"write_jpeg takes uint8 pixels, not {a.dtype}")
    if not (a.ndim == 2 or (a.ndim == 3 and a.shape[2] == 3)):
        raise ValueError(f"write_jpeg takes (H, W) or (H, W, 3), not {a.shape}")
    if subsampling not in _SUBSAMPLING:
        raise ValueError(f"subsampling {subsampling!r}: one of 4:4:4, 4:2:2, 4:2:0")
    lib, err = _lib(), ctypes.create_string_buffer(_ERR_LEN)
    size = ctypes.c_int64(0)
    ptr = lib.jpeg_encode(a.ctypes.data, a.shape[0], a.shape[1], 1 if a.ndim == 2 else 3,
                          int(quality), _SUBSAMPLING[subsampling], int(bool(progressive)),
                          ctypes.byref(size), err, _ERR_LEN)
    if not ptr:
        raise ValueError(f"{path}: {err.value.decode()}")
    try:
        data = ctypes.string_at(ptr, size.value)
    finally:
        lib.jpeg_free(ptr)
    with open(path, "wb") as fh:
        fh.write(data)

"""The port's image and depth I/O (surf_tpu_torch/io) against what the JAX
package reads them with: ``surf_tpu.io.pfm``, ``PIL.Image`` (the JAX
loaders' ``np.array(Image.open(path))`` and the evaluation's
``convert("L")``), ``cv2.resize(..., INTER_NEAREST)`` and matplotlib's
magma (the runner's ``save_depth_png``).  The PNGs come from Pillow, cv2
and this file's own writer (``_encode``: every depth and colour type the
PNG specification allows, every filter, Adam7 at sizes whose passes are
empty).  Every comparison is exact: the same bytes, pixels, dtypes,
shapes and indices."""

import struct
import zlib

import cv2
import matplotlib
import numpy as np
import pytest
from PIL import Image

from surf_tpu.io import pfm as jpfm
from surf_tpu.runner import save_depth_png as j_save_depth_png

from surf_tpu_torch.io import colormap, image, pfm

matplotlib.use("Agg")

MODES = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4}
COLOR_TYPE = {"L": 0, "LA": 4, "RGB": 2, "RGBA": 6}


def _pixels(rng, h, w, c):
    """A smooth gradient plus noise, so that PIL's and cv2's encoders pick
    every kind of row filter."""
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([(np.sin(xx / 7.0 + k) * 90 + np.cos(yy / 5.0) * 30 + 128)
                     for k in range(c)], -1)
    noise = rng.randint(0, 3, (h, w, c)) * (rng.rand(h, 1, 1) < 0.5)
    img = np.clip(base + noise, 0, 255).astype(np.uint8)
    return img[..., 0] if c == 1 else img


def _scanlines(buf):
    """The inflated scanlines, (h, 1 + row bytes) uint8, of a non-interlaced
    8-bit PNG's bytes: each row's filter byte, then its filtered bytes."""
    pos, idat, hdr = 8, b"", None
    while pos < len(buf):
        n, = struct.unpack(">I", buf[pos:pos + 4])
        kind, data = buf[pos + 4:pos + 8], buf[pos + 8:pos + 8 + n]
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", data)
        elif kind == b"IDAT":
            idat += data
        pos += 12 + n
    w, h, _, color, *_ = hdr
    bpp = {0: 1, 4: 2, 2: 3, 6: 4}[color]
    return np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + w * bpp)


def _filter_types(path):
    """The scanline filter byte of every row of a non-interlaced 8-bit PNG."""
    return set(_scanlines(open(path, "rb").read())[:, 0].tolist())


# Adam7 (PNG specification, 8.2): (first row, first column, row step,
# column step) of each of the seven passes
ADAM7 = [(0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4), (2, 0, 4, 2), (0, 1, 2, 2),
         (1, 0, 2, 1)]


def _pack(a, depth):
    """The (h, row bytes) uint8 rows of (h, w, c) samples at ``depth``:
    big-endian pairs at 16, bytes at 8, and below 8 (one channel) the
    samples packed most significant first, the last byte padded."""
    h, w, c = a.shape
    if depth == 16:
        return a.astype(">u2").view(np.uint8).reshape(h, w * c * 2)
    if depth == 8:
        return a.astype(np.uint8).reshape(h, w * c)
    per = 8 // depth
    v = np.zeros((h, -(-w // per) * per), np.int64)
    v[:, :w] = a[..., 0]
    shifts = 8 - depth - depth * np.arange(per)
    return (v.reshape(h, -1, per) << shifts).sum(-1).astype(np.uint8)


def _filter(rows, filters, bpp):
    """Scanlines (filter byte + filtered bytes) of packed rows, row y under
    ``filters[y % len(filters)]``."""
    out = []
    prev = np.zeros(rows.shape[1], np.int32)
    for y in range(rows.shape[0]):
        cur = rows[y].astype(np.int32)
        left = np.concatenate([np.zeros(bpp, np.int32), cur[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        t = filters[y % len(filters)]
        if t == 0:
            pred = np.zeros_like(cur)
        elif t == 1:
            pred = left
        elif t == 2:
            pred = prev
        elif t == 3:
            pred = (left + prev) // 2
        else:
            p = left + prev - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
        out.append(bytes([t]) + ((cur - pred) % 256).astype(np.uint8).tobytes())
        prev = cur
    return out


def _encode(img, filters, depth=8, color=None, interlace=0, plte=None):
    """A PNG of the samples ``img`` ((H, W) or (H, W, C), uint8 or uint16)
    at ``depth`` whose row y is filtered with ``filters[y % len(filters)]``
    (the PNG specification's five filters, written out here independently
    of the reader); with ``interlace`` 1 in Adam7's passes, each packed and
    filtered on its own, an empty pass written as nothing; ``plte``: a PLTE
    chunk's bytes."""
    a = img if img.ndim == 3 else img[..., None]
    h, w, c = a.shape
    bpp = max(1, c * depth // 8)
    passes = ADAM7 if interlace == 1 else [(0, 0, 1, 1)]
    rows = []
    for r0, c0, dr, dc in passes:
        part = a[r0::dr, c0::dc]
        if part.size:
            rows += _filter(_pack(part, depth), filters, bpp)
    if color is None:
        color = {1: 0, 2: 4, 3: 2, 4: 6}[c]

    def chunk(kind, data):
        return struct.pack(">I", len(data)) + kind + data + \
            struct.pack(">I", zlib.crc32(kind + data))
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, interlace))
            + (chunk(b"PLTE", plte) if plte is not None else b"")
            + chunk(b"IDAT", zlib.compress(b"".join(rows)))
            + chunk(b"IEND", b""))


# -- PFM ------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(37, 53), (12, 9, 3)])
def test_pfm_matches_jax_both_ways(tmp_path, shape):
    rng = np.random.RandomState(0)
    d = (rng.randn(*shape) * 100).astype(np.float32)
    jpfm.write_pfm(str(tmp_path / "j.pfm"), d, scale=2.0)
    pfm.write_pfm(str(tmp_path / "t.pfm"), d, scale=2.0)
    assert (tmp_path / "j.pfm").read_bytes() == (tmp_path / "t.pfm").read_bytes()
    got, s = pfm.read_pfm(str(tmp_path / "j.pfm"))
    ref, sr = jpfm.read_pfm(str(tmp_path / "j.pfm"))
    assert s == sr == 2.0 and got.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, d)


# -- PNG reading -------------------------------------------------------------

@pytest.mark.parametrize("mode", sorted(MODES))
def test_read_png_matches_pil_on_pil_files(tmp_path, mode):
    img = _pixels(np.random.RandomState(1), 61, 83, MODES[mode])
    path = str(tmp_path / f"{mode}.png")
    Image.fromarray(img, mode=mode).save(path)
    ref = np.array(Image.open(path))
    got = image.read_png(path)
    assert got.dtype == ref.dtype == np.uint8 and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, img)


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_read_png_matches_pil_on_cv2_files(tmp_path, channels):
    img = _pixels(np.random.RandomState(2), 70, 45, channels)
    path = str(tmp_path / "c.png")
    assert cv2.imwrite(path, img)
    ref = np.array(Image.open(path))
    np.testing.assert_array_equal(image.read_png(path), ref)


def test_pil_and_cv2_files_exercise_the_filters(tmp_path):
    """The files the two tests above read hold more than filter 0: the
    encoders' adaptive filtering picks sub, up and Paeth rows on this
    content (average rows, which neither picks here, are in
    ``test_read_png_every_filter``)."""
    seen = set()
    for c, mode in ((1, "L"), (3, "RGB"), (4, "RGBA")):
        img = _pixels(np.random.RandomState(1), 61, 83, c)
        Image.fromarray(img, mode=mode).save(str(tmp_path / "p.png"))
        seen |= _filter_types(str(tmp_path / "p.png"))
        cv2.imwrite(str(tmp_path / "c.png"), img)
        seen |= _filter_types(str(tmp_path / "c.png"))
    assert {1, 2, 4} <= seen


@pytest.mark.parametrize("filters", [[0], [1], [2], [3], [4], [0, 1, 2, 3, 4], [4, 3, 1]])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_read_png_every_filter(tmp_path, mode, filters):
    img = _pixels(np.random.RandomState(3), 23, 31, MODES[mode])
    path = tmp_path / "f.png"
    path.write_bytes(_encode(img, filters))
    ref = np.array(Image.open(str(path)))
    np.testing.assert_array_equal(ref, img)
    np.testing.assert_array_equal(image.read_png(str(path)), ref)


def test_read_png_one_row_and_one_column(tmp_path):
    for img in (_pixels(np.random.RandomState(4), 1, 17, 3),
                _pixels(np.random.RandomState(5), 19, 1, 4)):
        path = tmp_path / "e.png"
        path.write_bytes(_encode(img, [4, 3]))
        np.testing.assert_array_equal(image.read_png(str(path)), img)


def test_unsupported_pngs_raise(tmp_path):
    rng = np.random.RandomState(6)
    cases = {}
    # depth / colour-type pairs the PNG specification forbids
    (tmp_path / "p16.png").write_bytes(_encode(
        rng.randint(0, 4, (9, 11)).astype(np.uint16), [0], depth=16, color=3,
        plte=bytes(range(12))))
    cases["p16.png"] = "bit depth 16 is not allowed for colour type 3"
    (tmp_path / "rgb1.png").write_bytes(_encode(
        rng.randint(0, 2, (9, 11)).astype(np.uint8), [0], depth=1, color=2))
    cases["rgb1.png"] = "bit depth 1 is not allowed for colour type 2"
    (tmp_path / "nopal.png").write_bytes(_encode(
        rng.randint(0, 4, (9, 11)).astype(np.uint8), [0], depth=2, color=3))
    cases["nopal.png"] = "without a PLTE chunk"
    (tmp_path / "i2.png").write_bytes(_encode(_pixels(rng, 8, 8, 3), [0], interlace=2))
    cases["i2.png"] = "interlace method 2"
    (tmp_path / "j.png").write_bytes(b"\xff\xd8\xff\xe0" + bytes(64))
    cases["j.png"] = "not a PNG"
    bad = bytearray(_encode(_pixels(rng, 8, 8, 3), [0]))
    bad[40] ^= 0xFF
    (tmp_path / "crc.png").write_bytes(bytes(bad))
    cases["crc.png"] = "corrupt"
    (tmp_path / "f5.png").write_bytes(_encode(_pixels(rng, 8, 8, 3), [0, 0, 5]))
    cases["f5.png"] = "scanline filter 5"
    for name, what in cases.items():
        with pytest.raises(ValueError, match=what):
            image.read_png(str(tmp_path / name))
        with pytest.raises(ValueError, match=what):
            image.read_png_luma(str(tmp_path / name))


# -- the PNG forms beyond 8-bit L / LA / RGB / RGBA ---------------------------

def assert_pil_png(path):
    """``read_png`` as ``np.array(Image.open)`` (dtype, shape, values) and
    ``read_png_luma`` as ``convert("L")``; returns Pillow's image."""
    im = Image.open(path)
    ref = np.array(im)
    got = image.read_png(path)
    assert got.dtype == ref.dtype and got.shape == ref.shape, (got.dtype, ref.dtype,
                                                                got.shape, ref.shape)
    np.testing.assert_array_equal(got, ref)
    luma = np.array(im.convert("L"))
    np.testing.assert_array_equal(image.read_png_luma(path), luma)
    if im.mode != "P":
        np.testing.assert_array_equal(image.to_luma(got), luma)
    return im


@pytest.mark.parametrize("form,depth,mode", [
    ("1", 1, "1"), ("P", 1, "P"), ("P", 2, "P"), ("P", 4, "P"), ("P", 8, "P"),
    ("I;16", 16, "I;16")])
def test_read_png_pillow_forms(tmp_path, form, depth, mode):
    rng = np.random.RandomState(depth)
    path = str(tmp_path / "f.png")
    if form == "1":
        Image.fromarray(rng.rand(37, 53) > 0.4).save(path)
    elif form == "P":
        im = Image.fromarray(rng.randint(0, 1 << depth, (37, 53)).astype(np.uint8), "P")
        im.putpalette(rng.randint(0, 256, 3 << depth).astype(np.uint8).tobytes())
        im.save(path, bits=depth)
    else:
        a = rng.randint(0, 65536, (37, 53)).astype(np.uint16)
        a[0, :6] = [0, 1, 254, 255, 256, 65535]
        Image.fromarray(a).save(path)
    data = open(path, "rb").read()
    assert data[24] == depth          # the file holds the depth this case is about
    assert assert_pil_png(path).mode == mode


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_read_png_cv2_16bit(tmp_path, channels):
    rng = np.random.RandomState(channels)
    path = str(tmp_path / "c.png")
    assert cv2.imwrite(path, rng.randint(0, 65536, (29, 43, channels)).astype(np.uint16))
    assert open(path, "rb").read()[24] == 16
    assert_pil_png(path)


# every (colour type, depth) pair the PNG specification allows
FORMS = [(0, 1), (0, 2), (0, 4), (0, 8), (0, 16), (2, 8), (2, 16), (3, 1), (3, 2), (3, 4),
         (3, 8), (4, 8), (4, 16), (6, 8), (6, 16)]


@pytest.mark.parametrize("interlace", [0, 1])
@pytest.mark.parametrize("color,depth", FORMS)
def test_read_png_every_form(tmp_path, color, depth, interlace):
    """Each form at sizes below 8x8 too (Adam7 passes left empty) and every
    filter, against Pillow."""
    rng = np.random.RandomState(color * 100 + depth)
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color]
    for h, w in [(1, 1), (3, 5), (9, 2), (23, 31)]:
        top = 1 << depth
        a = rng.randint(0, top, (h, w, channels)).astype(np.uint16 if depth == 16
                                                        else np.uint8)
        plte = rng.randint(0, 256, 3 * min(top, 256)).astype(np.uint8).tobytes() \
            if color == 3 else None
        path = tmp_path / f"{h}x{w}.png"
        path.write_bytes(_encode(a[..., 0] if channels == 1 else a, [0, 1, 2, 3, 4],
                                 depth=depth, color=color, interlace=interlace,
                                 plte=plte))
        im = assert_pil_png(str(path))
        assert im.info.get("interlace", 0) == interlace


@pytest.mark.parametrize("filters", [[0], [4, 3, 1], [0, 1, 2, 3, 4]])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_read_png_adam7_every_filter(tmp_path, mode, filters):
    img = _pixels(np.random.RandomState(12), 23, 31, MODES[mode])
    path = tmp_path / "a.png"
    path.write_bytes(_encode(img, filters, interlace=1))
    np.testing.assert_array_equal(np.array(Image.open(str(path))), img)
    np.testing.assert_array_equal(image.read_png(str(path)), img)


def test_palette_index_beyond_plte(tmp_path):
    """An index past the PLTE's entries: the indices are read as Pillow
    reads them, their luma refused (the specification calls it an error)."""
    a = np.array([[0, 1, 3], [2, 1, 0]], np.uint8)
    path = tmp_path / "p.png"
    path.write_bytes(_encode(a, [0], depth=2, color=3, plte=bytes(range(6))))
    np.testing.assert_array_equal(image.read_png(str(path)), np.array(Image.open(path)))
    with pytest.raises(ValueError, match="beyond the palette"):
        image.read_png_luma(str(path))


# -- PNG writing ------------------------------------------------------------

@pytest.mark.parametrize("channels", [1, 3, 4])
def test_write_png_decodes_under_pil(tmp_path, channels):
    img = _pixels(np.random.RandomState(7), 41, 29, channels)
    path = str(tmp_path / "w.png")
    image.write_png(path, img)
    np.testing.assert_array_equal(np.array(Image.open(path)), img)
    np.testing.assert_array_equal(image.read_png(path), img)
    with pytest.raises(ValueError):
        image.write_png(path, img.astype(np.float32))


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_write_png_picks_libpngs_filters(tmp_path, channels):
    """Each row is filtered as libpng's default heuristic filters it: of
    the five filters (``_encode``, written out here from the PNG
    specification), the first with the least sum of |signed byte|; so the
    files exercise the reader's filters as the encoders' files do."""
    img = _pixels(np.random.RandomState(11), 47, 31, channels)
    path = str(tmp_path / "w.png")
    image.write_png(path, img)
    got = _scanlines(open(path, "rb").read())
    each = np.stack([_scanlines(_encode(img, [t])) for t in range(5)])
    signed = np.minimum(each[..., 1:], 256 - each[..., 1:].astype(np.int64))
    want = signed.sum(-1).argmin(0)
    np.testing.assert_array_equal(got[:, 0], want)
    np.testing.assert_array_equal(got, each[want, np.arange(len(want))])
    assert len(set(want.tolist())) >= 2


@pytest.mark.parametrize("size", [(1, 1), (3, 5), (9, 2), (41, 29)])
@pytest.mark.parametrize("channels", [1, 3, 4])
def test_write_png_interlaced(tmp_path, channels, size):
    img = _pixels(np.random.RandomState(13), *size, channels)
    path = str(tmp_path / "i.png")
    image.write_png(path, img, interlace=True)
    assert open(path, "rb").read()[28] == 1
    im = Image.open(path)
    assert im.info.get("interlace") == 1
    np.testing.assert_array_equal(np.array(im), img)
    np.testing.assert_array_equal(image.read_png(path), img)


# -- nearest resize -----------------------------------------------------------

RESIZES = [((1200, 1600), (576, 800)), ((1200, 1600), (480, 640)),
           ((1200, 1600), (300, 400)), ((1200, 1600), (1200, 1600)),
           ((192, 256), (48, 64)), ((97, 131), (40, 57)), ((40, 57), (97, 131))]


@pytest.mark.parametrize("src,dst", RESIZES)
def test_resize_nearest_matches_cv2(src, dst):
    rng = np.random.RandomState(8)
    for a in (rng.rand(*src).astype(np.float32), rng.rand(*src, 3).astype(np.float32),
              (rng.rand(*src) * 255).astype(np.uint8),
              (rng.rand(*src, 3) * 255).astype(np.uint8)):
        ref = cv2.resize(a, dst[::-1], interpolation=cv2.INTER_NEAREST)
        got = image.resize_nearest(a, dst[::-1])
        assert got.dtype == ref.dtype and got.shape == ref.shape
        np.testing.assert_array_equal(got, ref)


# -- the magma depth PNG --------------------------------------------------------

def test_magma_table_and_indexing_match_matplotlib():
    ref_map = matplotlib.colormaps["magma"]
    assert ref_map.N == len(colormap.MAGMA) == 256
    np.testing.assert_array_equal(ref_map(np.arange(256))[:, :3], colormap.MAGMA)
    rng = np.random.RandomState(9)
    x = np.concatenate([rng.rand(5000), np.arange(257) / 256.0, [0.0, 1.0, np.nan,
                                                                 1 - 1e-12, 1e-12]])
    np.testing.assert_array_equal(colormap.colormap(x), ref_map(x))


def test_save_depth_png_matches_the_runners(tmp_path):
    rng = np.random.RandomState(10)
    depth = (rng.rand(37, 50) * 3.6 - 0.3).astype(np.float32)
    depth[0, :4] = [0.0, 3.0, np.nan, 1.5]
    j_save_depth_png(depth, str(tmp_path / "j.png"))
    colormap.save_depth_png(depth, str(tmp_path / "t.png"))
    ref = np.array(Image.open(str(tmp_path / "j.png")))
    np.testing.assert_array_equal(image.read_png(str(tmp_path / "t.png")), ref)
    np.testing.assert_array_equal(np.array(Image.open(str(tmp_path / "t.png"))), ref)

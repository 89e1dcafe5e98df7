"""The port's JPEG decoder (``surf_tpu_torch.io.jpeg.read_jpeg``,
csrc/jpeg_decode.cpp) against Pillow's, bit for bit: ``read_jpeg(p)`` must
equal ``np.array(PIL.Image.open(p))`` (uint8, every pixel, the same shape)
on baseline and progressive files written by Pillow (qualities 50, 75 and
95 at 4:4:4, 4:2:2 and 4:2:0, greyscale, optimized Huffman tables, restart
intervals, 16-bit quantization tables, Adobe RGB) and by cv2 (its 4:1:1
and 4:4:0 sampling too), at sizes that are no multiple of the MCU (1x1,
1xN, Nx1, a chroma plane 1 or 2 samples wide, 37x53).  The features it
does not support, and bad, bogus or incomplete progressions, raise
``ValueError`` naming them, never a wrong image.  ``write_jpeg``'s
baseline and progressive files decode under Pillow to what ``read_jpeg``
gives, to the same pixels as each other, and stay near their input.
No tolerance: the decoder repeats libjpeg-turbo's integer arithmetic."""

import cv2
import numpy as np
import pytest
from PIL import Image

from surf_tpu_torch.io.jpeg import read_jpeg, write_jpeg

SIZES = [(37, 53), (1, 1), (1, 29), (29, 1), (9, 2), (6, 3), (48, 64)]


def picture(h, w, c=3, seed=0, noise=24.0):
    """A smooth pattern plus noise: large and small coefficients alike."""
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.stack([128 + 100 * np.sin(x / 6.0 + k) * np.cos(y / 4.0 - k)
                    for k in range(c)], -1) + rng.randn(h, w, c) * noise
    img = np.clip(img, 0, 255).astype(np.uint8)
    return img[..., 0] if c == 1 else img


def assert_pil_equal(path):
    ref = np.array(Image.open(path))
    got = read_jpeg(path)
    assert got.dtype == np.uint8 and got.shape == ref.shape, (got.shape, ref.shape)
    np.testing.assert_array_equal(got, ref)
    return got


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("subsampling", [0, 1, 2])
@pytest.mark.parametrize("quality", [50, 75, 95])
def test_pil_colour_files(tmp_path, quality, subsampling, size):
    p = tmp_path / "a.jpg"
    Image.fromarray(picture(*size)).save(p, quality=quality, subsampling=subsampling)
    assert_pil_equal(p)


@pytest.mark.parametrize("size", [(37, 53), (1, 1), (19, 2), (64, 80)])
def test_pil_greyscale(tmp_path, size):
    p = tmp_path / "g.jpg"
    Image.fromarray(picture(*size, c=1)).save(p, quality=85)
    assert assert_pil_equal(p).ndim == 2


@pytest.mark.parametrize("kw", [
    {"optimize": True, "subsampling": 0}, {"optimize": True, "subsampling": 1},
    {"optimize": True, "subsampling": 2}, {"restart_marker_blocks": 1},
    {"restart_marker_blocks": 3, "subsampling": 0}, {"restart_marker_blocks": 7},
    {"restart_marker_rows": 1}, {"restart_marker_rows": 2, "subsampling": 1},
    {"restart_marker_rows": 1, "optimize": True},
    {"qtables": [list(range(300, 364)), list(range(400, 464))]},   # 16-bit DQT
    {"keep_rgb": True, "quality": 90},                              # Adobe, no YCbCr
    {"quality": 1}, {"quality": 100, "subsampling": 0}])
def test_pil_options(tmp_path, kw):
    p = tmp_path / "o.jpg"
    Image.fromarray(picture(45, 67, seed=3)).save(p, **kw)
    assert_pil_equal(p)


@pytest.mark.parametrize("factor", ["411", "420", "422", "440", "444"])
@pytest.mark.parametrize("extra", [(), (cv2.IMWRITE_JPEG_RST_INTERVAL, 2),
                                   (cv2.IMWRITE_JPEG_OPTIMIZE, 1)])
def test_cv2_files(tmp_path, factor, extra):
    p = str(tmp_path / "c.jpg")
    assert cv2.imwrite(p, picture(41, 59, seed=5), [
        cv2.IMWRITE_JPEG_QUALITY, 80, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
        getattr(cv2, f"IMWRITE_JPEG_SAMPLING_FACTOR_{factor}"), *extra])
    assert_pil_equal(p)


def test_cv2_greyscale(tmp_path):
    p = str(tmp_path / "c.jpg")
    assert cv2.imwrite(p, picture(33, 50, c=1), [cv2.IMWRITE_JPEG_QUALITY, 60])
    assert_pil_equal(p)


def scans(data):
    """(start, end) of each scan of a JPEG: its SOS marker to the marker
    that follows its entropy-coded data (RSTn inside it skipped)."""
    out, i = [], data.index(b"\xff\xda")
    while True:
        j = i + 2 + int.from_bytes(data[i + 2:i + 4], "big")
        while not (data[j] == 0xFF and data[j + 1] not in (0, *range(0xD0, 0xD8))):
            j += 1
        out.append((i, j))
        if data[j + 1] == 0xD9:
            return out
        i = data.index(b"\xff\xda", j)


def _patched(data, old, new):
    i = data.index(old)
    return data[:i] + new + data[i + len(new):]


@pytest.mark.parametrize("case,match", [
    # a progressive file that ends (EOI) after its first 4 scans: the rest
    # of its coefficients never reach their last bit
    ("progressive", "incomplete progression"), ("cmyk", "CMYK"), ("truncated_scan", "truncated"),
    ("truncated_header", "truncated"), ("no_scan", "truncated"), ("arithmetic", "arithmetic"),
    ("lossless", "lossless"), ("twelve_bit", "12-bit"), ("dnl", "DNL"),
    ("not_jpeg", "not a JPEG")])
def test_unsupported_raise(tmp_path, case, match):
    base = tmp_path / "base.jpg"
    img = picture(40, 56, seed=7)
    Image.fromarray(img).save(base, quality=90)
    data = base.read_bytes()
    p = tmp_path / f"{case}.jpg"
    if case == "progressive":
        Image.fromarray(img).save(tmp_path / "prog.jpg", progressive=True)
        prog = (tmp_path / "prog.jpg").read_bytes()
        p = tmp_path / "x.jpg"
        p.write_bytes(prog[:scans(prog)[4][0]] + b"\xff\xd9")
    elif case == "cmyk":
        Image.fromarray(img).convert("CMYK").save(p)
    else:
        sof = data.index(b"\xff\xc0")
        sos = data.index(b"\xff\xda")
        p.write_bytes({
            "truncated_scan": data[:(sos + len(data)) // 2],
            "truncated_header": data[:sof + 6],
            "no_scan": data[:sos] + b"\xff\xd9",
            "arithmetic": _patched(data, b"\xff\xc0", b"\xff\xc9"),
            "lossless": _patched(data, b"\xff\xc0", b"\xff\xc3"),
            "twelve_bit": data[:sof + 4] + b"\x0c" + data[sof + 5:],
            "dnl": data[:sos] + b"\xff\xdc\x00\x04\x00\x28" + data[sos:],
            "not_jpeg": b"\x89PNG" + data[4:],
        }[case])
    with pytest.raises(ValueError, match=match):
        read_jpeg(p)


@pytest.mark.parametrize("size", [(37, 53), (1, 1), (64, 80)])
@pytest.mark.parametrize("subsampling", ["4:4:4", "4:2:2", "4:2:0"])
def test_write_jpeg_decodes_as_pil_decodes(tmp_path, subsampling, size):
    p = tmp_path / "w.jpg"
    img = picture(*size, noise=2.0)
    write_jpeg(p, img, quality=95, subsampling=subsampling)
    got = assert_pil_equal(p)
    # the encoder is lossy, not wrong: near its input on a smooth picture
    assert np.abs(got.astype(np.int64) - img).mean() < 8.0


def test_write_jpeg_greyscale(tmp_path):
    p = tmp_path / "w.jpg"
    img = picture(30, 41, c=1, noise=2.0)
    write_jpeg(p, img, quality=90)
    got = assert_pil_equal(p)
    assert got.ndim == 2 and np.abs(got.astype(np.int64) - img).mean() < 6.0


# -- progressive (SOF2) ---------------------------------------------------------

@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("subsampling", [0, 1, 2])
@pytest.mark.parametrize("quality", [50, 75, 95])
def test_pil_progressive_colour_files(tmp_path, quality, subsampling, size):
    p = tmp_path / "p.jpg"
    Image.fromarray(picture(*size)).save(p, quality=quality, subsampling=subsampling,
                                         progressive=True)
    assert p.read_bytes()[2:].find(b"\xff\xc2") > 0
    assert_pil_equal(p)


@pytest.mark.parametrize("c,kw", [
    (3, {"quality": 85}), (3, {"restart_marker_blocks": 1}),
    (3, {"restart_marker_blocks": 3, "subsampling": 0}), (3, {"restart_marker_blocks": 7}),
    (3, {"restart_marker_rows": 1}), (3, {"restart_marker_rows": 2, "subsampling": 1}),
    (3, {"keep_rgb": True, "quality": 90}),                     # Adobe, no YCbCr
    (3, {"qtables": [list(range(300, 364)), list(range(400, 464))]}),   # 16-bit DQT
    (1, {"quality": 85}), (1, {"restart_marker_blocks": 1}), (1, {"restart_marker_blocks": 3}),
    (1, {"restart_marker_blocks": 7}), (1, {"restart_marker_rows": 1}),
    (1, {"restart_marker_rows": 2}), (1, {"quality": 90}), (1, {"quality": 70})])
def test_pil_progressive_options(tmp_path, c, kw):
    p = tmp_path / "o.jpg"
    Image.fromarray(picture(45, 67, c=c, seed=3)).save(p, progressive=True, **kw)
    assert assert_pil_equal(p).ndim == (2 if c == 1 else 3)


@pytest.mark.parametrize("factor", ["411", "420", "422", "440", "444"])
@pytest.mark.parametrize("rst", [0, 2])
def test_cv2_progressive_files(tmp_path, factor, rst):
    p = str(tmp_path / "c.jpg")
    extra = (cv2.IMWRITE_JPEG_RST_INTERVAL, rst) if rst else ()
    assert cv2.imwrite(p, picture(41, 59, seed=5), [
        cv2.IMWRITE_JPEG_QUALITY, 80, cv2.IMWRITE_JPEG_PROGRESSIVE, 1,
        cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
        getattr(cv2, f"IMWRITE_JPEG_SAMPLING_FACTOR_{factor}"), *extra])
    assert_pil_equal(p)


@pytest.mark.parametrize("size", [(37, 53), (1, 1), (9, 2), (64, 80), (121, 333)])
@pytest.mark.parametrize("subsampling", ["4:4:4", "4:2:2", "4:2:0"])
def test_write_jpeg_progressive(tmp_path, subsampling, size):
    """The port's progressive file: 10 scans (jpeg_simple_progression),
    decoded as Pillow decodes it, to the pixels of the baseline file of the
    same array (the same coefficients)."""
    img = picture(*size)
    write_jpeg(tmp_path / "b.jpg", img, quality=75, subsampling=subsampling)
    write_jpeg(tmp_path / "p.jpg", img, quality=75, subsampling=subsampling,
               progressive=True)
    data = (tmp_path / "p.jpg").read_bytes()
    assert b"\xff\xc2" in data and b"\xff\xc0" not in data and len(scans(data)) == 10
    got = assert_pil_equal(tmp_path / "p.jpg")
    np.testing.assert_array_equal(got, read_jpeg(tmp_path / "b.jpg"))


def test_write_jpeg_progressive_greyscale(tmp_path):
    img = picture(30, 41, c=1)
    write_jpeg(tmp_path / "b.jpg", img, quality=90)
    write_jpeg(tmp_path / "p.jpg", img, quality=90, progressive=True)
    assert len(scans((tmp_path / "p.jpg").read_bytes())) == 6
    got = assert_pil_equal(tmp_path / "p.jpg")
    assert got.ndim == 2
    np.testing.assert_array_equal(got, read_jpeg(tmp_path / "b.jpg"))


@pytest.mark.parametrize("before_scan", [1, 6, 9])
def test_progressive_quant_tables_latched_at_first_scan(tmp_path, before_scan):
    """A DQT that redefines both tables after every component's first scan
    changes nothing: each component keeps the table in force at its first
    scan, as libjpeg latches it."""
    write_jpeg(tmp_path / "p.jpg", picture(40, 56, seed=9), quality=80, progressive=True)
    data = (tmp_path / "p.jpg").read_bytes()
    at = scans(data)[before_scan][0]
    dqt = b"\xff\xdb\x00\x84" + b"\x00" + bytes(range(1, 65)) + b"\x01" + bytes(range(2, 66))
    (tmp_path / "q.jpg").write_bytes(data[:at] + dqt + data[at:])
    got = assert_pil_equal(tmp_path / "q.jpg")
    np.testing.assert_array_equal(got, read_jpeg(tmp_path / "p.jpg"))


def _sos_params(data, scan):
    """Offset of scan ``scan``'s Ss byte (then Se, then Ah << 4 | Al)."""
    i = scans(data)[scan][0]
    return i + 2 + int.from_bytes(data[i + 2:i + 4], "big") - 3


def _set(data, at, *values):
    return data[:at] + bytes(values) + data[at + len(values):]


# the port's colour script: 0 DC (Ah 0, Al 1, all components), 1 luma AC
# 1-5 (Al 2), 2 and 3 chroma AC 1-63 (Al 1), 4 luma 6-63 (Al 2), 5 luma
# 1-63 (Ah 2, Al 1), 6 DC refinement, 7-9 AC refinements to Al 0
@pytest.mark.parametrize("case,match", [
    ("dc_se", "bad progression"),            # a DC scan with Se 1
    ("ac_ss_above_se", "bad progression"),   # Ss 6 > Se 5
    ("ac_se_64", "bad progression"),         # Se past 63
    ("al_not_ah_minus_1", "bad progression"),  # Ah 2, Al 0
    ("al_14", "bad progression"),            # Al above 13
    ("ac_three_components", "bad progression"),  # an AC band on the DC scan's 3
    ("ac_before_dc", "bogus progression"),   # the DC scan dropped
    ("wrong_ah", "bogus progression"),       # luma AC refined from bit 3, not 2
    ("repeated_first", "bogus progression"),  # luma 1-5's first scan twice
    ("incomplete", "incomplete progression"),  # EOI after 6 of 10 scans
    ("truncated", "truncated")])              # the file cut inside a scan
def test_refused_progressions_raise(tmp_path, case, match):
    write_jpeg(tmp_path / "p.jpg", picture(40, 56, seed=7), quality=90, progressive=True)
    data = (tmp_path / "p.jpg").read_bytes()
    sc = scans(data)
    if case == "dc_se":
        data = _set(data, _sos_params(data, 0) + 1, 1)
    elif case == "ac_ss_above_se":
        data = _set(data, _sos_params(data, 1), 6)
    elif case == "ac_se_64":
        data = _set(data, _sos_params(data, 4) + 1, 64)
    elif case == "al_not_ah_minus_1":
        data = _set(data, _sos_params(data, 5) + 2, 0x20)
    elif case == "al_14":
        data = _set(data, _sos_params(data, 0) + 2, 14)
    elif case == "ac_three_components":
        data = _set(data, _sos_params(data, 0), 1, 5)
    elif case == "ac_before_dc":
        data = data[:sc[0][0]] + data[sc[0][1]:]
    elif case == "wrong_ah":
        data = _set(data, _sos_params(data, 5) + 2, 0x32)
    elif case == "repeated_first":
        data = data[:sc[1][1]] + data[sc[1][0]:]
    elif case == "incomplete":
        data = data[:sc[6][0]] + b"\xff\xd9"
    else:
        data = data[:(sc[5][0] + sc[5][1]) // 2]
    p = tmp_path / "x.jpg"          # a name the messages cannot match
    p.write_bytes(data)
    with pytest.raises(ValueError, match=match):
        read_jpeg(p)

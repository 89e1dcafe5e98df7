"""The port's baseline JPEG decoder (``surf_tpu_torch.io.jpeg.read_jpeg``,
csrc/jpeg_decode.cpp) against Pillow's, bit for bit: ``read_jpeg(p)`` must
equal ``np.array(PIL.Image.open(p))`` (uint8, every pixel, the same shape)
on files written by Pillow (qualities 50, 75 and 95 at 4:4:4, 4:2:2 and
4:2:0, greyscale, optimized Huffman tables, restart intervals, 16-bit
quantization tables, Adobe RGB) and by cv2 (its 4:1:1 and 4:4:0 sampling
too), at sizes that are no multiple of the MCU (1x1, 1xN, Nx1, a chroma
plane 1 or 2 samples wide, 37x53).  The features it does not support raise
``ValueError`` naming them, never a wrong image.  ``write_jpeg``'s files
decode under Pillow to what ``read_jpeg`` gives and stay near their input.
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


def _patched(data, old, new):
    i = data.index(old)
    return data[:i] + new + data[i + len(new):]


@pytest.mark.parametrize("case,match", [
    ("progressive", "progressive"), ("cmyk", "CMYK"), ("truncated_scan", "truncated"),
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
        Image.fromarray(img).save(p, progressive=True)
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

"""The port's PNG codec (gbnerf_tpu_torch/utils/png.py) and its numpy
resizes (data/llff.py) against imageio and cv2, which the JAX package
calls and the machine with the card lacks.

Tolerances: decoding is exact (the same bytes); nearest resize is exact
(the same index rule); area resize within one level of cv2.INTER_AREA
(both average the same pixels with the same weights, but cv2 sums in
single precision and rounds factor-2 means half up).
"""
import struct
import zlib

import cv2
import imageio.v2 as imageio
import numpy as np
import pytest
from PIL import Image

from gbnerf_tpu_torch.data.llff import resize_area, resize_nearest
from gbnerf_tpu_torch.utils.png import read_png, write_png


def _img(rng, shape, dtype=np.uint8):
    hi = 256 if dtype == np.uint8 else 65536
    # smooth ramps plus noise: every filter predicts something nonzero
    y, x = np.mgrid[0:shape[0], 0:shape[1]]
    base = (x * 7 + y * 3)
    if len(shape) == 3:
        base = base[..., None] + np.arange(shape[2]) * 40
    return ((base + rng.integers(0, 30, shape)) % hi).astype(dtype)


@pytest.mark.parametrize("kind", ["g8", "ga8", "rgb8", "rgba8", "g16"])
def test_read_png_equals_imageio_on_files_imageio_writes(tmp_path, kind):
    rng = np.random.default_rng(1)
    C = {"g": None, "ga": 2, "rgb": 3, "rgba": 4}[kind.rstrip("0123456789")]
    dtype = np.uint16 if kind.endswith("16") else np.uint8
    arr = _img(rng, (23, 37) if C is None else (23, 37, C), dtype)
    path = str(tmp_path / f"{kind}.png")
    imageio.imwrite(path, arr)
    got, ref = read_png(path), imageio.imread(path)
    assert got.dtype == ref.dtype == dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, arr)


@pytest.mark.parametrize("trns", [False, True])
def test_read_png_palette_equals_imageio(tmp_path, trns):
    """Palette files (Pillow's quantizer, as imageio writes them), with and
    without a tRNS chunk: RGB through the palette, the tRNS dropped, as
    imageio returns them; and 1/2/4-bit palettes."""
    rng = np.random.default_rng(2)
    im = Image.fromarray(_img(rng, (19, 29, 3)))
    for bits in (8, 4, 2, 1):
        q = im.quantize(2 ** bits)
        path = str(tmp_path / f"p{bits}.png")
        kw = {"transparency": 1} if trns else {}
        q.save(path, bits=bits, **kw)
        got, ref = read_png(path), imageio.imread(path)
        assert got.shape == ref.shape == (19, 29, 3) and got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref, err_msg=f"{bits} bits")


def _png_bytes(raw_rows, W, H, depth, ctype, filters, bpp, *, extra=(),
               interlace=0):
    """A PNG built by hand: each row of raw_rows [H, rowbytes] encoded with
    its filter from ``filters`` (the PNG spec's formulas, byte by byte)."""
    out = []
    prev = np.zeros(raw_rows.shape[1], np.int64)
    for y in range(H):
        cur = raw_rows[y].astype(np.int64)
        f = filters[y]
        enc = np.empty_like(cur)
        for i in range(len(cur)):
            a = cur[i - bpp] if i >= bpp else 0
            b = prev[i]
            c = prev[i - bpp] if i >= bpp else 0
            if f == 0:
                pred = 0
            elif f == 1:
                pred = a
            elif f == 2:
                pred = b
            elif f == 3:
                pred = (a + b) // 2
            else:
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if pa <= pb and pa <= pc else b if pb <= pc else c
            enc[i] = (cur[i] - pred) % 256
        out.append(bytes([f]) + enc.astype(np.uint8).tobytes())
        prev = cur

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data)))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, depth, ctype, 0,
                                         0, interlace))
            + b"".join(chunk(k, d) for k, d in extra)
            + chunk(b"IDAT", zlib.compress(b"".join(out)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("filt", [0, 1, 2, 3, 4, "mixed"])
@pytest.mark.parametrize("fmt", ["rgb8", "rgba16", "g8"])
def test_read_png_each_filter_on_hand_built_files(tmp_path, filt, fmt):
    rng = np.random.default_rng(3)
    H, W = 9, 13
    C = {"rgb8": 3, "rgba16": 4, "g8": 1}[fmt]
    dtype = np.uint16 if fmt.endswith("16") else np.uint8
    arr = _img(rng, (H, W, C), dtype)
    raw = (arr.astype(">u2") if dtype == np.uint16 else arr).view(
        np.uint8).reshape(H, -1)
    filters = (rng.integers(0, 5, H) if filt == "mixed" else [filt] * H)
    ctype = {1: 0, 3: 2, 4: 6}[C]
    path = tmp_path / "f.png"
    path.write_bytes(_png_bytes(raw, W, H, 8 * arr.itemsize, ctype,
                                list(filters), C * arr.itemsize))
    got = read_png(str(path))
    want = arr[..., 0] if C == 1 else arr
    assert got.dtype == dtype
    np.testing.assert_array_equal(got, want)
    if dtype == np.uint8:            # imageio's Pillow reads 16-bit RGBA as 8
        np.testing.assert_array_equal(got, imageio.imread(str(path)))


@pytest.mark.parametrize("depth", [2, 4])
def test_read_png_low_bit_grey_scaled_as_imageio(tmp_path, depth):
    rng = np.random.default_rng(4)
    H, W = 7, 11
    vals = rng.integers(0, 2 ** depth, (H, W)).astype(np.uint8)
    bits = ((vals[..., None] >> np.arange(depth - 1, -1, -1)) & 1).astype(
        np.uint8).reshape(H, -1)
    raw = np.packbits(bits, axis=1)
    path = tmp_path / "g.png"
    path.write_bytes(_png_bytes(raw, W, H, depth, 0, [4, 3] * 3 + [1], 1))
    got = read_png(str(path))
    np.testing.assert_array_equal(got, vals * (255 // (2 ** depth - 1)))
    np.testing.assert_array_equal(got, imageio.imread(str(path)))


def test_read_png_decodes_a_large_adaptive_file(tmp_path):
    """Pillow's adaptive per-row filters at 1008 × 756 RGB."""
    rng = np.random.default_rng(5)
    arr = _img(rng, (756, 1008, 3))
    path = str(tmp_path / "big.png")
    imageio.imwrite(path, arr)
    np.testing.assert_array_equal(read_png(path), arr)


@pytest.mark.parametrize("shape,dtype", [
    ((15, 21), np.uint8), ((15, 21, 2), np.uint8), ((15, 21, 3), np.uint8),
    ((15, 21, 4), np.uint8), ((15, 21), np.uint16),
    ((15, 21, 3), np.uint16)])
def test_write_png_round_trip_through_imageio(tmp_path, shape, dtype):
    rng = np.random.default_rng(6)
    arr = _img(rng, shape, dtype)
    path = str(tmp_path / "w.png")
    write_png(path, arr)
    np.testing.assert_array_equal(read_png(path), arr)
    if arr.ndim == 2 or dtype == np.uint8:
        np.testing.assert_array_equal(imageio.imread(path), arr)
    else:          # imageio's Pillow reads 16-bit colour as 8-bit: use cv2
        ref = cv2.imread(path, cv2.IMREAD_UNCHANGED)[..., ::-1]
        np.testing.assert_array_equal(ref, arr)


def test_png_refusals(tmp_path):
    rng = np.random.default_rng(7)
    arr = _img(rng, (8, 8, 3))
    jpg = str(tmp_path / "a.jpg")
    imageio.imwrite(jpg, arr)
    with pytest.raises(ValueError, match="a.jpg: not a PNG"):
        read_png(jpg)
    raw = arr.reshape(8, -1)
    inter = tmp_path / "i.png"
    inter.write_bytes(_png_bytes(raw, 8, 8, 8, 2, [0] * 8, 3, interlace=1))
    with pytest.raises(ValueError, match="i.png: Adam7"):
        read_png(str(inter))
    low = tmp_path / "low.png"
    low.write_bytes(_png_bytes(raw[:, :3], 8, 8, 4, 2, [0] * 8, 1))
    with pytest.raises(ValueError, match="low.png: PNG bit depth 4"):
        read_png(str(low))
    for bad in (arr.astype(np.float32), arr.astype(np.int32)):
        with pytest.raises(TypeError, match="w.png"):
            write_png(str(tmp_path / "w.png"), bad)


@pytest.mark.parametrize("src,dst", [((24, 32), (48, 64)),
                                     ((48, 64), (24, 32)),
                                     ((37, 53), (12, 17)),
                                     ((30, 31), (29, 62))])
def test_resize_nearest_equals_cv2(src, dst):
    rng = np.random.default_rng(8)
    for a in (rng.random(src, dtype=np.float32),
              rng.integers(0, 256, src + (3,)).astype(np.uint8)):
        ref = cv2.resize(a, dst[::-1], interpolation=cv2.INTER_NEAREST)
        np.testing.assert_array_equal(resize_nearest(a, *dst), ref)


@pytest.mark.parametrize("src,dst", [((48, 64), (12, 16)),
                                     ((48, 64), (24, 32)),
                                     ((37, 53), (12, 17)),
                                     ((189, 252), (47, 63))])
def test_resize_area_within_one_level_of_cv2(src, dst):
    rng = np.random.default_rng(9)
    for a in (rng.integers(0, 256, src).astype(np.uint8),
              _img(rng, src + (3,)),
              rng.integers(0, 65536, src + (4,)).astype(np.uint16)):
        ref = cv2.resize(a, dst[::-1], interpolation=cv2.INTER_AREA)
        got = resize_area(a, *dst)
        assert got.dtype == a.dtype and got.shape == ref.shape
        assert np.abs(got.astype(np.int64) - ref).max() <= 1

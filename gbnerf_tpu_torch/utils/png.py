"""A PNG codec of the port's own, on zlib, struct and numpy.

The JAX package reads and writes a scene's images through imageio; the
machine with the card has neither imageio nor cv2, so the port reads PNG
itself (as it reads .safetensors itself in guidance/weights.py).

``read_png`` returns what ``imageio.v2.imread`` returns for the same file:
``uint8`` for bit depths 1 to 8 and ``uint16`` for 16 (big-endian on
disk), ``[H, W]`` for grey and ``[H, W, C]`` otherwise (grey + alpha 2,
RGB 3, RGBA 4). A palette image becomes RGB through its palette; a tRNS
chunk is read past and dropped, as imageio's Pillow reader drops it.
Grey at 1, 2 or 4 bits is scaled to 0…255, as Pillow scales 2 and 4
bits (imageio returns a 1-bit grey file as bool; here it is 0 / 255).
Refused, with a message that names the file: anything that is not a PNG
(JPEG included), Adam7 interlacing, and bit depths below 8 for colour
types other than grey and palette.

``write_png`` writes uint8 / uint16 grey, grey + alpha, RGB and RGBA,
every row with the Up filter.
"""
from __future__ import annotations

import struct
import zlib
from typing import Dict, List

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type → channels of a pixel as stored (the palette's is an index)
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_BIT_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8),
               4: (8, 16), 6: (8, 16)}


def _chunks(path: str, raw: bytes) -> List[tuple]:
    """The (type, data) chunks of a PNG file's bytes, CRCs checked."""
    if raw[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file (no PNG signature)")
    out, pos = [], 8
    while pos + 12 <= len(raw):
        (n,) = struct.unpack(">I", raw[pos:pos + 4])
        kind = raw[pos + 4:pos + 8]
        data = raw[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", raw[pos + 8 + n:pos + 12 + n])
        if len(data) != n or zlib.crc32(kind + data) != crc:
            raise ValueError(f"{path}: corrupt PNG chunk {kind!r}")
        out.append((kind, data))
        pos += 12 + n
        if kind == b"IEND":
            break
    return out


def _unfilter(path: str, data: bytes, H: int, rowbytes: int,
              bpp: int) -> np.ndarray:
    """Undo the per-row filters → the raw scanline bytes [H, rowbytes].

    None, Sub (a cumulative sum mod 256 of each byte lane along the row)
    and Up (one add of the row above) are row operations. Average and
    Paeth predict each byte from its decoded left neighbour, so they are
    sequential along x as well as down the rows. Then the image is decoded
    by anti-diagonals: step d decodes pixel d − y of every row y at once,
    whose left, upper and upper-left neighbours lie on earlier diagonals;
    each step is vectorised over its rows and a pixel's bytes.
    """
    if len(data) != H * (rowbytes + 1):
        raise ValueError(f"{path}: PNG image data has {len(data)} bytes, "
                         f"expected {H * (rowbytes + 1)}")
    rows = np.frombuffer(data, np.uint8).reshape(H, rowbytes + 1)
    ftype, line = rows[:, 0], rows[:, 1:]
    if ftype.max(initial=0) > 4:
        raise ValueError(f"{path}: unknown PNG row filter {ftype.max()}")
    n = rowbytes // bpp
    if ftype.max(initial=0) <= 2:
        out = np.empty((H, rowbytes), np.uint8)
        prev = np.zeros(rowbytes, np.uint8)
        for y in range(H):
            f, x = ftype[y], line[y]
            if f == 0:
                cur = x
            elif f == 1:
                cur = np.cumsum(x.reshape(n, bpp), axis=0,
                                dtype=np.uint8).reshape(-1)
            else:
                cur = x + prev
            out[y] = cur
            prev = out[y]
        return out

    src = line.reshape(H, n, bpp).astype(np.int16)
    # decoded bytes, padded with a zero row above and a zero pixel on the
    # left: the neighbours the filters read outside the image
    dec = np.zeros((H + 1, n + 1, bpp), np.int16)
    f_all = ftype.astype(np.int16)[:, None]
    for d in range(H + n - 1):
        ys = np.arange(max(0, d - n + 1), min(H - 1, d) + 1)
        xs = d - ys
        a = dec[ys + 1, xs]              # left
        b = dec[ys, xs + 1]              # up
        c = dec[ys, xs]                  # upper left
        f = f_all[ys]
        pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = np.select([f == 0, f == 1, f == 2, f == 3],
                         [0, a, b, (a + b) >> 1], paeth)
        dec[ys + 1, xs + 1] = (src[ys, xs] + pred) & 255
    return dec[1:, 1:].reshape(H, rowbytes).astype(np.uint8)


def read_png(path: str) -> np.ndarray:
    """Decode the PNG file at ``path`` → uint8 / uint16 [H, W] or [H, W, C]
    (see the module note)."""
    with open(path, "rb") as fh:
        raw = fh.read()
    chunks = _chunks(path, raw)
    if not chunks or chunks[0][0] != b"IHDR":
        raise ValueError(f"{path}: PNG file without an IHDR chunk")
    W, H, depth, ctype, comp, filt, interlace = struct.unpack(
        ">IIBBBBB", chunks[0][1])
    if ctype not in _CHANNELS or comp != 0 or filt != 0:
        raise ValueError(f"{path}: unsupported PNG header (colour type "
                         f"{ctype}, compression {comp}, filter {filt})")
    if depth not in _BIT_DEPTHS[ctype]:
        raise ValueError(f"{path}: PNG bit depth {depth} is not read for "
                         f"colour type {ctype}")
    if interlace:
        raise ValueError(f"{path}: Adam7-interlaced PNG is not read")
    extra: Dict[bytes, bytes] = {}
    idat = []
    for kind, data in chunks[1:]:
        if kind == b"IDAT":
            idat.append(data)
        elif kind in (b"PLTE", b"tRNS"):
            extra[kind] = data
    C = _CHANNELS[ctype]
    bpp = max(1, C * depth // 8)
    rowbytes = (W * C * depth + 7) // 8
    try:
        data = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"{path}: corrupt PNG image data ({e})") from None
    rows = _unfilter(path, data, H, rowbytes, bpp)

    if depth == 16:
        img = rows.view(">u2").astype(np.uint16).reshape(H, W, C)
    elif depth == 8:
        img = rows.reshape(H, W, C)
    else:
        bits = np.unpackbits(rows, axis=1)[:, :W * depth].reshape(H, W, depth)
        weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
        img = (bits * weights).sum(-1, dtype=np.uint8)[..., None]
        if ctype == 0:
            img = img * np.uint8(255 // ((1 << depth) - 1))
    if ctype == 3:
        if b"PLTE" not in extra:
            raise ValueError(f"{path}: palette PNG without a PLTE chunk")
        pal = np.frombuffer(extra[b"PLTE"], np.uint8).reshape(-1, 3)
        if int(img.max(initial=0)) >= len(pal):
            raise ValueError(f"{path}: PNG palette index out of range")
        return pal[img[..., 0]]
    return img[..., 0] if C == 1 else img


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data)))


def write_png(path: str, arr: np.ndarray) -> None:
    """Write a uint8 or uint16 array — [H, W] grey, or [H, W, C] with C 1
    (grey), 2 (grey + alpha), 3 (RGB) or 4 (RGBA) — as a PNG file."""
    arr = np.asarray(arr)
    if arr.dtype not in (np.uint8, np.uint16):
        raise TypeError(f"{path}: write_png takes uint8 or uint16, not "
                        f"{arr.dtype}")
    if arr.ndim == 2:
        arr = arr[..., None]
    if arr.ndim != 3 or arr.shape[2] not in (1, 2, 3, 4):
        raise ValueError(f"{path}: write_png takes [H, W] or [H, W, 1-4], "
                         f"not {arr.shape}")
    H, W, C = arr.shape
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[C]
    depth = 8 * arr.dtype.itemsize
    rows = np.ascontiguousarray(arr.astype(">u2") if depth == 16 else arr)
    rows = rows.view(np.uint8).reshape(H, W * C * arr.dtype.itemsize)
    up = rows.copy()
    up[1:] -= rows[:-1]                  # the Up filter, mod 256
    filtered = np.concatenate([np.full((H, 1), 2, np.uint8), up], axis=1)
    with open(path, "wb") as fh:
        fh.write(_SIGNATURE)
        fh.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, depth, ctype,
                                             0, 0, 0)))
        fh.write(_chunk(b"IDAT", zlib.compress(filtered.tobytes(), 6)))
        fh.write(_chunk(b"IEND", b""))

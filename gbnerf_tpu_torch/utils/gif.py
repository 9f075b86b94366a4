"""An animated-GIF writer and reader of the port's own, on numpy.

The JAX package writes its videos through imageio (mp4 where an ffmpeg
backend exists, else GIF); the machine with the card has no imageio, so
the port writes GIF itself, as it writes PNG (utils/png.py).

``write_gif`` writes GIF89a with one global palette, a NETSCAPE2.0 block
that loops forever and each frame's delay in hundredths of a second. Grey frames ([N, H, W] or [N, H, W, 1]) use the grey ramp, so
they come back exactly; RGB frames map to a uniform palette of 6 × 7 × 6
levels, each channel rounded to its nearest level (at most half a step
off: 25.5 of 255 for R and B, 21.25 for G). The LZW stream is written
without compression: 9-bit literal codes, with a clear code before every
253 literals so that the code table never needs a tenth bit. Every
decoder reads that; it is about 1.1 bytes a pixel, and is written with a
few numpy operations a frame.

``read_gif`` decodes GIF87a/89a of 1 to 8 bits a pixel (global or local
palettes, frames at an offset drawn over the canvas with their
transparent index, no interlacing) → (frames [N, H, W, 3] uint8, delays
in ms). Segments of literal codes, as ``write_gif`` writes, decode with
numpy; others code by code.
"""
from __future__ import annotations

import struct
from typing import List, Tuple

import numpy as np

# the colour palette's levels a channel, R × G × B
_LEVELS = (6, 7, 6)
_LITERALS_PER_CLEAR = 253


def _palettes() -> Tuple[np.ndarray, np.ndarray]:
    grey = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, axis=1)
    axes = [np.rint(np.arange(n) * 255.0 / (n - 1)) for n in _LEVELS]
    r, g, b = np.meshgrid(*axes, indexing="ij")
    colour = np.zeros((256, 3), np.uint8)
    colour[:r.size] = np.stack([r, g, b], -1).reshape(-1, 3)
    return grey, colour


def _indices(frame: np.ndarray, grey: bool) -> np.ndarray:
    """uint8 frame → palette indices [H, W] uint8."""
    if grey:
        return frame.reshape(frame.shape[:2])
    q = [np.rint(frame[..., c].astype(np.float32) * ((n - 1) / 255.0)
                 ).astype(np.int32) for c, n in enumerate(_LEVELS)]
    idx = (q[0] * _LEVELS[1] + q[1]) * _LEVELS[2] + q[2]
    return idx.astype(np.uint8)


def _lzw_literal(idx: np.ndarray) -> bytes:
    """8-bit indices → the image data sub-blocks of a literal-code LZW
    stream (minimum code size 8: clear 256, end 257, all codes 9 bits)."""
    px = idx.reshape(-1).astype(np.uint16)
    n = len(px)
    n_blocks = -(-n // _LITERALS_PER_CLEAR)
    codes = np.full((n_blocks, _LITERALS_PER_CLEAR + 1), 0xFFFF, np.uint16)
    codes[:, 0] = 256
    body = np.full(n_blocks * _LITERALS_PER_CLEAR, 0xFFFF, np.uint16)
    body[:n] = px
    codes[:, 1:] = body.reshape(n_blocks, _LITERALS_PER_CLEAR)
    codes = codes.reshape(-1)
    codes = np.concatenate([codes[codes != 0xFFFF], [257]]).astype(np.uint16)
    bits = ((codes[:, None] >> np.arange(9, dtype=np.uint16)) & 1
            ).astype(np.uint8)
    data = np.packbits(bits.reshape(-1), bitorder="little")
    # sub-blocks of at most 255 bytes, each after its length
    full, rest = divmod(len(data), 255)
    out = np.empty((full, 256), np.uint8)
    out[:, 0] = 255
    out[:, 1:] = data[:full * 255].reshape(full, 255)
    tail = (bytes([rest]) + data[full * 255:].tobytes()) if rest else b""
    return out.tobytes() + tail + b"\x00"


def write_gif(path: str, frames, fps: float = 30) -> str:
    """Write uint8 frames [N, H, W] / [N, H, W, 1] (grey) or [N, H, W, 3]
    (RGB) as an animated GIF at ``fps`` → path."""
    frames = np.asarray(frames)
    if frames.dtype != np.uint8:
        raise TypeError(f"{path}: write_gif takes uint8 frames, not "
                        f"{frames.dtype}")
    if frames.ndim == 3:
        frames = frames[..., None]
    if frames.ndim != 4 or frames.shape[3] not in (1, 3) or not len(frames):
        raise ValueError(f"{path}: write_gif takes [N, H, W], [N, H, W, 1] "
                         f"or [N, H, W, 3] with N > 0, not {frames.shape}")
    N, H, W, C = frames.shape
    if H > 0xFFFF or W > 0xFFFF:
        raise ValueError(f"{path}: GIF frames are at most 65535 pixels wide")
    grey = C == 1
    palette = _palettes()[0 if grey else 1]
    delay = int(round(100.0 / fps))
    parts = [b"GIF89a", struct.pack("<HHBBB", W, H, 0xF7, 0, 0),
             palette.tobytes(),
             b"\x21\xff\x0bNETSCAPE2.0\x03\x01\x00\x00\x00"]
    for frame in frames:
        parts.append(b"\x21\xf9\x04\x00" + struct.pack("<H", delay)
                     + b"\x00\x00")
        parts.append(b"\x2c" + struct.pack("<HHHHB", 0, 0, W, H, 0))
        parts.append(b"\x08" + _lzw_literal(_indices(frame, grey)))
    parts.append(b"\x3b")
    with open(path, "wb") as fh:
        fh.write(b"".join(parts))
    return path


def _sub_blocks(raw: bytes, pos: int) -> Tuple[bytes, int]:
    out = []
    while True:
        n = raw[pos]
        pos += 1
        if n == 0:
            return b"".join(out), pos
        out.append(raw[pos:pos + n])
        pos += n


def _widths(min_size: int, n: int) -> np.ndarray:
    """Bit widths of the first n codes after a clear: each code after the
    first adds a table entry, so the k-th code's width is the bit length
    of the next free code before it (end + k), capped at 12."""
    end = (1 << min_size) + 1
    nxt = end + np.maximum(np.arange(n), 1)
    bl = np.floor(np.log2(nxt)).astype(np.int64) + 1
    return np.minimum(bl, 12)


def _codes_at(bits: np.ndarray, start: int, width: np.ndarray) -> np.ndarray:
    """Codes of the given widths read LSB-first from bit ``start`` (bits
    past the end read as 0)."""
    offs = start + np.concatenate([[0], np.cumsum(width)[:-1]])
    k = np.arange(12)
    at = offs[:, None] + k
    ok = (k < width[:, None]) & (at < len(bits))
    vals = bits[np.minimum(at, len(bits) - 1)].astype(np.int64) * ok
    return (vals << k).sum(1)


def _lzw_decode(path: str, data: bytes, min_size: int, n_px: int
                ) -> np.ndarray:
    bits = np.unpackbits(np.frombuffer(data, np.uint8), bitorder="little")
    clear, end = 1 << min_size, (1 << min_size) + 1
    w0 = min_size + 1
    short = (1 << w0) - end        # codes after a clear that keep width w0
    out, got, pos = [], 0, 0       # pos: a bit just after a clear
    while pos < len(bits) and got < n_px:
        # fast path: a run of literal segments short enough that every
        # code is w0 bits wide, as write_gif writes them
        n = min((len(bits) - pos) // w0, 4 * (n_px - got) + 8)
        codes = (bits[pos:pos + n * w0].reshape(n, w0).astype(np.int64)
                 << np.arange(w0)).sum(1)
        stops = np.nonzero((codes == clear) | (codes == end))[0]
        seg = np.searchsorted(stops, np.arange(n))     # each code's segment
        tabled = np.bincount(seg[codes > end], minlength=len(stops) + 1)
        seg_ok = ((np.diff(np.concatenate([[-1], stops])) - 1 <= short)
                  & (tabled[:len(stops)] == 0))
        n_ok = int(np.argmin(seg_ok)) if not seg_ok.all() else len(stops)
        if n_ok:
            last = int(stops[n_ok - 1])
            lit = codes[:last]
            lit = lit[lit < clear].astype(np.uint8)
            out.append(lit)
            got += len(lit)
            pos += (last + 1) * w0
            if codes[last] == end:
                break
            continue
        # general path: the codes up to the next clear or end, decoded
        # through the string table
        m = 512
        while True:
            width = _widths(min_size, m)
            codes = _codes_at(bits, pos, width)
            stops = np.nonzero((codes == clear) | (codes == end))[0]
            if len(stops) or int(width.sum()) >= len(bits) - pos:
                break
            m *= 2
        seg_len = int(stops[0]) if len(stops) else len(codes)
        seg = _decode_segment(path, codes[:seg_len], clear)
        out.append(seg)
        got += len(seg)
        pos += int(width[:seg_len + 1].sum())
        if not len(stops) or codes[seg_len] == end:
            break
    px = np.concatenate(out) if out else np.zeros(0, np.uint8)
    if len(px) < n_px:
        raise ValueError(f"{path}: GIF image data ends after {len(px)} of "
                         f"{n_px} pixels")
    return px[:n_px]


def _decode_segment(path: str, seg: np.ndarray, clear: int) -> np.ndarray:
    """General LZW decoding of the codes between two clears."""
    table = [bytes([i]) for i in range(clear)] + [b"", b""]
    out = bytearray()
    prev = None
    for c in seg.tolist():
        if c < len(table):
            entry = table[c]
        elif c == len(table) and prev is not None:
            entry = prev + prev[:1]
        else:
            raise ValueError(f"{path}: corrupt GIF LZW code {c}")
        out += entry
        if prev is not None and len(table) < 4096:
            table.append(prev + entry[:1])
        prev = entry
    return np.frombuffer(bytes(out), np.uint8)


def read_gif(path: str) -> Tuple[np.ndarray, List[int]]:
    """Decode the GIF at ``path`` → (frames [N, H, W, 3] uint8, each
    frame's delay in ms)."""
    with open(path, "rb") as fh:
        raw = fh.read()
    if raw[:6] not in (b"GIF87a", b"GIF89a"):
        raise ValueError(f"{path}: not a GIF file")
    W, H, flags, bg, _ = struct.unpack("<HHBBB", raw[6:13])
    pos = 13
    gct = None
    if flags & 0x80:
        n = 2 << (flags & 7)
        gct = np.frombuffer(raw[pos:pos + 3 * n], np.uint8).reshape(n, 3)
        pos += 3 * n
    canvas = np.zeros((H, W, 3), np.uint8)
    frames, delays = [], []
    delay, transparent = 0, None
    while pos < len(raw):
        kind = raw[pos]
        pos += 1
        if kind == 0x3B:
            break
        if kind == 0x21:
            label = raw[pos]
            body, pos = _sub_blocks(raw, pos + 1)
            if label == 0xF9 and len(body) >= 4:
                packed, delay, tidx = struct.unpack("<BHB", body[:4])
                transparent = tidx if packed & 1 else None
            continue
        if kind != 0x2C:
            raise ValueError(f"{path}: unknown GIF block 0x{kind:02x}")
        x0, y0, w, h, f = struct.unpack("<HHHHB", raw[pos:pos + 9])
        pos += 9
        pal = gct
        if f & 0x80:
            n = 2 << (f & 7)
            pal = np.frombuffer(raw[pos:pos + 3 * n], np.uint8).reshape(n, 3)
            pos += 3 * n
        if f & 0x40:
            raise ValueError(f"{path}: interlaced GIF frames are not read")
        if pal is None:
            raise ValueError(f"{path}: GIF frame without a palette")
        min_size = raw[pos]
        data, pos = _sub_blocks(raw, pos + 1)
        idx = _lzw_decode(path, data, min_size, w * h).reshape(h, w)
        if int(idx.max(initial=0)) >= len(pal):
            raise ValueError(f"{path}: GIF palette index out of range")
        region = canvas[y0:y0 + h, x0:x0 + w]
        keep = (idx == transparent) if transparent is not None else None
        new = pal[idx]
        if keep is not None:
            new[keep] = region[keep]
        canvas = canvas.copy()
        canvas[y0:y0 + h, x0:x0 + w] = new
        frames.append(canvas)
        delays.append(10 * delay)
        delay, transparent = 0, None
    if not frames:
        raise ValueError(f"{path}: GIF without frames")
    return np.stack(frames), delays

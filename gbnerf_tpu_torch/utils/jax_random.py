"""A torch twin of the JAX package's random draws (threefry2x32
``jax.random``), for runs that replay that package's streams.

This replays what the JAX package draws for a seed and adds nothing that
package lacks. Threefry2x32 is a pure function of a key and a counter, so a
key tree and every draw made from it can be recomputed here, on any device:

- keys (``PRNGKey``, ``split``, ``fold_in``) are pairs of Python ints,
  derived on the host in microseconds with no device work;
- the bits of a draw are computed on the tensor's device in int64
  arithmetic masked to 32 bits (``random_bits``);
- ``uniform``, ``randint`` (with its two-draw span arithmetic) and the raw
  bits equal jax 0.9.0's bit for bit, bf16 uniforms (built from 8-bit
  words) too; ``normal`` (f32 and bf16), ``truncated_normal`` and
  ``exponential`` evaluate XLA's own f32 ``log1p`` (Cephes) and
  ``erf_inv`` (Giles) formulas with the fused multiply-adds XLA's CPU
  backend emits, and equal jax's on more than 99.9 % of draws, the rest
  within 2 ulp (``tests/test_torch_jax_random.py`` holds them to 4).

Both layouts of ``jax_threefry_partitionable`` are implemented: a key
carries its mode (``PRNGKey(seed, partitionable=...)``; jax 0.9.0's default
is True, jax < 0.5's was False) and every key derived from it keeps it.

The helpers at the end (``split``, ``fold_in``, ``draw``, ``randint_``,
``is_jax``) take either a ``JaxKey`` or a ``torch.Generator``: with a
generator, ``split`` and ``fold_in`` return it unchanged and the draws come
from it as before, so one call site serves both streams and the torch
stream stays exactly what it was.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Sequence, Tuple, Union

import torch

M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


@dataclass(frozen=True)
class JaxKey:
    """A raw threefry key: two uint32 words, and the configuration of the
    jax that drew from it, which every derived key keeps: the threefry
    layout (``jax_threefry_partitionable``) and ``jax_enable_x64`` (64-bit
    seeds and integer draws)."""

    k0: int
    k1: int
    partitionable: bool = True
    x64: bool = False        # jax_enable_x64: randint draws int64

    def words(self) -> Tuple[int, int]:
        return self.k0, self.k1


Rng = Union[JaxKey, torch.Generator, None]


# ---- threefry2x32 -------------------------------------------------------

def _rotl_int(x: int, r: int) -> int:
    return ((x << r) | (x >> (32 - r))) & M32


def _threefry_int(k0: int, k1: int, x0: int, x1: int) -> Tuple[int, int]:
    """threefry2x32 of one counter pair, in Python ints (for keys)."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0, x1 = (x0 + ks[0]) & M32, (x1 + ks[1]) & M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = _rotl_int(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & M32
    return x0, x1


def threefry2x32(k0: int, k1: int, x0: torch.Tensor, x1: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """threefry2x32 over counter tensors (int64 holding uint32 values) with
    the key (k0, k1) → two int64 tensors of uint32 values."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & M32          # new tensors: updated in place below
    x1 = (x1 + ks[1]) & M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0.add_(x1).bitwise_and_(M32)
            hi = (x1 << r).bitwise_and_(M32)
            x1.bitwise_right_shift_(32 - r).bitwise_or_(hi).bitwise_xor_(x0)
        x0.add_(ks[(i + 1) % 3]).bitwise_and_(M32)
        x1.add_(ks[(i + 2) % 3] + i + 1).bitwise_and_(M32)
    return x0, x1


def _threefry_flat_int(key: JaxKey, counts: Sequence[int]) -> List[int]:
    """jax's ``threefry_2x32(key, count)`` on a short list of ints: the
    flat count split in halves (padded with 0 when odd), hashed pairwise,
    the two output halves concatenated."""
    n = len(counts)
    c = list(counts) + ([0] if n % 2 else [])
    h = len(c) // 2
    out0, out1 = [], []
    for a, b in zip(c[:h], c[h:]):
        y0, y1 = _threefry_int(key.k0, key.k1, a, b)
        out0.append(y0)
        out1.append(y1)
    return (out0 + out1)[:n]


# ---- keys ---------------------------------------------------------------

def PRNGKey(seed: int, *, partitionable: bool = True,
            x64: bool = False) -> JaxKey:
    """``jax.random.PRNGKey(seed)`` (threefry_seed): the key [seed >> 32,
    seed & 0xFFFFFFFF] of the seed as an int32 (jax's default; the logical
    shift by 32 gives 0) or, with x64, as an int64."""
    seed = int(seed)
    bits = 64 if x64 else 32
    if not -2 ** (bits - 1) <= seed < 2 ** (bits - 1):
        raise ValueError(f"seed {seed} does not fit jax's {bits}-bit seed")
    hi = (seed >> 32) & M32 if x64 else 0
    return JaxKey(hi, seed & M32, partitionable, x64)


def key_split(key: JaxKey, num: int = 2) -> List[JaxKey]:
    """``jax.random.split(key, num)`` → num keys, in either layout."""
    if key.partitionable:
        # foldlike: key i = threefry(key, (0, i))
        outs = [_threefry_int(key.k0, key.k1, 0, i) for i in range(num)]
        return [JaxKey(a, b, True, key.x64) for a, b in outs]
    w = _threefry_flat_int(key, range(2 * num))
    return [JaxKey(w[2 * i], w[2 * i + 1], False, key.x64)
            for i in range(num)]


def key_fold_in(key: JaxKey, data: int) -> JaxKey:
    """``jax.random.fold_in(key, data)``: threefry(key, seed(data))."""
    a, b = _threefry_flat_int(key, [0, int(data) & M32])
    return JaxKey(a, b, key.partitionable, key.x64)


# ---- bits and draws -----------------------------------------------------

def _numel(shape) -> int:
    return int(math.prod(tuple(shape)))


def random_bits(key: JaxKey, shape, device=None, bit_width: int = 32
                ) -> torch.Tensor:
    """``jax.random.bits`` of ``shape`` → an int64 tensor of unsigned
    values (8-, 16-, 32-bit, or 64-bit as int64's two's complement).
    Narrow words are, in the partitionable layout, the low bits of each
    32-bit word; in the original one, the bytes (or halves) of the
    threefry words in little-endian order."""
    shape, n = tuple(shape), _numel(shape)
    if bit_width not in (8, 16, 32, 64):
        raise ValueError(f"bit_width {bit_width}: 8, 16, 32 or 64 bits")
    if n == 0:
        return torch.zeros(shape, dtype=torch.int64, device=device)
    if key.partitionable:
        if n > 2 ** 32:
            raise ValueError("more than 2**32 values in one draw")
        lo = torch.arange(n, dtype=torch.int64, device=device)
        b1, b2 = threefry2x32(key.k0, key.k1, torch.zeros_like(lo), lo)
        if bit_width == 64:
            return ((b1 << 32) | b2).reshape(shape)
        return ((b1 ^ b2) & ((1 << bit_width) - 1)).reshape(shape)
    words = -(-n * bit_width // 32)
    if words >= M32:
        raise ValueError("draw too large for one threefry block")
    half = (words + 1) // 2
    c = torch.arange(2 * half, dtype=torch.int64, device=device)
    if words % 2:
        c[-1] = 0
    y0, y1 = threefry2x32(key.k0, key.k1, c[:half], c[half:])
    bits = torch.cat([y0, y1])[:words]
    if bit_width == 32:
        return bits.reshape(shape)
    if bit_width == 64:
        hi, lo = bits[:n], bits[n:]
        return ((hi << 32) | lo).reshape(shape)
    mask = (1 << bit_width) - 1
    parts = [(bits >> (bit_width * i)) & mask
             for i in range(32 // bit_width)]
    return torch.stack(parts, dim=1).reshape(-1)[:n].reshape(shape)


def _unit_floats(key: JaxKey, shape, dtype, device) -> torch.Tensor:
    """jax's [1, 2) mantissa trick minus 1 → floats in [0, 1). bfloat16
    (7 mantissa bits) takes jax's 8-bit words, shifted right by 1."""
    if dtype == torch.float32:
        bits = random_bits(key, shape, device, 32)
        f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
        return f - 1.0
    if dtype == torch.float64:
        bits = random_bits(key, shape, device, 64)
        # logical shift right by 12 of the unsigned 64-bit value
        mant = (bits >> 12) & ((1 << 52) - 1)
        f = (mant | 0x3FF0000000000000).view(torch.float64)
        return f - 1.0
    if dtype == torch.bfloat16:
        bits = random_bits(key, shape, device, 8)
        f = ((bits >> 1) | 0x3F80).to(torch.int16).view(torch.bfloat16)
        return f - 1.0
    raise TypeError(f"uniform draws in float32, float64 or bfloat16, "
                    f"not {dtype}")


def _fma32(a: torch.Tensor, b: torch.Tensor, c) -> torch.Tensor:
    """f32 a·b + c rounded once, as XLA's CPU backend fuses it (the f32
    product is exact in f64)."""
    return (a.double() * b.double() + c).float()


def uniform(key: JaxKey, shape, dtype=torch.float32, device=None,
            minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform``: max(minval, u·(maxval − minval) + minval),
    with the span and the bounds rounded to ``dtype`` first and, in f32,
    the product and the sum rounded once (a fused multiply-add, as XLA
    emits it)."""
    f = _unit_floats(key, shape, dtype, device)
    if minval == 0.0 and maxval == 1.0:
        return f
    lo = torch.tensor(minval, dtype=dtype, device=device)
    hi = torch.tensor(maxval, dtype=dtype, device=device)
    if dtype == torch.float32:
        x = _fma32(f, hi - lo, lo.double())
    else:           # f64; bf16 rounds after each operation, as XLA's CPU
        x = f * (hi - lo) + lo
    return torch.maximum(lo, x)


def randint(key: JaxKey, shape, minval: int, maxval, device=None
            ) -> torch.Tensor:
    """``jax.random.randint`` (int32, or int64 under x64; returned as
    int64): two draws of the dtype's width (the split's two keys) reduced
    modulo the span in unsigned arithmetic that wraps, as jax computes it.
    ``maxval`` may be a Python int or a 0-d integer tensor (a span that
    the data sets); maxval ≤ minval gives minval."""
    k1, k2 = key_split(key)
    if key.x64:
        return _randint64(k1, k2, shape, minval, maxval, device)
    hi_bits = random_bits(k1, shape, device)
    lo_bits = random_bits(k2, shape, device)
    if isinstance(maxval, torch.Tensor):
        maxval = maxval.to(torch.int64)
        span = torch.where(maxval <= minval, torch.ones_like(maxval),
                           (maxval - minval) & M32)
    else:
        span = 1 if maxval <= minval else (int(maxval) - minval) & M32
    mult = (2 ** 16) % span
    mult = ((mult * mult) & M32) % span
    off = ((((hi_bits % span) * mult) & M32) + (lo_bits % span)) & M32
    return minval + off % span


def _randint64(k1: JaxKey, k2: JaxKey, shape, minval: int, maxval, device
               ) -> torch.Tensor:
    """randint's 64-bit form (under x64), in numpy's wrapping uint64 on the
    host: the replays that use it are small."""
    import numpy as np

    maxval = int(maxval)
    hi = random_bits(k1, shape, None, 64).numpy().view(np.uint64)
    lo = random_bits(k2, shape, None, 64).numpy().view(np.uint64)
    span = np.uint64(1 if maxval <= minval else maxval - minval)
    with np.errstate(over="ignore"):
        mult = np.uint64(2 ** 32) % span
        mult = (mult * mult) % span
        off = ((hi % span) * mult + lo % span) % span
    out = torch.from_numpy(off.astype(np.int64)) + minval
    return out.to(device)


# XLA's f32 log1p on the CPU: a Cephes rational below √2 − 1, else
# log(1 + x) by XLA's vectorised Cephes logf, each multiply-add fused
_LOG1P_NUM = (4.5270000862445199635215E-5, 4.9854102823193375972212E-1,
              6.5787325942061044846969E0, 2.9911919328553073277375E1,
              6.0949667980987787057556E1, 5.7112963590585538103336E1,
              2.0039553499201281259648E1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167E1, 8.3047565967967209469434E1,
              2.2176239823732856465394E2, 3.0909872225312059774938E2,
              2.1642788614495947685003E2, 6.0118660497603843919306E1)
_LOGF_P = (7.0376836292E-2, -1.1514610310E-1, 1.1676998740E-1,
           -1.2420140846E-1, 1.4249322787E-1, -1.6668057665E-1,
           2.0000714765E-1, -2.4999993993E-1, 3.3333331174E-1)


def _f32(c: float) -> float:
    """c rounded to f32 (XLA's constants), as a Python float."""
    return float(torch.tensor(c, dtype=torch.float32))


def _logf_xla(v: torch.Tensor) -> torch.Tensor:
    """XLA CPU's f32 log of v > 0 (Cephes logf: exponent and mantissa in
    [√½, √2), a degree-8 polynomial in three interleaved parts)."""
    bits = v.view(torch.int32)
    e = ((bits >> 23) & 0xFF).float() - 126.0
    m = ((bits & ~0x7F800000) | 0x3F000000).view(torch.float32)
    small = m < _f32(0.707106781186547524)
    tmp = torch.where(small, m, torch.zeros_like(m))
    m = m - 1.0
    e = e - small.float()
    m = m + tmp
    m2 = m * m
    m3 = m2 * m
    P = [_f32(c) for c in _LOGF_P]
    y = _fma32(torch.full_like(m, P[0]), m, P[1])
    y1 = _fma32(torch.full_like(m, P[3]), m, P[4])
    y2 = _fma32(torch.full_like(m, P[6]), m, P[7])
    y = _fma32(y, m, P[2])
    y1 = _fma32(y1, m, P[5])
    y2 = _fma32(y2, m, P[8])
    y = _fma32(y, m3, y1.double())
    y = _fma32(y, m3, y2.double())
    y = _fma32(y, m3, (e * _f32(-2.12194440e-4)).double())
    m = _fma32(m2, torch.full_like(m, -0.5), m.double())
    m = m + y
    return _fma32(e, torch.full_like(e, _f32(0.693359375)), m.double())


def _log1p(x: torch.Tensor) -> torch.Tensor:
    """log1p as jax computes it on the CPU: XLA's f32 formula (above) for
    f32, bit for bit on (−1, 1); torch's own for f64. Each branch is
    evaluated on its own elements only."""
    if x.dtype != torch.float32:
        return torch.log1p(x)
    out = torch.empty_like(x)
    small = torch.abs(x) < _f32(0.41421356237309504880)
    xs = x[small]
    x2 = xs * xs
    num, den = _horner32(xs, _LOG1P_NUM), _horner32(xs, _LOG1P_DEN)
    t = (xs * x2) * (num / den)
    out[small] = xs + _fma32(torch.full_like(xs, -0.5), x2, t.double())
    large = ~small
    v = 1.0 + x[large]
    out[large] = torch.where(
        v > 0, _logf_xla(torch.where(v > 0, v, torch.ones_like(v))),
        torch.full_like(v, float("-inf")))
    return out


_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def _horner32(w: torch.Tensor, coefs) -> torch.Tensor:
    """Horner's rule in f32 with each step a fused multiply-add."""
    w64 = w.double()
    p = torch.full_like(w, _f32(coefs[0]))
    for c in coefs[1:]:
        p = (p.double().mul_(w64).add_(_f32(c))).float()
    return p


def erf_inv_f32(x: torch.Tensor) -> torch.Tensor:
    """XLA's single-precision ``erf_inv`` (Giles' polynomial in
    w = −log1p(−x²), two branches at w = 5), in f32 with each Horner step
    a fused multiply-add as XLA emits it; ±1 → ±inf."""
    w = -_log1p(-(x * x))
    lt = w < 5.0
    p = torch.empty_like(x)
    p[lt] = _horner32(w[lt] - 2.5, _ERFINV_LT5)
    ge = ~lt
    p[ge] = _horner32(torch.sqrt(w[ge]) - 3.0, _ERFINV_GE5)
    return torch.where(torch.abs(x) == 1.0, x * float("inf"), p * x)


# nextafter(-1, 0) in f32 and in bf16
_NEXT_M1 = {torch.float32: -0.99999994, torch.bfloat16: -0.99609375}


def normal(key: JaxKey, shape, dtype=torch.float32, device=None
           ) -> torch.Tensor:
    """``jax.random.normal``: √2 · erf_inv(u), u uniform over
    [nextafter(−1, 0), 1), in f32 or bf16. In bf16, XLA's CPU evaluates
    erf_inv in f32 on the upcast uniform and rounds it to bf16, then
    multiplies by √2 rounded to bf16 and rounds again."""
    if dtype not in _NEXT_M1:
        raise TypeError("normal draws are replayed in float32 and bfloat16 "
                        "only (XLA's f64 erf_inv is another polynomial)")
    u = uniform(key, shape, dtype, device, _NEXT_M1[dtype], 1.0)
    sqrt2 = torch.tensor(math.sqrt(2.0), dtype=dtype, device=device)
    if dtype == torch.float32:
        return sqrt2 * erf_inv_f32(u)
    e = erf_inv_f32(u.float()).to(dtype)
    return (e.float() * sqrt2.float()).to(dtype)


def _erf_f32(x: float) -> float:
    return float(torch.tensor(math.erf(x), dtype=torch.float32))


def truncated_normal(key: JaxKey, lower: float, upper: float, shape,
                     dtype=torch.float32, device=None) -> torch.Tensor:
    """``jax.random.truncated_normal``: √2·erf_inv(u), u uniform over
    [erf(lower/√2), erf(upper/√2)), clipped to the open (lower, upper)."""
    if dtype != torch.float32:
        raise TypeError("truncated_normal draws are replayed in float32 only")
    sqrt2 = float(torch.tensor(math.sqrt(2.0), dtype=torch.float32))
    lo_f = float(torch.tensor(lower, dtype=torch.float32))
    hi_f = float(torch.tensor(upper, dtype=torch.float32))
    a = _erf_f32(float(torch.tensor(lo_f / sqrt2, dtype=torch.float32)))
    b = _erf_f32(float(torch.tensor(hi_f / sqrt2, dtype=torch.float32)))
    u = uniform(key, shape, dtype, device, a, b)
    out = torch.tensor(sqrt2, dtype=dtype, device=device) * erf_inv_f32(u)
    lo_t = torch.tensor(lo_f, dtype=dtype, device=device)
    hi_t = torch.tensor(hi_f, dtype=dtype, device=device)
    return torch.clamp(out, torch.nextafter(lo_t, hi_t),
                       torch.nextafter(hi_t, lo_t))


def exponential(key: JaxKey, shape, dtype=torch.float32, device=None
                ) -> torch.Tensor:
    """``jax.random.exponential``: −log1p(−u)."""
    return -_log1p(-uniform(key, shape, dtype, device))


# ---- call sites: a JaxKey or a torch.Generator --------------------------

def is_jax(rng: Rng) -> bool:
    return isinstance(rng, JaxKey)


def split(rng: Rng, num: int = 2) -> list:
    """``jax.random.split`` for a JaxKey; a generator (or None) is returned
    ``num`` times, so that its stream runs on unchanged."""
    if isinstance(rng, JaxKey):
        return key_split(rng, num)
    return [rng] * num


def fold_in(rng: Rng, data: int) -> Rng:
    """``jax.random.fold_in`` for a JaxKey; a generator is returned."""
    return key_fold_in(rng, data) if isinstance(rng, JaxKey) else rng


def draw(kind: str, shape, rng: Rng, dtype=torch.float32, device=None
         ) -> torch.Tensor:
    """A draw of ``kind`` ("rand": uniform [0, 1), "randn", "exponential")
    from a JaxKey (jax's draw) or a generator (torch's)."""
    shape = tuple(shape)
    if isinstance(rng, JaxKey):
        fn = {"rand": uniform, "randn": normal,
              "exponential": exponential}.get(kind)
        if fn is None:
            raise ValueError(f"unknown draw kind: {kind!r}")
        return fn(rng, shape, dtype, device)
    if kind == "rand":
        return torch.rand(shape, generator=rng, dtype=dtype, device=device)
    if kind == "randn":
        return torch.randn(shape, generator=rng, dtype=dtype, device=device)
    if kind == "exponential":
        x = torch.empty(shape, dtype=dtype, device=device)
        return x.exponential_(generator=rng)
    raise ValueError(f"unknown draw kind: {kind!r}")


def randint_(rng: Rng, low: int, high: int, shape, device=None
             ) -> torch.Tensor:
    """Integers in [low, high): jax's ``randint`` from a JaxKey, torch's
    ``randint`` from a generator (int64 either way)."""
    if isinstance(rng, JaxKey):
        return randint(rng, shape, low, high, device)
    return torch.randint(low, high, tuple(shape), generator=rng,
                         device=device)

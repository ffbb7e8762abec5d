"""JAX's threefry key chain and samplers in torch (jax.random as the JAX
package calls it: jax._src.prng's threefry2x32 PRNG and jax._src.random's
uniform, normal, gumbel and categorical), reproduced for the layout of JAX
0.9 with `jax_threefry_partitionable` on. The same seed gives JAX's
numbers, so the port's `process()` from `cfg.seed` draws JAX's noise.

Keys are pairs of uint32 held as Python ints, `(k0, k1)`, as JAX's raw
`uint32[2]` keys: `key(seed)` is (seed >> 32, seed & 0xFFFFFFFF),
`split(key, n)` hashes the counters (0, i), `fold_in(key, d)` the counter
pair (0, d). A draw over `shape` hashes each element's flat row-major index
as the counter pair (index >> 32, index & 0xFFFFFFFF) and takes
`bits = y0 ^ y1` (the low 8 or 16 bits for narrower draws). A uniform sets
the top mantissa bits of 1.0 from the bits, subtracts 1, scales into
[minval, maxval) and takes max(minval, .); a normal is sqrt(2) erf_inv of
a uniform on (nextafter(-1, 0), 1), with erf_inv the fp32 polynomial XLA
lowers chlo.erf_inv to (Giles' single-precision approximation, the
branches at w = -log1p(-x^2) < 5; log1p and log are XLA's CPU
polynomials: the Cephes rational below sqrt(2) - 1, Cephes' logf); a
truncated normal on (lower, upper) is sqrt(2) erf_inv of a uniform on
[erf(lower / sqrt2), erf(upper / sqrt2)) (XLA's fp32 erf), clamped to
(nextafter(lower, +inf), nextafter(upper, -inf)), as Flax's lecun_normal
draws it; a Gumbel is -log(-log(u)) of a uniform on [tiny, 1) (JAX's
default "low" mode); categorical is the argmax of
logits plus Gumbels drawn in the logits' dtype. bf16 draws take 8 random
bits and round to bf16 after every step, as XLA computes bf16 on the
host.

`draw(rows, shape, dist)` fills [R, *shape] in one call: row r from
`fold_in(key_r, step_r)`, or from `key_r` itself where its step is None.
On a CUDA tensor it launches csrc/threefry.cu (`draw.launches` counts
them) and raises if the kernel cannot build or launch; `draw_plain` is the
plain PyTorch version, the CPU's path and the kernel's reference on the
card. Plain draws are computed with int64 tensor ops holding uint32
values, a chunk of rows at a time.

`draw_folded(base, folds, shape, dist)` is the device-keyed form: row r
is drawn from fold_in(...fold_in(base, folds[r, 0])..., folds[r, L-1]),
the fold words a [R, L] long tensor on the draw's device (L from 1 to 3),
so each row's key is worked out on the device from words that may change
in place between replays of a CUDA graph (the serving engine's nonces and
counts). On the card it launches the kernel's folded entry
(`draw_folded.launches`); `draw_folded_plain` is its plain version.
`randint` is jax.random.randint for int32.
"""

from __future__ import annotations

import ctypes
import math
from typing import Sequence

import torch

from . import cuda_build

SOURCE = "threefry.cu"
M32 = 0xFFFFFFFF
Key = tuple  # (k0, k1), uint32 values as Python ints
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
# XLA's chlo.erf_inv for f32 (stablehlo's materializeErfInvF32): Horner
# coefficients, highest power first, for w < 5 and for w >= 5
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)
# XLA's f32 erf on the CPU (its elemental emitter): an odd numerator over
# an even denominator in x^2, Horner steps as fused multiply-adds, the input
# clamped to +-3.8325; equal to jax.lax.erf for |x| < 3
_ERF_NUM = (0.00022905065861350646, 0.0034082910107109506,
            0.050955695062380861, 0.18520832239976145, 1.128379143519084)
_ERF_DEN = (-1.1791602954361697e-7, 0.000023547966471313185,
            0.0010179625278914885, 0.014070470171167667,
            0.11098505178285362, 0.49746925110067538, 1.0)
_ERF_CLAMP = 3.832506856900711
# XLA's f32 log1p / log on the CPU: the Cephes rational below sqrt(2) - 1
# (numerator and denominator, Horner order) and Cephes' logf polynomial
_LOG1P_NUM = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
              6.5787325942061044846969e0, 2.9911919328553073277375e1,
              6.0949667980987787057556e1, 5.7112963590585538103336e1,
              2.0039553499201281259648e1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
              2.2176239823732856465394e2, 3.0909872225312059774938e2,
              2.1642788614495947685003e2, 6.0118660497603843919306e1)
_LOG_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
          -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
          2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)
# the kernel's distribution codes (csrc/threefry.cu)
DISTS = {"bits": 0, "uniform": 1, "normal": 2, "gumbel": 3,
         "truncated_normal": 4}
# elements a plain draw computes at once (int64 temporaries of 128 MB)
PLAIN_CHUNK = 1 << 24


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 (20 rounds) of the counter pair (x0, x1) under the key
    (k0, k1): Python ints or int64 tensors of uint32 values (the counters
    may be tensors with int keys). Returns (y0, y1) of the same kind."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + k0) & M32
    x1 = (x1 + k1) & M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = (((x1 << r) | (x1 >> (32 - r))) & M32) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & M32
    return x0, x1


def key(seed: int) -> Key:
    """jax.random.PRNGKey(seed): (seed >> 32, seed & 0xFFFFFFFF) for a
    seed in [0, 2^64); a negative seed as its 32-bit two's complement (JAX
    takes seeds as int32 without 64-bit mode)."""
    seed = int(seed)
    if seed < 0:
        if seed < -(1 << 31):
            raise ValueError(f"prng.key: seed {seed} is below int32")
        return (0, seed & M32)
    if seed >> 64:
        raise ValueError(f"prng.key: seed {seed} needs more than 64 bits")
    return (seed >> 32, seed & M32)


def split(k: Key, n: int = 2) -> list:
    """jax.random.split(k, n): n keys, key i the hash of the counters
    (0, i)."""
    return [threefry2x32(k[0], k[1], 0, i) for i in range(n)]


def fold_in(k: Key, data: int) -> Key:
    """jax.random.fold_in(k, data): the hash of the counters (0, data),
    data taken as uint32."""
    return threefry2x32(k[0], k[1], 0, int(data) & M32)


def row_key(k: Key, step: int | None) -> Key:
    """A draw row's key: fold_in(k, step), or k itself when step is None."""
    return k if step is None else fold_in(k, step)


def _check_dist(dist: str, dtype: torch.dtype):
    if dist not in DISTS:
        raise ValueError(f"prng: unknown distribution {dist!r}; expected one "
                         f"of {sorted(DISTS)}")
    allowed = ((torch.int64,) if dist == "bits"
               else (torch.float32, torch.bfloat16))
    if dtype not in allowed:
        raise TypeError(f"prng: {dist} draws take {allowed}, got {dtype}")


# --------------------------------------------------------- plain version
def _bits(keys: torch.Tensor, n: int, width: int) -> torch.Tensor:
    """[rows, n] int64: the low `width` bits of y0 ^ y1 under each row's
    key [rows, 2] over the flat indices 0..n-1 (hi word, lo word)."""
    idx = torch.arange(n, dtype=torch.int64, device=keys.device)[None]
    y0, y1 = threefry2x32(keys[:, :1], keys[:, 1:], idx >> 32, idx & M32)
    return (y0 ^ y1) & ((1 << width) - 1)


def _round_bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """fp32 a * b + c rounded once, as XLA contracts a product and a sum
    into a fused multiply-add: the product of two fp32 values is exact in
    fp64, and so is the sum wherever it spans at most 53 bits (every use
    here but inputs far outside the unit range)."""
    return (a.double() * b + c).float()


def _f32(v: float) -> float:
    return float(torch.tensor(v, dtype=torch.float32))


def _log_f32(y: torch.Tensor) -> torch.Tensor:
    """XLA's fp32 log on the CPU (Cephes' logf as Eigen evaluates it): the
    mantissa m in [0.5, 1) and exponent e of y, m < sqrt(1/2) shifted up an
    octave, t = m - 1, a degree-8 polynomial in three parts, every step a
    fused multiply-add."""
    m, e = torch.frexp(y.clamp_min(torch.finfo(torch.float32).tiny))
    e = e.float()
    low = m < _f32(0.707106781186547524)
    t = (m - 1.0) + torch.where(low, m, torch.zeros_like(m))
    e = e - low.float()
    t2 = t * t
    t3 = t2 * t
    p = [_f32(c) for c in _LOG_P]
    a = _fma(_fma(torch.full_like(t, p[0]), t, p[1]), t, p[2])
    b = _fma(_fma(torch.full_like(t, p[3]), t, p[4]), t, p[5])
    c = _fma(_fma(torch.full_like(t, p[6]), t, p[7]), t, p[8])
    r = _fma(_fma(a, t3, b), t3, c) * t3
    r = _fma(e, _f32(-2.12194440e-4), r)
    t = _fma(t2, -0.5, t) + r
    return _fma(e, _f32(0.693359375), t)


def _log1p_f32(x: torch.Tensor) -> torch.Tensor:
    """XLA's fp32 log1p on the CPU: below sqrt(2) - 1 in magnitude the
    Cephes rational x - x^2 / 2 + x^3 P(x) / Q(x) (Horner steps as fused
    multiply-adds), else log(1 + x)."""
    num = torch.zeros_like(x)
    for c in _LOG1P_NUM:
        num = _fma(num, x, _f32(c))
    den = torch.zeros_like(x)
    for c in _LOG1P_DEN:
        den = _fma(den, x, _f32(c))
    x2 = x * x
    small = x + (-0.5 * x2 + x * x2 * (num / den))
    return torch.where(x.abs() < _f32(0.41421356237309504880), small,
                       _log_f32(x + 1.0))


def _erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's fp32 erf_inv: Horner steps as fused multiply-adds, +-inf at
    |x| = 1."""
    w = -_log1p_f32(x * -x)
    lt = w < 5.0
    ws = torch.where(lt, w + -2.5, torch.sqrt(w) + -3.0).double()
    coef = lambda i: torch.where(lt, _ERFINV_LT5[i], _ERFINV_GE5[i])
    p = coef(0)
    for i in range(1, len(_ERFINV_LT5)):
        p = _fma(p, ws, coef(i).double())
    return torch.where(x.abs() == 1.0, x * math.inf, p * x)


def _erf(x: torch.Tensor) -> torch.Tensor:
    """XLA's fp32 erf (the CPU's): p(x^2) x / q(x^2), Horner steps as
    fused multiply-adds."""
    x = x.clamp(-_f32(_ERF_CLAMP), _f32(_ERF_CLAMP))
    x2 = x * x
    p = torch.full_like(x2, _f32(_ERF_NUM[0]))
    for c in _ERF_NUM[1:]:
        p = _fma(x2, p, _f32(c))
    q = torch.full_like(x2, _f32(_ERF_DEN[0]))
    for c in _ERF_DEN[1:]:
        q = _fma(x2, q, _f32(c))
    return x * p / q


def _bf16_const(v: float) -> float:
    return float(torch.tensor(v, dtype=torch.bfloat16))


def _tn_bounds(dtype, lower: float, upper: float) -> tuple:
    """JAX's truncated_normal constants in `dtype`, as Python floats: the
    uniform's ends (erf(lower / sqrt2), erf(upper / sqrt2)) and the clamp
    (nextafter(lower, +inf), nextafter(upper, -inf)); bf16 steps computed
    in fp32 and rounded, as XLA computes bf16 on the host."""
    ends = torch.tensor([lower, upper], dtype=torch.float32).to(dtype)
    sqrt2 = torch.tensor(math.sqrt(2), dtype=torch.float32).to(dtype)
    a, b = _erf((ends.float() / sqrt2.float()).to(dtype).float()).to(dtype)
    lo = torch.nextafter(ends[0], torch.tensor(math.inf, dtype=dtype))
    hi = torch.nextafter(ends[1], torch.tensor(-math.inf, dtype=dtype))
    return float(a), float(b), float(lo), float(hi)


def _span(dist: str, dtype, minval: float, maxval: float) -> tuple:
    """(lower end, maxval - minval) of the uniform a draw starts from, as
    Python floats of `dtype`'s values: [minval, maxval) for uniform,
    (nextafter(-1, 0), 1) for normal, [tiny, 1) for gumbel, [erf(minval /
    sqrt2), erf(maxval / sqrt2)) for truncated_normal."""
    if dist == "truncated_normal":
        minval, maxval = _tn_bounds(dtype, minval, maxval)[:2]
    elif dist == "gumbel":
        minval, maxval = torch.finfo(dtype).tiny, 1.0
    elif dist == "normal":
        minval, maxval = float(torch.nextafter(
            torch.tensor(-1.0, dtype=dtype), torch.tensor(0.0, dtype=dtype))), 1.0
    if dtype == torch.bfloat16:
        mn, mx = _bf16_const(minval), _bf16_const(maxval)
        return mn, _bf16_const(mx - mn)
    mn = torch.tensor(minval, dtype=torch.float32)
    return float(mn), float(torch.tensor(maxval, dtype=torch.float32) - mn)


def _uniform_from_bits(bits: torch.Tensor, dtype, mn: float,
                       span: float) -> torch.Tensor:
    """JAX's _uniform on given bits (32 for fp32, 8 for bf16), computed in
    fp32 and returned fp32 (bf16 values rounded at each step)."""
    if dtype == torch.float32:
        f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
        return torch.clamp_min(_fma(f - 1.0, span, mn), mn)
    f = ((bits >> 1) | 0x3F80).to(torch.int16).view(torch.bfloat16).float()
    v = _round_bf16(_round_bf16(_round_bf16(f - 1.0) * span) + mn)
    return torch.clamp_min(v, mn)


def _rows_plain(keys: torch.Tensor, n: int, dist: str, dtype,
                minval: float, maxval: float) -> torch.Tensor:
    """[rows, n] of `dist` for the row keys [rows, 2]."""
    bf16 = dtype == torch.bfloat16
    bits = _bits(keys, n, 8 if bf16 else 32)
    if dist == "bits":
        return bits
    u = _uniform_from_bits(bits, dtype, *_span(dist, dtype, minval, maxval))
    rnd = _round_bf16 if bf16 else (lambda t: t)
    if dist == "uniform":
        v = u
    elif dist == "gumbel":
        v = -rnd(_log_f32(-rnd(_log_f32(u))))
    else:
        v = float(torch.tensor(math.sqrt(2), dtype=dtype)) * rnd(_erf_inv(u))
        if dist == "truncated_normal":
            lo, hi = _tn_bounds(dtype, minval, maxval)[2:]
            v = rnd(v).clamp(lo, hi)
    return v.to(dtype)


def draw_plain(rows: Sequence, shape: Sequence[int], dist: str = "normal",
               dtype: torch.dtype = torch.float32, device="cpu",
               minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """The plain PyTorch version of `draw`: [R, *shape] on `device`, row r
    of `rows` = (key, step) drawn from row_key(key, step). `bits` are the
    32-bit values as int64; `uniform` takes [minval, maxval),
    `truncated_normal` the bounds (minval, maxval)."""
    _check_dist(dist, dtype)
    shape = tuple(int(s) for s in shape)
    n = math.prod(shape)
    keys = torch.tensor([row_key(k, s) for k, s in rows], dtype=torch.int64,
                        device=device).reshape(-1, 2)
    out = torch.empty((keys.shape[0], n), dtype=dtype, device=device)
    per = max(1, PLAIN_CHUNK // max(n, 1))
    for r in range(0, keys.shape[0], per):
        out[r:r + per] = _rows_plain(keys[r:r + per], n, dist, dtype,
                                     minval, maxval)
    return out.reshape(keys.shape[0], *shape)


def _fold_keys(base: Key, folds: torch.Tensor) -> torch.Tensor:
    """[R, 2] int64 row keys on folds' device: fold_in(...fold_in(base,
    folds[r, 0])..., folds[r, L-1]), the words taken as uint32."""
    folds = _check_folds(folds)
    k0 = torch.full((folds.shape[0], 1), base[0], dtype=torch.int64,
                    device=folds.device)
    k1 = torch.full_like(k0, base[1])
    for col in range(folds.shape[1]):
        k0, k1 = threefry2x32(k0, k1, 0, folds[:, col:col + 1] & M32)
    return torch.cat([k0, k1], 1)


def _check_folds(folds: torch.Tensor) -> torch.Tensor:
    if (not isinstance(folds, torch.Tensor) or folds.dim() != 2
            or not 1 <= folds.shape[1] <= 3 or folds.dtype != torch.int64):
        raise ValueError("prng: folds must be a [R, L] int64 tensor with L "
                         f"from 1 to 3, got {getattr(folds, 'dtype', folds)} "
                         f"{tuple(getattr(folds, 'shape', ()))}")
    return folds


def draw_folded_plain(base: Key, folds: torch.Tensor, shape: Sequence[int],
                      dist: str = "normal",
                      dtype: torch.dtype = torch.float32, minval: float = 0.0,
                      maxval: float = 1.0) -> torch.Tensor:
    """The plain PyTorch version of `draw_folded`, on folds' device."""
    _check_dist(dist, dtype)
    shape = tuple(int(s) for s in shape)
    n = math.prod(shape)
    keys = _fold_keys(base, folds)
    out = torch.empty((keys.shape[0], n), dtype=dtype, device=folds.device)
    per = max(1, PLAIN_CHUNK // max(n, 1))
    for r in range(0, keys.shape[0], per):
        out[r:r + per] = _rows_plain(keys[r:r + per], n, dist, dtype,
                                     minval, maxval)
    return out.reshape(keys.shape[0], *shape)


# --------------------------------------------------------------- kernel
def _bind(entry: str = "rsv_threefry"):
    lib = cuda_build.load(SOURCE)
    fn = getattr(lib, entry)
    if fn.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        if entry == "rsv_threefry":
            fn.argtypes = [p, i, ctypes.c_longlong, i, i, f, f, f, f, p, p]
        else:  # rsv_threefry_folded
            u = ctypes.c_uint32
            fn.argtypes = [p, i, i, ctypes.c_longlong, u, u, i, i, f, f, f,
                           f, p, p]
        fn.restype = ctypes.c_int
    return fn


def row_table(rows, device) -> torch.Tensor:
    """The kernel's row table: [R, 3] int64 (k0, k1, step or -1) on
    `device`."""
    return torch.tensor([[k[0], k[1], -1 if s is None else int(s) & M32]
                         for k, s in rows], dtype=torch.int64).to(device)


def launch(table: torch.Tensor, n: int, dist: str, dtype, out: torch.Tensor,
           minval: float = 0.0, maxval: float = 1.0, base: Key | None = None):
    """One launch of csrc/threefry.cu: R = len(table) rows of n draws into
    `out` (contiguous, R * n elements of `dtype` on the card; bits as int32
    words). `table` is the row table [R, 3] (`row_table`), or with `base`
    the [R, L] fold words of the device-keyed entry, each row keyed on the
    device from `base` (a replay of a captured launch reads the words as
    they are then). Allocates nothing and does not synchronise, so a CUDA
    graph can capture it."""
    if table.device != out.device or out.device.type != "cuda":
        raise ValueError(f"prng: the threefry kernel takes CUDA tensors on "
                         f"one device, got {table.device} and {out.device}")
    if not (table.is_contiguous() and out.is_contiguous()):
        raise TypeError("prng: the threefry kernel takes contiguous tensors")
    if out.numel() != table.shape[0] * n:
        raise ValueError(f"prng: out holds {out.numel()} elements, not "
                         f"{table.shape[0]} x {n}")
    mn, span = _span(dist, dtype, minval, maxval) if dist != "bits" else (0, 0)
    lo, hi = (_tn_bounds(dtype, minval, maxval)[2:]
              if dist == "truncated_normal" else (0.0, 0.0))
    tail = (DISTS[dist], int(dtype == torch.bfloat16), mn, span, lo, hi,
            out.data_ptr())
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        if base is None:
            rc = _bind()(table.data_ptr(), table.shape[0], n, *tail, stream)
        else:
            rc = _bind("rsv_threefry_folded")(
                table.data_ptr(), table.shape[0], table.shape[1], n,
                base[0] & M32, base[1] & M32, *tail, stream)
    if rc != 0:
        raise RuntimeError(f"prng: threefry kernel launch failed, "
                           f"cudaError {rc}")


def _fill(table: torch.Tensor, shape: tuple, dist: str, dtype, out, minval,
          maxval, counter, base: Key | None = None) -> torch.Tensor:
    """The card's side of `draw` / `draw_folded`: [R, *shape] from one
    launch over `table` (into `out` when given: contiguous, [R, *shape],
    `dtype`), counted on `counter.launches`."""
    want = (table.shape[0], *shape)
    odt = torch.int64 if dist == "bits" else dtype
    if out is None:
        out = torch.empty(want, device=table.device, dtype=odt)
    elif (tuple(out.shape) != want or not out.is_contiguous()
          or out.dtype != odt):
        raise ValueError(f"prng: out must be a contiguous {odt} tensor of "
                         f"shape {want}, got {out.dtype} {tuple(out.shape)}")
    if out.numel() == 0:
        return out
    n = math.prod(shape)
    if dist == "bits":  # the kernel writes uint32 words
        words = torch.empty(want, dtype=torch.int32, device=table.device)
        launch(table, n, dist, dtype, words, base=base)
        out.copy_(words.to(torch.int64) & M32)
    else:
        launch(table, n, dist, dtype, out, minval, maxval, base)
    counter.launches += 1
    return out


def draw(rows: Sequence, shape: Sequence[int], dist: str = "normal",
         dtype: torch.dtype = torch.float32, device="cpu",
         minval: float = 0.0, maxval: float = 1.0,
         out: torch.Tensor | None = None) -> torch.Tensor:
    """[R, *shape] draws, row r of `rows` = (key, step) from
    fold_in(key, step), or from key itself when step is None; `dist` one of
    bits (int64 values of uint32), uniform (on [minval, maxval)), normal,
    gumbel or truncated_normal (on (minval, maxval)), each fp32 or bf16.
    On the card, one launch of the threefry kernel writes them (into `out`
    when given: contiguous, [R, *shape], `dtype`); on the CPU,
    `draw_plain`."""
    _check_dist(dist, dtype)
    shape = tuple(int(s) for s in shape)
    device = torch.device(out.device if out is not None else device)
    if device.type != "cuda":
        res = draw_plain(rows, shape, dist, dtype, device, minval, maxval)
        return res if out is None else out.copy_(res)
    return _fill(row_table(rows, device).reshape(-1, 3), shape, dist, dtype,
                 out, minval, maxval, draw)


draw.launches = 0


def draw_folded(base: Key, folds: torch.Tensor, shape: Sequence[int] = (),
                dist: str = "normal", dtype: torch.dtype = torch.float32,
                minval: float = 0.0, maxval: float = 1.0,
                out: torch.Tensor | None = None) -> torch.Tensor:
    """[R, *shape] draws on folds' device, row r from fold_in(...fold_in(
    base, folds[r, 0])..., folds[r, L-1]); folds a [R, L] int64 tensor, L
    from 1 to 3; `dist` and `dtype` as `draw`'s. On the card one launch of
    the kernel's device-keyed entry, with no host read (a CUDA graph
    captures it); on the CPU `draw_folded_plain`."""
    _check_dist(dist, dtype)
    folds = _check_folds(folds)
    shape = tuple(int(s) for s in shape)
    if folds.device.type != "cuda":
        res = draw_folded_plain(base, folds, shape, dist, dtype, minval,
                                maxval)
        return res if out is None else out.copy_(res)
    return _fill(folds.contiguous(), shape, dist, dtype, out, minval, maxval,
                 draw_folded, base)


draw_folded.launches = 0


# ------------------------------------------------- jax.random's signatures
def bits(k: Key, shape=(), width: int = 32, device="cpu") -> torch.Tensor:
    """jax.random.bits(k, shape) at width 32 (int64 values of uint32), or
    the low 16 / 8 bits of the same words, which JAX's 16- / 8-bit draws
    take."""
    if width not in (8, 16, 32):
        raise ValueError(f"prng.bits: width {width} is not 8, 16 or 32")
    return draw([(k, None)], shape, "bits", torch.int64, device)[0] & (
        (1 << width) - 1)


def uniform(k: Key, shape=(), dtype=torch.float32, minval: float = 0.0,
            maxval: float = 1.0, device="cpu") -> torch.Tensor:
    """jax.random.uniform(k, shape, dtype, minval, maxval)."""
    return draw([(k, None)], shape, "uniform", dtype, device, minval,
                maxval)[0]


def normal(k: Key, shape=(), dtype=torch.float32, device="cpu") -> torch.Tensor:
    """jax.random.normal(k, shape, dtype)."""
    return draw([(k, None)], shape, "normal", dtype, device)[0]


def truncated_normal(k: Key, lower: float, upper: float, shape=(),
                     dtype=torch.float32, device="cpu") -> torch.Tensor:
    """jax.random.truncated_normal(k, lower, upper, shape, dtype): sqrt(2)
    erf_inv of a uniform on [erf(lower / sqrt2), erf(upper / sqrt2)),
    clamped to the open interval (lower, upper); XLA's erf, so the bounds
    equal JAX's for |bound| < 4.2."""
    return draw([(k, None)], shape, "truncated_normal", dtype, device, lower,
                upper)[0]


def gumbel(k: Key, shape=(), dtype=torch.float32, device="cpu") -> torch.Tensor:
    """jax.random.gumbel(k, shape, dtype) in its default "low" mode."""
    return draw([(k, None)], shape, "gumbel", dtype, device)[0]


def categorical(k: Key, logits: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """jax.random.categorical(k, logits, axis): the argmax over `axis` of
    the logits plus Gumbels drawn over the logits' shape in their dtype."""
    g = gumbel(k, tuple(logits.shape), logits.dtype, logits.device)
    return torch.argmax(g + logits, dim=axis)


def _urem(x, span: int):
    """XLA's unsigned remainder: x itself where the divisor is 0."""
    return x if span == 0 else x % span


def randint(k: Key, shape=(), minval: int = 0, maxval: int = 1,
            device="cpu") -> torch.Tensor:
    """jax.random.randint(k, shape, minval, maxval) for int32 (JAX 0.9's
    _randint): bits of both halves of split(k), reduced modulo the span
    with the uint32 wraps of JAX's arithmetic. minval / maxval are Python
    ints, clipped to int32; maxval <= minval gives minval. Returns int64
    values of the int32 results."""
    lo32, hi32 = -(1 << 31), (1 << 31) - 1
    out_of_range = maxval > hi32
    clip = lambda v: min(max(int(v), lo32), hi32)
    mn, mx = clip(minval), clip(maxval)
    span = (mx - mn) & M32
    if mx <= mn:
        span = 1
    elif out_of_range:
        span = (span + 1) & M32
    mult = _urem(1 << 16, span)
    mult = _urem((mult * mult) & M32, span)
    k1, k2 = split(k)
    hi, lo = draw([(k1, None), (k2, None)], shape, "bits", torch.int64, device)
    off = _urem((_urem(hi, span) * mult + _urem(lo, span)) & M32, span)
    return ((mn + off - lo32) & M32) + lo32

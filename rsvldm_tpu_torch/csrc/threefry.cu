// JAX's threefry-2x32 draws on Hopper, for rsvldm_tpu_torch/utils/prng.py::draw.
//
// Replaces no TPU kernel. The JAX package draws its noise with jax.random,
// which XLA compiles; the port draws the same numbers from the same keys
// (jax_threefry_partitionable layout), so that a seed gives JAX's Stage-1
// noise, caption and Stage-2b noise. It is added as a kernel because the
// path draws about 10^8 numbers a process() (Stage 1's [501, 1, 224, 224, 3]
// normals, the caption's [256, 1, 128256] Gumbels), which a plain PyTorch
// version computes with some 150 elementwise passes over int64 temporaries.
//
// One launch fills out[R][n]. Row r's key is fold_in(key_r, step_r), the
// threefry hash of the counters (0, step_r), or key_r itself where step_r is
// -1 (rsv_threefry, the row table worked out on the host). The folded entry
// (rsv_threefry_folded) takes one base key as two words and an [R][L] table
// of fold words on the device instead: row r's key is fold_in(...fold_in(
// base, w[r][0])..., w[r][L-1]), hashed on the device, so a CUDA graph that
// captured the launch draws the rows of whatever words the table holds at
// each replay (the serving engine's nonces and counts). Element i of a row
// hashes the counters (i >> 32, i & 0xffffffff) under
// the row's key, bits = y0 ^ y1, then:
//   bits    the 32-bit word;
//   uniform [mn, mn + span): the top 23 bits (bf16: bits 1-7 of the low
//           byte) under the exponent of 1.0, minus 1, times span plus mn as
//           one fused multiply-add (bf16: rounded after each step), max(mn, .);
//   normal  sqrt(2) * erf_inv(u) of the uniform on (nextafter(-1, 0), 1),
//           erf_inv the fp32 polynomial XLA lowers chlo.erf_inv to;
//   gumbel  -log(-log(u)) of the uniform on [tiny, 1);
//   truncated_normal  sqrt(2) * erf_inv(u) of the uniform on [mn, mn + span)
//           = [erf(lower / sqrt2), erf(upper / sqrt2)), clamped to [lo, hi]
//           = (nextafter(lower, +inf), nextafter(upper, -inf)), as
//           jax.random.truncated_normal (Flax's lecun_normal init).
// prng.py's plain version computes the same steps with torch ops and passes
// mn, span, lo and hi in (its `_span`, `_tn_bounds`); log and log1p are XLA's
// CPU polynomials written out as IEEE steps on both sides, so the two agree
// bit for bit.
//
// Bound: integer operations. The hash is 20 rounds of add, rotate, xor plus
// the key injections, about 78 32-bit operations a draw, against 4 bytes
// (bf16: 2) written. Design: a grid of (blocks over a row's elements, rows);
// each thread hashes its row's key once, then strides over the row with
// neighbouring threads on neighbouring elements, so stores coalesce. Rotates
// are funnel shifts; every product and sum is written with an explicit
// rounding intrinsic, so nvcc contracts nothing the plain version does not.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;  // elements a thread takes on a full grid

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

template <int A, int B, int C, int D>
__device__ __forceinline__ void four_rounds(uint32_t& x0, uint32_t& x1) {
  x0 += x1; x1 = rotl(x1, A) ^ x0;
  x0 += x1; x1 = rotl(x1, B) ^ x0;
  x0 += x1; x1 = rotl(x1, C) ^ x0;
  x0 += x1; x1 = rotl(x1, D) ^ x0;
}

__device__ __forceinline__ uint2 threefry2x32(uint32_t k0, uint32_t k1,
                                              uint32_t x0, uint32_t x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  x0 += k0; x1 += k1;
  four_rounds<13, 15, 26, 6>(x0, x1);  x0 += k1; x1 += k2 + 1u;
  four_rounds<17, 29, 16, 24>(x0, x1); x0 += k2; x1 += k0 + 2u;
  four_rounds<13, 15, 26, 6>(x0, x1);  x0 += k0; x1 += k1 + 3u;
  four_rounds<17, 29, 16, 24>(x0, x1); x0 += k1; x1 += k2 + 4u;
  four_rounds<13, 15, 26, 6>(x0, x1);  x0 += k2; x1 += k0 + 5u;
  return make_uint2(x0, x1);
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// XLA's fp32 log on the CPU (Cephes' logf as Eigen evaluates it): y =
// m * 2^e with m in [0.5, 1), m below sqrt(1/2) shifted up an octave, t =
// m - 1, a degree-8 polynomial in three parts, every step a fused
// multiply-add (prng.py `_log_f32`)
__device__ __forceinline__ float xla_log(float y) {
  int ei;
  const float m = frexpf(fmaxf(y, 1.17549435e-38f), &ei);
  const bool low = m < 0.707106781186547524f;
  const float t = __fadd_rn(__fadd_rn(m, -1.0f), low ? m : 0.0f);
  const float e = __fsub_rn((float)ei, low ? 1.0f : 0.0f);
  const float t2 = __fmul_rn(t, t), t3 = __fmul_rn(t2, t);
  const float a = fmaf(fmaf(7.0376836292e-2f, t, -1.1514610310e-1f), t,
                       1.1676998740e-1f);
  const float b = fmaf(fmaf(-1.2420140846e-1f, t, 1.4249322787e-1f), t,
                       -1.6668057665e-1f);
  const float c = fmaf(fmaf(2.0000714765e-1f, t, -2.4999993993e-1f), t,
                       3.3333331174e-1f);
  float r = __fmul_rn(fmaf(fmaf(a, t3, b), t3, c), t3);
  r = fmaf(e, -2.12194440e-4f, r);
  return fmaf(e, 0.693359375f, __fadd_rn(fmaf(t2, -0.5f, t), r));
}

// XLA's fp32 log1p on the CPU: the Cephes rational x - x^2 / 2 + x^3 P / Q
// below sqrt(2) - 1 in magnitude (Horner steps as fused multiply-adds),
// else log(1 + x) (prng.py `_log1p_f32`)
__device__ __forceinline__ float xla_log1p(float x) {
  float num = 4.5270000862445199635215e-5f;
  num = fmaf(num, x, 4.9854102823193375972212e-1f);
  num = fmaf(num, x, 6.5787325942061044846969e0f);
  num = fmaf(num, x, 2.9911919328553073277375e1f);
  num = fmaf(num, x, 6.0949667980987787057556e1f);
  num = fmaf(num, x, 5.7112963590585538103336e1f);
  num = fmaf(num, x, 2.0039553499201281259648e1f);
  float den = 1.0f;
  den = fmaf(den, x, 1.5062909083469192043167e1f);
  den = fmaf(den, x, 8.3047565967967209469434e1f);
  den = fmaf(den, x, 2.2176239823732856465394e2f);
  den = fmaf(den, x, 3.0909872225312059774938e2f);
  den = fmaf(den, x, 2.1642788614495947685003e2f);
  den = fmaf(den, x, 6.0118660497603843919306e1f);
  const float x2 = __fmul_rn(x, x);
  const float small = __fadd_rn(
      x, __fadd_rn(__fmul_rn(-0.5f, x2),
                   __fmul_rn(__fmul_rn(x, x2), __fdiv_rn(num, den))));
  return fabsf(x) < 0.41421356237309504880f ? small
                                            : xla_log(__fadd_rn(x, 1.0f));
}

// XLA's fp32 erf_inv (Giles): w = -log1p(-x^2), Horner over w - 2.5 below
// 5, over sqrt(w) - 3 above, each step one fused multiply-add
__device__ __forceinline__ float erf_inv(float x) {
  const float w = -xla_log1p(__fmul_rn(x, -x));
  const bool lt = w < 5.0f;
  const float s = lt ? __fadd_rn(w, -2.5f) : __fadd_rn(sqrtf(w), -3.0f);
  float p = lt ? 2.81022636e-08f : -0.000200214257f;
  p = fmaf(p, s, lt ? 3.43273939e-07f : 0.000100950558f);
  p = fmaf(p, s, lt ? -3.5233877e-06f : 0.00134934322f);
  p = fmaf(p, s, lt ? -4.39150654e-06f : -0.00367342844f);
  p = fmaf(p, s, lt ? 0.00021858087f : 0.00573950773f);
  p = fmaf(p, s, lt ? -0.00125372503f : -0.0076224613f);
  p = fmaf(p, s, lt ? -0.00417768164f : 0.00943887047f);
  p = fmaf(p, s, lt ? 0.246640727f : 1.00167406f);
  p = fmaf(p, s, lt ? 1.50140941f : 2.83297682f);
  return fabsf(x) == 1.0f ? __fmul_rn(x, INFINITY) : __fmul_rn(p, x);
}

template <bool BF16>
__device__ __forceinline__ float uniform(uint32_t bits, float mn, float span) {
  if (BF16) {
    const float f = __uint_as_float((((bits & 0xFFu) >> 1) | 0x3F80u) << 16);
    const float v = round_bf16(__fadd_rn(
        round_bf16(__fmul_rn(round_bf16(__fadd_rn(f, -1.0f)), span)), mn));
    return fmaxf(mn, v);
  }
  const float f = __fadd_rn(__uint_as_float((bits >> 9) | 0x3F800000u), -1.0f);
  return fmaxf(mn, fmaf(f, span, mn));
}

enum Dist { kBits = 0, kUniform = 1, kNormal = 2, kGumbel = 3,
            kTruncNormal = 4 };

template <int DIST, bool BF16>
__device__ __forceinline__ float transform(uint32_t bits, float mn, float span,
                                           float lo, float hi) {
  const float u = uniform<BF16>(bits, mn, span);
  if (DIST == kTruncNormal) {
    // lo and hi are values of the draw's dtype, so clamping the rounded
    // product is clamping and then rounding
    const float v =
        BF16 ? round_bf16(__fmul_rn(1.4140625f, round_bf16(erf_inv(u))))
             : __fmul_rn(1.41421356237309505f, erf_inv(u));
    return fminf(fmaxf(v, lo), hi);
  }
  if (DIST == kUniform) return u;
  if (DIST == kGumbel) {
    const float a = BF16 ? round_bf16(xla_log(u)) : xla_log(u);
    const float b = BF16 ? round_bf16(xla_log(-a)) : xla_log(-a);
    return -b;
  }
  if (BF16) return __fmul_rn(1.4140625f, round_bf16(erf_inv(u)));
  return __fmul_rn(1.41421356237309505f, erf_inv(u));
}

// L == 0: rows is the host-keyed table [R][3] (k0, k1, step or -1);
// L >= 1: rows is the fold-word table [R][L] under the base key (bk0, bk1)
template <int DIST, bool BF16>
__global__ void __launch_bounds__(kThreads)
threefry_kernel(const long long* __restrict__ rows, int R, int L, long long n,
                uint32_t bk0, uint32_t bk1, float mn, float span, float lo,
                float hi, void* __restrict__ out) {
  const long long stride = (long long)gridDim.x * kThreads;
  for (int r = blockIdx.y; r < R; r += gridDim.y) {
    uint32_t k0, k1;
    if (L > 0) {
      k0 = bk0; k1 = bk1;
      for (int l = 0; l < L; ++l) {
        const uint2 k =
            threefry2x32(k0, k1, 0u, (uint32_t)rows[(long long)r * L + l]);
        k0 = k.x; k1 = k.y;
      }
    } else {
      k0 = (uint32_t)rows[3 * r]; k1 = (uint32_t)rows[3 * r + 1];
      const long long step = rows[3 * r + 2];
      if (step >= 0) {
        const uint2 k = threefry2x32(k0, k1, 0u, (uint32_t)step);
        k0 = k.x; k1 = k.y;
      }
    }
    const long long base = (long long)r * n;
    for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n;
         i += stride) {
      const uint2 y = threefry2x32(k0, k1, (uint32_t)(i >> 32), (uint32_t)i);
      const uint32_t bits = y.x ^ y.y;
      if (DIST == kBits) {
        static_cast<uint32_t*>(out)[base + i] = bits;
      } else if (BF16) {
        static_cast<__nv_bfloat16*>(out)[base + i] =
            __float2bfloat16_rn(transform<DIST, true>(bits, mn, span, lo, hi));
      } else {
        static_cast<float*>(out)[base + i] =
            transform<DIST, false>(bits, mn, span, lo, hi);
      }
    }
  }
}

template <int DIST, bool BF16>
cudaError_t launch(const long long* rows, int R, int L, long long n,
                   uint32_t bk0, uint32_t bk1, float mn, float span, float lo,
                   float hi, void* out, cudaStream_t st) {
  long long bx = (n + (long long)kThreads * kPerThread - 1) /
                 ((long long)kThreads * kPerThread);
  if (bx > 65535) bx = 65535;  // the stride loop covers the rest
  const dim3 grid((unsigned)bx, (unsigned)(R < 65535 ? R : 65535));
  threefry_kernel<DIST, BF16><<<grid, kThreads, 0, st>>>(
      rows, R, L, n, bk0, bk1, mn, span, lo, hi, out);
  return cudaGetLastError();
}

int dispatch(const void* rows, int R, int L, long long n, uint32_t bk0,
             uint32_t bk1, int dist, int bf16, float mn, float span, float lo,
             float hi, void* out, void* stream) {
  if (R <= 0 || n <= 0 || dist < kBits || dist > kTruncNormal ||
      (bf16 && dist == kBits) || rows == nullptr || out == nullptr)
    return (int)cudaErrorInvalidValue;
  const long long* rw = static_cast<const long long*>(rows);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
#define RSV_CASE(D, B) \
  launch<D, B>(rw, R, L, n, bk0, bk1, mn, span, lo, hi, out, st)
  switch (dist * 2 + (bf16 ? 1 : 0)) {
    case kBits * 2: e = RSV_CASE(kBits, false); break;
    case kUniform * 2: e = RSV_CASE(kUniform, false); break;
    case kUniform * 2 + 1: e = RSV_CASE(kUniform, true); break;
    case kNormal * 2: e = RSV_CASE(kNormal, false); break;
    case kNormal * 2 + 1: e = RSV_CASE(kNormal, true); break;
    case kGumbel * 2: e = RSV_CASE(kGumbel, false); break;
    case kGumbel * 2 + 1: e = RSV_CASE(kGumbel, true); break;
    case kTruncNormal * 2: e = RSV_CASE(kTruncNormal, false); break;
    case kTruncNormal * 2 + 1: e = RSV_CASE(kTruncNormal, true); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef RSV_CASE
  return (int)e;
}

}  // namespace

// rows: [R, 3] int64 on the device (k0, k1, step or -1); out: R * n
// elements (uint32 words for bits, else fp32 or bf16). mn, span: the
// uniform's lower end and width in the draw's dtype (prng.py `_span`);
// lo, hi: truncated_normal's clamp (prng.py `_tn_bounds`), else unused.
extern "C" int rsv_threefry(const void* rows, int R, long long n, int dist,
                            int bf16, float mn, float span, float lo, float hi,
                            void* out, void* stream) {
  return dispatch(rows, R, 0, n, 0u, 0u, dist, bf16, mn, span, lo, hi, out,
                  stream);
}

// folds: [R, L] int64 fold words on the device (1 <= L <= 3, each taken as
// uint32) under the base key (k0, k1); out, mn, span, lo, hi as
// rsv_threefry's.
extern "C" int rsv_threefry_folded(const void* folds, int R, int L,
                                   long long n, uint32_t k0, uint32_t k1,
                                   int dist, int bf16, float mn, float span,
                                   float lo, float hi, void* out,
                                   void* stream) {
  if (L < 1 || L > 3) return (int)cudaErrorInvalidValue;
  return dispatch(folds, R, L, n, k0, k1, dist, bf16, mn, span, lo, hi, out,
                  stream);
}

// K2: int4 weight-only product for decode (R <= 32 rows) on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_int4_decode_kernel` / `int4_matmul_pallas`
// in rsvldm_tpu/ops/quant.py. Same function: y[r, c] = sum over 128-row
// groups g of xs[r, g] * ws[g, c] * sum_k xq[r, g*128 + k] * q[g*128 + k, c],
// with xq the int8 activations quantized per (row, 128-group) outside the
// kernel, q the int4 weights and every group sum an exact int32.
//
// Weight layout, byte-identical to the JAX package: packed int8 [in/2, out],
// row-major; byte (j, c) holds weight row j in its low nibble, stored +8
// (values 1..15), and weight row j + in/2 in its high nibble, two's
// complement. With in % 256 == 0, packed rows [128p, 128p + 128) hold group p
// of the low plane and group p + in/256 of the high plane.
//
// Design for the card, not carried over from the TPU grid. The TPU kernel
// carries an fp32 accumulator in VMEM across a sequential contraction grid
// axis and, lacking int8 shifts on its vector unit, removes the low plane's
// +8 bias with a correction matmul and folds a /16 into the high plane's
// scales. Here shifts are free, so each byte is unpacked in registers to its
// two signed values and no correction is needed. Blocks cannot carry a sum,
// so the contraction is split across blocks: block (x, p) owns 512 output
// columns and packed rows [128p, 128p + 128) (one low and one high group).
// Each of its 8 warps reads 16 of those rows; each lane reads 16 consecutive
// columns of a row with one 16-byte load, so a warp reads 512 contiguous
// bytes. Every packed byte is read once. The warps' int32 group sums meet in
// shared memory, both scales are applied to the exact sum, and the block
// writes an fp32 partial [p, r, c]. A second small kernel sums the partials
// over p in a fixed order: no atomics, the result is deterministic.
//
// Bound on an H100 SXM (3.35 TB/s): about 0.5 byte and 2*R integer
// multiply-adds per weight, so bytes bound it. At R = 1 the packed weight and
// its scales are 8.39 + 0.52 MB for 4096x4096 (2.66 us), 29.4 + 1.8 MB for
// 4096x14336 and 14336x4096 (9.31 us), 263 + 16 MB for the 4096x128256
// lm_head (83 us); one Llama-3-8B decode step (224 projections and the
// lm_head) reads 3.99 GB: 1.19 ms. This first version has no TMA, no
// tensor-core s8 product and no pipelining; those are the levers left.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int COLS = 16;                    // columns per lane: one 16-byte load
constexpr int TILE_N = 32 * COLS;           // 512 columns per block
constexpr int GROUP = 128;                  // packed rows per block
constexpr int ROWS = GROUP / WARPS;         // 16 packed rows per warp
constexpr int MAX_R = 32;
constexpr int RED_STRIDE = COLS + 1;        // odd stride: no bank conflicts

// 16 packed bytes of one row, columns c0..c0+15 (bytes past `out` read as 0).
__device__ __forceinline__ uint4 load16(const int8_t* row, int c0, int out,
                                        int vec) {
  if (vec) return __ldg(reinterpret_cast<const uint4*>(row + c0));
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int i = 0; i < COLS; ++i)
    if (c0 + i < out)
      w[i / 4] |= (uint32_t)(uint8_t)row[c0 + i] << (8 * (i % 4));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__global__ void __launch_bounds__(THREADS)
int4_decode_kernel(const int8_t* __restrict__ xq,      // [R, in]
                   const float* __restrict__ xs,       // [R, in/128]
                   const int8_t* __restrict__ packed,  // [in/2, out]
                   const float* __restrict__ ws,       // [in/128, out]
                   float* __restrict__ partial,        // [in/256, R, out]
                   int R, int in, int out, int vec) {
  __shared__ int8_t xsh[MAX_R][2 * GROUP];
  __shared__ int red[WARPS][2][32 * RED_STRIDE];
  const int p = blockIdx.y;
  const int npairs = gridDim.y;
  const int gb = in / GROUP;
  const int half = in / 2;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int tile0 = blockIdx.x * TILE_N;
  const int c0 = tile0 + lane * COLS;

  // activations of the block's two groups: [0, 128) low plane, [128, 256) high
  for (int i = threadIdx.x; i < R * 2 * GROUP; i += THREADS) {
    const int r = i / (2 * GROUP), k = i % (2 * GROUP);
    const int col = k < GROUP ? p * GROUP + k : half + p * GROUP + (k - GROUP);
    xsh[r][k] = xq[(long long)r * in + col];
  }
  // this lane's 16 columns of the warp's 16 packed rows, read once
  uint4 wv[ROWS];
  const int row0 = p * GROUP + warp * ROWS;
#pragma unroll
  for (int i = 0; i < ROWS; ++i)
    wv[i] = c0 < out ? load16(packed + (long long)(row0 + i) * out, c0, out, vec)
                     : make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();

  for (int r = 0; r < R; ++r) {
    // the unpacked nibbles do not depend on r: without this the compiler
    // hoists all 512 of them out of the loop and spills
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
      asm volatile("" : "+r"(wv[i].x), "+r"(wv[i].y), "+r"(wv[i].z),
                   "+r"(wv[i].w));
    int alo[COLS], ahi[COLS];
#pragma unroll
    for (int c = 0; c < COLS; ++c) alo[c] = ahi[c] = 0;
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int xl = xsh[r][warp * ROWS + i];
      const int xh = xsh[r][GROUP + warp * ROWS + i];
      const uint32_t wd[4] = {wv[i].x, wv[i].y, wv[i].z, wv[i].w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int lo = (int)((wd[j] >> (8 * b)) & 0xFu) - 8;
          const int hi = ((int)(wd[j] << (24 - 8 * b))) >> 28;  // sign-extends
          alo[4 * j + b] += xl * lo;
          ahi[4 * j + b] += xh * hi;
        }
      }
    }
#pragma unroll
    for (int c = 0; c < COLS; ++c) {
      red[warp][0][lane * RED_STRIDE + c] = alo[c];
      red[warp][1][lane * RED_STRIDE + c] = ahi[c];
    }
    __syncthreads();
    // exact int32 group sums over the 8 warps, then both scales on each
    const float xs_lo = xs[r * gb + p];
    const float xs_hi = xs[r * gb + p + npairs];
    for (int cc = threadIdx.x; cc < TILE_N; cc += THREADS) {
      const int col = tile0 + cc;
      if (col < out) {
        const int idx = (cc / COLS) * RED_STRIDE + cc % COLS;
        int slo = 0, shi = 0;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) {
          slo += red[w][0][idx];
          shi += red[w][1][idx];
        }
        const float ylo = (float)slo * xs_lo * ws[(long long)p * out + col];
        const float yhi =
            (float)shi * xs_hi * ws[(long long)(p + npairs) * out + col];
        partial[((long long)p * R + r) * out + col] = ylo + yhi;
      }
    }
    __syncthreads();
  }
}

// y[i] = sum over s of partial[s, i], s in order.
__global__ void sum_splits_kernel(const float* __restrict__ partial,
                                  float* __restrict__ y, int splits,
                                  long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float acc = 0.f;
  for (int s = 0; s < splits; ++s) acc += partial[(long long)s * n + i];
  y[i] = acc;
}

}  // namespace

// Plain C entry point (bound with ctypes). `partial` is fp32 scratch of
// in/256 * R * out elements, `y` the fp32 [R, out] result. vec = 1 takes
// 16-byte loads and needs out % 16 == 0 and a 16-byte aligned `packed`.
// Returns a cudaError_t value; 0 means both launches were accepted.
extern "C" int rsv_int4_decode(const void* xq, const void* xs,
                               const void* packed, const void* ws,
                               void* partial, void* y, int R, int in, int out,
                               int vec, void* stream) {
  if (R <= 0 || R > MAX_R || in <= 0 || in % (2 * GROUP) != 0 || out <= 0 ||
      (vec && out % COLS != 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int npairs = in / (2 * GROUP);
  const dim3 grid((out + TILE_N - 1) / TILE_N, npairs);
  int4_decode_kernel<<<grid, THREADS, 0, st>>>(
      static_cast<const int8_t*>(xq), static_cast<const float*>(xs),
      static_cast<const int8_t*>(packed), static_cast<const float*>(ws),
      static_cast<float*>(partial), R, in, out, vec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long n = (long long)R * out;
  sum_splits_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
      static_cast<const float*>(partial), static_cast<float*>(y), npairs, n);
  return (int)cudaGetLastError();
}

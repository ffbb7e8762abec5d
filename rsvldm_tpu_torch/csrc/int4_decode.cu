// K2: int4 weight-only product for decode (R <= 32 rows) on Hopper (sm_90a),
// one launch per projection.
//
// Replaces the Pallas TPU kernel `_int4_decode_kernel` / `int4_matmul_pallas`
// in rsvldm_tpu/ops/quant.py (with the activation quantization and the bias
// correction its wrapper does around it). Same function: x [R, in] (bf16 or
// fp32) is quantized per (row, 128-group), s = max(amax / 127, 1e-12) and
// xq = clamp(rint(x / s), -127, 127) with correctly rounded divisions, as
// `quantize_acts_grouped`; then y[r, c] = sum over groups g of
// xs[r, g] * ws[g, c] * sum_k xq[r, g*128 + k] * q[g*128 + k, c], every
// group sum an exact integer, the groups summed in fp32, y written in bf16
// or fp32.
//
// Weight layout, byte-identical to the JAX package: packed int8 [in/2, out],
// row-major; byte (j, c) holds weight row j in its low nibble, stored +8
// (values 1..15), and weight row j + in/2 in its high nibble, two's
// complement. With in % 256 == 0, packed rows [128p, 128p + 128) ("pair p")
// hold group p of the low plane and group p + in/256 of the high plane.
//
// Bound on an H100 SXM (3.35 TB/s): about 0.5 byte and 2*R integer
// operations per weight, so bytes bound it. At R = 1 the packed weight and
// its scales are 8.39 + 0.52 MB for q/o 4096x4096 (2.66 us), 2.10 + 0.13 MB
// for k/v 4096x1024 (0.67 us), 29.4 + 1.8 MB for gate/up 4096x14336 and down
// 14336x4096 (9.31 us), 263 + 16 MB for the 4096x128256 lm_head (83 us); one
// Llama-3-8B decode step (224 projections and the lm_head) reads 3.99 GB:
// 1.19 ms.
//
// What limited the first version, and what this one does about each:
// 1. Its grid was one block per 512 columns and group pair: 32 blocks for
//    k/v on 132 SMs. Here the column tile (64, 128 or 256) and the split of
//    the contraction into pair ranges are chosen per shape by the wrapper
//    (`k2_plan` in ops/quant.py) so every decode shape has at least 132
//    blocks: q/o 256 blocks of 128 columns in 8 splits, k/v 256 of 64 in
//    16, gate/up 224 of 256 in 4, down 224 of 128 in 7, the lm_head 501 of
//    256 unsplit. Up to three blocks share an SM.
// 2. Its loads were one burst per warp, all compute waiting on it. Here a
//    block streams its pairs through a ring of up to 8 stages in shared
//    memory (64 KB), filled with cp.async 16-byte copies that bypass L1:
//    the copies of the next stages are in flight while a stage is unpacked,
//    and the first ones are issued before the activations are quantized.
// 3. It unpacked byte by byte: two bit-field extracts and two multiply-adds
//    per byte. Here the plane format's own algebra runs on whole words, as
//    the TPU kernel's does: w & 0x0F0F0F0F gives four biased low nibbles
//    (q + 8, 0..15) and w & 0xF0F0F0F0 four signed bytes 16*q. A word holds
//    4 columns of one packed row; a 4x4 byte transpose of 4 rows' words
//    (8 __byte_perm) gives each column 4 contraction values, which meet 4
//    activation codes in one __dp4a. Per 16 bytes at R = 1: 8 byte
//    permutes, 8 masks, 8 dp4a, about 1.5 integer operations per byte
//    against 4. The +8 bias comes off each exact group sum as 8 * sum(xq)
//    (the prologue keeps the code sums), and the high plane's sum is exactly
//    16x the true one, so it is shifted back: every group sum stays exact.
//    The s8 dot products go to dp4a rather than mma.sync m16n8k32: decode
//    has R = 1, where an MMA tile would be 1/16 used and would need its
//    B fragments permuted, and dp4a is already far below the byte bound.
// 4. A second launch summed the contraction splits, and the wrapper added
//    nine quantization launches and a cast: 12 launches per projection.
//    Here the block quantizes its own slice of x in a prologue (at most 16
//    pairs: 4096 codes a row), and the splits of a column tile are one
//    thread-block cluster: each block leaves its fp32 sums in its shared
//    memory, and after a cluster barrier block 0 reads them all through
//    distributed shared memory, in split order, and writes y in its final
//    type. One launch, no workspace in device memory, deterministic. (A
//    first version of this design summed the splits through device memory,
//    the last block to arrive at a per-tile counter reading the others'
//    partials; its fence, atomic and re-read cost about 1.5 us a launch.)
//
// Inside a block (256 threads): thread t owns column quad t % (TN/4) and a
// slice of the pair's 128 rows; its int32 sums for those rows meet the
// other slices' in shared memory once per pair; each output (plane, row,
// column) has one owner thread that applies both scales, float(sum) * xs *
// ws as the plain version does, and sums the pairs in order. Larger R runs
// in chunks of RB rows, one grid layer per chunk.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int GROUP = 128;          // contraction rows per scale group
constexpr int PAIR = GROUP;         // packed rows per pair
constexpr int MAX_R = 32;
constexpr int MAX_PAIRS = 16;       // pairs per block: the prologue's codes
constexpr int MAX_SPLITS = 16;      // blocks of a cluster (non-portable > 8)
constexpr int RING_BYTES = 64 * 1024;
constexpr int MAX_DEVICES = 64;     // launch attributes remembered per device

template <int TN>
struct Geo {
  static constexpr int QN = TN / 4;              // column quads
  static constexpr int SLICES = THREADS / QN;    // row slices of a pair
  static constexpr int RS = PAIR / SLICES;       // packed rows per slice
  static constexpr int UNITS = RS / 4;           // 4-row units per thread
  static constexpr int STAGE = PAIR * TN;        // bytes per stage
  static constexpr int STAGES = RING_BYTES / STAGE;
  static constexpr int CHUNKS = STAGE / 16 / THREADS;  // copies per thread
  static_assert(THREADS % QN == 0 && RS % 4 == 0 && CHUNKS >= 1, "tile");
  static_assert(STAGES >= 2 && STAGES <= 8, "cp_async_wait takes 0..7");
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Until at most n (0..7) of this thread's copy groups are incomplete.
__device__ __forceinline__ void cp_async_wait(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::: "memory"); break;
    case 6: asm volatile("cp.async.wait_group 6;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 7;\n" ::: "memory"); break;
  }
}

// Shared memory of one block; the host computes the same size.
template <int TN, int RB>
struct Smem {
  static constexpr int RED = Geo<TN>::SLICES * 2 * RB * TN;  // ints
  static __host__ __device__ size_t bytes(int stages) {
    return (size_t)stages * Geo<TN>::STAGE + RED * 4 +
           RB * 2 * MAX_PAIRS * GROUP + RB * 2 * MAX_PAIRS * 4 +
           RB * MAX_PAIRS * 4;
  }
};

// one row: three blocks an SM (at most 80 registers), two at 256 columns,
// where 80 registers spill; more rows: one block, unspilled
template <int TN, int RB>
__global__ void __launch_bounds__(THREADS, RB > 1 ? 1 : TN == 256 ? 2 : 3)
int4_decode_kernel(const void* __restrict__ x, int x_bf16,
                   const uint8_t* __restrict__ packed,  // [in/2, out]
                   const float* __restrict__ ws,        // [in/128, out]
                   void* __restrict__ y, int y_bf16,    // [R, out]
                   int R, int in, int out, int vec, int stages) {
  using G = Geo<TN>;
  constexpr int NOUT = (2 * RB * TN + THREADS - 1) / THREADS;
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* ring = smem;
  int* red = reinterpret_cast<int*>(smem + (size_t)stages * G::STAGE);
  int8_t* xq = reinterpret_cast<int8_t*>(red + Smem<TN, RB>::RED);
  float* xs = reinterpret_cast<float*>(xq + RB * 2 * MAX_PAIRS * GROUP);
  int* xsum = reinterpret_cast<int*>(xs + RB * 2 * MAX_PAIRS);

  const int tid = threadIdx.x;
  const int npairs = in / (2 * GROUP);
  const int tile0 = blockIdx.x * TN;
  const int split = blockIdx.y, splits = gridDim.y;
  const int r0 = blockIdx.z * RB;
  const int p0 = (int)((long long)npairs * split / splits);
  const int np = (int)((long long)npairs * (split + 1) / splits) - p0;

  // stage i: packed rows of pair p0 + i, columns [tile0, tile0 + TN), into
  // ring slot i % stages; one copy group per call, empty past the last pair
  auto issue = [&](int i) {
    if (i < np) {
      uint8_t* dst = ring + (size_t)(i % stages) * G::STAGE;
      const uint8_t* src = packed + (long long)(p0 + i) * PAIR * out + tile0;
#pragma unroll
      for (int k = 0; k < G::CHUNKS; ++k) {
        const int c = tid + k * THREADS;
        const int row = c / (TN / 16), col = (c % (TN / 16)) * 16;
        const uint8_t* s = src + (long long)row * out + col;
        if (vec) {
          const bool in_range = tile0 + col < out;
          cp_async16(dst + row * TN + col, in_range ? s : packed,
                     in_range ? 16 : 0);
        } else {
          uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
          for (int b = 0; b < 16; ++b)
            if (tile0 + col + b < out)
              w[b / 4] |= (uint32_t)__ldg(s + b) << (8 * (b % 4));
          *reinterpret_cast<uint4*>(dst + row * TN + col) =
              make_uint4(w[0], w[1], w[2], w[3]);
        }
      }
    }
    cp_async_commit();
  };

  for (int i = 0; i < stages - 1; ++i) issue(i);

  // prologue: quantize this block's groups of x, one warp per (row, group):
  // local group lg < np is low group p0 + lg, lg >= np high group
  // npairs + p0 + lg - np
  {
    const int warp = tid >> 5, lane = tid & 31;
    for (int t = warp; t < RB * 2 * np; t += THREADS / 32) {
      const int r = t / (2 * np), lg = t % (2 * np);
      const int g = lg < np ? p0 + lg : npairs + p0 + (lg - np);
      const int row = r0 + r;
      float v[4] = {0.f, 0.f, 0.f, 0.f};
      if (row < R) {
        const long long base = (long long)row * in + (long long)g * GROUP +
                               lane * 4;
#pragma unroll
        for (int k = 0; k < 4; ++k)
          v[k] = x_bf16 ? __bfloat162float(
                              static_cast<const __nv_bfloat16*>(x)[base + k])
                        : static_cast<const float*>(x)[base + k];
      }
      float amax = fmaxf(fmaxf(fabsf(v[0]), fabsf(v[1])),
                         fmaxf(fabsf(v[2]), fabsf(v[3])));
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
      const float s = fmaxf(__fdiv_rn(amax, 127.0f), 1e-12f);
      uint32_t word = 0u;
      int sum = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int q = (int)fminf(fmaxf(rintf(__fdiv_rn(v[k], s)), -127.0f),
                                 127.0f);
        sum += q;
        word |= (uint32_t)(q & 0xff) << (8 * k);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      *reinterpret_cast<uint32_t*>(
          xq + (r * 2 * MAX_PAIRS + lg) * GROUP + lane * 4) = word;
      if (lane == 0) {
        xs[r * 2 * MAX_PAIRS + lg] = s;
        if (lg < np) xsum[r * MAX_PAIRS + lg] = sum;
      }
    }
  }

  const int quad = tid % G::QN, slice = tid / G::QN;
  float yacc[NOUT], wsv[NOUT];
#pragma unroll
  for (int o = 0; o < NOUT; ++o) yacc[o] = wsv[o] = 0.f;

  // the owner of output (plane, r, col): index tid + o * THREADS
  auto reduce = [&](int i) {
#pragma unroll
    for (int o = 0; o < NOUT; ++o) {
      const int idx = tid + o * THREADS;
      if (idx < 2 * RB * TN) {
        const int plane = idx / (RB * TN), rem = idx % (RB * TN);
        const int r = rem / TN, col = rem % TN;
        int sum = 0;
#pragma unroll
        for (int sl = 0; sl < G::SLICES; ++sl)
          sum += red[((sl * 2 + plane) * RB + r) * TN + col];
        sum = plane ? sum >> 4 : sum - 8 * xsum[r * MAX_PAIRS + i];
        const float scale = xs[r * 2 * MAX_PAIRS + (plane ? np + i : i)];
        yacc[o] += (float)sum * scale * wsv[o];
      }
    }
  };

  for (int i = 0; i < np; ++i) {
    __syncthreads();  // stage i - 1 read from its slot, its sums in red
    issue(i + stages - 1);
    if (i > 0) reduce(i - 1);
#pragma unroll
    for (int o = 0; o < NOUT; ++o) {
      const int idx = tid + o * THREADS;
      const int plane = idx / (RB * TN), col = idx % TN;
      const int g = plane ? npairs + p0 + i : p0 + i;
      wsv[o] = idx < 2 * RB * TN && tile0 + col < out
                   ? __ldg(ws + (long long)g * out + tile0 + col)
                   : 0.f;
    }
    cp_async_wait(stages - 1);  // this thread's copies of stage i landed
    __syncthreads();  // everyone's, the prologue's codes; red read

    const uint8_t* st = ring + (size_t)(i % stages) * G::STAGE;
    int acc[RB][2][4];
#pragma unroll
    for (int r = 0; r < RB; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][0][c] = acc[r][1][c] = 0;
#pragma unroll
    for (int u = 0; u < G::UNITS; ++u) {
      const int j = slice * G::RS + 4 * u;  // packed row within the pair
      const uint8_t* wp = st + j * TN + 4 * quad;
      const uint32_t w0 = *reinterpret_cast<const uint32_t*>(wp);
      const uint32_t w1 = *reinterpret_cast<const uint32_t*>(wp + TN);
      const uint32_t w2 = *reinterpret_cast<const uint32_t*>(wp + 2 * TN);
      const uint32_t w3 = *reinterpret_cast<const uint32_t*>(wp + 3 * TN);
      // 4x4 byte transpose: t[c] holds column c of rows j..j+3
      const uint32_t a = __byte_perm(w0, w1, 0x5140);
      const uint32_t b = __byte_perm(w0, w1, 0x7362);
      const uint32_t e = __byte_perm(w2, w3, 0x5140);
      const uint32_t f = __byte_perm(w2, w3, 0x7362);
      const uint32_t t[4] = {__byte_perm(a, e, 0x5410),
                             __byte_perm(a, e, 0x7632),
                             __byte_perm(b, f, 0x5410),
                             __byte_perm(b, f, 0x7632)};
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        const int xl = *reinterpret_cast<const int*>(
            xq + (r * 2 * MAX_PAIRS + i) * GROUP + j);
        const int xh = *reinterpret_cast<const int*>(
            xq + (r * 2 * MAX_PAIRS + np + i) * GROUP + j);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          acc[r][0][c] = __dp4a((int)(t[c] & 0x0F0F0F0Fu), xl, acc[r][0][c]);
          acc[r][1][c] = __dp4a((int)(t[c] & 0xF0F0F0F0u), xh, acc[r][1][c]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < RB; ++r)
#pragma unroll
      for (int p = 0; p < 2; ++p)
        *reinterpret_cast<int4*>(red + ((slice * 2 + p) * RB + r) * TN +
                                 4 * quad) =
            make_int4(acc[r][p][0], acc[r][p][1], acc[r][p][2], acc[r][p][3]);
  }
  __syncthreads();
  reduce(np - 1);
  __syncthreads();

  // low plane + high plane: y (one split) or this split's sum in shared
  // memory, where block 0 of the cluster reads every split's in order
  float* comb = reinterpret_cast<float*>(red);  // [RB][TN]
#pragma unroll
  for (int o = 0; o < NOUT; ++o) {
    const int idx = tid + o * THREADS;
    if (idx >= RB * TN && idx < 2 * RB * TN) comb[idx - RB * TN] = yacc[o];
  }
  __syncthreads();
  auto store = [&](int idx, float v) {
    const int row = r0 + idx / TN, col = tile0 + idx % TN;
    if (row < R && col < out) {
      const long long at = (long long)row * out + col;
      if (y_bf16)
        static_cast<__nv_bfloat16*>(y)[at] = __float2bfloat16_rn(v);
      else
        static_cast<float*>(y)[at] = v;
    }
  };
#pragma unroll
  for (int o = 0; o < NOUT; ++o) {
    const int idx = tid + o * THREADS;
    if (idx < RB * TN) {
      const float v = yacc[o] + comb[idx];
      if (splits == 1)
        store(idx, v);
      else
        comb[idx] = v;
    }
  }
  if (splits == 1) return;

  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every split's sums are in its block's shared memory
  if (split == 0) {
    for (int idx = tid; idx < RB * TN; idx += THREADS) {
      float v = 0.f;
      for (int s = 0; s < splits; ++s)
        v += cluster.map_shared_rank(comb, s)[idx];
      store(idx, v);
    }
  }
  cluster.sync();  // block 0 has read them: the blocks may exit
}

template <int TN, int RB>
int launch(const void* x, int x_bf16, const void* packed, const void* ws,
           void* y, int y_bf16, int R, int in, int out, int splits, int vec,
           cudaStream_t st) {
  using G = Geo<TN>;
  const auto kernel = int4_decode_kernel<TN, RB>;
  const int npairs = in / (2 * GROUP);
  const int most = (npairs + splits - 1) / splits;  // pairs of a block, at most
  const int stages = most < G::STAGES ? most : G::STAGES;
  const size_t smem = Smem<TN, RB>::bytes(stages);
  // the attributes belong to the current device's copy of the kernel: set
  // them once per device and instantiation, again when more memory is asked
  static size_t granted[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= MAX_DEVICES || smem > granted[dev]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
    if (dev < MAX_DEVICES) granted[dev] = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((out + TN - 1) / TN, splits, (R + RB - 1) / RB);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = 1;
  cluster.val.clusterDim.y = splits;  // a cluster holds a tile's splits
  cluster.val.clusterDim.z = 1;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, kernel, x, x_bf16, static_cast<const uint8_t*>(packed),
      static_cast<const float*>(ws), y, y_bf16, R, in, out, vec, stages);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes). x is bf16 (x_bf16 = 1) or fp32
// [R, in]; y is bf16 (y_bf16 = 1) or fp32 [R, out]. The wrapper's plan
// gives the column tile tn (64, 128, 256), the rows per chunk rb (1, 2, 4)
// and the number of contraction splits (1..16, at most 16 pairs each; the
// splits of a column tile form one thread-block cluster). vec = 1 takes
// 16-byte copies and needs out % 16 == 0 and a 16-byte aligned `packed`.
// Returns a cudaError_t value; 0 means the launch was accepted.
extern "C" int rsv_int4_decode(const void* x, int x_bf16, const void* packed,
                               const void* ws, void* y, int y_bf16, int R,
                               int in, int out, int tn, int rb, int splits,
                               int vec, void* stream) {
  const int npairs = in > 0 ? in / (2 * GROUP) : 0;
  if (R <= 0 || R > MAX_R || in <= 0 || in % (2 * GROUP) != 0 || out <= 0 ||
      splits < 1 || splits > npairs || splits > MAX_SPLITS ||
      (npairs + splits - 1) / splits > MAX_PAIRS || (vec && out % 16 != 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define RSV_K2(TN, RB)                                                     \
  if (tn == TN && rb == RB)                                                \
    return launch<TN, RB>(x, x_bf16, packed, ws, y, y_bf16, R, in, out,    \
                          splits, vec, st);
  RSV_K2(64, 1) RSV_K2(64, 2) RSV_K2(64, 4)
  RSV_K2(128, 1) RSV_K2(128, 2) RSV_K2(128, 4)
  RSV_K2(256, 1) RSV_K2(256, 2) RSV_K2(256, 4)
#undef RSV_K2
  return (int)cudaErrorInvalidValue;
}

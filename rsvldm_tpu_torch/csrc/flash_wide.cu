// Flash attention at wide head dims (D > 256) for Hopper (sm_90a): the
// forward (K1) and the backward (K3 + K4), bf16 in, fp32 sums.
//
// Replaces the Pallas TPU kernels of rsvldm_tpu/ops/flash_attention.py at
// the head dims csrc/flash_fwd.cu and csrc/flash_bwd.cu are not built for:
// `_flash_kernel` (flash_attention), `_flash_bwd_kv_kernel` (dK, dV) and
// `_flash_bwd_q_kernel` (dQ), and the delta pass the JAX wrapper runs
// before them. The Pallas kernels take any D; these take any D that is a
// multiple of 64 (the wrapper, ops/flash_attention.py, zero-pads the
// others along D, which is exact when the scale stays the true D's).
// Same functions as flash_fwd.cu / flash_bwd.cu: online softmax in base 2,
// suffix-aligned causal mask, keys at or past kv_len masked (forward),
// rows with no valid key written as exact zeros, lse in natural-log units
// [B, H, Sq] with l clamped at 1e-30; in the backward p rebuilt from lse
// and masked to exact zeros, ds = p * (dP - delta) * scale, p and ds
// rounded to bf16 before their products.
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s), counted as
// chip_smoke.py counts it: the forward 4*D FLOP per valid (query, key)
// pair, the backward 10*D (five products); operations at every shape of
// the wide-head path. At [4, 1536, 8, 512] causal that is the D=128
// training shape's bound, because H*D is equal: 0.0782 ms forward,
// 0.196 ms backward.
//
// Design: simple first, registers bounded at any D. The D=128 and D=256
// kernels keep a whole Q or K row tile and O's accumulator in a
// warpgroup's registers; at D=512 O alone would need 256 fp32 registers a
// thread. Here a block owns a 128-column slab of the output, and the
// products over D are taken in 64-column chunks staged through shared
// memory:
// - 128 threads (4 warps x 16 rows of a 64-row tile); mma.sync m16n8k16
//   bf16 with fp32 accumulators, fragments read from padded shared rows
//   (one conflict-free 32-bit load each), as the first K1 was written.
// - Forward: grid (64-query tile, B*H, 128-column slab of O). For each
//   64-key tile, S = Q K^T is summed over D chunk by chunk (Q and K chunks
//   staged side by side), then the online softmax runs in registers and
//   O_slab += P V_slab takes P straight from the S accumulators as A
//   fragments, V's slab staged transposed. Slab 0 writes lse.
// - Backward: a prologue computes delta = rowsum(dO * O) over the whole D
//   and lse * log2(e). Then two kernels, each recomputing the scores over
//   D: dK/dV with grid (64-key tile, B*H, slab), S^T = K Q^T and
//   dP^T = V dO^T chunk by chunk, dV_slab += P^T dO_slab and
//   dK_slab += dS^T Q_slab (dO and Q slabs staged transposed); dQ with
//   grid (64-query tile, B*H, slab), S = Q K^T and dP = dO V^T,
//   dQ_slab += dS K_slab, written once in bf16: no fp32 workspace, no
//   atomics, deterministic.
// Cost of the design: S (and dP) are recomputed once a slab, D/128 times,
// and the backward computes them twice more for dQ; every chunk is
// staged by all threads behind two block barriers, with no copy in
// flight during the products. It is the simple form that a later redesign
// (TMA rings and wgmma, as at D <= 256) replaces; its times are in
// PERF.md, from chip_smoke.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 64;        // query rows / keys of a tile
constexpr int CHUNK = 64;       // D columns staged at a time
constexpr int SLAB = 128;       // output columns a block owns
constexpr int THREADS = 128;    // 4 warps, 16 rows each
constexpr int LD = CHUNK + 8;   // row stride of a staged chunk (elements)
constexpr int LDT = TILE + 8;   // row stride of a transposed slab (elements)
constexpr int CHUNK_ELEMS = TILE * LD;
constexpr int SLAB_ELEMS = SLAB * LDT;
constexpr int FWD_SMEM = (2 * CHUNK_ELEMS + SLAB_ELEMS) * 2;
constexpr float NEG_INF = -1e30f;  // initial running max, as the TPU kernel
constexpr float LN2 = 0.6931471805599453f;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ void mma_16816(float* c, const uint32_t* a,
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats -> one register of two bf16, `lo` in the low half (the element
// with the smaller column index in an mma fragment).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Rows [r0, r0 + 64) x columns [c0, c0 + 64) of one head of a [B, S, H, D]
// tensor (`base` points at (b, 0, h, 0), rows `rs` elements apart) into
// dst[64][LD]; rows at or past S are zeros.
__device__ __forceinline__ void stage_chunk(__nv_bfloat16* dst,
                                            const __nv_bfloat16* base, int r0,
                                            int S, long long rs, int c0) {
  for (int i = threadIdx.x; i < TILE * (CHUNK / 8); i += THREADS) {
    const int r = i >> 3;
    const int c = (i & 7) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < S)
      val = *reinterpret_cast<const uint4*>(base + (r0 + r) * rs + c0 + c);
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
}

// Rows [r0, r0 + 64) x columns [c0, c0 + nc) (nc 64 or 128) transposed into
// dst[column][row] (stride LDT); rows at or past S are zeros.
__device__ __forceinline__ void stage_slab_t(__nv_bfloat16* dst,
                                             const __nv_bfloat16* base,
                                             int r0, int S, long long rs,
                                             int c0, int nc) {
  const int pieces = nc / 8;  // 16-byte pieces a row
  for (int i = threadIdx.x; i < TILE * pieces; i += THREADS) {
    const int r = i / pieces;
    const int c = (i - r * pieces) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < S)
      val = *reinterpret_cast<const uint4*>(base + (r0 + r) * rs + c0 + c);
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&val);
#pragma unroll
    for (int j = 0; j < 8; ++j) dst[(c + j) * LDT + r] = e[j];
  }
}

// acc (this warp's 16 rows x 64 columns, 8 n-tiles) += A[16 rows] B^T over
// one staged 64-column chunk: A's rows warp*16.., all 64 rows of B.
__device__ __forceinline__ void mma_chunk(float (&acc)[8][4],
                                          const __nv_bfloat16* A,
                                          const __nv_bfloat16* B, int warp,
                                          int g, int t) {
#pragma unroll
  for (int kk = 0; kk < CHUNK / 16; ++kk) {
    uint32_t a[4];
    const __nv_bfloat16* p = A + (warp * 16 + g) * LD + kk * 16 + t * 2;
    a[0] = ld32(p);
    a[1] = ld32(p + 8 * LD);
    a[2] = ld32(p + 8);
    a[3] = ld32(p + 8 * LD + 8);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const __nv_bfloat16* b = B + (j * 8 + g) * LD + kk * 16 + t * 2;
      mma_16816(acc[j], a, ld32(b), ld32(b + 8));
    }
  }
}

// acc (16 rows x the slab's nc columns, 16 n-tiles) += P Bt^T: P is this
// warp's 16 x 64 score tile in accumulator layout (two adjacent n-tiles
// are the A fragment of one 16-deep step), Bt the slab staged transposed.
__device__ __forceinline__ void mma_slab(float (&acc)[16][4],
                                         const float (&p)[8][4],
                                         const __nv_bfloat16* Bt, int nc,
                                         int g, int t) {
#pragma unroll
  for (int kk = 0; kk < TILE / 16; ++kk) {
    uint32_t a[4];
    a[0] = pack_bf16(p[2 * kk][0], p[2 * kk][1]);
    a[1] = pack_bf16(p[2 * kk][2], p[2 * kk][3]);
    a[2] = pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]);
    a[3] = pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3]);
#pragma unroll
    for (int n = 0; n < SLAB / 8; ++n) {
      if (n * 8 < nc) {
        const __nv_bfloat16* b = Bt + (n * 8 + g) * LDT + kk * 16 + t * 2;
        mma_16816(acc[n], a, ld32(b), ld32(b + 8));
      }
    }
  }
}

__device__ __forceinline__ void zero(float (&x)[8][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) x[j][0] = x[j][1] = x[j][2] = x[j][3] = 0.f;
}

__device__ __forceinline__ void zero(float (&x)[16][4]) {
#pragma unroll
  for (int j = 0; j < 16; ++j) x[j][0] = x[j][1] = x[j][2] = x[j][3] = 0.f;
}

// This warp's 16 x nc slab of `acc` (rows r0 + warp*16 + g (+8)) stored in
// bf16 to rows < S of one head of a [B, S, H, D] tensor, times `mul[i]`
// for the row half i.
__device__ __forceinline__ void store_slab(__nv_bfloat16* base, long long rs,
                                           const float (&acc)[16][4], int r0,
                                           int S, int c0, int nc, int warp,
                                           int g, int t, const float* mul) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + warp * 16 + g + i * 8;
    if (row >= S) continue;
    __nv_bfloat16* out = base + row * rs + c0;
#pragma unroll
    for (int n = 0; n < SLAB / 8; ++n)
      if (n * 8 < nc)
        *reinterpret_cast<uint32_t*>(out + n * 8 + t * 2) =
            pack_bf16(acc[n][2 * i] * mul[i], acc[n][2 * i + 1] * mul[i]);
  }
}

// ------------------------------------------------------------------ forward
// q: [B, Sq, H, D], k/v: [B, Sk, H, D], o: [B, Sq, H, D] bf16, contiguous;
// lse: [B, H, Sq] fp32 or null. Grid (q tiles, B*H, slabs).
__global__ void __launch_bounds__(THREADS)
flash_wide_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                      int H, int Sq, int Sk, int D, int kv_len, int causal,
                      int q_offset, float scale_log2e) {
  __shared__ __align__(16) unsigned char smem_raw[FWD_SMEM];  // 36 KB
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + CHUNK_ELEMS;
  __nv_bfloat16* Vt = Ks + CHUNK_ELEMS;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int q_start = blockIdx.x * TILE;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int c0 = blockIdx.z * SLAB;
  const int nc = min(SLAB, D - c0);
  const long long rs = (long long)H * D;
  const __nv_bfloat16* qb = q + ((long long)b * Sq * H + h) * D;
  const __nv_bfloat16* kb = k + ((long long)b * Sk * H + h) * D;
  const __nv_bfloat16* vb = v + ((long long)b * Sk * H + h) * D;

  int n_keys = kv_len;
  if (causal) n_keys = min(n_keys, min(q_start + TILE, Sq) + q_offset);
  const int n_tiles = n_keys > 0 ? (n_keys + TILE - 1) / TILE : 0;

  // per thread: rows warp*16 + g and warp*16 + g + 8 of the tile
  float m_i[2] = {NEG_INF, NEG_INF};
  float l_i[2] = {0.f, 0.f};  // partial over this thread's columns
  float acc[16][4];
  zero(acc);

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k_start = kt * TILE;
    float s[8][4];
    zero(s);
    for (int c = 0; c < D; c += CHUNK) {
      __syncthreads();  // the last chunk (and at c = 0 the last V slab) used
      stage_chunk(Qs, qb, q_start, Sq, rs, c);
      stage_chunk(Ks, kb, k_start, Sk, rs, c);
      if (c == 0) stage_slab_t(Vt, vb, k_start, Sk, rs, c0, nc);
      __syncthreads();
      mma_chunk(s, Qs, Ks, warp, g, t);
    }

    // base-2 scores, masked only where the tile crosses kv_len or the
    // causal diagonal of the tile's first row
    const bool need_mask =
        (k_start + TILE > kv_len) ||
        (causal && k_start + TILE - 1 > q_start + q_offset);
    float row_max[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale_log2e;
        if (need_mask) {
          const int key = k_start + j * 8 + t * 2 + (e & 1);
          const int row = q_start + warp * 16 + g + (e >> 1) * 8;
          const bool ok = key < kv_len && (!causal || key <= row + q_offset);
          x = ok ? x : -INFINITY;
        }
        s[j][e] = x;
        row_max[e >> 1] = fmaxf(row_max[e >> 1], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      row_max[r] = fmaxf(row_max[r], __shfl_xor_sync(0xffffffffu, row_max[r], 1));
      row_max[r] = fmaxf(row_max[r], __shfl_xor_sync(0xffffffffu, row_max[r], 2));
      const float m_new = fmaxf(m_i[r], row_max[r]);
      alpha[r] = exp2f(m_i[r] - m_new);
      m_i[r] = m_new;
    }
    float row_sum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // masked scores are -inf: p = 0, also while m is still NEG_INF
        const float p = exp2f(s[j][e] - m_i[e >> 1]);
        s[j][e] = p;
        row_sum[e >> 1] += p;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_i[r] = l_i[r] * alpha[r] + row_sum[r];
#pragma unroll
    for (int n = 0; n < 16; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }
    mma_slab(acc, s, Vt, nc, g, t);
  }

  // normalise and write; rows with no valid key have l = 0 and acc = 0
  float inv[2];
  float l_safe[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_i[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    l_safe[r] = fmaxf(l, 1e-30f);
    inv[r] = 1.f / l_safe[r];
  }
  __nv_bfloat16* ob = o + ((long long)b * Sq * H + h) * D;
  store_slab(ob, rs, acc, q_start, Sq, c0, nc, warp, g, t, inv);
  if (lse != nullptr && blockIdx.z == 0 && t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q_start + warp * 16 + g + r * 8;
      if (row < Sq) lse[(long long)bh * Sq + row] = m_i[r] * LN2 + logf(l_safe[r]);
    }
  }
}

// ----------------------------------------------------------------- backward
// aux[0][bh][i] = lse * log2(e), aux[1][bh][i] = rowsum(dO * O) over D for
// every (b, i, h) row; one warp a row, 8 rows a block.
__global__ void __launch_bounds__(256)
flash_wide_prep_kernel(const __nv_bfloat16* __restrict__ o,
                       const __nv_bfloat16* __restrict__ dout,
                       const float* __restrict__ lse, float* __restrict__ aux,
                       long long rows, int BH, int H, int Sq, int D) {
  const long long row = (long long)blockIdx.x * 8 + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const __nv_bfloat16* op = o + row * D;
  const __nv_bfloat16* dp = dout + row * D;
  float sum = 0.f;
  for (int c = lane * 8; c < D; c += 32 * 8) {
    const uint4 a = *reinterpret_cast<const uint4*>(op + c);
    const uint4 d = *reinterpret_cast<const uint4*>(dp + c);
    const __nv_bfloat16* ae = reinterpret_cast<const __nv_bfloat16*>(&a);
    const __nv_bfloat16* de = reinterpret_cast<const __nv_bfloat16*>(&d);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      sum += __bfloat162float(ae[j]) * __bfloat162float(de[j]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (lane == 0) {
    // row indexes [B, Sq, H]
    const int h = (int)(row % H);
    const long long bs = row / H;
    const int i = (int)(bs % Sq);
    const long long b = bs / Sq;
    const long long at = (b * H + h) * Sq + i;
    aux[at] = lse[at] * LOG2E;
    aux[(long long)BH * Sq + at] = sum;
  }
}

// dK, dV: grid (key tiles, B*H, slabs). Dynamic shared memory: the K, V, Q
// and dO chunks, then the Q and dO slabs transposed.
__global__ void __launch_bounds__(THREADS)
flash_wide_bwd_kv_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const __nv_bfloat16* __restrict__ dout,
                         const float* __restrict__ aux,
                         __nv_bfloat16* __restrict__ dk,
                         __nv_bfloat16* __restrict__ dv, int H, int Sq,
                         int Sk, int D, int causal, int q_offset, float scale,
                         float scale_log2e) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Vs = Ks + CHUNK_ELEMS;
  __nv_bfloat16* Qs = Vs + CHUNK_ELEMS;
  __nv_bfloat16* Os = Qs + CHUNK_ELEMS;
  __nv_bfloat16* Qt = Os + CHUNK_ELEMS;
  __nv_bfloat16* Ot = Qt + SLAB_ELEMS;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int k_start = blockIdx.x * TILE;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int c0 = blockIdx.z * SLAB;
  const int nc = min(SLAB, D - c0);
  const long long rs = (long long)H * D;
  const long long q_at = ((long long)b * Sq * H + h) * D;
  const long long k_at = ((long long)b * Sk * H + h) * D;
  const float* lse2 = aux + (long long)bh * Sq;
  const float* delta = aux + ((long long)gridDim.y + bh) * Sq;

  float dk_acc[16][4];
  float dv_acc[16][4];
  zero(dk_acc);
  zero(dv_acc);
  // causal: query i sees key j when j <= i + q_offset, so the first query
  // that sees any key of this block is k_start - q_offset
  const int first = causal ? max(k_start - q_offset, 0) / TILE : 0;
  for (int qt = first; qt * TILE < Sq; ++qt) {
    const int q_start = qt * TILE;
    float st[8][4];
    float dpt[8][4];
    zero(st);
    zero(dpt);
    for (int c = 0; c < D; c += CHUNK) {
      __syncthreads();
      stage_chunk(Ks, k + k_at, k_start, Sk, rs, c);
      stage_chunk(Vs, v + k_at, k_start, Sk, rs, c);
      stage_chunk(Qs, q + q_at, q_start, Sq, rs, c);
      stage_chunk(Os, dout + q_at, q_start, Sq, rs, c);
      if (c == 0) {
        stage_slab_t(Qt, q + q_at, q_start, Sq, rs, c0, nc);
        stage_slab_t(Ot, dout + q_at, q_start, Sq, rs, c0, nc);
      }
      __syncthreads();
      mma_chunk(st, Ks, Qs, warp, g, t);   // S^T = K Q^T
      mma_chunk(dpt, Vs, Os, warp, g, t);  // dP^T = V dO^T
    }
    // P^T and dS^T in place: key rows warp*16 + g (+8), query columns
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = q_start + j * 8 + t * 2 + (e & 1);
        const int key = k_start + warp * 16 + g + (e >> 1) * 8;
        const bool ok =
            qi < Sq && key < Sk && (!causal || key <= qi + q_offset);
        float p = 0.f, ds = 0.f;
        if (ok) {
          p = exp2f(st[j][e] * scale_log2e - lse2[qi]);
          ds = p * (dpt[j][e] - delta[qi]) * scale;
        }
        st[j][e] = p;
        dpt[j][e] = ds;
      }
    }
    mma_slab(dv_acc, st, Ot, nc, g, t);   // dV += P^T dO
    mma_slab(dk_acc, dpt, Qt, nc, g, t);  // dK += dS^T Q
  }
  const float one[2] = {1.f, 1.f};
  store_slab(dk + k_at, rs, dk_acc, k_start, Sk, c0, nc, warp, g, t, one);
  store_slab(dv + k_at, rs, dv_acc, k_start, Sk, c0, nc, warp, g, t, one);
}

// dQ: grid (query tiles, B*H, slabs). Dynamic shared memory: the Q, K, dO
// and V chunks, then the K slab transposed.
__global__ void __launch_bounds__(THREADS)
flash_wide_bwd_q_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const __nv_bfloat16* __restrict__ dout,
                        const float* __restrict__ aux,
                        __nv_bfloat16* __restrict__ dq, int H, int Sq, int Sk,
                        int D, int causal, int q_offset, float scale,
                        float scale_log2e) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + CHUNK_ELEMS;
  __nv_bfloat16* Os = Ks + CHUNK_ELEMS;
  __nv_bfloat16* Vs = Os + CHUNK_ELEMS;
  __nv_bfloat16* Kt = Vs + CHUNK_ELEMS;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int q_start = blockIdx.x * TILE;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int c0 = blockIdx.z * SLAB;
  const int nc = min(SLAB, D - c0);
  const long long rs = (long long)H * D;
  const long long q_at = ((long long)b * Sq * H + h) * D;
  const long long k_at = ((long long)b * Sk * H + h) * D;
  const float* lse2 = aux + (long long)bh * Sq;
  const float* delta = aux + ((long long)gridDim.y + bh) * Sq;

  float lse_r[2], delta_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q_start + warp * 16 + g + i * 8;
    lse_r[i] = row < Sq ? lse2[row] : 0.f;
    delta_r[i] = row < Sq ? delta[row] : 0.f;
  }
  int n_keys = Sk;
  if (causal) n_keys = min(n_keys, min(q_start + TILE, Sq) + q_offset);
  const int n_tiles = n_keys > 0 ? (n_keys + TILE - 1) / TILE : 0;

  float dq_acc[16][4];
  zero(dq_acc);
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k_start = kt * TILE;
    float s[8][4];
    float dp[8][4];
    zero(s);
    zero(dp);
    for (int c = 0; c < D; c += CHUNK) {
      __syncthreads();
      stage_chunk(Qs, q + q_at, q_start, Sq, rs, c);
      stage_chunk(Ks, k + k_at, k_start, Sk, rs, c);
      stage_chunk(Os, dout + q_at, q_start, Sq, rs, c);
      stage_chunk(Vs, v + k_at, k_start, Sk, rs, c);
      if (c == 0) stage_slab_t(Kt, k + k_at, k_start, Sk, rs, c0, nc);
      __syncthreads();
      mma_chunk(s, Qs, Ks, warp, g, t);   // S = Q K^T
      mma_chunk(dp, Os, Vs, warp, g, t);  // dP = dO V^T
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = q_start + warp * 16 + g + (e >> 1) * 8;
        const int key = k_start + j * 8 + t * 2 + (e & 1);
        const bool ok =
            row < Sq && key < Sk && (!causal || key <= row + q_offset);
        float ds = 0.f;
        if (ok) {
          const float p = exp2f(s[j][e] * scale_log2e - lse_r[e >> 1]);
          ds = p * (dp[j][e] - delta_r[e >> 1]) * scale;
        }
        s[j][e] = ds;
      }
    }
    mma_slab(dq_acc, s, Kt, nc, g, t);  // dQ += dS K
  }
  const float one[2] = {1.f, 1.f};
  store_slab(dq + q_at, rs, dq_acc, q_start, Sq, c0, nc, warp, g, t, one);
}

constexpr int KV_SMEM = (4 * CHUNK_ELEMS + 2 * SLAB_ELEMS) * 2;
constexpr int Q_SMEM = (4 * CHUNK_ELEMS + SLAB_ELEMS) * 2;

bool bad_shape(int B, int H, int Sq, int Sk, int D) {
  return B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0 || D <= 0 || D % CHUNK ||
         (long long)B * H > 65535 || (D + SLAB - 1) / SLAB > 65535;
}

}  // namespace

// Plain C entry points (bound with ctypes). Each returns a cudaError_t
// value; 0 means every launch was accepted. Tensors are contiguous bf16
// [B, S, H, D] (lse [B, H, Sq] fp32), D a multiple of 64.
extern "C" int rsv_flash_wide_fwd(const void* q, const void* k, const void* v,
                                  void* o, void* lse, int B, int H, int Sq,
                                  int Sk, int D, int kv_len, int causal,
                                  float scale, void* stream) {
  if (bad_shape(B, H, Sq, Sk, D) || kv_len < 0 || kv_len > Sk)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((Sq + TILE - 1) / TILE, B * H, (D + SLAB - 1) / SLAB);
  flash_wide_fwd_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), H, Sq, Sk, D, kv_len, causal, kv_len - Sq,
      scale * LOG2E);
  return (int)cudaGetLastError();
}

// The whole backward: the prologue into aux ([2, B*H, Sq] fp32, scratch),
// then the dK/dV and the dQ kernels, on one stream. o and lse come from
// the forward on the same inputs.
extern "C" int rsv_flash_wide_bwd(const void* q, const void* k, const void* v,
                                  const void* o, const void* dout,
                                  const void* lse, void* aux, void* dq,
                                  void* dk, void* dv, int B, int H, int Sq,
                                  int Sk, int D, int causal, float scale,
                                  void* stream) {
  if (bad_shape(B, H, Sq, Sk, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  static const cudaError_t attr_kv = cudaFuncSetAttribute(
      flash_wide_bwd_kv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      KV_SMEM);
  if (attr_kv != cudaSuccess) return (int)attr_kv;
  static const cudaError_t attr_q = cudaFuncSetAttribute(
      flash_wide_bwd_q_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Q_SMEM);
  if (attr_q != cudaSuccess) return (int)attr_q;
  const long long rows = (long long)B * Sq * H;
  const long long blocks = (rows + 7) / 8;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  const auto* dop = static_cast<const __nv_bfloat16*>(dout);
  float* auxp = static_cast<float*>(aux);
  flash_wide_prep_kernel<<<(int)blocks, 256, 0, st>>>(
      static_cast<const __nv_bfloat16*>(o), dop,
      static_cast<const float*>(lse), auxp, rows, B * H, H, Sq, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int slabs = (D + SLAB - 1) / SLAB;
  const float sl2e = scale * LOG2E;
  flash_wide_bwd_kv_kernel<<<dim3((Sk + TILE - 1) / TILE, B * H, slabs),
                             THREADS, KV_SMEM, st>>>(
      qp, kp, vp, dop, auxp, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), H, Sq, Sk, D, causal, Sk - Sq, scale,
      sl2e);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_wide_bwd_q_kernel<<<dim3((Sq + TILE - 1) / TILE, B * H, slabs),
                            THREADS, Q_SMEM, st>>>(
      qp, kp, vp, dop, auxp, static_cast<__nv_bfloat16*>(dq), H, Sq, Sk, D,
      causal, Sk - Sq, scale, sl2e);
  return (int)cudaGetLastError();
}

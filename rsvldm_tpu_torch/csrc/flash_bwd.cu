// K3 and K4: flash-attention backward for Hopper (sm_90a), bf16 in, fp32
// accumulation.
//
// Replace the Pallas TPU kernels `_flash_bwd_kv_kernel` (K3: dK, dV) and
// `_flash_bwd_q_kernel` (K4: dQ) of `flash_attention_bwd` in
// rsvldm_tpu/ops/flash_attention.py. Same function: p is rebuilt from the
// forward's logsumexp in base 2, p = exp2(s*scale*log2e - lse*log2e), so no
// [Sq, Sk] matrix is stored; ds = p * (dP - delta) * scale with
// delta = rowsum(dO * O) computed by the caller; dV = p^T dO, dK = ds^T Q,
// dQ = ds K. p and ds are rounded to bf16 before their products and every
// sum is fp32, as the TPU kernels cast them to the input dtype. Causal
// masking is suffix-aligned (q_offset = Sk - Sq); queries with no valid key
// (causal, Sq > Sk) have p = 0, so their gradients are exact zeros whatever
// the forward wrote to their lse; sequence lengths need not be multiples of
// the tiles.
//
// Design for the card, not carried over from the TPU grid: the TPU kernels
// carry fp32 accumulators in VMEM across a sequential grid axis. Here a
// block owns its outputs and loops itself, and the two kernels write
// disjoint outputs, so there are no atomics and the result is
// deterministic, as the JAX split is.
//   K3: one block per (b*h, 64-key tile); 4 warps, 16 keys each. K and V
//       stay in shared memory; the block walks the live q tiles (QN rows:
//       32 at D=128, 64 at D=64), staging Q and dO both row-major and
//       transposed. Per tile: S^T = K Q^T and dP^T = V dO^T (mma.sync
//       m16n8k16 bf16, fp32 accumulators), P^T and dS^T elementwise in
//       registers, then dV += P^T dO and dK += dS^T Q straight from the
//       accumulators (the S^T accumulator layout of two n-tiles is the A
//       fragment of one 16-query k-step). Causal q tiles wholly above the
//       block's first key are never visited.
//   K4: one block per (b*h, 64-query tile); 4 warps, 16 queries each. Q and
//       dO stay in shared memory; the block walks the live K/V tiles, K
//       staged row-major and transposed. Per tile: S = Q K^T and dP = dO V^T,
//       dS in registers, dQ += dS K. Causal K/V tiles past the tile's last
//       query are never loaded.
// Registers: K3 at D=128 holds dK and dV (2 x 16x128 fp32 per warp, 128 a
// thread) plus S^T and dP^T for 32 queries (32 a thread); the 32-row q tile
// is what keeps it under 255 without spills. ptxas's counts are printed by
// the build (`-Xptxas -v`).
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s): at the training
// shape (B=4, S=1536, H=32, D=128, causal) K3 does four products and K4
// three, each B*H*S^2*D/2 multiply-adds over the live (causal) half, i.e.
// 38.7 GFLOP: 155 GFLOP -> 0.156 ms for K3 and 116 GFLOP -> 0.117 ms for
// K4, compute-bound. This
// first version has no TMA, wgmma or load/compute overlap, and recomputes
// S and dP in both kernels; those are the levers left.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int KV_TILE = 64;  // keys per K3 block and per K4 loop step
constexpr int Q_TILE = 64;   // queries per K4 block
constexpr int NUM_WARPS = 4;
constexpr int NUM_THREADS = NUM_WARPS * 32;
constexpr int PAD = 8;  // bf16 elements of padding per shared-memory row
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ void mma_16816(float* c, const uint32_t* a,
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats -> one register of two bf16, `lo` in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// A fragment (16 rows x 16 k) of a row-major shared tile with row stride
// `stride`, rows starting at `row0`, k starting at `k0`.
__device__ __forceinline__ void load_a(uint32_t* a, const __nv_bfloat16* base,
                                       int stride, int row0, int k0, int g,
                                       int t) {
  const __nv_bfloat16* p = base + (row0 + g) * stride + k0 + t * 2;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * stride);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * stride + 8);
}

// Rows [0, ROWS) of a [B, S, H, D] tensor starting at `src` (row stride
// `row_stride`) into shared memory row-major (stride D + PAD) and, when
// `dst_t` is set, transposed (dst_t[d][row], stride ROWS + PAD). Rows at or
// past `valid` are zeros.
template <int D, int ROWS>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst,
                                           __nv_bfloat16* dst_t,
                                           const __nv_bfloat16* src, int valid,
                                           long long row_stride) {
  constexpr int CHUNKS = D / 8;
  for (int c = threadIdx.x; c < ROWS * CHUNKS; c += NUM_THREADS) {
    const int r = c / CHUNKS;
    const int col = (c - r * CHUNKS) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid)
      val = *reinterpret_cast<const uint4*>(src + r * row_stride + col);
    *reinterpret_cast<uint4*>(dst + r * (D + PAD) + col) = val;
    if (dst_t != nullptr) {
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&val);
#pragma unroll
      for (int i = 0; i < 8; ++i) dst_t[(col + i) * (ROWS + PAD) + r] = e[i];
    }
  }
}

template <int D, int QN>
constexpr int kv_smem_bytes() {
  return (2 * KV_TILE * (D + PAD) + 2 * QN * (D + PAD) + 2 * D * (QN + PAD)) * 2 +
         2 * QN * 4;
}

template <int D>
constexpr int q_smem_bytes() {
  return (2 * Q_TILE * (D + PAD) + 2 * KV_TILE * (D + PAD) +
          D * (KV_TILE + PAD)) * 2;
}

// ---- K3: dK, dV. q/do: [B, Sq, H, D]; k/v/dk/dv: [B, Sk, H, D], bf16,
// contiguous; lse/delta: [B, H, Sq] fp32.
template <int D, int QN>
__global__ void __launch_bounds__(NUM_THREADS)
flash_bwd_kv_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    __nv_bfloat16* __restrict__ dk,
                    __nv_bfloat16* __restrict__ dv, int H, int Sq, int Sk,
                    int causal, int q_offset, float scale, float scale_log2e) {
  constexpr int ROW = D + PAD;     // row-major stride
  constexpr int ROW_T = QN + PAD;  // transposed stride
  constexpr int KSTEPS = D / 16;   // k-steps over D
  constexpr int NT_Q = QN / 8;     // n-tiles over the q tile
  constexpr int NT_D = D / 8;      // n-tiles over D

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Vs = Ks + KV_TILE * ROW;
  __nv_bfloat16* Qs = Vs + KV_TILE * ROW;
  __nv_bfloat16* Qt = Qs + QN * ROW;
  __nv_bfloat16* dOs = Qt + D * ROW_T;
  __nv_bfloat16* dOt = dOs + QN * ROW;
  float* lse_s = reinterpret_cast<float*>(dOt + D * ROW_T);
  float* delta_s = lse_s + QN;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int k_start = blockIdx.x * KV_TILE;
  const long long row_stride = (long long)H * D;
  const __nv_bfloat16* qb = q + ((long long)b * Sq * H + h) * D;
  const __nv_bfloat16* dob = dout + ((long long)b * Sq * H + h) * D;
  const long long kv_off = ((long long)b * Sk * H + h) * D;
  const float* lse_b = lse + (long long)bh * Sq;
  const float* delta_b = delta + (long long)bh * Sq;

  const int k_valid = min(KV_TILE, Sk - k_start);
  stage_rows<D, KV_TILE>(Ks, nullptr, k + kv_off + k_start * row_stride,
                         k_valid, row_stride);
  stage_rows<D, KV_TILE>(Vs, nullptr, v + kv_off + k_start * row_stride,
                         k_valid, row_stride);

  float dk_acc[NT_D][4];
  float dv_acc[NT_D][4];
#pragma unroll
  for (int n = 0; n < NT_D; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  const int key0 = k_start + warp * 16 + g;  // this thread's keys: +0, +8
  // causal: queries below k_start - q_offset see no key of this tile
  int q_begin = 0;
  if (causal) {
    const int first = k_start - q_offset;
    q_begin = first > 0 ? (first / QN) * QN : 0;
  }

  for (int q_start = q_begin; q_start < Sq; q_start += QN) {
    const int q_valid = min(QN, Sq - q_start);
    __syncthreads();  // the previous q tile is fully consumed
    stage_rows<D, QN>(Qs, Qt, qb + q_start * row_stride, q_valid, row_stride);
    stage_rows<D, QN>(dOs, dOt, dob + q_start * row_stride, q_valid,
                      row_stride);
    for (int i = tid; i < QN; i += NUM_THREADS) {
      lse_s[i] = i < q_valid ? lse_b[q_start + i] : 0.f;
      delta_s[i] = i < q_valid ? delta_b[q_start + i] : 0.f;
    }
    __syncthreads();

    // ---- S^T = K Q^T and dP^T = V dO^T: 16 keys x QN queries per warp
    float s[NT_Q][4];
    float dp[NT_Q][4];
#pragma unroll
    for (int j = 0; j < NT_Q; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      uint32_t ka[4], va[4];
      load_a(ka, Ks, ROW, warp * 16, kk * 16, g, t);
      load_a(va, Vs, ROW, warp * 16, kk * 16, g, t);
#pragma unroll
      for (int j = 0; j < NT_Q; ++j) {
        const __nv_bfloat16* pq = Qs + (j * 8 + g) * ROW + kk * 16 + t * 2;
        mma_16816(s[j], ka, ld32(pq), ld32(pq + 8));
        const __nv_bfloat16* pd = dOs + (j * 8 + g) * ROW + kk * 16 + t * 2;
        mma_16816(dp[j], va, ld32(pd), ld32(pd + 8));
      }
    }

    // ---- P^T (rebuilt from lse) and dS^T = P^T (dP^T - delta) scale
#pragma unroll
    for (int j = 0; j < NT_Q; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = key0 + (e >> 1) * 8;
        const int qi = j * 8 + t * 2 + (e & 1);
        const bool ok = key < Sk && qi < q_valid &&
                        (!causal || key <= q_start + qi + q_offset);
        const float p =
            ok ? exp2f(s[j][e] * scale_log2e - lse_s[qi] * LOG2E) : 0.f;
        s[j][e] = p;
        dp[j][e] = p * (dp[j][e] - delta_s[qi]) * scale;
      }
    }

    // ---- dV += P^T dO, dK += dS^T Q (k = the tile's queries)
#pragma unroll
    for (int kk = 0; kk < QN / 16; ++kk) {
      uint32_t pa[4], da[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      da[0] = pack_bf16(dp[2 * kk][0], dp[2 * kk][1]);
      da[1] = pack_bf16(dp[2 * kk][2], dp[2 * kk][3]);
      da[2] = pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]);
      da[3] = pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3]);
#pragma unroll
      for (int n = 0; n < NT_D; ++n) {
        const __nv_bfloat16* po = dOt + (n * 8 + g) * ROW_T + kk * 16 + t * 2;
        mma_16816(dv_acc[n], pa, ld32(po), ld32(po + 8));
        const __nv_bfloat16* pq = Qt + (n * 8 + g) * ROW_T + kk * 16 + t * 2;
        mma_16816(dk_acc[n], da, ld32(pq), ld32(pq + 8));
      }
    }
  }

  // ---- write; keys no query sees get zeros
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + r * 8;
    if (key < Sk) {
      const long long off = kv_off + key * row_stride;
#pragma unroll
      for (int n = 0; n < NT_D; ++n) {
        *reinterpret_cast<uint32_t*>(dk + off + n * 8 + t * 2) =
            pack_bf16(dk_acc[n][2 * r], dk_acc[n][2 * r + 1]);
        *reinterpret_cast<uint32_t*>(dv + off + n * 8 + t * 2) =
            pack_bf16(dv_acc[n][2 * r], dv_acc[n][2 * r + 1]);
      }
    }
  }
}

// ---- K4: dQ. Same layouts; dq like q.
template <int D>
__global__ void __launch_bounds__(NUM_THREADS)
flash_bwd_q_kernel(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v,
                   const __nv_bfloat16* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta,
                   __nv_bfloat16* __restrict__ dq, int H, int Sq, int Sk,
                   int causal, int q_offset, float scale, float scale_log2e) {
  constexpr int ROW = D + PAD;
  constexpr int ROW_T = KV_TILE + PAD;
  constexpr int KSTEPS = D / 16;
  constexpr int NT_K = KV_TILE / 8;  // n-tiles over the K/V tile
  constexpr int NT_D = D / 8;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* dOs = Qs + Q_TILE * ROW;
  __nv_bfloat16* Ks = dOs + Q_TILE * ROW;
  __nv_bfloat16* Vs = Ks + KV_TILE * ROW;
  __nv_bfloat16* Kt = Vs + KV_TILE * ROW;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q_start = blockIdx.x * Q_TILE;
  const long long row_stride = (long long)H * D;
  const long long q_off = ((long long)b * Sq * H + h) * D;
  const __nv_bfloat16* kb = k + ((long long)b * Sk * H + h) * D;
  const __nv_bfloat16* vb = v + ((long long)b * Sk * H + h) * D;

  const int q_valid = min(Q_TILE, Sq - q_start);
  stage_rows<D, Q_TILE>(Qs, nullptr, q + q_off + q_start * row_stride,
                        q_valid, row_stride);
  stage_rows<D, Q_TILE>(dOs, nullptr, dout + q_off + q_start * row_stride,
                        q_valid, row_stride);

  const int row0 = q_start + warp * 16 + g;  // this thread's rows: +0, +8
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + r * 8;
    lse_r[r] = row < Sq ? lse[(long long)bh * Sq + row] * LOG2E : 0.f;
    delta_r[r] = row < Sq ? delta[(long long)bh * Sq + row] : 0.f;
  }

  int n_keys = Sk;
  if (causal) {
    const int last_row = q_start + q_valid - 1;
    n_keys = min(n_keys, last_row + q_offset + 1);
  }
  const int n_blocks = n_keys > 0 ? (n_keys + KV_TILE - 1) / KV_TILE : 0;

  float dq_acc[NT_D][4];
#pragma unroll
  for (int n = 0; n < NT_D; ++n)
    dq_acc[n][0] = dq_acc[n][1] = dq_acc[n][2] = dq_acc[n][3] = 0.f;

  for (int kb_i = 0; kb_i < n_blocks; ++kb_i) {
    const int k_start = kb_i * KV_TILE;
    const int k_valid = min(KV_TILE, Sk - k_start);
    __syncthreads();  // the previous K/V tile is fully consumed
    stage_rows<D, KV_TILE>(Ks, Kt, kb + k_start * row_stride, k_valid,
                           row_stride);
    stage_rows<D, KV_TILE>(Vs, nullptr, vb + k_start * row_stride, k_valid,
                           row_stride);
    __syncthreads();

    // ---- S = Q K^T and dP = dO V^T: 16 queries x 64 keys per warp
    float s[NT_K][4];
    float dp[NT_K][4];
#pragma unroll
    for (int j = 0; j < NT_K; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      uint32_t qa[4], oa[4];
      load_a(qa, Qs, ROW, warp * 16, kk * 16, g, t);
      load_a(oa, dOs, ROW, warp * 16, kk * 16, g, t);
#pragma unroll
      for (int j = 0; j < NT_K; ++j) {
        const __nv_bfloat16* pk = Ks + (j * 8 + g) * ROW + kk * 16 + t * 2;
        mma_16816(s[j], qa, ld32(pk), ld32(pk + 8));
        const __nv_bfloat16* pv = Vs + (j * 8 + g) * ROW + kk * 16 + t * 2;
        mma_16816(dp[j], oa, ld32(pv), ld32(pv + 8));
      }
    }

    // ---- dS = P (dP - delta) scale, P rebuilt from lse
#pragma unroll
    for (int j = 0; j < NT_K; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row0 + (e >> 1) * 8;
        const int key = k_start + j * 8 + t * 2 + (e & 1);
        const bool ok = row < Sq && key < Sk &&
                        (!causal || key <= row + q_offset);
        const float p =
            ok ? exp2f(s[j][e] * scale_log2e - lse_r[e >> 1]) : 0.f;
        dp[j][e] = p * (dp[j][e] - delta_r[e >> 1]) * scale;
      }
    }

    // ---- dQ += dS K (k = the tile's keys)
#pragma unroll
    for (int kk = 0; kk < KV_TILE / 16; ++kk) {
      uint32_t da[4];
      da[0] = pack_bf16(dp[2 * kk][0], dp[2 * kk][1]);
      da[1] = pack_bf16(dp[2 * kk][2], dp[2 * kk][3]);
      da[2] = pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]);
      da[3] = pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3]);
#pragma unroll
      for (int n = 0; n < NT_D; ++n) {
        const __nv_bfloat16* pk = Kt + (n * 8 + g) * ROW_T + kk * 16 + t * 2;
        mma_16816(dq_acc[n], da, ld32(pk), ld32(pk + 8));
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + r * 8;
    if (row < Sq) {
      __nv_bfloat16* drow = dq + q_off + row * row_stride;
#pragma unroll
      for (int n = 0; n < NT_D; ++n)
        *reinterpret_cast<uint32_t*>(drow + n * 8 + t * 2) =
            pack_bf16(dq_acc[n][2 * r], dq_acc[n][2 * r + 1]);
    }
  }
}

struct Args {
  const __nv_bfloat16 *q, *k, *v, *dout;
  const float *lse, *delta;
  int B, H, Sq, Sk, causal;
  float scale;
};

template <int D, int QN>
int launch_kv(const Args& a, __nv_bfloat16* dk, __nv_bfloat16* dv,
              cudaStream_t stream) {
  constexpr int smem = kv_smem_bytes<D, QN>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_kv_kernel<D, QN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.Sk + KV_TILE - 1) / KV_TILE, a.B * a.H);
  flash_bwd_kv_kernel<D, QN><<<grid, NUM_THREADS, smem, stream>>>(
      a.q, a.k, a.v, a.dout, a.lse, a.delta, dk, dv, a.H, a.Sq, a.Sk, a.causal,
      a.Sk - a.Sq, a.scale, a.scale * LOG2E);
  return (int)cudaGetLastError();
}

template <int D>
int launch_q(const Args& a, __nv_bfloat16* dq, cudaStream_t stream) {
  constexpr int smem = q_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_q_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.Sq + Q_TILE - 1) / Q_TILE, a.B * a.H);
  flash_bwd_q_kernel<D><<<grid, NUM_THREADS, smem, stream>>>(
      a.q, a.k, a.v, a.dout, a.lse, a.delta, dq, a.H, a.Sq, a.Sk, a.causal,
      a.Sk - a.Sq, a.scale, a.scale * LOG2E);
  return (int)cudaGetLastError();
}

bool bad_shape(int B, int H, int Sq, int Sk) {
  return B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0;
}

Args make_args(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, int B, int H, int Sq,
               int Sk, int causal, float scale) {
  return Args{static_cast<const __nv_bfloat16*>(q),
              static_cast<const __nv_bfloat16*>(k),
              static_cast<const __nv_bfloat16*>(v),
              static_cast<const __nv_bfloat16*>(dout),
              static_cast<const float*>(lse),
              static_cast<const float*>(delta),
              B, H, Sq, Sk, causal, scale};
}

}  // namespace

// Plain C entry points (bound with ctypes). Each returns a cudaError_t
// value; 0 means the launch was accepted.
extern "C" int rsv_flash_bwd_kv(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, void* dk, void* dv, int B,
                                int H, int Sq, int Sk, int D, int causal,
                                float scale, void* stream) {
  if (bad_shape(B, H, Sq, Sk)) return (int)cudaErrorInvalidValue;
  const Args a = make_args(q, k, v, dout, lse, delta, B, H, Sq, Sk, causal,
                           scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* dk_ = static_cast<__nv_bfloat16*>(dk);
  auto* dv_ = static_cast<__nv_bfloat16*>(dv);
  if (D == 64) return launch_kv<64, 64>(a, dk_, dv_, st);
  if (D == 128) return launch_kv<128, 32>(a, dk_, dv_, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int rsv_flash_bwd_q(const void* q, const void* k, const void* v,
                               const void* dout, const void* lse,
                               const void* delta, void* dq, int B, int H,
                               int Sq, int Sk, int D, int causal, float scale,
                               void* stream) {
  if (bad_shape(B, H, Sq, Sk)) return (int)cudaErrorInvalidValue;
  const Args a = make_args(q, k, v, dout, lse, delta, B, H, Sq, Sk, causal,
                           scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* dq_ = static_cast<__nv_bfloat16*>(dq);
  if (D == 64) return launch_q<64>(a, dq_, st);
  if (D == 128) return launch_q<128>(a, dq_, st);
  return (int)cudaErrorInvalidValue;
}

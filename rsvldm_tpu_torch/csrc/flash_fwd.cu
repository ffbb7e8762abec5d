// K1: flash-attention forward for Hopper (sm_90a), bf16 in, fp32 softmax.
//
// Replaces the Pallas TPU kernel `_flash_kernel` / `flash_attention` in
// rsvldm_tpu/ops/flash_attention.py. Same function: online softmax in base 2
// (scale*log2e folded into the scores, bare exp2), fp32 running max m,
// normalizer l and accumulator, suffix-aligned causal mask
// (q_offset = kv_len - Sq), keys at or past kv_len masked, rows with no valid
// key written as zeros, optional logsumexp in natural-log units [B, H, Sq].
//
// Design for the card, not carried over from the TPU grid: the TPU kernel
// carries m/l/acc in VMEM scratch across a sequential kv grid axis; Hopper
// blocks share nothing across the grid, so one block owns one (b*h, 64-row q
// tile) and loops over the K/V tiles itself. 4 warps, 16 q rows each. Q is
// read once into registers as mma fragments; each 64-key K tile is staged in
// shared memory row-major and each V tile transposed (Vt[d][key]), so every
// fragment load is one aligned 32-bit read. QK^T and PV run on the tensor
// cores as mma.sync m16n8k16 bf16 with fp32 accumulation; P goes from the
// S accumulators straight into A fragments without touching shared memory.
// Causal blocks above the diagonal are never loaded; blocks fully inside the
// valid region skip the mask.
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s): at the SDXL
// shapes (non-causal, D=64, B=2, S=4096/H=10 and S=1024/H=20) the work is
// 4*B*H*S^2*D FLOP against 4*B*S*H*D*2 bytes, i.e. compute-bound: 85.9 GFLOP
// -> 87 us at S=4096, 10.7 GFLOP -> 11 us at S=1024. This first version has
// no TMA, wgmma or load/compute overlap; those are the levers left.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK_M = 64;  // q rows per block, 16 per warp
constexpr int BLOCK_N = 64;  // keys per K/V tile
constexpr int NUM_WARPS = 4;
constexpr int NUM_THREADS = NUM_WARPS * 32;
constexpr int PAD = 8;  // bf16 elements of padding per shared-memory row
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

template <int D>
constexpr int smem_bytes() {
  return ((BLOCK_M + BLOCK_N) * (D + PAD) + D * (BLOCK_N + PAD)) * 2;
}

// q: [B, Sq, H, D], k/v: [B, Sk, H, D], o: [B, Sq, H, D], all bf16 and
// contiguous; lse: [B, H, Sq] fp32 or null.
template <int D>
__global__ void __launch_bounds__(NUM_THREADS)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                 int H, int Sq, int Sk, int kv_len, int causal, int q_offset,
                 float scale_log2e) {
  constexpr int QK_STRIDE = D + PAD;        // Qs / Ks row stride (elements)
  constexpr int VT_STRIDE = BLOCK_N + PAD;  // Vt row stride (elements)
  constexpr int CHUNKS = D / 8;             // 16-byte chunks per row
  constexpr int KSTEPS = D / 16;            // mma k-steps over D
  constexpr int NT_S = BLOCK_N / 8;         // n-tiles of the S block
  constexpr int NT_O = D / 8;               // n-tiles of the output

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + BLOCK_M * QK_STRIDE;
  __nv_bfloat16* Vt = Ks + BLOCK_N * QK_STRIDE;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // thread within the quad

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q_start = blockIdx.x * BLOCK_M;
  const long long row_stride = (long long)H * D;
  const __nv_bfloat16* qb = q + ((long long)b * Sq * H + h) * D;
  const __nv_bfloat16* kbase = k + ((long long)b * Sk * H + h) * D;
  const __nv_bfloat16* vbase = v + ((long long)b * Sk * H + h) * D;

  // ---- Q tile -> shared -> this warp's A fragments (kept in registers)
  for (int c = tid; c < BLOCK_M * CHUNKS; c += NUM_THREADS) {
    const int r = c / CHUNKS;
    const int col = (c - r * CHUNKS) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (q_start + r < Sq)
      val = *reinterpret_cast<const uint4*>(qb + (q_start + r) * row_stride + col);
    *reinterpret_cast<uint4*>(Qs + r * QK_STRIDE + col) = val;
  }
  __syncthreads();
  uint32_t qf[KSTEPS][4];
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    const __nv_bfloat16* p = Qs + (warp * 16 + g) * QK_STRIDE + kk * 16 + t * 2;
    qf[kk][0] = ld32(p);
    qf[kk][1] = ld32(p + 8 * QK_STRIDE);
    qf[kk][2] = ld32(p + 8);
    qf[kk][3] = ld32(p + 8 * QK_STRIDE + 8);
  }

  // ---- number of K/V tiles this q tile can see
  int n_keys = kv_len;
  if (causal) {
    const int last_row = min(q_start + BLOCK_M, Sq) - 1;
    n_keys = min(n_keys, last_row + q_offset + 1);
  }
  const int n_blocks = n_keys > 0 ? (n_keys + BLOCK_N - 1) / BLOCK_N : 0;

  // per thread: rows (warp*16 + g) and (warp*16 + g + 8) of the tile
  float m_i[2] = {NEG_INF, NEG_INF};
  float l_i[2] = {0.f, 0.f};  // partial over this thread's columns
  float acc[NT_O][4];
#pragma unroll
  for (int n = 0; n < NT_O; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int kb = 0; kb < n_blocks; ++kb) {
    const int k_start = kb * BLOCK_N;
    __syncthreads();  // the previous tile is fully consumed
    for (int c = tid; c < BLOCK_N * CHUNKS; c += NUM_THREADS) {
      const int r = c / CHUNKS;
      const int col = (c - r * CHUNKS) * 8;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u);
      uint4 vv = make_uint4(0u, 0u, 0u, 0u);
      if (k_start + r < Sk) {
        const long long off = (long long)(k_start + r) * row_stride + col;
        kv = *reinterpret_cast<const uint4*>(kbase + off);
        vv = *reinterpret_cast<const uint4*>(vbase + off);
      }
      *reinterpret_cast<uint4*>(Ks + r * QK_STRIDE + col) = kv;
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vv);
#pragma unroll
      for (int i = 0; i < 8; ++i) Vt[(col + i) * VT_STRIDE + r] = ve[i];
    }
    __syncthreads();

    // ---- S = Q K^T (16 x 64 per warp), fp32
    float s[NT_S][4];
#pragma unroll
    for (int j = 0; j < NT_S; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        const __nv_bfloat16* p = Ks + (j * 8 + g) * QK_STRIDE + kk * 16 + t * 2;
        mma_16816(s[j], qf[kk], ld32(p), ld32(p + 8));
      }
    }

    // ---- base-2 scores, mask only where the tile crosses kv_len or the
    // causal diagonal of the tile's first row
    const bool need_mask =
        (k_start + BLOCK_N > kv_len) ||
        (causal && k_start + BLOCK_N - 1 > q_start + q_offset);
    float row_max[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < NT_S; ++j) {
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
    for (int j = 0; j < NT_S; ++j) {
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
    for (int n = 0; n < NT_O; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    // ---- O += P V: the S accumulator layout of two adjacent n-tiles is the
    // A fragment layout of one 16-key k-step
#pragma unroll
    for (int kk = 0; kk < BLOCK_N / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int n = 0; n < NT_O; ++n) {
        const __nv_bfloat16* p = Vt + (n * 8 + g) * VT_STRIDE + kk * 16 + t * 2;
        mma_16816(acc[n], pa, ld32(p), ld32(p + 8));
      }
    }
  }

  // ---- normalise and write; rows with no valid key have l = 0, acc = 0
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_i[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float l_safe = fmaxf(l, 1e-30f);
    const float inv = 1.f / l_safe;
    const int row = q_start + warp * 16 + g + r * 8;
    if (row < Sq) {
      __nv_bfloat16* orow = o + (((long long)b * Sq + row) * H + h) * D;
#pragma unroll
      for (int n = 0; n < NT_O; ++n)
        *reinterpret_cast<uint32_t*>(orow + n * 8 + t * 2) =
            pack_bf16(acc[n][2 * r] * inv, acc[n][2 * r + 1] * inv);
      if (lse != nullptr && t == 0)
        lse[(long long)bh * Sq + row] = m_i[r] * LN2 + logf(l_safe);
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int B, int H, int Sq, int Sk, int kv_len, int causal, float scale,
           cudaStream_t stream) {
  constexpr int smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + BLOCK_M - 1) / BLOCK_M, B * H);
  flash_fwd_kernel<D><<<grid, NUM_THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), H, Sq, Sk, kv_len, causal, kv_len - Sq,
      scale * LOG2E);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes). Returns a cudaError_t value;
// 0 means the launch was accepted.
extern "C" int rsv_flash_fwd(const void* q, const void* k, const void* v,
                             void* o, void* lse, int B, int H, int Sq, int Sk,
                             int D, int kv_len, int causal, float scale,
                             void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0 || kv_len < 0 || kv_len > Sk)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return launch<64>(q, k, v, o, lse, B, H, Sq, Sk, kv_len, causal, scale, st);
  if (D == 128)
    return launch<128>(q, k, v, o, lse, B, H, Sq, Sk, kv_len, causal, scale, st);
  return (int)cudaErrorInvalidValue;
}

// Flash-attention backward for Hopper (sm_90a): one fused kernel for dQ, dK
// and dV, bf16 in, fp32 sums, and its prologue.
//
// Replaces the Pallas TPU kernels `_flash_bwd_kv_kernel` (dK, dV) and
// `_flash_bwd_q_kernel` (dQ) of `flash_attention_bwd` in
// rsvldm_tpu/ops/flash_attention.py, and the delta pass the JAX wrapper
// runs before them. Same function: p is rebuilt from the forward's
// logsumexp in base 2, p = exp2(s*scale*log2e - lse*log2e), and masked to
// exact 0 before any product, so no [Sq, Sk] matrix is stored;
// ds = p * (dP - delta) * scale with delta = rowsum(dO * O); dV = p^T dO,
// dK = ds^T Q, dQ = ds K. p and ds are rounded to bf16 before their
// products and every sum is fp32, as the TPU kernels cast them to the
// input dtype. Causal masking is suffix-aligned (q_offset = Sk - Sq);
// queries with no valid key (causal, Sq > Sk) have p = 0 everywhere, so
// their dq rows receive only zero adds and stay exact zeros; sequence
// lengths need not be multiples of the tiles; D is 64 or 128.
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s): five products
// (S, dP, dV, dK, dQ), each B*H*D multiply-adds per valid (query, key)
// pair. At the training shape (B=4, S=1536, H=32, D=128, causal) that is
// 5 x 38.7 = 193 GFLOP -> 0.196 ms, bound by operations; its bytes (q, k,
// v, dO read, dK, dV written once in bf16, dQ in fp32: 404 MB) take
// 0.12 ms.
//
// Design (FlashAttention-3's backward layout, from csrc/hopper.cuh's
// pieces). The TPU kernels carry fp32 accumulators in VMEM across a
// sequential grid axis, one kernel per side. Here one block owns a
// (b*h, 128-key tile) item, keeps dK and dV in registers while it walks
// the q tiles that see its keys, and adds its share of dQ into an fp32
// workspace.
// - 384 threads. Warpgroup 2 is the producer (24 registers after
//   setmaxnreg); one of its threads loads the block's K and V tiles once
//   by TMA, then streams (Q tile, dO tile) pairs of 64 rows, 128-byte
//   swizzled, with their 64 lse*log2e and 64 delta values (bulk copies),
//   through a ring of two stages with full / empty mbarriers. Causal q
//   tiles wholly above the block's first key are never loaded.
// - Warpgroups 0 and 1 are consumers (240 registers), 64 keys each. Per q
//   tile: S^T = K Q^T and dP^T = V dO^T by wgmma (m64n64k16, both operands
//   K-major in shared memory); P^T and dS^T in registers (one FFMA and one
//   exp2 per score; the masked code runs only on tiles that cross Sq, Sk
//   or the causal diagonal); dV += P^T dO and dK += dS^T Q by register-A
//   wgmma, the score accumulators packed to bf16 pairs as A, dO and Q read
//   MN-major through the transpose bit (no transposed copy anywhere).
// - dQ: each warpgroup stores its dS^T to shared memory (bf16, swizzled,
//   conflict-free 4-byte stores; two buffers) and, at D=128, a named
//   barrier joins the two; warpgroup w then computes dQ_tile[:, 64w:64w+64]
//   = dS K[:, 64w:64w+64] over all 128 keys (wgmma with both operands read
//   MN-major), 32 fp32 registers a thread, stages it in shared memory and
//   adds it into the workspace with two TMA reduce-adds (cp.reduce.async.
//   bulk.tensor, 32-column swizzled boxes), issued by one thread. At D=64
//   each warpgroup takes its own 64 keys and all 64 columns instead (twice
//   the adds, no barrier between the two).
// - Blocks are numbered head-major, so the ~132 in flight add into about
//   11 heads' dQ (9 MB, which stays in the 50 MB L2) and read the same Q
//   and dO tiles; numbered key-tile-major, as first written, they touched
//   every head at once (100 MB of dQ) and the adds went to DRAM.
// - Registers at D=128: dK 64 + dV 64 + S^T 32 + dP^T 32 per thread while
//   the scores are live; dK + dV + dQ 32 after. They fit the 240 that
//   setmaxnreg grants only because the mbarrier waits end a deadlock with
//   a faulting store, not __trap() (hopper.cuh, mbar_wait_tight): with
//   __trap() ptxas spilled 756-928 bytes and serialised every wgmma.
// - Shared memory at D=128: K + V 64 KB, two stages of Q + dO 64 KB, two
//   dS^T buffers 32 KB, dQ staging 32 KB, lse/delta 1 KB: 194 KB.
// - The prologue (flash_bwd_prep_kernel) computes delta from one bf16 read
//   of dO and O, writes it and lse*log2e into a [2, B*H, Sq padded to 64]
//   buffer that the ring copies from, and zeroes the dQ workspace; the
//   caller casts the workspace to bf16.
//
// Against the two mma.sync kernels this replaces (K3: dK, dV; K4: dQ):
// wgmma instead of mma.sync with 32-bit fragment loads; TMA and a ring
// instead of copies through registers behind two block barriers per tile;
// no transposed staging (the transpose bit reads dO, Q, dS^T and K in
// place); 64-query tiles against 128 keys instead of 32 queries against
// 64; five products instead of seven (S and dP once); delta from one
// fused pass instead of fp32 copies of dO and O.
//
// Determinism: the order of the fp32 dQ adds changes from run to run (as
// in SDPA's backward), so dq may differ in its last bits between runs; the
// JAX split and the kernels before this one were deterministic. dK and dV
// are deterministic.
//
// Left: the two consumer warpgroups run in step (one barrier per q tile;
// taking turns to issue, as K1 does, measured no faster), and within a
// warpgroup the products wait for the exponentials and the reverse: no
// product of the next tile is in flight while this one's P and dS are
// computed, for want of registers; the grid is not persistent, so each
// block's K/V load and epilogue are exposed; the fp32 workspace costs the
// prologue's zeroing and the caller's cast. ptxas's register and spill
// counts are printed by the build (`-Xptxas -v`); times and shares of the
// bound: PERF.md, from chip_smoke.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int KV_TILE = 128;  // keys per block
constexpr int WG_KEYS = 64;   // keys per consumer warpgroup
constexpr int Q_TILE = 64;    // queries per ring stage
constexpr int THREADS = 384;  // consumers: warpgroups 0, 1; producer: 2
constexpr int CONSUMER_WARPS = 8;
constexpr int PRODUCER_REGS = 24;  // 2 * 128 * 240 + 128 * 24 <= 65536
constexpr int CONSUMER_REGS = 240;
constexpr int ROW_BYTES = 128;                  // one swizzled row: 64 bf16
constexpr int KV_HALF = KV_TILE * ROW_BYTES;    // 64 columns of K or V
constexpr int Q_HALF = Q_TILE * ROW_BYTES;      // 64 columns of Q or dO
constexpr int DS_BYTES = KV_TILE * Q_TILE * 2;  // dS^T, bf16 [key][query]
constexpr int VEC_BYTES = Q_TILE * 4;           // a stage's lse2 or delta
// dQ staging, per warpgroup: its 64 columns as two TMA boxes of 32 fp32
// columns (128-byte rows, swizzled) by 64 rows
constexpr int DQ_BOX_BYTES = Q_TILE * 128;
constexpr int DQ_BYTES = 2 * 2 * DQ_BOX_BYTES;  // both warpgroups
// named barriers: dS^T stored (D=128: 1; D=64: 2 + w); warpgroup w's dQ
// staging free / filled, 4 + w
constexpr int BAR_DS = 1;
constexpr int BAR_DQ = 4;
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct Cfg {
  static constexpr int STAGES = 2;
  static constexpr int KV_BYTES = (D / 64) * KV_HALF;  // K or V tile
  static constexpr int QT_BYTES = (D / 64) * Q_HALF;   // Q or dO tile
  static constexpr int BAR_BYTES = 8 * (1 + 2 * STAGES);
  // + 1024: the dynamic shared memory is aligned up to 1024 bytes by hand
  static constexpr int SMEM = 2 * KV_BYTES + 2 * STAGES * QT_BYTES +
                              2 * DS_BYTES + DQ_BYTES +
                              2 * STAGES * VEC_BYTES + BAR_BYTES + 1024;
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two floats -> one register of two bf16, `lo` in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int D>
__device__ __forceinline__ void fence_acc(float (&acc)[D / 64][32]) {
#pragma unroll
  for (int hf = 0; hf < D / 64; ++hf) fence_regs(acc[hf]);
}

__device__ __forceinline__ float2 ld_shared_f2(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(v.x), "=f"(v.y) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ void st_shared_u32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;\n" :: "r"(addr), "r"(v) : "memory");
}

__device__ __forceinline__ void st_shared_f2(uint32_t addr, float x, float y) {
  asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n"
               :: "r"(addr), "f"(x), "f"(y) : "memory");
}

// acc[64 keys x 64 queries] = A B^T over D: A is this warpgroup's 64 rows
// of K (or V), B the Q (or dO) tile, both K-major.
template <int D>
__device__ __forceinline__ void issue_scores(float (&acc)[32], uint32_t a_addr,
                                             uint32_t b_addr) {
  wgmma_m64n64k16_ss_init<0, 0>(acc, desc_sw128(a_addr, 16, 1024),
                                desc_sw128(b_addr, 16, 1024));
#pragma unroll
  for (int kk = 1; kk < D / 16; ++kk)
    wgmma_m64n64k16_ss<0, 0>(
        acc, desc_sw128(a_addr + (kk / 4) * KV_HALF + (kk % 4) * 32, 16, 1024),
        desc_sw128(b_addr + (kk / 4) * Q_HALF + (kk % 4) * 32, 16, 1024), 1);
}

// s (S^T) -> P^T = exp2(s * c - lse*log2e) in place; this thread's keys
// key0, key0 + 8 against queries q0 + 8*nb + t2 (+1), their lse*log2e at
// shared address `lse` + 32*nb. MASK: exact zeros at pairs past Sk or Sq
// or above the causal diagonal (a separate instantiation, so that tiles
// that need no mask run straight-line code).
template <bool MASK>
__device__ __forceinline__ void scores_to_p(float (&s)[32], uint32_t lse,
                                            float c, int key0, int q0, int Sq,
                                            int Sk, int causal, int q_offset) {
  const int t2 = (threadIdx.x & 3) * 2;
#pragma unroll
  for (int nb = 0; nb < 8; ++nb) {
    const float2 l2 = ld_shared_f2(lse + nb * 32);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * nb + e;
      const float p = ex2(fmaf(s[i], c, -((e & 1) ? l2.y : l2.x)));
      if (MASK) {
        const int key = key0 + (e >> 1) * 8;
        const int qi = q0 + nb * 8 + t2 + (e & 1);
        const bool ok =
            key < Sk && qi < Sq && (!causal || key <= qi + q_offset);
        s[i] = ok ? p : 0.f;
      } else {
        s[i] = p;
      }
    }
  }
}

// acc[64 keys x D] += A B over the tile's 64 queries: A (P^T or dS^T) as
// bf16 pairs in registers, 4 per 16 queries; B (dO or Q) MN-major. One
// 32-register accumulator per 64 columns.
template <int D>
__device__ __forceinline__ void issue_grad(float (&acc)[D / 64][32],
                                           const uint32_t (&a)[16],
                                           uint32_t b_addr) {
#pragma unroll
  for (int kk = 0; kk < Q_TILE / 16; ++kk) {
    const uint32_t f[4] = {a[4 * kk], a[4 * kk + 1], a[4 * kk + 2],
                           a[4 * kk + 3]};
#pragma unroll
    for (int hf = 0; hf < D / 64; ++hf)
      wgmma_m64n64k16_rs_tb(
          acc[hf],
          f, desc_sw128(b_addr + hf * Q_HALF + kk * 16 * ROW_BYTES, Q_HALF,
                        1024));
  }
}

// acc[64 queries x 64 columns] = dS K over KEYS keys: dS^T rows (keys) in
// shared memory as A and K rows as B, both read MN-major.
template <int KEYS>
__device__ __forceinline__ void issue_dq(float (&acc)[32], uint32_t ds_addr,
                                         uint32_t k_addr) {
  wgmma_m64n64k16_ss_init<1, 1>(acc, desc_sw128(ds_addr, Q_HALF, 1024),
                                desc_sw128(k_addr, KV_HALF, 1024));
#pragma unroll
  for (int kk = 1; kk < KEYS / 16; ++kk)
    wgmma_m64n64k16_ss<1, 1>(
        acc, desc_sw128(ds_addr + kk * 16 * ROW_BYTES, Q_HALF, 1024),
        desc_sw128(k_addr + kk * 16 * ROW_BYTES, KV_HALF, 1024), 1);
}

// q/k/v/dout: tensor maps over bf16 [B, S, H, D]; aux: [2, B*H, Sq_pad]
// fp32, lse*log2e then delta, zeros past Sq; dq: a tensor map over the
// zeroed fp32 [B, Sq, H, D] workspace; dk/dv: [B, Sk, H, D] bf16. One
// block per (b*h, 128-key tile).
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                 const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v,
                 const __grid_constant__ CUtensorMap tm_do,
                 const __grid_constant__ CUtensorMap tm_dq,
                 const float* __restrict__ aux,
                 __nv_bfloat16* __restrict__ dk,
                 __nv_bfloat16* __restrict__ dv, int BH, int H, int Sq, int Sk,
                 int Sq_pad, int causal, int q_offset, float scale,
                 float scale_log2e) {
  using C = Cfg<D>;
  constexpr int STAGES = C::STAGES;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sK = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sV = sK + C::KV_BYTES;
  const uint32_t sQ = sV + C::KV_BYTES;
  const uint32_t sDO = sQ + STAGES * C::QT_BYTES;
  const uint32_t sDS = sDO + STAGES * C::QT_BYTES;
  const uint32_t sDQ = sDS + 2 * DS_BYTES;
  const uint32_t sLSE = sDQ + DQ_BYTES;
  const uint32_t sDELTA = sLSE + STAGES * VEC_BYTES;
  const uint32_t kv_full = sDELTA + STAGES * VEC_BYTES;
  const uint32_t full = kv_full + 8;
  const uint32_t empty = full + 8 * STAGES;

  // Blocks are numbered head-major: the key tiles of one (b, h) run side by
  // side, so that the blocks in flight add into a few heads' dQ, which
  // stays in L2, and read the same Q and dO tiles; within a head the key
  // tiles that see the most causal queries start first.
  const int n_kt = gridDim.x / BH;
  const int bh = blockIdx.x / n_kt;
  const int b = bh / H;
  const int h = bh - b * H;
  const int k_start = (blockIdx.x % n_kt) * KV_TILE;
  // the q tiles that see a key of this block: causal, from the one that
  // holds query k_start - q_offset
  int j0 = 0;
  if (causal) {
    const int first = k_start - q_offset;
    j0 = first > 0 ? first / Q_TILE : 0;
  }
  const int n = max((Sq + Q_TILE - 1) / Q_TILE - j0, 0);
  // warp-uniform as far as the compiler can tell, so that the wgmma
  // descriptors derived from it stay in uniform registers
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, CONSUMER_WARPS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 2) {
    // ---------------------------------------------------------- producer
    reg_dealloc<PRODUCER_REGS>();
    if (threadIdx.x == 256 && n > 0) {
      tma_prefetch_map(&tm_q);
      tma_prefetch_map(&tm_do);
      mbar_arrive_expect_tx(kv_full, 2 * C::KV_BYTES);
#pragma unroll
      for (int half = 0; half < D / 64; ++half) {
        tma_load_4d(sK + half * KV_HALF, &tm_k, kv_full, half * 64, h,
                    k_start, b);
        tma_load_4d(sV + half * KV_HALF, &tm_v, kv_full, half * 64, h,
                    k_start, b);
      }
      const float* lse2 = aux + (long long)bh * Sq_pad;
      const float* delta = aux + ((long long)BH + bh) * Sq_pad;
      for (int j = 0; j < n; ++j) {
        const int s = j % STAGES;
        const int q0 = (j0 + j) * Q_TILE;
        // the stage's previous fill was released (passes on the first)
        mbar_wait_tight(empty + 8 * s, ((j / STAGES) & 1) ^ 1);
        const uint32_t bar = full + 8 * s;
        mbar_arrive_expect_tx(bar, 2 * C::QT_BYTES + 2 * VEC_BYTES);
#pragma unroll
        for (int half = 0; half < D / 64; ++half) {
          tma_load_4d(sQ + s * C::QT_BYTES + half * Q_HALF, &tm_q, bar,
                      half * 64, h, q0, b);
          tma_load_4d(sDO + s * C::QT_BYTES + half * Q_HALF, &tm_do, bar,
                      half * 64, h, q0, b);
        }
        bulk_load(sLSE + s * VEC_BYTES, lse2 + q0, VEC_BYTES, bar);
        bulk_load(sDELTA + s * VEC_BYTES, delta + q0, VEC_BYTES, bar);
      }
    }
  } else {
    // --------------------------------------------------------- consumers
    reg_alloc<CONSUMER_REGS>();
    const int lane = threadIdx.x & 31;
    const int warp = (threadIdx.x >> 5) & 3;  // within the warpgroup
    const int g = lane >> 2;
    const int t2 = (lane & 3) * 2;
    const int kw0 = k_start + wg * WG_KEYS;  // this warpgroup's first key
    const int key0 = kw0 + warp * 16 + g;    // this thread's keys: +0, +8
    const uint32_t k_rows = sK + wg * WG_KEYS * ROW_BYTES;
    const uint32_t v_rows = sV + wg * WG_KEYS * ROW_BYTES;
    const int ds_row = wg * WG_KEYS + warp * 16 + g;  // and + 8
    const float c = scale_log2e;

    float dk_acc[D / 64][32], dv_acc[D / 64][32];
#pragma unroll
    for (int hf = 0; hf < D / 64; ++hf)
#pragma unroll
      for (int i = 0; i < 32; ++i) dk_acc[hf][i] = dv_acc[hf][i] = 0.f;
    if (n > 0) mbar_wait_tight(kv_full, 0);

    for (int j = 0; j < n; ++j) {
      const int s = j % STAGES;
      const int q0 = (j0 + j) * Q_TILE;
      const uint32_t q_addr = sQ + s * C::QT_BYTES;
      const uint32_t do_addr = sDO + s * C::QT_BYTES;
      const uint32_t ds_addr = sDS + (j & 1) * DS_BYTES;
      mbar_wait_tight(full + 8 * s, (j / STAGES) & 1);
      // tiles that cross Sq, Sk or this warpgroup's causal diagonal
      const bool need_mask = q0 + Q_TILE > Sq || kw0 + WG_KEYS > Sk ||
                             (causal && kw0 + WG_KEYS - 1 > q0 + q_offset);
      // S^T and dP^T: this thread's keys key0, key0 + 8 against queries
      // q0 + 8*nb + t2 (+1)
      float sacc[32], dpacc[32];
      wgmma_fence();
      issue_scores<D>(sacc, k_rows, q_addr);
      wgmma_commit();
      issue_scores<D>(dpacc, v_rows, do_addr);
      wgmma_commit();
      const uint32_t vec = s * VEC_BYTES + t2 * 4;

      // P^T, exact zeros where masked
      wgmma_wait<1>();
      fence_regs(sacc);
      if (need_mask)
        scores_to_p<true>(sacc, sLSE + vec, c, key0, q0, Sq, Sk, causal,
                          q_offset);
      else
        scores_to_p<false>(sacc, sLSE + vec, c, key0, q0, Sq, Sk, causal,
                           q_offset);
      // dS^T = P^T (dP^T - delta) scale
      wgmma_wait<0>();
      fence_regs(dpacc);
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) {
        const float2 d2 = ld_shared_f2(sDELTA + vec + nb * 32);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * nb + e;
          dpacc[i] = sacc[i] * (dpacc[i] - ((e & 1) ? d2.y : d2.x)) * scale;
        }
      }
      uint32_t pa[16], da[16];  // wgmma reads them until retired
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        pa[i] = pack_bf16(sacc[2 * i], sacc[2 * i + 1]);
        da[i] = pack_bf16(dpacc[2 * i], dpacc[2 * i + 1]);
      }
      // dS^T to shared memory for dQ: row = the key within the block, 64
      // queries (128 bytes) a row, 16-byte chunk nb at nb ^ (row % 8)
#pragma unroll
      for (int nb = 0; nb < 8; ++nb)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          st_shared_u32(ds_addr + (ds_row + 8 * r) * ROW_BYTES +
                            ((nb ^ g) << 4) + t2 * 2,
                        da[2 * nb + r]);

      // dV += P^T dO, dK += dS^T Q
      wgmma_fence();
      fence_acc<D>(dk_acc);
      fence_acc<D>(dv_acc);
      fence_regs(pa);
      fence_regs(da);
      issue_grad<D>(dv_acc, pa, do_addr);
      issue_grad<D>(dk_acc, da, q_addr);
      wgmma_commit();
      // both warpgroups' dS^T stored (at D=64 this warpgroup's own); the
      // wait retires the dV and dK products
      fence_proxy_async();
      if constexpr (D == 128)
        named_bar_sync(BAR_DS, 2 * 128);
      else
        named_bar_sync(BAR_DS + 1 + wg, 128);
      wgmma_wait<0>();
      fence_acc<D>(dk_acc);
      fence_acc<D>(dv_acc);
      fence_regs(pa);
      fence_regs(da);
      // the stage's Q, dO, lse and delta are no longer read
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * s);

      // dQ for this tile, this warpgroup's share
      float dq[32];
      wgmma_fence();
      if constexpr (D == 128)
        issue_dq<KV_TILE>(dq, ds_addr, sK + wg * KV_HALF);
      else
        issue_dq<WG_KEYS>(dq, ds_addr + wg * WG_KEYS * ROW_BYTES, k_rows);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dq);

      // dQ into the fp32 workspace (the prologue's zeros) by TMA reduce-add:
      // this warpgroup's 64 x 64 share through shared memory, two boxes,
      // issued by its first thread once the previous tile's are read out
      const uint32_t dq_stage = sDQ + wg * 2 * DQ_BOX_BYTES;
      const bool leader = threadIdx.x % 128 == 0;
      if (leader) bulk_wait_read<0>();
      named_bar_sync(BAR_DQ + wg, 128);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = warp * 16 + g + 8 * r;
#pragma unroll
        for (int nb = 0; nb < 8; ++nb)
          st_shared_f2(dq_stage + (nb / 4) * DQ_BOX_BYTES + row * 128 +
                           (((2 * (nb % 4) + (t2 >> 2)) ^ g) << 4) +
                           (t2 & 2) * 4,
                       dq[4 * nb + 2 * r], dq[4 * nb + 2 * r + 1]);
      }
      fence_proxy_async();
      named_bar_sync(BAR_DQ + wg, 128);
      if (leader) {
        const int col0 = D == 128 ? wg * 64 : 0;
        tma_reduce_add_4d(&tm_dq, dq_stage, col0, h, q0, b);
        tma_reduce_add_4d(&tm_dq, dq_stage + DQ_BOX_BYTES, col0 + 32, h, q0,
                          b);
        bulk_commit();
      }
    }
    if (threadIdx.x % 128 == 0) bulk_wait<0>();

    // ---- dK, dV once, bf16; keys no query sees get zeros
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = key0 + 8 * r;
      if (key < Sk) {
        const long long off = (((long long)b * Sk + key) * H + h) * D + t2;
#pragma unroll
        for (int nb = 0; nb < D / 8; ++nb) {
          const float* k2 = &dk_acc[nb / 8][4 * (nb % 8) + 2 * r];
          const float* v2 = &dv_acc[nb / 8][4 * (nb % 8) + 2 * r];
          *reinterpret_cast<uint32_t*>(dk + off + nb * 8) =
              pack_bf16(k2[0], k2[1]);
          *reinterpret_cast<uint32_t*>(dv + off + nb * 8) =
              pack_bf16(v2[0], v2[1]);
        }
      }
    }
  }
}

__device__ __forceinline__ float dot_bf16x2(uint32_t a, uint32_t b) {
  const float2 x = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&a));
  const float2 y = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&b));
  return x.x * y.x + x.y * y.y;
}

// The prologue: one warp per (b, q, h) row of o / dout ([B, Sq, H, D] bf16,
// the rows in memory order). Writes lse*log2e and delta = rowsum(dO * O) of
// the row into aux ([2, B*H, Sq_pad] fp32; zeros at Sq..Sq_pad) and zeroes
// the row of the dQ workspace ([B, Sq, H, D] fp32).
template <int D>
__global__ void __launch_bounds__(256)
flash_bwd_prep_kernel(const __nv_bfloat16* __restrict__ o,
                      const __nv_bfloat16* __restrict__ dout,
                      const float* __restrict__ lse, float* __restrict__ aux,
                      float* __restrict__ dq_acc, long long rows, int BH,
                      int H, int Sq, int Sq_pad) {
  const long long r = (long long)blockIdx.x * 8 + (threadIdx.x >> 5);
  if (r >= rows) return;
  const int lane = threadIdx.x & 31;
  const int h = (int)(r % H);
  const long long bq = r / H;
  const int qi = (int)(bq % Sq);
  const int bh = (int)(bq / Sq) * H + h;
  const long long off = r * D + lane * (D / 32);
  float acc;
  if constexpr (D == 128) {
    const uint2 x = *reinterpret_cast<const uint2*>(o + off);
    const uint2 y = *reinterpret_cast<const uint2*>(dout + off);
    acc = dot_bf16x2(x.x, y.x) + dot_bf16x2(x.y, y.y);
    *reinterpret_cast<float4*>(dq_acc + off) = make_float4(0.f, 0.f, 0.f, 0.f);
  } else {
    acc = dot_bf16x2(*reinterpret_cast<const uint32_t*>(o + off),
                     *reinterpret_cast<const uint32_t*>(dout + off));
    *reinterpret_cast<float2*>(dq_acc + off) = make_float2(0.f, 0.f);
  }
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, m);
  float* lse2 = aux + (long long)bh * Sq_pad;
  float* delta = aux + ((long long)BH + bh) * Sq_pad;
  if (lane == 0) {
    lse2[qi] = lse[(long long)bh * Sq + qi] * LOG2E;
    delta[qi] = acc;
  }
  if (qi == Sq - 1)
    for (int p = Sq + lane; p < Sq_pad; p += 32) lse2[p] = delta[p] = 0.f;
}

int sq_pad(int Sq) { return (Sq + Q_TILE - 1) / Q_TILE * Q_TILE; }

template <int D>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const void* aux, void* dq_acc, void* dk, void* dv, int B, int H,
           int Sq, int Sk, int causal, float scale, cudaStream_t stream) {
  using C = Cfg<D>;
  CUtensorMap tm_q, tm_k, tm_v, tm_do, tm_dq;
  cudaError_t err = encode_bshd_map(&tm_q, q, B, Sq, H, D, Q_TILE);
  if (err == cudaSuccess) err = encode_bshd_map(&tm_do, dout, B, Sq, H, D, Q_TILE);
  if (err == cudaSuccess) err = encode_bshd_map(&tm_k, k, B, Sk, H, D, KV_TILE);
  if (err == cudaSuccess) err = encode_bshd_map(&tm_v, v, B, Sk, H, D, KV_TILE);
  if (err == cudaSuccess)
    err = encode_bshd_map_f32(&tm_dq, dq_acc, B, Sq, H, D, Q_TILE);
  if (err != cudaSuccess) return (int)err;
  // once per process (one card), so that a launch inside a CUDA graph
  // capture makes no call but the launch itself
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_bwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::SMEM);
  if (attr != cudaSuccess) return (int)attr;
  const long long blocks =
      (long long)B * H * ((Sk + KV_TILE - 1) / KV_TILE);
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  flash_bwd_kernel<D><<<(int)blocks, THREADS, C::SMEM, stream>>>(
      tm_q, tm_k, tm_v, tm_do, tm_dq, static_cast<const float*>(aux),
      static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), B * H, H, Sq, Sk, sq_pad(Sq), causal,
      Sk - Sq, scale, scale * LOG2E);
  return (int)cudaGetLastError();
}

template <int D>
int launch_prep(const void* o, const void* dout, const void* lse, void* aux,
                void* dq_acc, int B, int H, int Sq, cudaStream_t stream) {
  const long long rows = (long long)B * Sq * H;
  const long long blocks = (rows + 7) / 8;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  flash_bwd_prep_kernel<D><<<(int)blocks, 256, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(o),
      static_cast<const __nv_bfloat16*>(dout), static_cast<const float*>(lse),
      static_cast<float*>(aux), static_cast<float*>(dq_acc), rows, B * H, H,
      Sq, sq_pad(Sq));
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points (bound with ctypes). Each returns a cudaError_t
// value; 0 means the launch was accepted. The prologue runs first, on the
// same stream: o, dout [B, Sq, H, D] bf16; lse [B, H, Sq] fp32; aux
// [2, B*H, Sq rounded up to 64] fp32 and dq_acc [B, Sq, H, D] fp32 are
// written by it and read by the main kernel.
extern "C" int rsv_flash_bwd_prep(const void* o, const void* dout,
                                  const void* lse, void* aux, void* dq_acc,
                                  int B, int H, int Sq, int D, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64) return launch_prep<64>(o, dout, lse, aux, dq_acc, B, H, Sq, st);
  if (D == 128) return launch_prep<128>(o, dout, lse, aux, dq_acc, B, H, Sq, st);
  return (int)cudaErrorInvalidValue;
}

// q, dout [B, Sq, H, D], k, v, dk, dv [B, Sk, H, D] bf16, contiguous;
// dq_acc receives dQ in fp32 (adds into the prologue's zeros).
extern "C" int rsv_flash_bwd(const void* q, const void* k, const void* v,
                             const void* dout, const void* aux, void* dq_acc,
                             void* dk, void* dv, int B, int H, int Sq, int Sk,
                             int D, int causal, float scale, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return launch<64>(q, k, v, dout, aux, dq_acc, dk, dv, B, H, Sq, Sk, causal,
                      scale, st);
  if (D == 128)
    return launch<128>(q, k, v, dout, aux, dq_acc, dk, dv, B, H, Sq, Sk,
                       causal, scale, st);
  return (int)cudaErrorInvalidValue;
}

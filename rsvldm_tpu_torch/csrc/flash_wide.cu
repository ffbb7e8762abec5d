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
// Design. At D=512 a 64-row tile's O, or a 64-key tile's dK + dV, in fp32
// is 128 KB and 256 KB: a whole warpgroup's, or SM's, registers. So the
// columns are cut into 64-wide boxes (one TMA box, one 128-byte swizzled
// row) and the two consumer warpgroups of a block share a tile and split
// its columns, while the scores, which contract over all of D, are
// computed once a tile and shared. Both kernels: 384 threads, warpgroups
// 0 and 1 consumers (240 registers after setmaxnreg), warpgroup 2 the
// producer (24), one thread of which issues every load by TMA over the
// 4-D [B, S, H, D] maps (rows past S zero-filled) into rings of slots with
// full / empty mbarriers (every consumer warp waits for a slot's fill and
// releases it, whether it reads it or not); wgmma for every product, both
// operands in shared memory, V, dO, Q, K and dS^T read MN-major through
// the transpose bit where they are the contraction's rows (no thread
// transposes anything); the waits end a deadlock with a faulting store
// (hopper.cuh, mbar_wait_tight), not __trap(), which costs registers.
//
// Forward: a work item is (b*h, 64-query tile, up to 8 of O's boxes); O
// columns past 512 (D=576, 640, ...) go to a second item, which computes
// the scores again (at D=640: two items of 320 columns, S twice, 1.5x the
// tensor-core work; at D <= 512 one item, S once). A persistent grid of one
// block per SM walks the items longest first (the q tiles with the most
// causal keys).
// - Per 128-key tile, warpgroup w computes S_w = Q K[64w..64w+63]^T over all
//   of D (m64n64k16) from a ring of 4 slots, each a 64-column box of the Q
//   tile and of the K tile (24 KB): Q is streamed with K rather than kept,
//   so shared memory does not grow with D.
// - The two warpgroups exchange their row maxima through shared memory
//   (a named barrier), so both hold the same running max; each writes its
//   half of P (bf16, swizzled) into a shared 64 x 128 P tile (a second
//   barrier); then warpgroup w adds P V[:, its boxes] into its O boxes
//   (m64n64k16, P the shared-memory A, V's 128 x 64 boxes read MN-major)
//   from a ring of 3 slots, each one V box per warpgroup (32 KB).
// - O: up to 4 boxes a warpgroup, 128 fp32 registers a thread at D=512
//   (at D=320, 3 and 2). The row sums l are summed over the warpgroups at
//   the end through shared memory; warpgroup 0 of the item holding box 0
//   writes lse.
// - Causal tiles wholly above the diagonal are never loaded; masking runs
//   only on tiles that cross kv_len or the item's first row's diagonal.
// - Shared memory: 96 + 96 KB of rings, 16 KB P, 1.5 KB of row vectors.
//
// Backward: a work item is (b*h, 64-key tile, up to 4 boxes of dK / dV /
// dQ's columns), one block each, head-major (as flash_bwd.cu, so that the
// blocks in flight add into a few heads' dQ, which stays in L2); at D=512
// two items a key tile, each computing S^T and dP^T once over all of D:
// 7 products' work for the 5 needed (D=320: two items of 3 + 2 boxes,
// 7 for 5; D=640: three, 9 for 5).
// - Per 64-query tile, warpgroup w computes S^T and dP^T for the tile's
//   64 keys against queries 32w..32w+31 (m64n32k16, K / V rows as A, Q /
//   dO rows as B) over all of D, from a ring of 5 slots of 4 boxes (K, Q,
//   V, dO: 32 KB); P^T = exp2(S^T c - lse2) and dS^T = P^T (dP^T - delta)
//   scale in registers (lse2 and delta read from the prologue's buffer);
//   both halves go to shared memory as bf16 (two buffers, one barrier).
// - Then for each of its boxes (2 at most: dK 64 + dV 64 registers a
//   thread) warpgroup w takes a slot holding that box of dO, Q and K:
//   dV += P^T dO, dK += dS^T Q (m64n64k16, P^T / dS^T the A) and
//   dQ[:, box] = dS K[:, box] (A = dS^T read MN-major), which it stages in
//   shared memory (fp32, swizzled) and adds into the fp32 workspace with
//   two TMA reduce-adds.
// - dK and dV are written once in bf16; dq is the workspace, which the
//   prologue zeroed and the caller casts to bf16. The adds' order changes
//   from run to run, so dq's last bits may too (as at D <= 256).
// - Shared memory: a 160 KB ring, 32 KB of P^T / dS^T, 32 KB of dQ
//   staging.
//
// Against the four faults of the mma.sync kernels this replaces (one
// block a 128-column slab, 128 threads, a separate dQ kernel):
// 1. Scores recomputed: there each slab recomputed S (and dP) over all of
//    D and the dQ kernel both again, 2.5x the forward's and 3.8x the
//    backward's tensor work at D=512. Here S is computed once an item
//    and shared by its warpgroups through shared memory: 1x forward,
//    1.4x backward at D=512.
// 2. No copy in flight: there every chunk was staged through registers
//    by all threads between two block barriers. Here one producer thread
//    keeps TMA loads in flight in the rings while the consumers compute.
// 3. mma.sync with 32-bit fragment loads: here every product is wgmma
//    with both operands in shared memory, V / dO / Q / K / dS^T read
//    through the transpose bit.
// 4. Registers at one warpgroup a block (236-252 there): here two consumer
//    warpgroups split the columns, 240 registers each after setmaxnreg.
// Budget, as ptxas reports it (sm_90a): both kernels 168 registers at
// launch (the consumers run at 240 after setmaxnreg), 0 bytes spilled, no
// serialised wgmma (the prologue 32); dynamic shared memory 215,664 bytes
// forward, 230,480 backward (of 232,448).
// Left: every slot is read from L2 once per (query, key) tile pair, K and
// V included (the rings do not hold a tile's boxes across the other
// side's tiles), so the kernels move more bytes from L2 than
// flash_fwd.cu / flash_bwd.cu; within a warpgroup the products and the
// exponentials do not overlap; the backward's grid is not persistent.
// Times and shares of the bound: PERF.md, from chip_smoke.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int THREADS = 384;       // consumers: warpgroups 0, 1; producer: 2
constexpr int CONSUMERS = 256;     // threads of the two consumer warpgroups
constexpr int CONSUMER_WARPS = 8;
constexpr int PRODUCER_REGS = 24;  // 2 * 128 * 240 + 128 * 24 <= 65536
constexpr int CONSUMER_REGS = 240;
constexpr int BOX_COLS = 64;       // columns of a box: one swizzled row
constexpr int ROW_BYTES = 128;
constexpr int TILE = 64;           // query rows of a tile; keys (backward)
constexpr int BOX = TILE * ROW_BYTES;  // a 64-row box, bf16: 8 KB
constexpr float NEG_INF = -1e30f;  // initial running max, as the TPU kernel
constexpr float LN2 = 0.6931471805599453f;
constexpr float LOG2E = 1.4426950408889634f;

// ------------------------------------------------------------------ forward
constexpr int F_KEYS = 128;                  // keys a tile, 64 a warpgroup
constexpr int F_KBOX = F_KEYS * ROW_BYTES;   // a K or V box: 16 KB
constexpr int F_MAX_BOXES = 8;               // O boxes an item
constexpr int F_WG_BOXES = F_MAX_BOXES / 2;  // O boxes a warpgroup
constexpr int F_QK_SLOT = BOX + F_KBOX;      // a Q box and a K box
constexpr int F_V_SLOT = 2 * F_KBOX;         // a V box per warpgroup
constexpr int F_QK_STAGES = 4;
constexpr int F_V_STAGES = 3;
constexpr int F_P_BYTES = 2 * BOX;           // P: 64 rows x 128 keys
constexpr int F_VEC = 2 * TILE * 4;          // a float per (warpgroup, row)
constexpr int F_BARS = 8 * 2 * (F_QK_STAGES + F_V_STAGES);
// + 1024: the dynamic shared memory is aligned up to 1024 bytes by hand
constexpr int F_SMEM = F_QK_STAGES * F_QK_SLOT + F_V_STAGES * F_V_SLOT +
                       F_P_BYTES + 3 * F_VEC + F_BARS + 1024;
static_assert(F_SMEM <= 232448, "more shared memory than a block can use");
// named barriers of the forward (0 is __syncthreads')
constexpr int BAR_MAX = 1;  // row maxima exchanged
constexpr int BAR_P = 2;    // both halves of P stored
constexpr int BAR_L = 3;    // row sums exchanged

// ----------------------------------------------------------------- backward
constexpr int B_MAX_BOXES = 4;               // dK / dV / dQ boxes an item
constexpr int B_WG_BOXES = B_MAX_BOXES / 2;  // a warpgroup's
constexpr int B_SLOT = 4 * BOX;              // K, Q, V, dO boxes (or dO, Q, K)
constexpr int B_STAGES = 5;
constexpr int B_PDS = 2 * BOX;               // P^T, dS^T: 64 keys x 64 queries
constexpr int DQ_BOX = TILE * 128;           // 32 fp32 columns x 64 rows
constexpr int B_DQ = 2 * DQ_BOX;             // a warpgroup's box of dQ
constexpr int B_BARS = 8 * 2 * B_STAGES;
constexpr int B_SMEM = B_STAGES * B_SLOT + 2 * B_PDS + 2 * B_DQ + B_BARS + 1024;
static_assert(B_SMEM <= 232448, "more shared memory than a block can use");
constexpr int BAR_PDS = 1;  // both halves of P^T and dS^T stored
constexpr int BAR_DQ = 2;   // + w: warpgroup w's dQ staging free / filled

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

__device__ __forceinline__ void st_shared_u32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;\n" :: "r"(addr), "r"(v) : "memory");
}

__device__ __forceinline__ void st_shared_f2(uint32_t addr, float x, float y) {
  asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n"
               :: "r"(addr), "f"(x), "f"(y) : "memory");
}

// The consumer side of a ring whose barriers sit 8 bytes apart from shared
// address `bar`: wait for fill `pos`, release it (one arrive per warp).
__device__ __forceinline__ void wait_full(uint32_t bar, int pos, int stages) {
  mbar_wait_tight(bar + 8 * (pos % stages), (pos / stages) & 1);
}

__device__ __forceinline__ void release(uint32_t bar, int pos, int stages) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(bar + 8 * (pos % stages));
}

// The producer side: wait until fill `pos`'s slot was released by its
// previous fill (passes at once on the first round).
__device__ __forceinline__ void wait_empty(uint32_t bar, int pos, int stages) {
  mbar_wait_tight(bar + 8 * (pos % stages), ((pos / stages) & 1) ^ 1);
}

__device__ __forceinline__ uint64_t kmajor(uint32_t addr) {
  return desc_sw128(addr, 16, 1024);
}

// MN-major: rows of the contraction dim, 64 output columns a row.
__device__ __forceinline__ uint64_t mnmajor(uint32_t addr) {
  return desc_sw128(addr, BOX, 1024);
}

// An item's boxes [box0, box0 + nb0) for warpgroup 0 and the next nb1 for
// warpgroup 1 (nb0 >= nb1) of `n` boxes from `box0`.
struct Boxes {
  int box0, nb0, nb1;
};

__device__ __forceinline__ Boxes boxes_of(int part, int per_item, int NB) {
  Boxes x;
  x.box0 = part * per_item;
  const int n = min(NB - x.box0, per_item);
  x.nb0 = (n + 1) / 2;
  x.nb1 = n - x.nb0;
  return x;
}

// ------------------------------------------------------------------ forward
// A work item: (b*h, 64-row q tile, a part of O's boxes). Items are
// numbered longest first (the q tiles with the most causal keys, then the
// rest); block c of the persistent grid takes items c, c + gridDim.x, ...
struct FwdItem {
  int b, h, bh, q_start, n_tiles;
  Boxes x;
};

__device__ __forceinline__ FwdItem fwd_item(int i, int BH, int H, int n_qt,
                                            int split, int per_item, int NB,
                                            int Sq, int kv_len, int causal,
                                            int q_offset) {
  FwdItem it;
  it.x = boxes_of(i % split, per_item, NB);
  i /= split;
  it.bh = i % BH;
  it.b = it.bh / H;
  it.h = it.bh - it.b * H;
  it.q_start = (n_qt - 1 - i / BH) * TILE;
  int n_keys = kv_len;
  if (causal) n_keys = min(n_keys, min(it.q_start + TILE, Sq) + q_offset);
  it.n_tiles = n_keys > 0 ? (n_keys + F_KEYS - 1) / F_KEYS : 0;
  return it;
}

// q/k/v: tensor maps over bf16 [B, S, H, D] (q boxes of 64 rows, k / v of
// 128); o: [B, Sq, H, D] bf16, contiguous; lse: [B, H, Sq] fp32 or null.
// `split` items a (b*h, q tile), each of at most `per_item` <= 8 boxes.
__global__ void __launch_bounds__(THREADS, 1)
flash_wide_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                      int BH, int H, int Sq, int D, int kv_len, int causal,
                      int q_offset, int split, int per_item,
                      float scale_log2e) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sQK = (raw + 1023) & ~1023u;
  const uint32_t sV = sQK + F_QK_STAGES * F_QK_SLOT;
  const uint32_t sP = sV + F_V_STAGES * F_V_SLOT;
  const uint32_t sVec = sP + F_P_BYTES;
  float* s_max = reinterpret_cast<float*>(smem_raw + (sVec - raw));
  float* s_l = s_max + 2 * TILE;  // two sets, by the item's parity
  const uint32_t qk_full = sVec + 3 * F_VEC;
  const uint32_t qk_empty = qk_full + 8 * F_QK_STAGES;
  const uint32_t v_full = qk_empty + 8 * F_QK_STAGES;
  const uint32_t v_empty = v_full + 8 * F_V_STAGES;

  const int NB = D / BOX_COLS;
  const int n_qt = (Sq + TILE - 1) / TILE;
  const int n_items = BH * n_qt * split;
  // warp-uniform as far as the compiler can tell, so that the wgmma
  // descriptors derived from it stay in uniform registers
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);

  if (threadIdx.x == 0) {
    for (int s = 0; s < F_QK_STAGES; ++s) {
      mbar_init(qk_full + 8 * s, 1);
      mbar_init(qk_empty + 8 * s, CONSUMER_WARPS);
    }
    for (int s = 0; s < F_V_STAGES; ++s) {
      mbar_init(v_full + 8 * s, 1);
      mbar_init(v_empty + 8 * s, CONSUMER_WARPS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 2) {
    // ---------------------------------------------------------- producer
    reg_dealloc<PRODUCER_REGS>();
    if (threadIdx.x == 256) {
      tma_prefetch_map(&tm_q);
      tma_prefetch_map(&tm_k);
      tma_prefetch_map(&tm_v);
      int tq = 0, tv = 0;  // fills of the two rings so far
      for (int i = blockIdx.x; i < n_items; i += gridDim.x) {
        const FwdItem w = fwd_item(i, BH, H, n_qt, split, per_item, NB, Sq,
                                   kv_len, causal, q_offset);
        for (int j = 0; j < w.n_tiles; ++j) {
          for (int c = 0; c < NB; ++c, ++tq) {
            wait_empty(qk_empty, tq, F_QK_STAGES);
            const uint32_t bar = qk_full + 8 * (tq % F_QK_STAGES);
            const uint32_t slot = sQK + (tq % F_QK_STAGES) * F_QK_SLOT;
            mbar_arrive_expect_tx(bar, F_QK_SLOT);
            tma_load_4d(slot, &tm_q, bar, c * BOX_COLS, w.h, w.q_start, w.b);
            tma_load_4d(slot + BOX, &tm_k, bar, c * BOX_COLS, w.h,
                        j * F_KEYS, w.b);
          }
          for (int p = 0; p < w.x.nb0; ++p, ++tv) {
            wait_empty(v_empty, tv, F_V_STAGES);
            const uint32_t bar = v_full + 8 * (tv % F_V_STAGES);
            const uint32_t slot = sV + (tv % F_V_STAGES) * F_V_SLOT;
            const bool pair = p < w.x.nb1;
            mbar_arrive_expect_tx(bar, pair ? 2 * F_KBOX : F_KBOX);
            tma_load_4d(slot, &tm_v, bar, (w.x.box0 + p) * BOX_COLS, w.h,
                        j * F_KEYS, w.b);
            if (pair)
              tma_load_4d(slot + F_KBOX, &tm_v, bar,
                          (w.x.box0 + w.x.nb0 + p) * BOX_COLS, w.h,
                          j * F_KEYS, w.b);
          }
        }
      }
    }
  } else {
    // --------------------------------------------------------- consumers
    reg_alloc<CONSUMER_REGS>();
    const int lane = threadIdx.x & 31;
    const int warp = (threadIdx.x >> 5) & 3;  // within the warpgroup
    const int g = lane >> 2;
    const int t2 = (lane & 3) * 2;
    const int rl = warp * 16 + g;  // this thread's rows of the tile: +0, +8
    const int key_off = wg * 64;   // this warpgroup's keys within a tile
    const float c = scale_log2e;
    int tq = 0, tv = 0, parity = 0;

    float acc[F_WG_BOXES][32];
    float s[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) s[e] = 0.f;
    for (int i = blockIdx.x; i < n_items; i += gridDim.x, parity ^= 1) {
      const FwdItem w = fwd_item(i, BH, H, n_qt, split, per_item, NB, Sq,
                                 kv_len, causal, q_offset);
      const int nbw = wg == 0 ? w.x.nb0 : w.x.nb1;
      const int first_box = w.x.box0 + (wg == 0 ? 0 : w.x.nb0);
      // tiles whose keys cross kv_len or the item's first row's diagonal
      const int mask_from =
          causal ? min(kv_len, w.q_start + q_offset + 1) : kv_len;
#pragma unroll
      for (int b = 0; b < F_WG_BOXES; ++b)
#pragma unroll
        for (int e = 0; e < 32; ++e) acc[b][e] = 0.f;
      float m[2] = {NEG_INF, NEG_INF};
      float l[2] = {0.f, 0.f};  // partial over this thread's keys

      for (int j = 0; j < w.n_tiles; ++j) {
        // S = Q K^T for this warpgroup's 64 keys over all of D, box by box
        for (int cc = 0; cc < NB; ++cc) {
          const int pos = tq + cc;
          const uint32_t slot = sQK + (pos % F_QK_STAGES) * F_QK_SLOT;
          wait_full(qk_full, pos, F_QK_STAGES);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_m64n64k16_ss<0, 0>(
                s, kmajor(slot + kk * 32),
                kmajor(slot + BOX + key_off * ROW_BYTES + kk * 32),
                (cc | kk) != 0);
          wgmma_commit();
          if (cc > 0) {
            wgmma_wait<1>();
            release(qk_empty, pos - 1, F_QK_STAGES);
          }
        }
        wgmma_wait<0>();
        fence_regs(s);
        release(qk_empty, tq + NB - 1, F_QK_STAGES);
        tq += NB;

        // online softmax; the row max over both warpgroups' keys
        const int k0 = j * F_KEYS + key_off;
        const bool need_mask = k0 + 64 > mask_from;
        float mx[2] = {m[0], m[1]};
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          if (need_mask) {
            const int key = k0 + (e / 4) * 8 + t2 + (e & 1);
            const int row = w.q_start + rl + ((e >> 1) & 1) * 8;
            const bool ok =
                key < kv_len && (!causal || key <= row + q_offset);
            s[e] = ok ? s[e] : -INFINITY;
          }
          mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], s[e]);
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        }
        if (t2 == 0) {
          s_max[wg * TILE + rl] = mx[0];
          s_max[wg * TILE + rl + 8] = mx[1];
        }
        named_bar_sync(BAR_MAX, CONSUMERS);
        float alpha[2], neg_mc[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], s_max[(1 - wg) * TILE + rl + 8 * r]);
          neg_mc[r] = -mx[r] * c;
          // not fmaf(m, c, neg_mc): with m = mx = NEG_INF its rounding
          // residue would give 0 * inf in the accumulator
          alpha[r] = ex2((m[r] - mx[r]) * c);
          m[r] = mx[r];
        }
        float sum[2] = {0.f, 0.f};
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          // masked scores are -inf: p = 0, also while m is still NEG_INF
          s[e] = ex2(fmaf(s[e], c, neg_mc[(e >> 1) & 1]));
          sum[(e >> 1) & 1] += s[e];
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + sum[r];

        // this warpgroup's 64 keys of P, bf16, swizzled, into the P tile
        const uint32_t p_box = sP + wg * BOX;
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int r = 0; r < 2; ++r)
            st_shared_u32(p_box + (rl + 8 * r) * ROW_BYTES +
                              ((n ^ g) << 4) + t2 * 2,
                          pack_bf16(s[4 * n + 2 * r], s[4 * n + 2 * r + 1]));
        fence_proxy_async();
        named_bar_sync(BAR_P, CONSUMERS);

        // O = alpha O + P V over the tile's 128 keys, this warpgroup's boxes
#pragma unroll
        for (int b = 0; b < F_WG_BOXES; ++b)
#pragma unroll
          for (int e = 0; e < 32; ++e) acc[b][e] *= alpha[(e >> 1) & 1];
#pragma unroll
        for (int b = 0; b < F_WG_BOXES; ++b) {
          if (b < w.x.nb0) {
            const int pos = tv + b;
            const uint32_t slot =
                sV + (pos % F_V_STAGES) * F_V_SLOT + wg * F_KBOX;
            wait_full(v_full, pos, F_V_STAGES);
            fence_regs(acc[b]);
            wgmma_fence();
            if (b < nbw) {
#pragma unroll
              for (int kk = 0; kk < F_KEYS / 16; ++kk)
                wgmma_m64n64k16_ss<0, 1>(
                    acc[b], kmajor(sP + (kk / 4) * BOX + (kk % 4) * 32),
                    mnmajor(slot + kk * 16 * ROW_BYTES), 1);
            }
            wgmma_commit();
            if (b > 0) {
              wgmma_wait<1>();
              release(v_empty, pos - 1, F_V_STAGES);
            }
          }
        }
        wgmma_wait<0>();
#pragma unroll
        for (int b = 0; b < F_WG_BOXES; ++b) fence_regs(acc[b]);
        release(v_empty, tv + w.x.nb0 - 1, F_V_STAGES);
        tv += w.x.nb0;
      }

      // ---- normalise and write; rows with no valid key have l = 0, acc = 0
      float* sl = s_l + parity * 2 * TILE;
      float lrow[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        lrow[r] = l[r];
        lrow[r] += __shfl_xor_sync(0xffffffffu, lrow[r], 1);
        lrow[r] += __shfl_xor_sync(0xffffffffu, lrow[r], 2);
      }
      if (t2 == 0) {
        sl[wg * TILE + rl] = lrow[0];
        sl[wg * TILE + rl + 8] = lrow[1];
      }
      named_bar_sync(BAR_L, CONSUMERS);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float lsum = lrow[r] + sl[(1 - wg) * TILE + rl + 8 * r];
        const float l_safe = fmaxf(lsum, 1e-30f);
        const float inv = 1.f / l_safe;
        const int row = w.q_start + rl + 8 * r;
        if (row < Sq) {
          __nv_bfloat16* orow = o + (((long long)w.b * Sq + row) * H + w.h) * D +
                                first_box * BOX_COLS + t2;
#pragma unroll
          for (int b = 0; b < F_WG_BOXES; ++b)
            if (b < nbw)
#pragma unroll
              for (int n = 0; n < 8; ++n)
                *reinterpret_cast<uint32_t*>(orow + b * BOX_COLS + n * 8) =
                    pack_bf16(acc[b][4 * n + 2 * r] * inv,
                              acc[b][4 * n + 2 * r + 1] * inv);
          if (lse != nullptr && wg == 0 && t2 == 0 && w.x.box0 == 0) {
            // the running max in scaled units; NEG_INF where no key was valid
            const float m_scaled = lsum > 0.f ? m[r] * c : NEG_INF;
            lse[(long long)w.bh * Sq + row] = m_scaled * LN2 + logf(l_safe);
          }
        }
      }
    }
  }
}

// ----------------------------------------------------------------- backward
// aux[0][bh][i] = lse * log2(e), aux[1][bh][i] = rowsum(dO * O) over D for
// every (b, i, h) row, and the row of the fp32 dQ workspace zeroed; one
// warp a row, 8 rows a block.
__global__ void __launch_bounds__(256)
flash_wide_prep_kernel(const __nv_bfloat16* __restrict__ o,
                       const __nv_bfloat16* __restrict__ dout,
                       const float* __restrict__ lse, float* __restrict__ aux,
                       float* __restrict__ dq_acc, long long rows, int BH,
                       int H, int Sq, int D) {
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
  float4* z = reinterpret_cast<float4*>(dq_acc + row * D);
  for (int c = lane; c < D / 4; c += 32) z[c] = make_float4(0.f, 0.f, 0.f, 0.f);
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

// st (S^T) -> P^T = exp2(st * c - lse2), dpt (dP^T) -> dS^T =
// P^T (dP^T - delta) scale, in place; this thread's keys key0, key0 + 8
// against queries qb + 8n (+1), n = 0..3, whose lse2 / delta are v[2n (+1)].
// MASK: exact zeros at pairs past Sk or Sq or above the causal diagonal
// (a separate instantiation, so that tiles that need no mask run
// straight-line code).
template <bool MASK>
__device__ __forceinline__ void bwd_scores(float (&st)[16], float (&dpt)[16],
                                           const float (&lq)[8],
                                           const float (&dl)[8], float c,
                                           float scale, int key0, int qb,
                                           int Sq, int Sk, int causal,
                                           int q_offset) {
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int n = i >> 2, e = i & 3;
    const int v = 2 * n + (e & 1);
    float p = ex2(fmaf(st[i], c, -lq[v]));
    if (MASK) {
      const int key = key0 + (e >> 1) * 8;
      const int qi = qb + 8 * n + (e & 1);
      const bool ok = key < Sk && qi < Sq && (!causal || key <= qi + q_offset);
      p = ok ? p : 0.f;
    }
    st[i] = p;
    dpt[i] = p * (dpt[i] - dl[v]) * scale;
  }
}

// q/k/v/dout: tensor maps over bf16 [B, S, H, D], 64-row boxes; dq: a map
// over the zeroed fp32 [B, Sq, H, D] workspace; aux: [2, B*H, Sq] fp32
// (lse*log2e, delta); dk/dv: [B, Sk, H, D] bf16. One block per (b*h,
// 64-key tile, part of the boxes), numbered head-major, the parts of a key
// tile side by side.
__global__ void __launch_bounds__(THREADS, 1)
flash_wide_bwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      const __grid_constant__ CUtensorMap tm_do,
                      const __grid_constant__ CUtensorMap tm_dq,
                      const float* __restrict__ aux,
                      __nv_bfloat16* __restrict__ dk,
                      __nv_bfloat16* __restrict__ dv, int BH, int H, int Sq,
                      int Sk, int D, int causal, int q_offset, int split,
                      int per_item, float scale, float scale_log2e) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sRing = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sPDS = sRing + B_STAGES * B_SLOT;
  const uint32_t sDQ = sPDS + 2 * B_PDS;
  const uint32_t full = sDQ + 2 * B_DQ;
  const uint32_t empty = full + 8 * B_STAGES;

  const int NB = D / BOX_COLS;
  const int n_kt = (Sk + TILE - 1) / TILE;
  int x = blockIdx.x;
  const Boxes bx = boxes_of(x % split, per_item, NB);
  x /= split;
  const int bh = x / n_kt;
  const int b = bh / H;
  const int h = bh - b * H;
  const int k_start = (x % n_kt) * TILE;
  // the q tiles that see a key of this block: causal, from the one that
  // holds query k_start - q_offset
  int j0 = 0;
  if (causal) {
    const int first = k_start - q_offset;
    j0 = first > 0 ? first / TILE : 0;
  }
  const int n = max((Sq + TILE - 1) / TILE - j0, 0);
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);

  if (threadIdx.x == 0) {
    for (int s = 0; s < B_STAGES; ++s) {
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
      tma_prefetch_map(&tm_k);
      tma_prefetch_map(&tm_v);
      tma_prefetch_map(&tm_do);
      int pos = 0;
      for (int j = 0; j < n; ++j) {
        const int q0 = (j0 + j) * TILE;
        // the scores' contraction: every box of K, Q, V and dO
        for (int cc = 0; cc < NB; ++cc, ++pos) {
          wait_empty(empty, pos, B_STAGES);
          const uint32_t bar = full + 8 * (pos % B_STAGES);
          const uint32_t slot = sRing + (pos % B_STAGES) * B_SLOT;
          const int col = cc * BOX_COLS;
          mbar_arrive_expect_tx(bar, B_SLOT);
          tma_load_4d(slot, &tm_k, bar, col, h, k_start, b);
          tma_load_4d(slot + BOX, &tm_q, bar, col, h, q0, b);
          tma_load_4d(slot + 2 * BOX, &tm_v, bar, col, h, k_start, b);
          tma_load_4d(slot + 3 * BOX, &tm_do, bar, col, h, q0, b);
        }
        // the gradients: each warpgroup's boxes of dO, Q and K, in turn
        for (int p = 0; p < bx.nb0; ++p) {
          for (int ww = 0; ww < 2; ++ww) {
            if (ww == 1 && p >= bx.nb1) continue;
            wait_empty(empty, pos, B_STAGES);
            const uint32_t bar = full + 8 * (pos % B_STAGES);
            const uint32_t slot = sRing + (pos % B_STAGES) * B_SLOT;
            const int col = (bx.box0 + ww * bx.nb0 + p) * BOX_COLS;
            mbar_arrive_expect_tx(bar, 3 * BOX);
            tma_load_4d(slot, &tm_do, bar, col, h, q0, b);
            tma_load_4d(slot + BOX, &tm_q, bar, col, h, q0, b);
            tma_load_4d(slot + 2 * BOX, &tm_k, bar, col, h, k_start, b);
            ++pos;
          }
        }
      }
    }
  } else {
    // --------------------------------------------------------- consumers
    reg_alloc<CONSUMER_REGS>();
    const int lane = threadIdx.x & 31;
    const int warp = (threadIdx.x >> 5) & 3;  // within the warpgroup
    const int g = lane >> 2;
    const int t2 = (lane & 3) * 2;
    const int key0 = k_start + warp * 16 + g;  // this thread's keys: +0, +8
    const int nbw = wg == 0 ? bx.nb0 : bx.nb1;
    const int first_box = bx.box0 + (wg == 0 ? 0 : bx.nb0);
    const uint32_t dq_stage = sDQ + wg * B_DQ;
    const bool leader = threadIdx.x % 128 == 0;
    const float* lse2 = aux + (long long)bh * Sq;
    const float* delta = aux + ((long long)BH + bh) * Sq;
    const float c = scale_log2e;

    float dk_acc[B_WG_BOXES][32], dv_acc[B_WG_BOXES][32];
#pragma unroll
    for (int p = 0; p < B_WG_BOXES; ++p)
#pragma unroll
      for (int i = 0; i < 32; ++i) dk_acc[p][i] = dv_acc[p][i] = 0.f;

    float st[16], dpt[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) st[i] = dpt[i] = 0.f;
    int pos = 0;
    for (int j = 0; j < n; ++j) {
      const int q0 = (j0 + j) * TILE;
      const int qb = q0 + wg * 32 + t2;  // this thread's queries: qb + 8n (+1)
      float lq[8], dl[8];
#pragma unroll
      for (int v = 0; v < 8; ++v) {
        const int qi = qb + 8 * (v >> 1) + (v & 1);
        lq[v] = qi < Sq ? lse2[qi] : 0.f;
        dl[v] = qi < Sq ? delta[qi] : 0.f;
      }

      // S^T = K Q^T and dP^T = V dO^T over all of D: this warpgroup's 32
      // queries against the tile's 64 keys
      for (int cc = 0; cc < NB; ++cc, ++pos) {
        const uint32_t slot = sRing + (pos % B_STAGES) * B_SLOT;
        const uint32_t q_rows = wg * 32 * ROW_BYTES;
        wait_full(full, pos, B_STAGES);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_m64n32k16_ss(st, kmajor(slot + kk * 32),
                             kmajor(slot + BOX + q_rows + kk * 32),
                             (cc | kk) != 0);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_m64n32k16_ss(dpt, kmajor(slot + 2 * BOX + kk * 32),
                             kmajor(slot + 3 * BOX + q_rows + kk * 32),
                             (cc | kk) != 0);
        wgmma_commit();
        if (cc > 0) {
          wgmma_wait<1>();
          release(empty, pos - 1, B_STAGES);
        }
      }
      wgmma_wait<0>();
      fence_regs(st);
      fence_regs(dpt);
      release(empty, pos - 1, B_STAGES);

      // P^T and dS^T; exact zeros where masked
      const bool need_mask = q0 + TILE > Sq || k_start + TILE > Sk ||
                             (causal && k_start + TILE - 1 > q0 + q_offset);
      if (need_mask)
        bwd_scores<true>(st, dpt, lq, dl, c, scale, key0, qb, Sq, Sk, causal,
                         q_offset);
      else
        bwd_scores<false>(st, dpt, lq, dl, c, scale, key0, qb, Sq, Sk,
                          causal, q_offset);
      // both, bf16, into this warpgroup's 32 query columns of the shared
      // [64 keys][64 queries] tiles: 16-byte chunk 4w + n of a row at
      // (4w + n) ^ (row % 8)
      const uint32_t pds = sPDS + (j & 1) * B_PDS;
#pragma unroll
      for (int nn = 0; nn < 4; ++nn)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const uint32_t off = (warp * 16 + g + 8 * r) * ROW_BYTES +
                               (((4 * wg + nn) ^ g) << 4) + t2 * 2;
          st_shared_u32(pds + off, pack_bf16(st[4 * nn + 2 * r],
                                             st[4 * nn + 2 * r + 1]));
          st_shared_u32(pds + BOX + off, pack_bf16(dpt[4 * nn + 2 * r],
                                                   dpt[4 * nn + 2 * r + 1]));
        }
      fence_proxy_async();
      named_bar_sync(BAR_PDS, CONSUMERS);

      // dV += P^T dO, dK += dS^T Q and dQ = dS K, box by box; each slot
      // holds one warpgroup's box, the other waits for it and releases it
#pragma unroll
      for (int p = 0; p < B_WG_BOXES; ++p) {
#pragma unroll
        for (int ww = 0; ww < 2; ++ww) {
          if (p < bx.nb0 && (ww == 0 || p < bx.nb1)) {
            const uint32_t slot = sRing + (pos % B_STAGES) * B_SLOT;
            wait_full(full, pos, B_STAGES);
            if (ww == wg) {
              float dq[32];
              fence_regs(dv_acc[p]);
              fence_regs(dk_acc[p]);
              wgmma_fence();
#pragma unroll
              for (int kk = 0; kk < 4; ++kk)
                wgmma_m64n64k16_ss<0, 1>(dv_acc[p], kmajor(pds + kk * 32),
                                         mnmajor(slot + kk * 16 * ROW_BYTES),
                                         1);
#pragma unroll
              for (int kk = 0; kk < 4; ++kk)
                wgmma_m64n64k16_ss<0, 1>(
                    dk_acc[p], kmajor(pds + BOX + kk * 32),
                    mnmajor(slot + BOX + kk * 16 * ROW_BYTES), 1);
              wgmma_m64n64k16_ss_init<1, 1>(dq, mnmajor(pds + BOX),
                                            mnmajor(slot + 2 * BOX));
#pragma unroll
              for (int kk = 1; kk < 4; ++kk)
                wgmma_m64n64k16_ss<1, 1>(
                    dq, mnmajor(pds + BOX + kk * 16 * ROW_BYTES),
                    mnmajor(slot + 2 * BOX + kk * 16 * ROW_BYTES), 1);
              wgmma_commit();
              wgmma_wait<0>();
              fence_regs(dv_acc[p]);
              fence_regs(dk_acc[p]);
              fence_regs(dq);
              release(empty, pos, B_STAGES);

              // dQ into the fp32 workspace by TMA reduce-add: the 64 x 64
              // box through shared memory, two boxes of 32 columns, issued
              // by the warpgroup's first thread once the previous adds
              // have read their staging
              if (leader) bulk_wait_read<0>();
              named_bar_sync(BAR_DQ + wg, 128);
#pragma unroll
              for (int r = 0; r < 2; ++r) {
                const int row = warp * 16 + g + 8 * r;
#pragma unroll
                for (int nb = 0; nb < 8; ++nb)
                  st_shared_f2(dq_stage + (nb / 4) * DQ_BOX + row * 128 +
                                   (((2 * (nb % 4) + (t2 >> 2)) ^ g) << 4) +
                                   (t2 & 2) * 4,
                               dq[4 * nb + 2 * r], dq[4 * nb + 2 * r + 1]);
              }
              fence_proxy_async();
              named_bar_sync(BAR_DQ + wg, 128);
              if (leader) {
                const int col = (first_box + p) * BOX_COLS;
                tma_reduce_add_4d(&tm_dq, dq_stage, col, h, q0, b);
                tma_reduce_add_4d(&tm_dq, dq_stage + DQ_BOX, col + 32, h, q0,
                                  b);
                bulk_commit();
              }
            } else {
              release(empty, pos, B_STAGES);
            }
            ++pos;
          }
        }
      }
    }
    if (leader) bulk_wait<0>();

    // ---- this warpgroup's boxes of dK, dV once, bf16; keys no query sees
    // get zeros
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = key0 + 8 * r;
      if (key < Sk) {
        const long long off = (((long long)b * Sk + key) * H + h) * D +
                              first_box * BOX_COLS + t2;
#pragma unroll
        for (int p = 0; p < B_WG_BOXES; ++p) {
          if (p < nbw) {
#pragma unroll
            for (int nb = 0; nb < 8; ++nb) {
              *reinterpret_cast<uint32_t*>(dk + off + p * BOX_COLS + nb * 8) =
                  pack_bf16(dk_acc[p][4 * nb + 2 * r],
                            dk_acc[p][4 * nb + 2 * r + 1]);
              *reinterpret_cast<uint32_t*>(dv + off + p * BOX_COLS + nb * 8) =
                  pack_bf16(dv_acc[p][4 * nb + 2 * r],
                            dv_acc[p][4 * nb + 2 * r + 1]);
            }
          }
        }
      }
    }
  }
}

bool bad_shape(int B, int H, int Sq, int Sk, int D) {
  return B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0 || D <= 0 || D % BOX_COLS;
}

// Items a tile and boxes an item when an item holds at most `most` boxes:
// as few items as can hold them, then the boxes spread evenly over them
// (every item holds at least one).
void split_boxes(int NB, int most, int* split, int* per_item) {
  *per_item = (NB + (NB + most - 1) / most - 1) / ((NB + most - 1) / most);
  *split = (NB + *per_item - 1) / *per_item;
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
  CUtensorMap tm_q, tm_k, tm_v;
  cudaError_t err = encode_bshd_map(&tm_q, q, B, Sq, H, D, TILE);
  if (err == cudaSuccess) err = encode_bshd_map(&tm_k, k, B, Sk, H, D, F_KEYS);
  if (err == cudaSuccess) err = encode_bshd_map(&tm_v, v, B, Sk, H, D, F_KEYS);
  if (err != cudaSuccess) return (int)err;
  // once per process (one card), so that a launch inside a CUDA graph
  // capture makes no call but the launch itself
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_wide_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      F_SMEM);
  if (attr != cudaSuccess) return (int)attr;
  const int sms = sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  int split, per_item;
  split_boxes(D / BOX_COLS, F_MAX_BOXES, &split, &per_item);
  const long long items =
      (long long)B * H * ((Sq + TILE - 1) / TILE) * split;
  if (items > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const int grid = (int)(items < sms ? items : sms);
  flash_wide_fwd_kernel<<<grid, THREADS, F_SMEM,
                          static_cast<cudaStream_t>(stream)>>>(
      tm_q, tm_k, tm_v, static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), B * H, H, Sq, D, kv_len, causal, kv_len - Sq,
      split, per_item, scale * LOG2E);
  return (int)cudaGetLastError();
}

// The whole backward on one stream: the prologue into aux ([2, B*H, Sq]
// fp32, scratch) and dq_acc ([B, Sq, H, D] fp32, zeroed), then the main
// kernel, which adds dQ into dq_acc and writes dk and dv. o and lse come
// from the forward on the same inputs; the caller casts dq_acc.
extern "C" int rsv_flash_wide_bwd(const void* q, const void* k, const void* v,
                                  const void* o, const void* dout,
                                  const void* lse, void* aux, void* dq_acc,
                                  void* dk, void* dv, int B, int H, int Sq,
                                  int Sk, int D, int causal, float scale,
                                  void* stream) {
  if (bad_shape(B, H, Sq, Sk, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  CUtensorMap tm_q, tm_k, tm_v, tm_do, tm_dq;
  cudaError_t err = encode_bshd_map(&tm_q, q, B, Sq, H, D, TILE);
  if (err == cudaSuccess) err = encode_bshd_map(&tm_do, dout, B, Sq, H, D, TILE);
  if (err == cudaSuccess) err = encode_bshd_map(&tm_k, k, B, Sk, H, D, TILE);
  if (err == cudaSuccess) err = encode_bshd_map(&tm_v, v, B, Sk, H, D, TILE);
  if (err == cudaSuccess)
    err = encode_bshd_map_f32(&tm_dq, dq_acc, B, Sq, H, D, TILE);
  if (err != cudaSuccess) return (int)err;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_wide_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      B_SMEM);
  if (attr != cudaSuccess) return (int)attr;
  int split, per_item;
  split_boxes(D / BOX_COLS, B_MAX_BOXES, &split, &per_item);
  const long long rows = (long long)B * Sq * H;
  const long long prep_blocks = (rows + 7) / 8;
  const long long blocks =
      (long long)B * H * ((Sk + TILE - 1) / TILE) * split;
  if (prep_blocks > 0x7fffffff || blocks > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  float* auxp = static_cast<float*>(aux);
  flash_wide_prep_kernel<<<(int)prep_blocks, 256, 0, st>>>(
      static_cast<const __nv_bfloat16*>(o),
      static_cast<const __nv_bfloat16*>(dout), static_cast<const float*>(lse),
      auxp, static_cast<float*>(dq_acc), rows, B * H, H, Sq, D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_wide_bwd_kernel<<<(int)blocks, THREADS, B_SMEM, st>>>(
      tm_q, tm_k, tm_v, tm_do, tm_dq, auxp, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), B * H, H, Sq, Sk, D, causal, Sk - Sq,
      split, per_item, scale, scale * LOG2E);
  return (int)cudaGetLastError();
}

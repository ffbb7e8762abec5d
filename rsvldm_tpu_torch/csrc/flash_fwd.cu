// K1: flash-attention forward for Hopper (sm_90a), bf16 in, fp32 softmax.
//
// Replaces the Pallas TPU kernel `_flash_kernel` / `flash_attention` in
// rsvldm_tpu/ops/flash_attention.py. Same function: online softmax in base 2,
// fp32 running max m, normalizer l and accumulator, suffix-aligned causal
// mask (q_offset = kv_len - Sq), keys at or past kv_len masked, rows with no
// valid key written as exact zeros, optional logsumexp in natural-log units
// [B, H, Sq] with l clamped at 1e-30 (K3 and K4 rebuild p from it).
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s), counted as
// chip_smoke.py counts it (4*D FLOP per valid (query, key) pair against q,
// k, v and o read or written once): operations at every main-path shape.
// SDXL self-attention (D=64, B=2): S=4096 H=10 0.0869 ms, S=1024 H=20
// 0.0109 ms; Llama prefill (causal, S=1280 H=32 D=128) 0.0136 ms; training
// forward (causal, B=4 S=1536 H=32 D=128, with lse) 0.0782 ms. A second
// floor at D=64: one exp2 per score on the special-function units, about
// 3.9e12/s on an H100, is 86 us for the 335.5 M scores at S=4096, as long
// as the tensor-core bound. At D=128 the exponentials are half of it. So
// the exponentials must run while the tensor cores work.
//
// Design (the TPU kernel carries m/l/acc in VMEM across a sequential kv
// grid axis; Hopper blocks share nothing, so a block owns a (b*h, 128-row q
// tile) work item and walks its K/V tiles itself):
// - Persistent grid: one block per SM takes items c, c + grid, ... in an
//   order that puts the q tiles with the most causal keys first, so the
//   last round holds the short ones; the producer loads the next item's Q
//   and K/V while the consumers finish the last one.
// - Warp roles, 384 threads. Warpgroups 0 and 1 are consumers, 64 q rows
//   each; warpgroup 2 is the producer, one thread of which issues every
//   TMA load. setmaxnreg moves registers from the producer (24) to the
//   consumers (240).
// - TMA: Q (128 x D) once per item, then 128-key K and V tiles into two
//   rings of STAGES stages (2 at D=128: Q 32 KB + 2 x (32 + 32) KB = 160 KB;
//   3 at D=64: 112 KB), each stage with a "full" mbarrier (the producer's
//   arrive plus the tile's transaction bytes) and an "empty" one (one arrive
//   from each of the 8 consumer warps); Q has the same pair. The maps are
//   4-D over [B, S, H, D], swizzled 128B, so rows past S are zero-filled
//   inside the right batch; a D=128 tile is two 64-column boxes. Causal
//   tiles wholly above the diagonal are never loaded.
// - wgmma for both products. S = Q K^T is m64n128k16 with Q and K both
//   K-major in shared memory. O += P V takes P from registers: the S
//   accumulator, rounded to bf16 pairs, is already wgmma's register-A
//   layout. V is the B operand straight from its TMA tile, read MN-major
//   through the transpose bit: V is never transposed or copied.
// - Softmax overlapped with the tensor cores, as FlashAttention-3 does it.
//   Ping-pong, both head dims: the two consumer warpgroups take turns
//   through two named barriers to issue their products, so one
//   warpgroup's exp2 runs while the other's wgmmas do. In-warpgroup
//   pipelining, D=64 only: iteration j issues S_j = Q K_j^T together with
//   O += P_{j-1} V_{j-1} and computes softmax(S_j) while that P V product
//   runs; O takes the previous tile's factor just before the next P V is
//   issued. It is kept at D=64, where the exp2 floor equals the
//   tensor-core floor. At D=128 it needs S, P and O live at once (160 of
//   the 240 registers plus addressing), and ptxas then spills and
//   serialises the wgmmas, so D=128 runs each warpgroup's products in
//   series and relies on the ping-pong.
// - One FFMA per score: the row max is taken on the raw scores and
//   p = exp2(s * scale*log2e - m * scale*log2e). Only tiles that cross
//   kv_len or the causal diagonal of the warpgroup's first row are masked
//   (to -inf; TMA's zero fill would otherwise score 0).
// - Epilogue: normalise by l, guarded bf16 stores of rows < Sq, lse.
// - Head dims: 64 and 128 as above; 256 (Gemma-7B) is its own kernel,
//   flash_fwd_d256_kernel, described where it is defined. Other D <= 256
//   (MLCD's 104, 192) are zero-padded along D to the next of them by the
//   wrapper (ops/flash_attention.py::with_padded_head_dim), which is exact
//   when the scale stays 1/sqrt(D) of the true D.
//
// ptxas (sm_90a): 168 registers at launch for the D=64 / 128
// instantiations (the consumers run at 240 after setmaxnreg), no spills,
// no serialised wgmma. Times and shares of bound: PERF.md, from
// chip_smoke.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int BLOCK_M = 128;  // q rows per work item: two consumer warpgroups
constexpr int BLOCK_N = 128;  // keys per K/V tile
constexpr int WG_ROWS = 64;   // q rows per consumer warpgroup
constexpr int THREADS = 384;  // consumers: warpgroups 0, 1; producer: 2
constexpr int CONSUMER_WARPS = 8;
constexpr int PRODUCER_REGS = 24;   // 2 * 128 * 240 + 128 * 24 <= 65536
constexpr int CONSUMER_REGS = 240;
constexpr int ROW_BYTES = 128;  // one swizzled row of a 64-column box
constexpr int HALF_BYTES = BLOCK_N * ROW_BYTES;  // a 64-column box: Q, K or V
constexpr int BAR_TURN = 1;  // named barrier BAR_TURN + w: warpgroup w's turn
constexpr int TURN_THREADS = 256;  // both consumer warpgroups
constexpr float NEG_INF = -1e30f;  // initial running max, as the TPU kernel
constexpr float LN2 = 0.6931471805599453f;
constexpr float LOG2E = 1.4426950408889634f;

static_assert(BLOCK_M == BLOCK_N, "Q, K and V tiles share one box shape");

// Per head dim (64 or 128; 256 is flash_fwd_d256_kernel): ring stages, and
// whether P_{j-1} V_{j-1} runs under softmax(S_j) (at D=128, S, P and O
// together do not fit the consumers' 240 registers: ptxas spills and
// serialises the wgmmas).
template <int D>
struct Cfg {
  static_assert(D == 64 || D == 128, "flash_fwd_kernel takes D 64 or 128");
  static constexpr int STAGES = D == 64 ? 3 : 2;
  static constexpr bool OVERLAP_PV = D == 64;
  static constexpr int QK_BYTES = (D / 64) * HALF_BYTES;  // a Q, K or V tile
  static constexpr int BAR_BYTES = 8 * (2 + 4 * STAGES);
  // + 1024: the dynamic shared memory is aligned up to 1024 bytes by hand
  static constexpr int SMEM = QK_BYTES * (1 + 2 * STAGES) + BAR_BYTES + 1024;
  static_assert(SMEM <= 232448, "more shared memory than a block can use");
};

// Number of K/V tiles the q tile [q_start, q_start + BLOCK_M) can see.
__device__ __forceinline__ int kv_tiles(int q_start, int Sq, int kv_len,
                                        int causal, int q_offset) {
  int n_keys = kv_len;
  if (causal) n_keys = min(n_keys, min(q_start + BLOCK_M, Sq) + q_offset);
  return n_keys > 0 ? (n_keys + BLOCK_N - 1) / BLOCK_N : 0;
}

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

// The consumer side of a stage ring whose barriers sit 8 bytes apart from
// shared address `bar`: wait for the ring's tile t, release it.
__device__ __forceinline__ void wait_full(uint32_t bar, int t, int stages) {
  mbar_wait(bar + 8 * (t % stages), (t / stages) & 1);
}

__device__ __forceinline__ void release(uint32_t bar, int t, int stages) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(bar + 8 * (t % stages));
}

// S = Q K^T for this warpgroup's 64 rows and one 128-key tile.
template <int D>
__device__ __forceinline__ void issue_qk(float (&s)[64], uint32_t q_addr,
                                         uint32_t k_addr) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk / 4) * HALF_BYTES + (kk % 4) * 32;
    wgmma_m64n128k16_ss(s, desc_sw128(q_addr + off, 16, 1024),
                        desc_sw128(k_addr + off, 16, 1024), kk > 0);
  }
}

// O += P V over one 128-key tile; P in registers, 4 per 16 keys.
template <int D>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2],
                                         const uint32_t (&p)[32],
                                         uint32_t v_addr) {
#pragma unroll
  for (int kk = 0; kk < BLOCK_N / 16; ++kk) {
    const uint32_t a[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2],
                           p[4 * kk + 3]};
    const uint64_t b = desc_sw128(v_addr + kk * 16 * ROW_BYTES, HALF_BYTES,
                                  1024);
    if constexpr (D == 64)
      wgmma_m64n64k16_rs_tb(o, a, b);
    else
      wgmma_m64n128k16_rs_tb(o, a, b);
  }
}

// Online softmax over one tile of raw scores s (this thread: rows row0 and
// row0 + 8, N / 2 keys each). Updates m (raw units) and l, sets alpha to
// the factor the accumulator must take, and leaves p = exp2(...) in s.
template <int N>
__device__ __forceinline__ void softmax_tile(float (&s)[N], float (&m)[2],
                                             float (&l)[2], float (&alpha)[2],
                                             bool need_mask, int k_start,
                                             int row0, int kv_len, int causal,
                                             int q_offset, float c) {
  const int t2 = (threadIdx.x & 3) * 2;
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (need_mask) {
      const int key = k_start + (i / 4) * 8 + t2 + (i & 1);
      const int row = row0 + ((i >> 1) & 1) * 8;
      const bool ok = key < kv_len && (!causal || key <= row + q_offset);
      s[i] = ok ? s[i] : -INFINITY;
    }
    mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
  }
  float neg_mc[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    neg_mc[r] = -mx[r] * c;
    // not fmaf(m, c, neg_mc): with m = mx = NEG_INF its rounding residue
    // is about 1e22 and would give 0 * inf in the accumulator
    alpha[r] = ex2((m[r] - mx[r]) * c);
    m[r] = mx[r];
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < N; ++i) {
    // masked scores are -inf: p = 0, also while m is still NEG_INF
    s[i] = ex2(fmaf(s[i], c, neg_mc[(i >> 1) & 1]));
    sum[(i >> 1) & 1] += s[i];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + sum[r];
}

// s (p) -> bf16 pairs in wgmma's register-A layout, 16 keys per 4.
template <int N>
__device__ __forceinline__ void to_bf16(const float (&s)[N],
                                        uint32_t (&p)[N / 2]) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) p[i] = pack_bf16(s[2 * i], s[2 * i + 1]);
}

template <int N>
__device__ __forceinline__ void rescale(float (&o)[N], const float (&a)[2]) {
#pragma unroll
  for (int i = 0; i < N; ++i) o[i] *= a[(i >> 1) & 1];
}

// One work item: a (b*h, BLOCK_M-row q tile) pair. Items are numbered
// longest first (the q tiles with the most causal keys, then the rest), and
// block c of the persistent grid takes items c, c + gridDim.x, ...
struct Item {
  int bh, b, h, q_start, n_tiles;
};

__device__ __forceinline__ Item item_at(int i, int BH, int H, int n_qt,
                                        int Sq, int kv_len, int causal,
                                        int q_offset) {
  Item it;
  it.bh = i % BH;
  it.b = it.bh / H;
  it.h = it.bh - it.b * H;
  it.q_start = (n_qt - 1 - i / BH) * BLOCK_M;
  it.n_tiles = kv_tiles(it.q_start, Sq, kv_len, causal, q_offset);
  return it;
}

// q/k/v: tensor maps over bf16 [B, S, H, D]; o: [B, Sq, H, D] bf16,
// contiguous; lse: [B, H, Sq] fp32 or null. A persistent grid of at most
// one block per SM walks the BH * ceil(Sq / BLOCK_M) items.
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                 const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v,
                 __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                 int BH, int H, int Sq, int kv_len, int causal, int q_offset,
                 float scale_log2e) {
  using C = Cfg<D>;
  constexpr int STAGES = C::STAGES;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sK = sQ + C::QK_BYTES;
  const uint32_t sV = sK + STAGES * C::QK_BYTES;
  const uint32_t q_full = sV + STAGES * C::QK_BYTES;  // then q_empty and
  const uint32_t q_empty = q_full + 8;                // the two rings
  const uint32_t k_full = q_empty + 8;
  const uint32_t k_empty = k_full + 8 * STAGES;
  const uint32_t v_full = k_empty + 8 * STAGES;
  const uint32_t v_empty = v_full + 8 * STAGES;

  const int n_qt = (Sq + BLOCK_M - 1) / BLOCK_M;
  const int n_items = BH * n_qt;
  // warp-uniform as far as the compiler can tell, so that the wgmma
  // descriptors derived from it stay in uniform registers
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, CONSUMER_WARPS);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(k_empty + 8 * s, CONSUMER_WARPS);
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
      int t = 0;        // K/V tiles loaded so far: the ring position
      int q_loads = 0;  // Q tiles loaded so far
      for (int i = blockIdx.x; i < n_items; i += gridDim.x) {
        const Item w = item_at(i, BH, H, n_qt, Sq, kv_len, causal, q_offset);
        if (w.n_tiles == 0) continue;
        // the consumers are done with the previous item's Q
        mbar_wait(q_empty, (q_loads++ & 1) ^ 1);
        mbar_arrive_expect_tx(q_full, C::QK_BYTES);
#pragma unroll
        for (int half = 0; half < D / 64; ++half)
          tma_load_4d(sQ + half * HALF_BYTES, &tm_q, q_full, half * 64, w.h,
                      w.q_start, w.b);
        for (int j = 0; j < w.n_tiles; ++j, ++t) {
          const int s = t % STAGES;
          // the stage's previous fill was released (passes on the first)
          const uint32_t parity = ((t / STAGES) & 1) ^ 1;
          mbar_wait(k_empty + 8 * s, parity);
          mbar_arrive_expect_tx(k_full + 8 * s, C::QK_BYTES);
#pragma unroll
          for (int half = 0; half < D / 64; ++half)
            tma_load_4d(sK + s * C::QK_BYTES + half * HALF_BYTES, &tm_k,
                        k_full + 8 * s, half * 64, w.h, j * BLOCK_N, w.b);
          mbar_wait(v_empty + 8 * s, parity);
          mbar_arrive_expect_tx(v_full + 8 * s, C::QK_BYTES);
#pragma unroll
          for (int half = 0; half < D / 64; ++half)
            tma_load_4d(sV + s * C::QK_BYTES + half * HALF_BYTES, &tm_v,
                        v_full + 8 * s, half * 64, w.h, j * BLOCK_N, w.b);
        }
      }
    }
  } else {
    // --------------------------------------------------------- consumers
    reg_alloc<CONSUMER_REGS>();
    const int lane = threadIdx.x & 31;
    const int warp = (threadIdx.x >> 5) & 3;  // within the warpgroup
    const int t2 = (lane & 3) * 2;
    const uint32_t q_addr = sQ + wg * WG_ROWS * ROW_BYTES;
    const int my_turn = BAR_TURN + wg;
    const int next_turn = BAR_TURN + (1 - wg);
    const float c = scale_log2e;
    int t = 0;       // K/V tiles consumed so far: the ring position
    int q_uses = 0;  // Q tiles consumed so far

    float acc[D / 2];
    float s[64];
    uint32_t p[32];
#pragma unroll
    for (int i = 0; i < 64; ++i) s[i] = 0.f;

    if (wg == 1) named_bar_arrive(BAR_TURN, TURN_THREADS);  // 0 goes first
    for (int i = blockIdx.x; i < n_items; i += gridDim.x) {
      const Item w = item_at(i, BH, H, n_qt, Sq, kv_len, causal, q_offset);
      const int n = w.n_tiles;
      const int wg_row0 = w.q_start + wg * WG_ROWS;
      const int row0 = wg_row0 + warp * 16 + (lane >> 2);  // and row0 + 8
      // tiles that cross kv_len or this warpgroup's causal diagonal
      const int mask_from = causal ? min(kv_len, wg_row0 + q_offset + 1)
                                   : kv_len;
#pragma unroll
      for (int k = 0; k < D / 2; ++k) acc[k] = 0.f;
      float m[2] = {NEG_INF, NEG_INF};
      float l[2] = {0.f, 0.f};  // partial over this thread's columns
      float alpha[2] = {1.f, 1.f};

      if (n > 0 && C::OVERLAP_PV) {
        mbar_wait(q_full, q_uses++ & 1);
        // prologue: S_0 and its softmax
        wait_full(k_full, t, STAGES);
        named_bar_sync(my_turn, TURN_THREADS);
        wgmma_fence();
        issue_qk<D>(s, q_addr, sK + (t % STAGES) * C::QK_BYTES);
        wgmma_commit();
        named_bar_arrive(next_turn, TURN_THREADS);
        wgmma_wait<0>();
        fence_regs(s);
        release(k_empty, t, STAGES);
        if (n == 1) release(q_empty, 0, 1);
        softmax_tile(s, m, l, alpha, BLOCK_N > mask_from, 0, row0, kv_len,
                     causal, q_offset, c);
        to_bf16(s, p);

        for (int j = 1; j < n; ++j) {
          const int tk = t + j;
          wait_full(k_full, tk, STAGES);
          wait_full(v_full, tk - 1, STAGES);
          rescale(acc, alpha);
          named_bar_sync(my_turn, TURN_THREADS);
          wgmma_fence();
          fence_regs(acc);
          fence_regs(p);
          issue_qk<D>(s, q_addr, sK + (tk % STAGES) * C::QK_BYTES);
          wgmma_commit();
          issue_pv<D>(acc, p, sV + ((tk - 1) % STAGES) * C::QK_BYTES);
          wgmma_commit();
          named_bar_arrive(next_turn, TURN_THREADS);
          wgmma_wait<1>();  // S_j is done, P_{j-1} V_{j-1} may still run
          fence_regs(s);
          release(k_empty, tk, STAGES);
          if (j == n - 1) release(q_empty, 0, 1);
          softmax_tile(s, m, l, alpha, (j + 1) * BLOCK_N > mask_from,
                       j * BLOCK_N, row0, kv_len, causal, q_offset, c);
          wgmma_wait<0>();
          fence_regs(acc);
          fence_regs(p);
          release(v_empty, tk - 1, STAGES);
          to_bf16(s, p);
        }

        // the last tile's P V
        const int last = t + n - 1;
        wait_full(v_full, last, STAGES);
        rescale(acc, alpha);
        named_bar_sync(my_turn, TURN_THREADS);
        wgmma_fence();
        fence_regs(acc);
        fence_regs(p);
        issue_pv<D>(acc, p, sV + (last % STAGES) * C::QK_BYTES);
        wgmma_commit();
        named_bar_arrive(next_turn, TURN_THREADS);
        wgmma_wait<0>();
        fence_regs(acc);
        release(v_empty, last, STAGES);
      } else if (n > 0) {
        mbar_wait(q_full, q_uses++ & 1);
        for (int j = 0; j < n; ++j) {
          const int tk = t + j;
          wait_full(k_full, tk, STAGES);
          named_bar_sync(my_turn, TURN_THREADS);
          wgmma_fence();
          issue_qk<D>(s, q_addr, sK + (tk % STAGES) * C::QK_BYTES);
          wgmma_commit();
          named_bar_arrive(next_turn, TURN_THREADS);
          wgmma_wait<0>();
          fence_regs(s);
          release(k_empty, tk, STAGES);
          if (j == n - 1) release(q_empty, 0, 1);
          softmax_tile(s, m, l, alpha, (j + 1) * BLOCK_N > mask_from,
                       j * BLOCK_N, row0, kv_len, causal, q_offset, c);
          rescale(acc, alpha);
          to_bf16(s, p);
          wait_full(v_full, tk, STAGES);
          wgmma_fence();
          fence_regs(acc);
          fence_regs(p);
          issue_pv<D>(acc, p, sV + (tk % STAGES) * C::QK_BYTES);
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(acc);
          release(v_empty, tk, STAGES);
        }
      }
      t += n;

      // ---- normalise and write; rows with no valid key have l = 0, acc = 0
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float lsum = l[r];
        lsum += __shfl_xor_sync(0xffffffffu, lsum, 1);
        lsum += __shfl_xor_sync(0xffffffffu, lsum, 2);
        const float l_safe = fmaxf(lsum, 1e-30f);
        const float inv = 1.f / l_safe;
        const int row = row0 + r * 8;
        if (row < Sq) {
          __nv_bfloat16* orow = o + (((long long)w.b * Sq + row) * H + w.h) * D;
#pragma unroll
          for (int k = 0; k < D / 8; ++k)
            *reinterpret_cast<uint32_t*>(orow + k * 8 + t2) = pack_bf16(
                acc[4 * k + 2 * r] * inv, acc[4 * k + 2 * r + 1] * inv);
          if (lse != nullptr && t2 == 0) {
            // the running max in scaled units; NEG_INF where no key was valid
            const float m_scaled = lsum > 0.f ? m[r] * c : NEG_INF;
            lse[(long long)w.bh * Sq + row] = m_scaled * LN2 + logf(l_safe);
          }
        }
      }
    }
    // warpgroup 1 arrived once more on warpgroup 0's turn than 0 waited
    if (wg == 0) named_bar_sync(BAR_TURN, TURN_THREADS);
  }
}

// ------------------------------------------------------------- D = 256
// flash_fwd_d256_kernel: K1 at D=256 (Gemma-7B; 128 < D < 256 padded to
// it). A work item is (b*h, 128-row q tile) with O whole and S computed
// once: warpgroup w of the two consumers owns rows 64w..64w+63 of the tile
// and all 256 columns of O, 128 fp32 registers a thread; with 64-key K / V
// tiles its scores are 32 registers and P 16.
// - Shared memory: Q (128 x 256, four 64-column boxes, 64 KB) once an
//   item; K and V in 64-key tiles (32 KB each) through two stages, each
//   with full / empty mbarriers for K and V apart: 64 + 2 x 64 KB + the
//   barriers = 192.1 KB + the 1 KB alignment slack, within 227 KB.
// - Products: S = Q K^T by m64n64k16 with Q and K K-major, 16 k-steps;
//   O += P V by m64n256k16 with P the bf16-packed scores in registers and
//   V's four boxes read MN-major through the transpose bit, 4 a tile.
// - Overlap, as FlashAttention-3's: the two warpgroups take turns to issue
//   their products (BAR_TURN), so one's exponentials run while the other's
//   wgmmas do; and within a warpgroup, tile j's S = Q K_j^T is issued
//   together with P_{j-1} V_{j-1} and softmax(S_j) runs while that P V
//   product does (S, P and O live at once: 176 registers, no spill).
//   Causal tiles wholly above a warpgroup's diagonal (the last one of an
//   item, for warpgroup 0) are waited for and released but not computed;
//   each warpgroup takes n + 1 turns an item of n tiles either way. Every
//   wait ends a deadlock with a faulting store (mbar_wait_tight), not
//   __trap(), which costs registers.
// - Few items: where the items would fill at most half the SMs (D=192
//   padded at [1, 1100, 4]: 36 items on 132), each q tile becomes two items
//   that both compute S but each add P V into one 128-column half of O
//   (DV = 128: m64n128k16, half of V loaded, 64 registers of O): 1.5x the
//   products, spread over twice the SMs.
// - Persistent grid, dealt in a snake (hopper.cuh::snake_item): block c
//   takes item c in even rounds and item G - 1 - c of the round in odd ones
//   (G blocks), so the blocks that took the longest items take the
//   shortest of the next round. The two halves of a q tile are adjacent
//   items. The items go longest first over all heads, or, when all heads' K
//   and V
//   pass KV_L2_BYTES, head by head (longest first within a head): each
//   item streams its head's K and V, and the blocks in flight then read a
//   few heads' from L2 instead of every head's from device memory (at
//   Gemma's [4, 1536, 16, 256], 100 MB of K and V).
// - Masking, zero rows and lse as flash_fwd_kernel's.
// Bound at Gemma's training shape as the other head dims (operations), but
// a 64-row warpgroup tile at D=256 feeds half the products per byte of K
// and V that D=128's does, so the blocks in flight also lean on L2.
// ptxas (sm_90a), both instantiations (DV = 256 and 128): 168 registers at
// launch (the consumers run at 240), 0 bytes spilled, no serialised wgmma
// (C7515) and no injected fences (C7519). Times: PERF.md, from
// chip_smoke.py.
constexpr int D256 = 256;
constexpr int N256 = 64;                        // keys per K / V tile
constexpr int Q256_BOX = BLOCK_M * ROW_BYTES;   // 64 columns of Q: 16 KB
constexpr int KV256_BOX = N256 * ROW_BYTES;     // of a K or V tile: 8 KB
constexpr int Q256_BYTES = (D256 / 64) * Q256_BOX;
constexpr int KV256_BYTES = (D256 / 64) * KV256_BOX;
constexpr int STAGES256 = 2;
constexpr int BAR256_BYTES = 8 * (2 + 4 * STAGES256);
// K and V bytes of all heads above which the items go head-major: most of
// the H100's 50 MB L2, less room for the Q and O streams
constexpr long long KV_L2_BYTES = 32ll << 20;
constexpr int SMEM256 =
    Q256_BYTES + 2 * STAGES256 * KV256_BYTES + BAR256_BYTES + 1024;
static_assert(SMEM256 <= 232448, "more shared memory than a block can use");

// As item_at, with N256-key tiles; head_major: the items of one head side
// by side (longest first within it), else longest first over all heads.
__device__ __forceinline__ Item item_d256(int i, int BH, int H, int n_qt,
                                          int Sq, int kv_len, int causal,
                                          int q_offset, int head_major) {
  Item it;
  it.bh = head_major ? i / n_qt : i % BH;
  it.b = it.bh / H;
  it.h = it.bh - it.b * H;
  it.q_start = (n_qt - 1 - (head_major ? i % n_qt : i / BH)) * BLOCK_M;
  int n_keys = kv_len;
  if (causal) n_keys = min(n_keys, min(it.q_start + BLOCK_M, Sq) + q_offset);
  it.n_tiles = n_keys > 0 ? (n_keys + N256 - 1) / N256 : 0;
  return it;
}

__device__ __forceinline__ void wait_full_tight(uint32_t bar, int t) {
  mbar_wait_tight(bar + 8 * (t % STAGES256), (t / STAGES256) & 1);
}

// S = Q K^T for this warpgroup's 64 rows and one 64-key tile, over D=256.
__device__ __forceinline__ void issue_qk_d256(float (&s)[32], uint32_t q_addr,
                                              uint32_t k_addr) {
  wgmma_m64n64k16_ss_init<0, 0>(s, desc_sw128(q_addr, 16, 1024),
                                desc_sw128(k_addr, 16, 1024));
#pragma unroll
  for (int kk = 1; kk < D256 / 16; ++kk)
    wgmma_m64n64k16_ss<0, 0>(
        s, desc_sw128(q_addr + (kk / 4) * Q256_BOX + (kk % 4) * 32, 16, 1024),
        desc_sw128(k_addr + (kk / 4) * KV256_BOX + (kk % 4) * 32, 16, 1024),
        1);
}

// O += P V over one 64-key tile and DV columns of O (V's DV / 64 boxes
// from v_addr); P in registers, 4 per 16 keys.
template <int DV>
__device__ __forceinline__ void issue_pv_d256(float (&o)[DV / 2],
                                              const uint32_t (&p)[16],
                                              uint32_t v_addr) {
#pragma unroll
  for (int kk = 0; kk < N256 / 16; ++kk) {
    const uint32_t a[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2],
                           p[4 * kk + 3]};
    const uint64_t b =
        desc_sw128(v_addr + kk * 16 * ROW_BYTES, KV256_BOX, 1024);
    if constexpr (DV == 256)
      wgmma_m64n256k16_rs_tb(o, a, b);
    else
      wgmma_m64n128k16_rs_tb(o, a, b);
  }
}

// The arguments as flash_fwd_kernel's (q maps with 128-row boxes, k / v
// with 64-row ones), and the items' order (item_d256). DV: the columns of O
// an item computes, 256 (O whole) or 128 (each q tile two items, item i
// its columns (i % 2) * 128 ..).
template <int DV>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_d256_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                      int BH, int H, int Sq, int kv_len, int causal,
                      int q_offset, int head_major, float scale_log2e) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sK = sQ + Q256_BYTES;
  const uint32_t sV = sK + STAGES256 * KV256_BYTES;
  const uint32_t q_full = sV + STAGES256 * KV256_BYTES;  // then q_empty
  const uint32_t q_empty = q_full + 8;                    // and the rings
  const uint32_t k_full = q_empty + 8;
  const uint32_t k_empty = k_full + 8 * STAGES256;
  const uint32_t v_full = k_empty + 8 * STAGES256;
  const uint32_t v_empty = v_full + 8 * STAGES256;

  constexpr int SPLIT = D256 / DV;
  constexpr int V_BYTES = (DV / 64) * KV256_BOX;  // of V loaded a tile
  const int n_qt = (Sq + BLOCK_M - 1) / BLOCK_M;
  const int n_items = BH * n_qt * SPLIT;
  // warp-uniform as far as the compiler can tell, so that the wgmma
  // descriptors derived from it stay in uniform registers
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, CONSUMER_WARPS);
#pragma unroll
    for (int s = 0; s < STAGES256; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(k_empty + 8 * s, CONSUMER_WARPS);
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
      int t = 0;        // K/V tiles loaded so far: the ring position
      int q_loads = 0;  // Q tiles loaded so far
      for (int r = 0;; ++r) {
        const int i = snake_item(r);
        if (i >= n_items) break;
        const Item w = item_d256(i / SPLIT, BH, H, n_qt, Sq, kv_len, causal,
                                 q_offset, head_major);
        const int box0 = (i % SPLIT) * (DV / 64);  // V's first box
        if (w.n_tiles == 0) continue;
        // the consumers are done with the previous item's Q
        mbar_wait_tight(q_empty, (q_loads++ & 1) ^ 1);
        mbar_arrive_expect_tx(q_full, Q256_BYTES);
#pragma unroll
        for (int box = 0; box < D256 / 64; ++box)
          tma_load_4d(sQ + box * Q256_BOX, &tm_q, q_full, box * 64, w.h,
                      w.q_start, w.b);
        for (int j = 0; j < w.n_tiles; ++j, ++t) {
          const int s = t % STAGES256;
          // the stage's previous fill was released (passes on the first)
          const uint32_t parity = ((t / STAGES256) & 1) ^ 1;
          mbar_wait_tight(k_empty + 8 * s, parity);
          mbar_arrive_expect_tx(k_full + 8 * s, KV256_BYTES);
#pragma unroll
          for (int box = 0; box < D256 / 64; ++box)
            tma_load_4d(sK + s * KV256_BYTES + box * KV256_BOX, &tm_k,
                        k_full + 8 * s, box * 64, w.h, j * N256, w.b);
          mbar_wait_tight(v_empty + 8 * s, parity);
          mbar_arrive_expect_tx(v_full + 8 * s, V_BYTES);
#pragma unroll
          for (int box = 0; box < DV / 64; ++box)
            tma_load_4d(sV + s * KV256_BYTES + box * KV256_BOX, &tm_v,
                        v_full + 8 * s, (box0 + box) * 64, w.h, j * N256,
                        w.b);
        }
      }
    }
  } else {
    // --------------------------------------------------------- consumers
    reg_alloc<CONSUMER_REGS>();
    const int lane = threadIdx.x & 31;
    const int warp = (threadIdx.x >> 5) & 3;  // within the warpgroup
    const int t2 = (lane & 3) * 2;
    const uint32_t q_addr = sQ + wg * WG_ROWS * ROW_BYTES;
    const int my_turn = BAR_TURN + wg;
    const int next_turn = BAR_TURN + (1 - wg);
    const float c = scale_log2e;
    int t = 0;       // K/V tiles consumed so far: the ring position
    int q_uses = 0;  // Q tiles consumed so far

    float acc[DV / 2];
    float s[32];
    uint32_t p[16];

    if (wg == 1) named_bar_arrive(BAR_TURN, TURN_THREADS);  // 0 goes first
    for (int r = 0;; ++r) {
      const int i = snake_item(r);
      if (i >= n_items) break;
      const Item w = item_d256(i / SPLIT, BH, H, n_qt, Sq, kv_len, causal,
                               q_offset, head_major);
      const int col0 = (i % SPLIT) * DV;  // this item's first column of O
      const int n = w.n_tiles;
      const int wg_row0 = w.q_start + wg * WG_ROWS;
      const int row0 = wg_row0 + warp * 16 + (lane >> 2);  // and row0 + 8
      // tiles that cross kv_len or this warpgroup's causal diagonal
      const int mask_from = causal ? min(kv_len, wg_row0 + q_offset + 1)
                                   : kv_len;
      // causal: tiles from this one on lie wholly above the diagonal of
      // every row of this warpgroup
      const int skip_from =
          causal ? max(wg_row0 + WG_ROWS + q_offset + N256 - 1, 0) / N256 : n;
#pragma unroll
      for (int k = 0; k < DV / 2; ++k) acc[k] = 0.f;
      float m[2] = {NEG_INF, NEG_INF};
      float l[2] = {0.f, 0.f};  // partial over this thread's columns
      float alpha[2] = {1.f, 1.f};

      if (n > 0) {
        mbar_wait_tight(q_full, q_uses++ & 1);
        // tiles this warpgroup computes; those after them lie wholly above
        // its rows' diagonal (p = 0) and are only waited for and released.
        // Each warpgroup takes n + 1 turns an item, whatever it computes.
        const int n_c = min(n, skip_from);
        if (n_c == 0) {
          release(q_empty, 0, 1);
          named_bar_sync(my_turn, TURN_THREADS);
          named_bar_arrive(next_turn, TURN_THREADS);
        } else {
          // prologue: S_0 and its softmax
          wait_full_tight(k_full, t);
          named_bar_sync(my_turn, TURN_THREADS);
          wgmma_fence();
          issue_qk_d256(s, q_addr, sK + (t % STAGES256) * KV256_BYTES);
          wgmma_commit();
          named_bar_arrive(next_turn, TURN_THREADS);
          wgmma_wait<0>();
          fence_regs(s);
          release(k_empty, t, STAGES256);
          if (n_c == 1) release(q_empty, 0, 1);
          softmax_tile(s, m, l, alpha, N256 > mask_from, 0, row0, kv_len,
                       causal, q_offset, c);
          to_bf16(s, p);

          for (int j = 1; j < n_c; ++j) {
            const int tk = t + j;
            wait_full_tight(k_full, tk);
            wait_full_tight(v_full, tk - 1);
            rescale(acc, alpha);
            named_bar_sync(my_turn, TURN_THREADS);
            wgmma_fence();
            fence_regs(acc);
            fence_regs(p);
            issue_qk_d256(s, q_addr, sK + (tk % STAGES256) * KV256_BYTES);
            wgmma_commit();
            issue_pv_d256<DV>(acc, p,
                              sV + ((tk - 1) % STAGES256) * KV256_BYTES);
            wgmma_commit();
            named_bar_arrive(next_turn, TURN_THREADS);
            wgmma_wait<1>();  // S_j is done, P_{j-1} V_{j-1} may still run
            fence_regs(s);
            release(k_empty, tk, STAGES256);
            if (j == n_c - 1) release(q_empty, 0, 1);
            softmax_tile(s, m, l, alpha, (j + 1) * N256 > mask_from,
                         j * N256, row0, kv_len, causal, q_offset, c);
            wgmma_wait<0>();
            fence_regs(acc);
            fence_regs(p);
            release(v_empty, tk - 1, STAGES256);
            to_bf16(s, p);
          }

          // the last computed tile's P V
          const int last = t + n_c - 1;
          wait_full_tight(v_full, last);
          rescale(acc, alpha);
          named_bar_sync(my_turn, TURN_THREADS);
          wgmma_fence();
          fence_regs(acc);
          fence_regs(p);
          issue_pv_d256<DV>(acc, p, sV + (last % STAGES256) * KV256_BYTES);
          wgmma_commit();
          named_bar_arrive(next_turn, TURN_THREADS);
          wgmma_wait<0>();
          fence_regs(acc);
          release(v_empty, last, STAGES256);
        }
        for (int j = n_c; j < n; ++j) {
          const int tk = t + j;
          wait_full_tight(k_full, tk);
          named_bar_sync(my_turn, TURN_THREADS);
          named_bar_arrive(next_turn, TURN_THREADS);
          release(k_empty, tk, STAGES256);
          wait_full_tight(v_full, tk);
          release(v_empty, tk, STAGES256);
        }
      }
      t += n;

      // ---- normalise and write; rows with no valid key have l = 0, acc = 0
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        float lsum = l[rr];
        lsum += __shfl_xor_sync(0xffffffffu, lsum, 1);
        lsum += __shfl_xor_sync(0xffffffffu, lsum, 2);
        const float l_safe = fmaxf(lsum, 1e-30f);
        const float inv = 1.f / l_safe;
        const int row = row0 + rr * 8;
        if (row < Sq) {
          __nv_bfloat16* orow =
              o + (((long long)w.b * Sq + row) * H + w.h) * D256 + col0 + t2;
#pragma unroll
          for (int k = 0; k < DV / 8; ++k)
            *reinterpret_cast<uint32_t*>(orow + k * 8) = pack_bf16(
                acc[4 * k + 2 * rr] * inv, acc[4 * k + 2 * rr + 1] * inv);
          if (lse != nullptr && t2 == 0 && col0 == 0) {
            // the running max in scaled units; NEG_INF where no key was valid
            const float m_scaled = lsum > 0.f ? m[rr] * c : NEG_INF;
            lse[(long long)w.bh * Sq + row] = m_scaled * LN2 + logf(l_safe);
          }
        }
      }
    }
    // warpgroup 1 arrived once more on warpgroup 0's turn than 0 waited
    if (wg == 0) named_bar_sync(BAR_TURN, TURN_THREADS);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int B, int H, int Sq, int Sk, int kv_len, int causal, float scale,
           cudaStream_t stream) {
  using C = Cfg<D>;
  CUtensorMap tm_q, tm_k, tm_v;
  cudaError_t err = encode_bshd_map(&tm_q, q, B, Sq, H, D, BLOCK_M);
  if (err == cudaSuccess)
    err = encode_bshd_map(&tm_k, k, B, Sk, H, D, BLOCK_N);
  if (err == cudaSuccess)
    err = encode_bshd_map(&tm_v, v, B, Sk, H, D, BLOCK_N);
  if (err != cudaSuccess) return (int)err;
  // once per process (one card), so that a launch inside a CUDA graph
  // capture makes no call but the launch itself
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::SMEM);
  if (attr != cudaSuccess) return (int)attr;
  const int sms = sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  const long long items = (long long)B * H * ((Sq + BLOCK_M - 1) / BLOCK_M);
  if (items > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const int grid = (int)(items < sms ? items : sms);
  flash_fwd_kernel<D><<<grid, THREADS, C::SMEM, stream>>>(
      tm_q, tm_k, tm_v, static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), B * H, H, Sq, kv_len, causal, kv_len - Sq,
      scale * LOG2E);
  return (int)cudaGetLastError();
}

template <int DV>
int launch_d256_as(const CUtensorMap& tm_q, const CUtensorMap& tm_k,
                   const CUtensorMap& tm_v, void* o, void* lse, int B, int H,
                   int Sq, int Sk, int kv_len, int causal, float scale,
                   long long items, int sms, cudaStream_t stream) {
  // once per process (one card), so that a launch inside a CUDA graph
  // capture makes no call but the launch itself
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_d256_kernel<DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM256);
  if (attr != cudaSuccess) return (int)attr;
  const int grid = (int)(items < sms ? items : sms);
  // every item streams its head's K and V: when all heads' K and V are more
  // than L2 keeps, the blocks in flight share a few heads' (head-major),
  // else the longest items go first over all heads (the better balance)
  const int head_major = (long long)B * H * Sk * D256 * 4 > KV_L2_BYTES;
  flash_fwd_d256_kernel<DV><<<grid, THREADS, SMEM256, stream>>>(
      tm_q, tm_k, tm_v, static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), B * H, H, Sq, kv_len, causal, kv_len - Sq,
      head_major, scale * LOG2E);
  return (int)cudaGetLastError();
}

int launch_d256(const void* q, const void* k, const void* v, void* o,
                void* lse, int B, int H, int Sq, int Sk, int kv_len,
                int causal, float scale, cudaStream_t stream) {
  CUtensorMap tm_q, tm_k, tm_v;
  cudaError_t err = encode_bshd_map(&tm_q, q, B, Sq, H, D256, BLOCK_M);
  if (err == cudaSuccess)
    err = encode_bshd_map(&tm_k, k, B, Sk, H, D256, N256);
  if (err == cudaSuccess)
    err = encode_bshd_map(&tm_v, v, B, Sk, H, D256, N256);
  if (err != cudaSuccess) return (int)err;
  const int sms = sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  const long long items = (long long)B * H * ((Sq + BLOCK_M - 1) / BLOCK_M);
  if (2 * items > 0x7fffffff) return (int)cudaErrorInvalidValue;
  // O split in two where the whole-O items would fill at most half the SMs
  if (2 * items <= sms)
    return launch_d256_as<128>(tm_q, tm_k, tm_v, o, lse, B, H, Sq, Sk, kv_len,
                               causal, scale, 2 * items, sms, stream);
  return launch_d256_as<256>(tm_q, tm_k, tm_v, o, lse, B, H, Sq, Sk, kv_len,
                             causal, scale, items, sms, stream);
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
  if (D == 256)
    return launch_d256(q, k, v, o, lse, B, H, Sq, Sk, kv_len, causal, scale,
                       st);
  // other D <= 256 are zero-padded to 64, 128 or 256 by the wrapper
  return (int)cudaErrorInvalidValue;
}

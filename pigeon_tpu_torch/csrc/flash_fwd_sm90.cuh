// The streaming attention forward of kernel K3 (flash_attention.cu) on
// Hopper's wgmma, for (B, S, H, 64) bf16 q/k/v:
//
//     s     = q k_c^T                                    (f32, keys of chunk c)
//     m_new = max(m, max_c s);  p = 2^((s - m_new) c2);  corr = 2^((m - m_new) c2)
//     l     = l * corr + sum(p);  o = o * corr + bf16(p) v_c     (f32)
//     out   = bf16(o / l),  c2 = 64^-0.5 * log2(e)
//
// K3′ (flash_attention_online.cu) launches the same kernel: its function,
// _attn_kernel_online, is this one (128-key chunks, p rounded to bf16
// against the running max, den from f32 p). The tuning kernel V10
// (attention_fwd_variants.cu) is the same function at 256-key chunks:
// the kernel's STEP, keys a softmax step, is 128 for every other user.
// The kernel's `Tag` names each user's instance, so K3, K3′ and V10 are
// told apart in a profile. Its `Out`
// policy writes out: bf16 (every user but K7), or K7's requantize of the
// bf16 output, oq = clip(rint(f32(out) / ao), +-127) as int8, so that the
// bf16 output never goes to device memory there (the TPU kernel keeps it
// in VMEM).
//
// Four diagnostics of the tuning script run the same kernel under their
// own tags (attention_fwd_variants.cu). The chain from a chunk's scores
// to p is a policy, `Chain`: SoftmaxChain (above; every other user);
// V6's CastChain, p = bf16(s) of the unscaled scores with no mask, max,
// exp or l, o never rescaled and stored undivided; or V8's and V9's
// SumChain, which only adds the unscaled scores into l (the row's sum of
// q k^T) and leaves them as they are. `PV` = false (V7, V8, V9) compiles
// out V's loads and every P V product: o holds the first 32 score
// registers of chunk 0 (keys 0-63, in o's m64n64 layout), p under
// SoftmaxChain, rescaled with the running max as K3 rescales o, or the
// raw scores under SumChain. Both are template choices, never run-time
// branches, so every other instance compiles as before. (flash_bwd_sm90.cuh
// has chain policies of the same names for its gradient pass; no source
// includes both.)
//
// A persistent grid (one block an SM) walks the (128-row query tile,
// head, image) tiles, query tiles of a head next to each other so their
// K and V are read from L2. A block has 384 threads in three warpgroups:
//   - a producer (registers cut to 40 by setmaxnreg) whose first thread
//     issues the TMA loads: each tile's Q into a ring of two, each
//     128-key chunk of K and V into a ring of FWD_STAGES stages, each slot
//     freed by the consumers through an `empty` mbarrier. It runs ahead
//     across tiles, so a tile's first loads overlap the previous tile;
//   - two consumers (232 registers) of 64 query rows each. Per chunk:
//     s = Q K_c^T by four m64n128k16 wgmma steps from shared memory (both
//     operands K-major); the online softmax in registers (one FFMA and one
//     ex2 an element, the scale and log2(e) folded into c2); p rounded to
//     bf16 in registers and fed as wgmma's A operand to eight m64n64k16
//     steps of P V_c, V read MN-major (transposed) from the same tile.
//     The next chunk's s is issued with this chunk's P V, and its softmax
//     runs while P V does, so the tensor cores and the exp unit work at
//     the same time (FlashAttention-3's intra-warpgroup overlap); p is
//     packed into the A fragments only once P V has read them.
//     At STEP = 256 a step takes two ring stages: s of both halves (2 x
//     four m64n128k16, 128 f32 registers), one max over both, then the
//     first half's P V runs while the second half's exps do. The next
//     step's s is not overlapped: two score halves, p and o would pass
//     the consumers' 232 registers. An odd chunk count ends on a step of
//     one half (S in (256k, 256k + 128]).
// o stays in registers in f32 and is divided by l once. Two S x S x 64
// product walks, no score tile in shared memory, no sequence limit.
//
// Keys past S (the ragged last chunk; TMA fills those rows with zeros) get
// s = -inf before the max; a row whose max is still -inf takes 0 in its
// place, so ex2 never sees -inf - (-inf). CastChain leaves them at s = 0:
// their V rows are zeros too, and bf16(-inf) x 0 would be NaN. Query rows
// past S are computed on zero rows and never written.

#pragma once

#include "hopper_sm90.cuh"

namespace {

constexpr int FWD_ROWS = 128;      // query rows of a block (2 x 64)
constexpr int FWD_CHUNK = 128;     // keys a step
constexpr int FWD_STAGES = 4;      // K/V ring depth
constexpr int FWD_THREADS = 384;   // producer + two consumer warpgroups
constexpr int TILE128 = 128 * ROW_BYTES;  // one 128-row tile, 16 KB
constexpr int FWD_Q_OFF = 0;                  // two Q slots
constexpr int FWD_KV_OFF = 2 * TILE128;
constexpr int FWD_BAR_OFF = FWD_KV_OFF + FWD_STAGES * 2 * TILE128;
// Barriers: q_full[2], q_empty[2], k_full[STAGES], v_full[STAGES],
// empty[STAGES].
constexpr int FWD_SMEM = FWD_BAR_OFF + (4 + 3 * FWD_STAGES) * 8 + 1024;

// The output policies: `store` takes a thread's pair o / l at two
// neighbouring columns, the row's l (quad-reduced where the chain sums),
// and the policy's scale (read once from the caller's device pointer
// where SCALED) and writes the pair at `dst`; where ADDS, also the pair
// at the same offset of the caller's (B, S, H, 64) bf16 tensor `add`, two
// bf16 in a word, which the kernel reads when the tile starts so that the
// load's latency hides under its chunks (0 otherwise). Where ROWSUM the
// kernel also writes each row's l, once, to the caller's (B, H, S) f32
// side output `rowsum`.
struct AttnOutBf16 {
  typedef bf16 T;
  static constexpr bool SCALED = false;
  static constexpr bool ADDS = false;
  static constexpr bool ROWSUM = false;
  __device__ static __forceinline__ void store(T* dst, float o0, float o1,
                                               float, float, uint32_t) {
    *reinterpret_cast<uint32_t*>(dst) = pack_bf16(o0, o1);
  }
};

// int8(clip(rint(f32(bf16(o / l)) / a), +-127)): K7's requantize of the
// attention output, rounded to bf16 first as the TPU kernel's oall_ref.
struct AttnOutQuantized {
  typedef int8_t T;
  static constexpr bool SCALED = true;
  static constexpr bool ADDS = false;
  static constexpr bool ROWSUM = false;
  __device__ static __forceinline__ void store(T* dst, float o0, float o1,
                                               float, float a, uint32_t) {
    const float2 o = __bfloat1622float2(__floats2bfloat162_rn(o0, o1));
    *reinterpret_cast<char2*>(dst) =
        make_char2(quantize_s8(o.x, a), quantize_s8(o.y, a));
  }
};

// The online softmax in parts, on the thread's two rows of a 64-row
// tile. chunk_max masks keys at or past `kv` of one 128-key chunk's
// scores (in place, s = -inf) and folds the chunk into the rows' partial
// max `mx`; update_max reduces `mx` over the row's four threads, moves the
// running max `m` (units of s) to it and gives mc = m_new c2 (0 while the
// row's max is -inf, so ex2 never sees -inf - (-inf)) and the correction
// corr = 2^((m - m_new) c2); chunk_exp leaves p = 2^(s c2 - mc) in `s`
// and adds the rows' sums of p to `psum`. A step takes one max over all
// its chunks before any exp.
__device__ __forceinline__ void chunk_max(float (&s)[64], int kv, int quad,
                                          float (&mx)[2]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int col = 8 * (i >> 2) + 2 * quad + (i & 1);
    s[i] = col < kv ? s[i] : -INFINITY;
    mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
  }
}

__device__ __forceinline__ void update_max(float (&mx)[2], float c2,
                                           float (&m)[2], float (&mc)[2],
                                           float (&corr)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    mc[r] = mx[r] == -INFINITY ? 0.0f : mx[r] * c2;
    corr[r] = fast_exp2(m[r] * c2 - mc[r]);
    m[r] = mx[r];
  }
}

__device__ __forceinline__ void chunk_exp(float (&s)[64], float c2,
                                          const float (&mc)[2],
                                          float (&psum)[2]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    s[i] = fast_exp2(fmaf(s[i], c2, -mc[(i >> 1) & 1]));
    psum[(i >> 1) & 1] += s[i];
  }
}

// Online softmax of one 128-key chunk's scores, in place: masks keys at
// or past `kv`, updates the running max `m` and the partial denominator
// `l`, leaves p in `s` and returns the rows' correction in `corr`.
__device__ __forceinline__ void online_softmax(float (&s)[64], int kv,
                                               int quad, float c2,
                                               float (&m)[2], float (&l)[2],
                                               float (&corr)[2]) {
  float mx[2] = {m[0], m[1]};
  chunk_max(s, kv, quad, mx);
  float mc[2], psum[2] = {0.0f, 0.0f};
  update_max(mx, c2, m, mc, corr);
  chunk_exp(s, c2, mc, psum);
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + psum[r];
}

// The chain policies of a 128-key step: `apply` turns a chunk's scores
// into p in place (its arguments are online_softmax's); where kSoftmax,
// o is rescaled by corr after each chunk and divided by l at the end;
// where kSums, l holds the thread's partial row sums, reduced over the
// row's four threads at the end.
struct SoftmaxChain {
  static constexpr bool kSoftmax = true;
  static constexpr bool kSums = true;
  __device__ __forceinline__ static void apply(float (&s)[64], int kv,
                                               int quad, float c2,
                                               float (&m)[2], float (&l)[2],
                                               float (&corr)[2]) {
    online_softmax(s, kv, quad, c2, m, l, corr);
  }
};

// V6's casts: p = s, unscaled and unmasked (keys past S score 0 against
// their zero-filled K rows and add 0 through their zero V rows).
struct CastChain {
  static constexpr bool kSoftmax = false;
  static constexpr bool kSums = false;
  __device__ __forceinline__ static void apply(float (&)[64], int, int,
                                               float, float (&)[2],
                                               float (&)[2], float (&)[2]) {}
};

// V8's and V9's row sums: l += the thread's 32 unscaled scores of each
// row, s left as it is; no mask (keys past S score 0 against their
// zero-filled K rows and add 0), max, exp or corr.
struct SumChain {
  static constexpr bool kSoftmax = false;
  static constexpr bool kSums = true;
  __device__ __forceinline__ static void apply(float (&s)[64], int, int,
                                               float, float (&)[2],
                                               float (&l)[2], float (&)[2]) {
#pragma unroll
    for (int i = 0; i < 64; ++i) l[(i >> 1) & 1] += s[i];
  }
};

template <class Tag, class Out, int STEP, class Chain, bool PV>
__global__ void __launch_bounds__(FWD_THREADS, 1)
flash_attention_kernel_wgmma(const __grid_constant__ CUtensorMap q_map,
                             const __grid_constant__ CUtensorMap k_map,
                             const __grid_constant__ CUtensorMap v_map,
                             typename Out::T* __restrict__ out,
                             const float* __restrict__ out_scale, int S,
                             int H, int B, float c2,
                             const bf16* __restrict__ add,
                             float* __restrict__ rowsum) {
  static_assert(STEP == FWD_CHUNK || (Chain::kSoftmax && PV),
                "256-key steps run the softmax chain with P V");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  const int n_qt = (S + FWD_ROWS - 1) / FWD_ROWS;
  const int n_tiles = n_qt * H * B;
  const int n_chunks = (S + FWD_CHUNK - 1) / FWD_CHUNK;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + FWD_BAR_OFF);
  uint64_t* q_full = bars;
  uint64_t* q_empty = bars + 2;
  uint64_t* k_full = bars + 4;
  uint64_t* v_full = bars + 4 + FWD_STAGES;
  uint64_t* empty = bars + 4 + 2 * FWD_STAGES;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(q_full + i, 1);
      mbar_init(q_empty + i, 2 * 128);
    }
    for (int st = 0; st < FWD_STAGES; ++st) {
      mbar_init(k_full + st, 1);
      mbar_init(v_full + st, 1);
      mbar_init(empty + st, 2 * 128);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    // Producer.
    regs_dec<40>();
    if (threadIdx.x == 0) {
      int it = 0, qi = 0;
      for (int w = blockIdx.x; w < n_tiles; w += gridDim.x, ++qi) {
        const int qt = w % n_qt, h = (w / n_qt) % H, b = w / (n_qt * H);
        const int qs = qi & 1;
        if (qi >= 2) mbar_wait(q_empty + qs, (qi / 2 - 1) & 1);
        mbar_expect_tx(q_full + qs, TILE128);
        tma_load(smem + FWD_Q_OFF + qs * TILE128, &q_map, q_full + qs, h,
                 qt * FWD_ROWS, b);
        for (int j = 0; j < n_chunks; ++j, ++it) {
          const int st = it % FWD_STAGES;
          if (it >= FWD_STAGES) {
            mbar_wait(empty + st, (it / FWD_STAGES - 1) & 1);
          }
          unsigned char* kv = smem + FWD_KV_OFF + st * 2 * TILE128;
          mbar_expect_tx(k_full + st, TILE128);
          tma_load(kv, &k_map, k_full + st, h, j * FWD_CHUNK, b);
          if constexpr (PV) {
            mbar_expect_tx(v_full + st, TILE128);
            tma_load(kv + TILE128, &v_map, v_full + st, h, j * FWD_CHUNK,
                     b);
          }
        }
      }
    }
    return;
  }

  // Consumer warpgroup cw: query rows 64 cw .. + 63 of each tile.
  regs_inc<232>();
  const int cw = wg - 1;
  const int tid = threadIdx.x % 128;
  const int lane = tid % 32;
  const int row = (tid / 32) * 16 + lane / 4;  // and row + 8
  const int quad = lane % 4;
  const size_t ld = static_cast<size_t>(H) * HD;
  const uint32_t kv_base = smem_u32(smem + FWD_KV_OFF);
  const float out_a = Out::SCALED ? *out_scale : 0.0f;

  int it = 0, qi = 0;
  for (int w = blockIdx.x; w < n_tiles; w += gridDim.x, ++qi) {
    const int qt = w % n_qt, h = (w / n_qt) % H, b = w / (n_qt * H);
    const int qs = qi & 1;
    const uint32_t q_addr = smem_u32(smem + FWD_Q_OFF + qs * TILE128) +
                            cw * 64 * ROW_BYTES;
    float o[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] = 0.0f;
    float m[2] = {-INFINITY, -INFINITY};
    float l[2] = {0.0f, 0.0f};
    float corr[2];
    float s[64];
    uint32_t pa[8][4];
    uint32_t adds[2][8];  // ADDS: the thread's pairs of `add`, both rows
    if constexpr (Out::ADDS) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int q = qt * FWD_ROWS + cw * 64 + row + 8 * r;
        const uint32_t* src = reinterpret_cast<const uint32_t*>(
            add + (static_cast<size_t>(b) * S + q) * ld + h * HD);
#pragma unroll
        for (int j8 = 0; j8 < 8; ++j8) {
          adds[r][j8] = q < S ? __ldg(src + 4 * j8 + quad) : 0u;
        }
      }
    }
    mbar_wait(q_full + qs, (qi / 2) & 1);

    if constexpr (STEP == FWD_CHUNK) {
      // Chunk 0's scores and chain.
      int st = it % FWD_STAGES;
      mbar_wait(k_full + st, (it / FWD_STAGES) & 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t k_addr = kv_base + st * 2 * TILE128;
        wgmma_ss_n128<0, 0>(s, desc_sw128(q_addr + kk * 32),
                            desc_sw128(k_addr + kk * 32), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      if constexpr (!PV) mbar_arrive(empty + st);  // s is all it reads
      Chain::apply(s, S, quad, c2, m, l, corr);
      if constexpr (PV) {
#pragma unroll
        for (int k = 0; k < 8; ++k) acc_to_a(s, k, pa[k]);
      } else {
        // Without P V, o keeps p (or s) of keys 0-63: s[0..31] in o's
        // layout.
#pragma unroll
        for (int i = 0; i < 32; ++i) o[i] = s[i];
      }

      // Chunk j's scores issued with chunk j - 1's P V, its chain while
      // P V runs. The waits come before the products: a branch between
      // wgmma.fence and a stage's last product makes ptxas serialise them.
      for (int j = 1; j < n_chunks; ++j) {
        const int prev = st;
        const int prev_parity = (it / FWD_STAGES) & 1;
        ++it;
        st = it % FWD_STAGES;
        if constexpr (PV) mbar_wait(v_full + prev, prev_parity);
        mbar_wait(k_full + st, (it / FWD_STAGES) & 1);
        const uint32_t k_addr = kv_base + st * 2 * TILE128;
        const uint32_t v_addr = kv_base + prev * 2 * TILE128 + TILE128;
        if constexpr (PV) fence_regs(o);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          wgmma_ss_n128<0, 0>(s, desc_sw128(q_addr + kk * 32),
                              desc_sw128(k_addr + kk * 32), kk > 0);
        }
        wgmma_commit();
        if constexpr (PV) {
#pragma unroll
          for (int k = 0; k < FWD_CHUNK / 16; ++k) {
            wgmma_rs_n64<1>(o, pa[k],
                            desc_sw128(v_addr + k * 16 * ROW_BYTES), 1);
          }
          wgmma_commit();
          wgmma_wait<1>();
        } else {
          wgmma_wait<0>();
        }
        fence_regs(s);
        if constexpr (!PV) mbar_arrive(empty + st);
        Chain::apply(s, S - j * FWD_CHUNK, quad, c2, m, l, corr);
        if constexpr (PV) {
          wgmma_wait<0>();
          fence_regs(o);
          mbar_arrive(empty + prev);
        }
        // p goes into the A fragments once P V has read them.
        if constexpr (Chain::kSoftmax) {
#pragma unroll
          for (int i = 0; i < 32; ++i) o[i] *= corr[(i >> 1) & 1];
        }
        if constexpr (PV) {
#pragma unroll
          for (int k = 0; k < 8; ++k) acc_to_a(s, k, pa[k]);
        }
      }
      // The last chunk's P V.
      if constexpr (PV) {
        const uint32_t v_addr = kv_base + st * 2 * TILE128 + TILE128;
        mbar_wait(v_full + st, (it / FWD_STAGES) & 1);
        fence_regs(o);
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < FWD_CHUNK / 16; ++k) {
          wgmma_rs_n64<1>(o, pa[k], desc_sw128(v_addr + k * 16 * ROW_BYTES),
                          1);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(o);
        mbar_arrive(empty + st);
      }
      ++it;
    } else {
      // 256-key steps: each consumes two ring stages, one max over both
      // halves' scores before any exp. The first half's P V runs while
      // the second half's exps do; no step overlaps the next one's
      // scores (two score halves, p and o would outgrow the registers).
      float s1[64];
      uint32_t pb[8][4];
      const int n_pairs = n_chunks / 2;
      for (int j = 0; j < n_pairs; ++j, it += 2) {
        const int st0 = it % FWD_STAGES, st1 = (it + 1) % FWD_STAGES;
        const int par0 = (it / FWD_STAGES) & 1;
        const int par1 = ((it + 1) / FWD_STAGES) & 1;
        const uint32_t k0_addr = kv_base + st0 * 2 * TILE128;
        const uint32_t k1_addr = kv_base + st1 * 2 * TILE128;
        mbar_wait(k_full + st0, par0);
        mbar_wait(k_full + st1, par1);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          wgmma_ss_n128<0, 0>(s, desc_sw128(q_addr + kk * 32),
                              desc_sw128(k0_addr + kk * 32), kk > 0);
        }
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          wgmma_ss_n128<0, 0>(s1, desc_sw128(q_addr + kk * 32),
                              desc_sw128(k1_addr + kk * 32), kk > 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(s);
        fence_regs(s1);

        const int kv = S - 2 * j * FWD_CHUNK;
        float mx[2] = {m[0], m[1]};
        chunk_max(s, kv, quad, mx);
        chunk_max(s1, kv - FWD_CHUNK, quad, mx);
        float mc[2], psum[2] = {0.0f, 0.0f};
        update_max(mx, c2, m, mc, corr);
#pragma unroll
        for (int i = 0; i < 32; ++i) o[i] *= corr[(i >> 1) & 1];
        chunk_exp(s, c2, mc, psum);
#pragma unroll
        for (int k = 0; k < 8; ++k) acc_to_a(s, k, pa[k]);
        mbar_wait(v_full + st0, par0);
        mbar_wait(v_full + st1, par1);
        fence_regs(o);
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < FWD_CHUNK / 16; ++k) {
          wgmma_rs_n64<1>(o, pa[k],
                          desc_sw128(k0_addr + TILE128 + k * 16 * ROW_BYTES),
                          1);
        }
        wgmma_commit();
        chunk_exp(s1, c2, mc, psum);
#pragma unroll
        for (int k = 0; k < 8; ++k) acc_to_a(s1, k, pb[k]);
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < FWD_CHUNK / 16; ++k) {
          wgmma_rs_n64<1>(o, pb[k],
                          desc_sw128(k1_addr + TILE128 + k * 16 * ROW_BYTES),
                          1);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(o);
        mbar_arrive(empty + st0);
        mbar_arrive(empty + st1);
#pragma unroll
        for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + psum[r];
      }
      // An odd chunk count leaves one 128-key half: a step of its own.
      if (n_chunks & 1) {
        const int st = it % FWD_STAGES;
        const int parity = (it / FWD_STAGES) & 1;
        const uint32_t k_addr = kv_base + st * 2 * TILE128;
        mbar_wait(k_full + st, parity);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          wgmma_ss_n128<0, 0>(s, desc_sw128(q_addr + kk * 32),
                              desc_sw128(k_addr + kk * 32), kk > 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(s);
        online_softmax(s, S - 2 * n_pairs * FWD_CHUNK, quad, c2, m, l, corr);
#pragma unroll
        for (int i = 0; i < 32; ++i) o[i] *= corr[(i >> 1) & 1];
#pragma unroll
        for (int k = 0; k < 8; ++k) acc_to_a(s, k, pa[k]);
        mbar_wait(v_full + st, parity);
        fence_regs(o);
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < FWD_CHUNK / 16; ++k) {
          wgmma_rs_n64<1>(o, pa[k],
                          desc_sw128(k_addr + TILE128 + k * 16 * ROW_BYTES),
                          1);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(o);
        mbar_arrive(empty + st);
        ++it;
      }
    }
    mbar_arrive(q_empty + qs);

    // out = Out(o / l) on the rows below S (Out(o) without the softmax).
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if constexpr (Chain::kSums) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      }
      const int q = qt * FWD_ROWS + cw * 64 + row + 8 * r;
      if (q >= S) continue;
      typename Out::T* dst =
          out + (static_cast<size_t>(b) * S + q) * ld + h * HD;
      if constexpr (Out::ROWSUM) {
        if (quad == 0) {
          rowsum[(static_cast<size_t>(b) * H + h) * S + q] = l[r];
        }
      }
#pragma unroll
      for (int j8 = 0; j8 < 8; ++j8) {
        float o0 = o[4 * j8 + 2 * r], o1 = o[4 * j8 + 2 * r + 1];
        if constexpr (Chain::kSoftmax) {
          o0 = o0 / l[r];
          o1 = o1 / l[r];
        }
        Out::store(dst + 8 * j8 + 2 * quad, o0, o1, l[r], out_a,
                   Out::ADDS ? adds[r][j8] : 0u);
      }
    }
  }
}

// Launch the forward over (B, S, H, 64) q/k/v on `stream` into out (B, S,
// H, 64) of the policy's type, STEP keys a softmax step (128 or 256),
// `Chain` and `PV` as the kernel's; `out_scale` a device pointer to the
// f32 scale of a SCALED policy, `add` the (B, S, H, 64) bf16 tensor of an
// ADDS policy, `rowsum` the (B, H, S) f32 side output of a ROWSUM policy.
// Returns the first failing call's error.
template <class Tag, class Out = AttnOutBf16, int STEP = FWD_CHUNK,
          class Chain = SoftmaxChain, bool PV = true>
inline cudaError_t launch_flash_forward(const void* q, const void* k,
                                        const void* v, void* out, int batch,
                                        int seq, int heads,
                                        cudaStream_t stream,
                                        const float* out_scale = nullptr,
                                        const void* add = nullptr,
                                        float* rowsum = nullptr) {
  static_assert(STEP == FWD_CHUNK || STEP == 2 * FWD_CHUNK,
                "a step is one or two 128-key chunks");
  if (batch < 1 || seq < 1 || heads < 1 || (Out::SCALED && !out_scale) ||
      (Out::ADDS && !add) || (Out::ROWSUM && !rowsum)) {
    return cudaErrorInvalidValue;
  }
  CUtensorMap maps[3];
  const void* srcs[3] = {q, k, v};
  for (int i = 0; i < 3; ++i) {
    cudaError_t err = bshd_map(&maps[i], srcs[i], batch, seq, heads, 128);
    if (err != cudaSuccess) return err;
  }
  int sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  static bool smem_set = false;  // once a process
  if (!smem_set) {
    err = cudaFuncSetAttribute(
        flash_attention_kernel_wgmma<Tag, Out, STEP, Chain, PV>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, FWD_SMEM);
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  const long tiles =
      static_cast<long>((seq + FWD_ROWS - 1) / FWD_ROWS) * heads * batch;
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);
  flash_attention_kernel_wgmma<Tag, Out, STEP, Chain, PV>
      <<<grid, FWD_THREADS, FWD_SMEM, stream>>>(
          maps[0], maps[1], maps[2], static_cast<typename Out::T*>(out),
          out_scale, seq, heads, batch,
          LOG2E / sqrtf(static_cast<float>(HD)),
          static_cast<const bf16*>(add), rowsum);
  return cudaGetLastError();
}

}  // namespace

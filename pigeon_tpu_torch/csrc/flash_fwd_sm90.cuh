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
// against the running max, den from f32 p). The kernel's `Tag` names each
// user's instance, so K3 and K3′ are told apart in a profile. Its `Out`
// policy writes out: bf16 (every user but K7), or K7's requantize of the
// bf16 output, oq = clip(rint(f32(out) / ao), +-127) as int8, so that the
// bf16 output never goes to device memory there (the TPU kernel keeps it
// in VMEM).
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
// o stays in registers in f32 and is divided by l once. Two S x S x 64
// product walks, no score tile in shared memory, no sequence limit.
//
// Keys past S (the ragged last chunk; TMA fills those rows with zeros) get
// s = -inf before the max; a row whose max is still -inf takes 0 in its
// place, so ex2 never sees -inf - (-inf). Query rows past S are computed
// on zero rows and never written.

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
// neighbouring columns and the policy's scale (read once from the
// caller's device pointer where SCALED) and writes the pair at `dst`.
struct AttnOutBf16 {
  typedef bf16 T;
  static constexpr bool SCALED = false;
  __device__ static __forceinline__ void store(T* dst, float o0, float o1,
                                               float) {
    *reinterpret_cast<uint32_t*>(dst) = pack_bf16(o0, o1);
  }
};

// int8(clip(rint(f32(bf16(o / l)) / a), +-127)): K7's requantize of the
// attention output, rounded to bf16 first as the TPU kernel's oall_ref.
struct AttnOutQuantized {
  typedef int8_t T;
  static constexpr bool SCALED = true;
  __device__ static __forceinline__ void store(T* dst, float o0, float o1,
                                               float a) {
    const float2 o = __bfloat1622float2(__floats2bfloat162_rn(o0, o1));
    *reinterpret_cast<char2*>(dst) =
        make_char2(quantize_s8(o.x, a), quantize_s8(o.y, a));
  }
};

// Online softmax of one chunk's scores on the thread's two rows, in
// place: masks keys at or past `kv`, updates the running max `m` (units of
// s) and the partial denominator `l`, leaves p in `s` and returns the
// rows' correction 2^((m - m_new) c2).
__device__ __forceinline__ void online_softmax(float (&s)[64], int kv,
                                               int quad, float c2,
                                               float (&m)[2], float (&l)[2],
                                               float (&corr)[2]) {
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int col = 8 * (i >> 2) + 2 * quad + (i & 1);
    s[i] = col < kv ? s[i] : -INFINITY;
    mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
  }
  float mc[2], psum[2] = {0.0f, 0.0f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    mc[r] = mx[r] == -INFINITY ? 0.0f : mx[r] * c2;
    corr[r] = fast_exp2(m[r] * c2 - mc[r]);
    m[r] = mx[r];
  }
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    s[i] = fast_exp2(fmaf(s[i], c2, -mc[(i >> 1) & 1]));
    psum[(i >> 1) & 1] += s[i];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + psum[r];
}

template <class Tag, class Out>
__global__ void __launch_bounds__(FWD_THREADS, 1)
flash_attention_kernel_wgmma(const __grid_constant__ CUtensorMap q_map,
                             const __grid_constant__ CUtensorMap k_map,
                             const __grid_constant__ CUtensorMap v_map,
                             typename Out::T* __restrict__ out,
                             const float* __restrict__ out_scale, int S,
                             int H, int B, float c2) {
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
          mbar_expect_tx(v_full + st, TILE128);
          tma_load(kv + TILE128, &v_map, v_full + st, h, j * FWD_CHUNK, b);
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
    mbar_wait(q_full + qs, (qi / 2) & 1);

    // Chunk 0's scores and softmax.
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
    online_softmax(s, S, quad, c2, m, l, corr);
#pragma unroll
    for (int k = 0; k < 8; ++k) acc_to_a(s, k, pa[k]);

    // Chunk j's scores issued with chunk j - 1's P V, its softmax while
    // P V runs. The waits come before the products: a branch between
    // wgmma.fence and a stage's last product makes ptxas serialise them.
    for (int j = 1; j < n_chunks; ++j) {
      const int prev = st;
      const int prev_parity = (it / FWD_STAGES) & 1;
      ++it;
      st = it % FWD_STAGES;
      mbar_wait(v_full + prev, prev_parity);
      mbar_wait(k_full + st, (it / FWD_STAGES) & 1);
      const uint32_t k_addr = kv_base + st * 2 * TILE128;
      const uint32_t v_addr = kv_base + prev * 2 * TILE128 + TILE128;
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        wgmma_ss_n128<0, 0>(s, desc_sw128(q_addr + kk * 32),
                            desc_sw128(k_addr + kk * 32), kk > 0);
      }
      wgmma_commit();
#pragma unroll
      for (int k = 0; k < FWD_CHUNK / 16; ++k) {
        wgmma_rs_n64<1>(o, pa[k], desc_sw128(v_addr + k * 16 * ROW_BYTES), 1);
      }
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(s);
      online_softmax(s, S - j * FWD_CHUNK, quad, c2, m, l, corr);
      wgmma_wait<0>();
      fence_regs(o);
      mbar_arrive(empty + prev);
      // p goes into the A fragments once P V has read them.
#pragma unroll
      for (int i = 0; i < 32; ++i) o[i] *= corr[(i >> 1) & 1];
#pragma unroll
      for (int k = 0; k < 8; ++k) acc_to_a(s, k, pa[k]);
    }
    // The last chunk's P V.
    {
      const uint32_t v_addr = kv_base + st * 2 * TILE128 + TILE128;
      mbar_wait(v_full + st, (it / FWD_STAGES) & 1);
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < FWD_CHUNK / 16; ++k) {
        wgmma_rs_n64<1>(o, pa[k], desc_sw128(v_addr + k * 16 * ROW_BYTES), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
      mbar_arrive(empty + st);
      ++it;
    }
    mbar_arrive(q_empty + qs);

    // out = Out(o / l) on the rows below S.
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      const int q = qt * FWD_ROWS + cw * 64 + row + 8 * r;
      if (q >= S) continue;
      typename Out::T* dst =
          out + (static_cast<size_t>(b) * S + q) * ld + h * HD;
#pragma unroll
      for (int j8 = 0; j8 < 8; ++j8) {
        Out::store(dst + 8 * j8 + 2 * quad, o[4 * j8 + 2 * r] / l[r],
                   o[4 * j8 + 2 * r + 1] / l[r], out_a);
      }
    }
  }
}

// Launch the forward over (B, S, H, 64) q/k/v on `stream` into out (B, S,
// H, 64) of the policy's type; `out_scale` a device pointer to the f32
// scale of a SCALED policy. Returns the first failing call's error.
template <class Tag, class Out = AttnOutBf16>
inline cudaError_t launch_flash_forward(const void* q, const void* k,
                                        const void* v, void* out, int batch,
                                        int seq, int heads,
                                        cudaStream_t stream,
                                        const float* out_scale = nullptr) {
  if (batch < 1 || seq < 1 || heads < 1 || (Out::SCALED && !out_scale)) {
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
    err = cudaFuncSetAttribute(flash_attention_kernel_wgmma<Tag, Out>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               FWD_SMEM);
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  const long tiles =
      static_cast<long>((seq + FWD_ROWS - 1) / FWD_ROWS) * heads * batch;
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);
  flash_attention_kernel_wgmma<Tag, Out>
      <<<grid, FWD_THREADS, FWD_SMEM, stream>>>(
          maps[0], maps[1], maps[2], static_cast<typename Out::T*>(out),
          out_scale, seq, heads, batch,
          LOG2E / sqrtf(static_cast<float>(HD)));
  return cudaGetLastError();
}

}  // namespace

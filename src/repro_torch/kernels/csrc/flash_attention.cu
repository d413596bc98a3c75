// Flash attention for Hopper (sm_90a), with a plain C interface for ctypes.
//
// Replaces the Pallas kernel of src/repro/kernels/flash_attention.py
// (flash_attention / _flash_kernel, grid (B*H, S/q_block)): online-softmax
// attention over q (B, H, S, Dh) and k, v (B, Hkv, T, Dh) with Hkv | H (q head
// h reads kv head h / (H / Hkv); Hkv = H is the reference's head-repeated
// input), f32 m/l/acc, p rounded to V's type before the PV product, l clamped
// at 1e-20, and a top-left causal mask qpos >= kpos (so S != T works).  Unlike
// the Pallas kernel, S and T need not be multiples of a tile: the ragged edge
// is masked here (rows past S are not written, keys past T score -inf).
//
// Bound on an H100 SXM: at the serving path's prefill (B=4, H=32, S=T=2048,
// Dh=128, causal) the two products are 137 GFLOP against 268 MB of q/k/v/o,
// so the tensor cores bound it (0.14 ms at 989 TFLOP/s bf16), not device
// memory (0.08 ms at 3.35 TB/s).
//
// bf16 design (after FlashAttention-3's forward pass):
//   * one CTA per (b*h, 128-row q tile), three warpgroups: two consumers of
//     64 q rows each and a producer whose first thread issues every load;
//     setmaxnreg moves registers from the producer to the consumers;
//   * TMA brings the Q tile once and K and V tiles of BN keys into a ring of
//     three stages (two at Dh > 192) behind mbarriers (K and V on separate
//     barriers, so QK^T starts before V lands); 3-D tensor maps over
//     (b*h, S|T, Dh) zero-fill past S, T and Dh, so no load reads another
//     head's rows, and Dh is padded up to a multiple of 64 in shared memory
//     only;
//   * S = Q K^T is wgmma m64nBNk16 with both operands in shared memory
//     (K-major, 128-byte swizzle); the online softmax runs on the
//     accumulator registers (quad shuffles for the row max and sum, exp2 on
//     scores pre-scaled by log2(e)); P, rounded to bf16, is the A operand of
//     P V straight from registers, and V is the B operand in its natural
//     (keys x Dh) layout through the descriptor's transpose bit, one
//     m64n64k16 per 64 head columns;
//   * within a warpgroup the products of one tile overlap the softmax of
//     the next: S of tile j+1 is issued, the accumulator rescaled while it
//     runs, then P V of tile j; the softmax of tile j+1 runs while P V is on
//     the tensor cores, and only then is P repacked; across the two
//     warpgroups, named barriers make them take turns to issue their
//     products (ping-pong), so one's softmax runs while the other's products
//     keep the tensor cores busy, instead of both exponentiating at once;
//   * causal CTAs stop at the diagonal tile; the grid walks the q tiles of
//     one head (longest first) before the next head, so the CTAs resident
//     at once share a few heads' K and V in L2 (all 16 q tiles and, with
//     GQA, the 8 q heads of a kv head), and the last CTAs are short ones.
//
// float32 inputs take the first version's design: 64-row q tiles, 32-row
// K/V tiles, everything in shared memory, FMA on the CUDA cores.
//
// Each entry point returns cudaGetLastError() after its launch (0 = ok), or
// hopper_host::kTensorMapError + a CUresult when a tensor map is refused.

#include <math_constants.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace hopper;

// Number of BK-key tiles that q rows [q0, q0 + bq) visit.
__device__ __forceinline__ int key_tiles(int q0, int bq, int S, int T, int causal, int bk) {
  const int q_end = min(q0 + bq, S);
  const int kv_end = causal ? min(T, q_end) : T;  // keys j <= i < q_end
  return (kv_end + bk - 1) / bk;
}

// ---------------------------------------------------------------------------
// bf16: TMA ring, wgmma, warp specialisation
// ---------------------------------------------------------------------------

constexpr int kBM = 128;        // q rows per CTA: two consumer warpgroups of 64
constexpr int kThreads = 384;   // warpgroups 0, 1 consume; warpgroup 2 produces

// Shared memory of one CTA: Q, then the K stages, the V stages and the
// barriers, each tile a DP / 64 row of (rows x 64) swizzled tiles.  Three
// stages in flight where they fit (227 KB), two at DP = 256.
template <int DP, int BN>
struct FlashTiles {
  static constexpr int kStages = DP == 256 ? 2 : 3;
  static constexpr int kChunks = DP / 64;       // 64-wide column tiles of the head
  static constexpr int kQBytes = kBM * DP * 2;
  static constexpr int kKVBytes = BN * DP * 2;  // one K (or V) stage
  static constexpr int kK = kQBytes;
  static constexpr int kV = kK + kStages * kKVBytes;
  static constexpr int kBar = kV + kStages * kKVBytes;
  static constexpr int kSmem = kBar + 8 * (1 + 3 * kStages) + 1024;  // + 1,024-byte alignment
};

// Named barriers 1 and 2 of 256 threads order the two consumer warpgroups'
// tensor-core work (0 is __syncthreads): a warpgroup syncs on its own before
// issuing its products and arrives on the other's after.
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// S = Q K^T of one key tile (64 x BN, this warpgroup's rows) into sc, both
// operands K-major in shared memory; committed as one group.
template <int DP, int BN>
__device__ __forceinline__ void issue_qk(float (&sc)[BN / 2], uint64_t q_desc, uint64_t k_desc) {
  fence_regs(sc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const uint32_t k_off = (kk % 4) * 32;  // k16 slice within a 64-wide tile
    wgmma_ss<BN, 0, 0>(sc, desc_advance(q_desc, (kk / 4) * kBM * 128 + k_off),
                       desc_advance(k_desc, (kk / 4) * BN * 128 + k_off), kk > 0);
  }
  wgmma_commit();
}

// acc += P V of one key tile: P from registers, V (BN keys x 64 head columns
// per tile) MN-major in shared memory; committed as one group.
template <int DP, int BN>
__device__ __forceinline__ void issue_pv(float (&acc)[DP / 64][32], uint32_t (&pf)[BN / 16][4],
                                         uint64_t v_desc) {
#pragma unroll
  for (int c = 0; c < DP / 64; ++c) fence_regs(acc[c]);
  wgmma_fence();
#pragma unroll
  for (int kc = 0; kc < BN / 16; ++kc)
#pragma unroll
    for (int c = 0; c < DP / 64; ++c)
      wgmma_rs_n64<1>(acc[c], pf[kc], desc_advance(v_desc, c * BN * 128 + kc * 2048), 1);
  wgmma_commit();
}

// After P V completes: its registers may be read and written again.
template <int DP, int BN>
__device__ __forceinline__ void pv_done(float (&acc)[DP / 64][32], uint32_t (&pf)[BN / 16][4]) {
#pragma unroll
  for (int c = 0; c < DP / 64; ++c) fence_regs(acc[c]);
#pragma unroll
  for (int kc = 0; kc < BN / 16; ++kc) fence_regs(pf[kc]);
}

// Online softmax of one key tile (keys k0 .. k0 + BN - 1) of raw scores sc:
// with kMasked, masks keys past T and, if causal, past each row (only the
// tiles that hold such keys take that code); updates the running max
// m (raw units) and sum l; leaves p = 2^(s * scale_log2 - m * scale_log2) =
// exp(scale (s - m)) in sc, in f32; and returns the factor alpha that takes
// the accumulator from the old max to the new.  Each row's scores are spread
// over the 4 threads of a quad, so row reductions shuffle across it.
template <int BN, bool kMasked>
__device__ __forceinline__ void softmax_tile(float (&sc)[BN / 2], float (&m_run)[2],
                                             float (&l_run)[2], float (&alpha)[2], int k0,
                                             int row0, int t4, int T, int causal,
                                             float scale_log2) {
  // Four partial maxima and sums per row keep the dependency chains short.
  float part[2][4];
#pragma unroll
  for (int r = 0; r < 2; ++r) part[r][0] = part[r][1] = part[r][2] = part[r][3] = -CUDART_INF_F;
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) {
    float x = sc[i];
    if constexpr (kMasked) {
      const int col = k0 + 8 * (i / 4) + 2 * t4 + (i & 1);
      const int row = row0 + 8 * ((i / 2) & 1);
      if (col >= T || (causal && col > row)) x = -CUDART_INF_F;
    }
    sc[i] = x;
    part[(i / 2) & 1][(i / 4) & 3] = fmaxf(part[(i / 2) & 1][(i / 4) & 3], x);
  }
  float m_cur[2], neg_m[2], rowsum[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    m_cur[r] = fmaxf(fmaxf(part[r][0], part[r][1]), fmaxf(part[r][2], part[r][3]));
    m_cur[r] = fmaxf(m_cur[r], __shfl_xor_sync(0xffffffffu, m_cur[r], 1));
    m_cur[r] = fmaxf(m_cur[r], __shfl_xor_sync(0xffffffffu, m_cur[r], 2));
    const float m_new = fmaxf(m_run[r], m_cur[r]);
    alpha[r] = m_run[r] == -CUDART_INF_F ? 0.f : ex2((m_run[r] - m_new) * scale_log2);
    neg_m[r] = m_new == -CUDART_INF_F ? 0.f : -m_new * scale_log2;
    m_run[r] = m_new;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) part[r][0] = part[r][1] = part[r][2] = part[r][3] = 0.f;
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) {
    const float p = ex2(fmaf(sc[i], scale_log2, neg_m[(i / 2) & 1]));  // masked: 2^-inf = 0
    sc[i] = p;
    part[(i / 2) & 1][(i / 4) & 3] += p;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    rowsum[r] = (part[r][0] + part[r][1]) + (part[r][2] + part[r][3]);
    rowsum[r] += __shfl_xor_sync(0xffffffffu, rowsum[r], 1);
    rowsum[r] += __shfl_xor_sync(0xffffffffu, rowsum[r], 2);
    l_run[r] = l_run[r] * alpha[r] + rowsum[r];
  }
}

template <int BN>
__device__ __forceinline__ void softmax_step(float (&sc)[BN / 2], float (&m_run)[2],
                                             float (&l_run)[2], float (&alpha)[2], int k0,
                                             bool masked, int row0, int t4, int T, int causal,
                                             float scale_log2) {
  if (masked)
    softmax_tile<BN, true>(sc, m_run, l_run, alpha, k0, row0, t4, T, causal, scale_log2);
  else
    softmax_tile<BN, false>(sc, m_run, l_run, alpha, k0, row0, t4, T, causal, scale_log2);
}

// The accumulator times alpha, by row (accumulator layout).
template <int DP>
__device__ __forceinline__ void rescale(float (&acc)[DP / 64][32], const float (&alpha)[2]) {
#pragma unroll
  for (int c = 0; c < DP / 64; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[c][i] *= alpha[(i / 2) & 1];
}

// p rounded to bf16 in pairs: accumulator registers 8j .. 8j+7 of the scores
// (keys 16j .. 16j+15) are the A operand of k-step j of P V.
template <int BN>
__device__ __forceinline__ void pack_p(const float (&sc)[BN / 2], uint32_t (&pf)[BN / 16][4]) {
#pragma unroll
  for (int i = 0; i < BN / 2; i += 2) pf[i / 8][(i / 2) % 4] = pack_bf16(sc[i], sc[i + 1]);
}

// blockIdx.x = q tile counted from the last, blockIdx.y = b*h.  DP is Dh
// rounded up to a multiple of 64; BN keys per tile.
template <int DP, int BN>
__global__ void __launch_bounds__(kThreads, 1)
flash_bf16_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv, bf16* __restrict__ o, int S, int T,
                  int dh, int group, int causal, float scale_log2) {
  using L = FlashTiles<DP, BN>;
  constexpr int kStages = L::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + kStages;
  uint64_t* kv_empty = v_full + kStages;

  const int bh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBM;
  const int n_tiles = key_tiles(q0, kBM, S, T, causal, BN);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&kv_empty[s], 8);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    // Producer warpgroup: its first thread issues every load.
    setmaxnreg_dec<40>();
    if (threadIdx.x == 256) {
      const int kvh = bh / group;
      mbar_arrive_expect_tx(q_full, L::kQBytes);
      for (int c = 0; c < L::kChunks; ++c)
        tma_load_3d(smem + c * kBM * 128, &tq, q_full, c * 64, q0, bh);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kStages;
        if (it >= kStages) mbar_wait(&kv_empty[s], ((it / kStages) - 1) & 1);
        unsigned char* ks = smem + L::kK + s * L::kKVBytes;
        unsigned char* vs = smem + L::kV + s * L::kKVBytes;
        mbar_arrive_expect_tx(&k_full[s], L::kKVBytes);
        for (int c = 0; c < L::kChunks; ++c)
          tma_load_3d(ks + c * BN * 128, &tk, &k_full[s], c * 64, it * BN, kvh);
        mbar_arrive_expect_tx(&v_full[s], L::kKVBytes);
        for (int c = 0; c < L::kChunks; ++c)
          tma_load_3d(vs + c * BN * 128, &tv, &v_full[s], c * 64, it * BN, kvh);
      }
    }
  } else {
    // Consumer warpgroup wg: q rows q0 + 64 wg .. + 63; this thread holds
    // rows row0 and row0 + 8 of its warp's 16 (accumulator layout).  The
    // softmax of key tile it runs while the tensor cores do P V of tile
    // it - 1 and the other warpgroup's products: the two warpgroups take
    // turns to issue (named barriers 1 + wg), warpgroup 0 first.
    setmaxnreg_inc<232>();
    const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int t4 = lane % 4;
    const int warp_row0 = q0 + wg * 64 + warp * 16;
    const int row0 = warp_row0 + lane / 4;
    const int my_turn = 1 + wg, other_turn = 2 - wg;
    // Operand descriptors: Q (this warpgroup's 64 rows) and K K-major, V MN-major.
    const uint64_t q_desc = sw128_desc(smem_addr(smem) + wg * 64 * 128, 16, 1024);
    const uint64_t k_desc = sw128_desc(smem_addr(smem + L::kK), 16, 1024);
    const uint64_t v_desc = sw128_desc(smem_addr(smem + L::kV), BN * 128, 1024);

    float acc[L::kChunks][32];
#pragma unroll
    for (int c = 0; c < L::kChunks; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;
    float sc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) sc[i] = 0.f;
    uint32_t pf[BN / 16][4];
    float m_run[2] = {-CUDART_INF_F, -CUDART_INF_F}, l_run[2] = {0.f, 0.f}, alpha[2];
    // Whether key tile it holds keys past T or, if causal, past this warp's first row.
    auto masked = [&](int it) {
      return (it + 1) * BN > T || (causal && (it + 1) * BN - 1 > warp_row0);
    };

    mbar_wait(q_full, 0);
    if (n_tiles > 0) {
      if (wg == 1) named_arrive(1);
      mbar_wait(&k_full[0], 0);
      named_sync(my_turn);
      issue_qk<DP, BN>(sc, q_desc, k_desc);
      named_arrive(other_turn);
      wgmma_wait<0>();
      fence_regs(sc);
      softmax_step<BN>(sc, m_run, l_run, alpha, 0, masked(0), row0, t4, T, causal, scale_log2);
      pack_p<BN>(sc, pf);
    }
    for (int it = 1; it < n_tiles; ++it) {
      const int s = it % kStages, sp = (it - 1) % kStages;
      mbar_wait(&k_full[s], (it / kStages) & 1);
      mbar_wait(&v_full[sp], ((it - 1) / kStages) & 1);
      named_sync(my_turn);
      issue_qk<DP, BN>(sc, q_desc, desc_advance(k_desc, s * L::kKVBytes));
      rescale<DP>(acc, alpha);  // to tile it - 1's max, while S is on the tensor cores
      issue_pv<DP, BN>(acc, pf, desc_advance(v_desc, sp * L::kKVBytes));
      named_arrive(other_turn);
      wgmma_wait<1>();  // S of tile it is in; P V of tile it - 1 may still run
      fence_regs(sc);
      softmax_step<BN>(sc, m_run, l_run, alpha, it * BN, masked(it), row0, t4, T, causal,
                       scale_log2);
      wgmma_wait<0>();
      pv_done<DP, BN>(acc, pf);
      __syncwarp();
      if (lane == 0) mbar_arrive(&kv_empty[sp]);  // tile it - 1's K and V are read
      pack_p<BN>(sc, pf);
    }
    if (n_tiles > 0) {
      const int sp = (n_tiles - 1) % kStages;
      mbar_wait(&v_full[sp], ((n_tiles - 1) / kStages) & 1);
      named_sync(my_turn);
      rescale<DP>(acc, alpha);
      issue_pv<DP, BN>(acc, pf, desc_advance(v_desc, sp * L::kKVBytes));
      if (wg == 0) named_arrive(other_turn);  // warpgroup 1 issues nothing more
      wgmma_wait<0>();
      pv_done<DP, BN>(acc, pf);
    }

    const float inv[2] = {1.f / fmaxf(l_run[0], 1e-20f), 1.f / fmaxf(l_run[1], 1e-20f)};
    bf16* ob = o + static_cast<long long>(bh) * S * dh;
#pragma unroll
    for (int c = 0; c < L::kChunks; ++c) {
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int col = c * 64 + 8 * (i / 4) + 2 * t4;
        const int row = row0 + 8 * ((i / 2) & 1);
        const float f = inv[(i / 2) & 1];
        if (col < dh && row < S)
          *reinterpret_cast<uint32_t*>(ob + static_cast<long long>(row) * dh + col) =
              pack_bf16(acc[c][i] * f, acc[c][i + 1] * f);
      }
    }
  }
}

template <int DP, int BN>
int launch_flash_bf16(const void* q, const void* k, const void* v, void* o, int bh, int bhkv,
                      int S, int T, int dh, int causal, float scale, cudaStream_t stream) {
  using L = FlashTiles<DP, BN>;
  static const int attr = hopper_host::allow_smem(flash_bf16_kernel<DP, BN>, L::kSmem);
  if (attr != 0) return attr;
  CUtensorMap tq, tk, tv;
  int err = hopper_host::make_map_3d(&tq, q, dh, S, bh, kBM);
  if (err == 0) err = hopper_host::make_map_3d(&tk, k, dh, T, bhkv, BN);
  if (err == 0) err = hopper_host::make_map_3d(&tv, v, dh, T, bhkv, BN);
  if (err != 0) return err;
  const dim3 grid((S + kBM - 1) / kBM, bh);
  flash_bf16_kernel<DP, BN><<<grid, kThreads, L::kSmem, stream>>>(
      tq, tk, tv, static_cast<bf16*>(o), S, T, dh, bh / bhkv, causal,
      scale * 1.4426950408889634f);  // log2(e): the kernel works in powers of 2
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// float32
// ---------------------------------------------------------------------------

// 64-row q tiles and 32-row K/V tiles, all in shared memory, FMA on the CUDA
// cores.  Scores and p live in Ss; the accumulator in Os.
constexpr int kBQ = 64;
constexpr int kBK32 = 32;
constexpr int kThreads32 = 128;

__global__ void __launch_bounds__(kThreads32)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int S, int T, int dh,
                 int group, int causal, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ldk = dh + 1;
  const int lds = kBK32 + 1;
  float* Qs = reinterpret_cast<float*>(smem_raw);  // [kBQ][dh]
  float* Ks = Qs + kBQ * dh;                        // [kBK32][ldk]
  float* Vs = Ks + kBK32 * ldk;                     // [kBK32][dh]
  float* Ss = Vs + kBK32 * dh;                      // [kBQ][lds]
  float* Os = Ss + kBQ * lds;                       // [kBQ][dh]
  float* m_run = Os + kBQ * dh;                     // [kBQ]
  float* l_run = m_run + kBQ;                       // [kBQ]
  float* alpha = l_run + kBQ;                       // [kBQ]

  const long long bh = blockIdx.y;
  const int q0 = blockIdx.x * kBQ;
  const float* qb = q + bh * S * dh;
  const float* kb = k + bh / group * T * dh;
  const float* vb = v + bh / group * T * dh;
  float* ob = o + bh * S * dh;

  for (int i = threadIdx.x; i < kBQ * dh; i += blockDim.x) {
    const int r = i / dh;
    Qs[i] = q0 + r < S ? qb[static_cast<long long>(q0) * dh + i] : 0.f;
    Os[i] = 0.f;
  }
  for (int r = threadIdx.x; r < kBQ; r += blockDim.x) {
    m_run[r] = -CUDART_INF_F;
    l_run[r] = 0.f;
  }

  const int n_tiles = key_tiles(q0, kBQ, S, T, causal, kBK32);
  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * kBK32;
    __syncthreads();
    for (int i = threadIdx.x; i < kBK32 * dh; i += blockDim.x) {
      const int r = i / dh, c = i % dh;
      const bool in = k0 + r < T;
      Ks[r * ldk + c] = in ? kb[static_cast<long long>(k0) * dh + i] : 0.f;
      Vs[i] = in ? vb[static_cast<long long>(k0) * dh + i] : 0.f;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < kBQ * kBK32; i += blockDim.x) {
      const int r = i / kBK32, j = i % kBK32;
      float acc = 0.f;
      for (int d = 0; d < dh; ++d) acc = fmaf(Qs[r * dh + d], Ks[j * ldk + d], acc);
      const int row = q0 + r, col = k0 + j;
      const bool ok = col < T && (!causal || row >= col);
      Ss[r * lds + j] = ok ? acc * scale : -CUDART_INF_F;
    }
    __syncthreads();
    for (int r = threadIdx.x; r < kBQ; r += blockDim.x) {
      float m_cur = -CUDART_INF_F;
      for (int j = 0; j < kBK32; ++j) m_cur = fmaxf(m_cur, Ss[r * lds + j]);
      const float m_new = fmaxf(m_run[r], m_cur);
      const float safe_m = m_new == -CUDART_INF_F ? 0.f : m_new;
      const float a = m_run[r] == -CUDART_INF_F ? 0.f : expf(m_run[r] - safe_m);
      float sum = 0.f;
      for (int j = 0; j < kBK32; ++j) {
        const float sv = Ss[r * lds + j];
        const float p = sv == -CUDART_INF_F ? 0.f : expf(sv - safe_m);
        Ss[r * lds + j] = p;
        sum += p;
      }
      l_run[r] = l_run[r] * a + sum;
      m_run[r] = m_new;
      alpha[r] = a;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < kBQ * dh; i += blockDim.x) {
      const int r = i / dh, c = i % dh;
      float pv = 0.f;
      for (int j = 0; j < kBK32; ++j) pv = fmaf(Ss[r * lds + j], Vs[j * dh + c], pv);
      Os[i] = Os[i] * alpha[r] + pv;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kBQ * dh; i += blockDim.x) {
    const int r = i / dh;
    if (q0 + r < S) ob[static_cast<long long>(q0) * dh + i] = Os[i] / fmaxf(l_run[r], 1e-20f);
  }
}

}  // namespace

extern "C" {

// q, o: (bh, S, dh); k, v: (bhkv, T, dh) with bhkv | bh, q row block i reading
// kv block i / (bh / bhkv); contiguous, 16-byte aligned; dh a multiple of 16
// and at most 256.
int flash_attention_bf16(const void* q, const void* k, const void* v, void* o, int bh,
                         int bhkv, int S, int T, int dh, int causal, float scale, void* stream) {
  if (bh <= 0 || S <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dh <= 64) return launch_flash_bf16<64, 128>(q, k, v, o, bh, bhkv, S, T, dh, causal, scale, s);
  if (dh <= 128)
    return launch_flash_bf16<128, 128>(q, k, v, o, bh, bhkv, S, T, dh, causal, scale, s);
  if (dh <= 192)
    return launch_flash_bf16<192, 64>(q, k, v, o, bh, bhkv, S, T, dh, causal, scale, s);
  return launch_flash_bf16<256, 64>(q, k, v, o, bh, bhkv, S, T, dh, causal, scale, s);
}

int flash_attention_f32(const void* q, const void* k, const void* v, void* o, int bh, int bhkv,
                        int S, int T, int dh, int causal, float scale, void* stream) {
  if (bh <= 0 || S <= 0) return 0;
  const size_t smem = sizeof(float) * (static_cast<size_t>(kBQ) * dh +
                                       static_cast<size_t>(kBK32) * (dh + 1) +
                                       static_cast<size_t>(kBK32) * dh +
                                       static_cast<size_t>(kBQ) * (kBK32 + 1) +
                                       static_cast<size_t>(kBQ) * dh + 3 * kBQ);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((S + kBQ - 1) / kBQ, bh);
  flash_f32_kernel<<<grid, kThreads32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), S, T, dh, bh / bhkv, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

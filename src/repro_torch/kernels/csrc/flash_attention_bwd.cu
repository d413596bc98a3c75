// Flash attention's backward pass for Hopper (sm_90a), with a plain C interface
// for ctypes.
//
// Replaces no Pallas kernel: the reference trains through its pure-JAX
// chunked_attention (src/repro/models/layers.py), whose gradients the port's
// training path took from autograd over float32 copies of q, k and v.  With
// the training forward of flash_attention.cu (which keeps each row's
// log-sum-exp), these kernels give the same gradients on the tensor cores:
//
//   P  = exp(S * scale - lse),  S = Q K^T        (float32, recomputed)
//   dV = bf16(P)^T dO
//   dP = dO V^T,  D = rowsum(dO o O)            (float32)
//   dS = scale * P o (dP - D)                   (float32)
//   dQ = dS K,  dK = dS^T Q
//
// q, k, v and dO are bf16 operands with float32 sums (a product of two bf16
// values is exact in float32); P is rounded to V's type before its product
// with dO, as the forward rounds it before P V; dS enters its two products as
// two bf16 halves, hi = bf16(dS) and lo = bf16(dS - hi), whose products are
// summed in float32, so it keeps ~16 of its 24 bits (no TF32, no single bf16
// rounding of a float32 operand).
//
// Bound on an H100 SXM: the tensor cores.  The arithmetic above needs seven
// products over the causal pairs against the forward's two (S, dP, dV, and
// dK and dQ each as two halves of dS): 2 pairs (5 Dh + 2 Dv) operations.  At
// the qwen3-moe training call (B 4, H 32 / 4 kv heads, S = T = 2,048, Dh 128)
// that is 0.48 TFLOP, 0.49 ms at 989 TFLOP/s, against 0.30 GB of q, k, v, o,
// dO and the gradients (0.09 ms at 3.35 TB/s).  This design computes S and
// dP a second time (once in each of its two kernels, to keep atomics out):
// 2 pairs (6 Dh + 3 Dv) operations run, 1.29x the bound's at Dh = Dv and
// 1.26x at Dh 192, Dv 128.
//
// Design (wgmma, TMA, one producer warp, two consumer warpgroups of 64 rows):
//   * dot_rows: D, one warp a row, summed in a fixed order;
//   * dkv: one CTA per (b * kv head, 128-key tile), longest first; K and V
//     stay in shared memory, Q and dO tiles of BQ rows stream through a ring,
//     looping over the group's q heads and, if causal, over the q tiles from
//     the diagonal on (tiles wholly above it are skipped).  S^T = K Q^T and
//     dP^T = V dO^T are wgmma with both operands in shared memory; P^T and
//     dS^T stay in the accumulator registers, which are the A operand of
//     dV += P^T dO and dK += dS^T Q (dO and Q read MN-major through the
//     descriptor's transpose bit).  Each q head of a kv head adds into the
//     same dK and dV registers, in order: GQA's sum happens in the CTA.
//     Each q tile's lse and D come with its stage, written by the producer
//     warp's lanes.  Where dK and dV would not fit the registers together
//     (Dh / 2 + Dv / 2 > 160 floats a thread) the kernel runs twice, once for
//     each;
//   * dq: one CTA per (b * h, 128-row q tile), longest first, as the forward:
//     Q and dO stay, K and V tiles stream, key tiles stop at the diagonal;
//     S = Q K^T and dP = dO V^T in shared memory, dS in registers is the A
//     operand of dQ += dS K (K read MN-major).
// No CTA adds into another's output and every sum runs in a fixed order, so
// two calls give the same bits.
//
// Each entry point returns cudaGetLastError() after its launches (0 = ok), or
// hopper_host::kTensorMapError + a CUresult when a tensor map is refused.

#include <math_constants.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace hopper;

constexpr int kBM = 128;       // rows a CTA owns: q rows (dq) or keys (dkv), two warpgroups of 64
constexpr int kThreads = 384;  // warpgroups 0, 1 consume; warp 8 of warpgroup 2 produces
constexpr float kLog2e = 1.4426950408889634f;

// Number of BK-key tiles that q rows [q0, q0 + bq) visit.
__device__ __forceinline__ int key_tiles(int q0, int bq, int S, int T, int causal, int bk) {
  const int q_end = min(q0 + bq, S);
  const int kv_end = causal ? min(T, q_end) : T;  // keys j <= i < q_end
  return (kv_end + bk - 1) / bk;
}

// acc (64 x N) = A B^T over KD columns, both operands K-major in shared
// memory: A this warpgroup's 64 rows of a tile of ROWS rows, B N rows;
// committed as one group.
template <int KD, int N, int ROWS>
__device__ __forceinline__ void issue_ss(float (&acc)[N / 2], uint64_t a_desc, uint64_t b_desc) {
  fence_regs(acc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < KD / 16; ++kk) {
    const uint32_t k_off = (kk % 4) * 32;  // k16 slice within a 64-wide tile
    wgmma_ss<N, 0, 0>(acc, desc_advance(a_desc, (kk / 4) * ROWS * 128 + k_off),
                      desc_advance(b_desc, (kk / 4) * N * 128 + k_off), kk > 0);
  }
  wgmma_commit();
}

template <int DW>
__device__ __forceinline__ void fence_acc(float (&acc)[DW / 64][32]) {
#pragma unroll
  for (int c = 0; c < DW / 64; ++c) fence_regs(acc[c]);
}

// acc (64 x DW, DW / 64 tiles of 64) += A B: A from registers (K = KN), B
// (KN rows x DW columns) MN-major in shared memory.  Issues only: the caller
// fences and commits.
template <int DW, int KN>
__device__ __forceinline__ void rs_products(float (&acc)[DW / 64][32],
                                            const uint32_t (&a)[KN / 16][4], uint64_t b_desc) {
#pragma unroll
  for (int kc = 0; kc < KN / 16; ++kc)
#pragma unroll
    for (int c = 0; c < DW / 64; ++c)
      wgmma_rs_n64<1>(acc[c], a[kc], desc_advance(b_desc, c * KN * 128 + kc * 2048), 1);
}

template <int N>
__device__ __forceinline__ void fence_frags(uint32_t (&f)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) fence_regs(f[i]);
}

// x in accumulator layout, rounded to bf16 in pairs: registers 8j .. 8j+7
// are the A operand of k-step j.
template <int N>
__device__ __forceinline__ void pack_a(const float (&x)[N / 2], uint32_t (&f)[N / 16][4]) {
#pragma unroll
  for (int i = 0; i < N / 2; i += 2) f[i / 8][(i / 2) % 4] = pack_bf16(x[i], x[i + 1]);
}

// x as hi = bf16(x) and lo = bf16(x - hi), each in A-operand pairs.
template <int N>
__device__ __forceinline__ void pack_split(const float (&x)[N / 2], uint32_t (&hi)[N / 16][4],
                                           uint32_t (&lo)[N / 16][4]) {
#pragma unroll
  for (int i = 0; i < N / 2; i += 2) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x[i], x[i + 1]);
    hi[i / 8][(i / 2) % 4] = *reinterpret_cast<const uint32_t*>(&h);
    lo[i / 8][(i / 2) % 4] =
        pack_bf16(x[i] - __low2float(h), x[i + 1] - __high2float(h));  // exact differences
  }
}

// A warpgroup's rows (DW / 64 tiles of 64 columns, accumulator layout),
// written as bf16 to out (n_rows x width, row-major) where in range.
template <int DW>
__device__ __forceinline__ void store_rows(const float (&acc)[DW / 64][32], bf16* out, int row0,
                                           int t4, int n_rows, int width) {
#pragma unroll
  for (int c = 0; c < DW / 64; ++c)
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int col = c * 64 + 8 * (i / 4) + 2 * t4;
      const int row = row0 + 8 * ((i / 2) & 1);
      if (col < width && row < n_rows)
        *reinterpret_cast<uint32_t*>(out + static_cast<long long>(row) * width + col) =
            pack_bf16(acc[c][i], acc[c][i + 1]);
    }
}

// ---------------------------------------------------------------------------
// D = rowsum(dO o O)
// ---------------------------------------------------------------------------

// One warp a row of width dv (even): each lane sums its column pairs in
// order, then a fixed butterfly.
__global__ void dot_rows_kernel(const bf16* __restrict__ o, const bf16* __restrict__ dout,
                                float* __restrict__ d, long long rows, int dv) {
  const long long row = static_cast<long long>(blockIdx.x) * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const __nv_bfloat162* a = reinterpret_cast<const __nv_bfloat162*>(o + row * dv);
  const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(dout + row * dv);
  float acc = 0.f;
  for (int c = lane; c < dv / 2; c += 32) {
    const float2 x = __bfloat1622float2(a[c]), y = __bfloat1622float2(b[c]);
    acc = fmaf(x.x, y.x, acc);
    acc = fmaf(x.y, y.y, acc);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) d[row] = acc;
}

// ---------------------------------------------------------------------------
// dK, dV
// ---------------------------------------------------------------------------

// Shared memory: K and V (kBM keys each), then the stages of Q (BQ rows) and
// dO, each stage's lse (in powers of 2) and D (BQ floats each), and the
// barriers.
template <int DP, int DVP, int BQ>
struct DkvTiles {
  static constexpr int kStages = 3;
  static constexpr int kKBytes = kBM * DP * 2;
  static constexpr int kVBytes = kBM * DVP * 2;
  static constexpr int kQBytes = BQ * DP * 2;
  static constexpr int kOBytes = BQ * DVP * 2;
  static constexpr int kV = kKBytes;
  static constexpr int kQ = kV + kVBytes;
  static constexpr int kO = kQ + kStages * kQBytes;
  static constexpr int kStat = kO + kStages * kOBytes;  // [stage][2][BQ] floats
  static constexpr int kBar = kStat + kStages * 2 * BQ * 4;
  static constexpr int kSmem = kBar + 8 * (1 + 3 * kStages) + 1024;
};

// dK and dV (kDK, kDV: which of them this launch computes) of kBM keys.
// blockIdx.x = b * kv head, blockIdx.y = key tile.
template <int DP, int DVP, int BQ, bool kDK, bool kDV>
__global__ void __launch_bounds__(kThreads, 1)
flash_dkv_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                 const float* __restrict__ lse, const float* __restrict__ dsum,
                 bf16* __restrict__ dk, bf16* __restrict__ dv_out, int S, int T, int dh, int dv,
                 int group, int causal, float scale, float scale_log2) {
  using L = DkvTiles<DP, DVP, BQ>;
  constexpr int kStages = L::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  float* stat = reinterpret_cast<float*>(smem + L::kStat);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* q_full = kv_full + 1;
  uint64_t* o_full = q_full + kStages;
  uint64_t* empty = o_full + kStages;

  const int bhkv = blockIdx.x;
  const int k0 = blockIdx.y * kBM;
  const int qt0 = causal ? k0 / BQ : 0;  // q tiles wholly above the diagonal are skipped
  const int n_qt = max(0, (S + BQ - 1) / BQ - qt0);
  const int n_it = group * n_qt;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&q_full[s], 1);
      mbar_init(&o_full[s], 1 + 32);  // the loads' arrival and one a producer lane
      mbar_init(&empty[s], 8);        // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    setmaxnreg_dec<40>();
    if (threadIdx.x < 288) {
      // Producer warp: lane 0 issues the loads; every lane writes its share of
      // the stage's lse and D, then arrives.
      const int lane = threadIdx.x - 256;
      if (lane == 0) {
        mbar_arrive_expect_tx(kv_full, L::kKBytes + L::kVBytes);
        for (int c = 0; c < DP / 64; ++c)
          tma_load_3d(smem + c * kBM * 128, &tk, kv_full, c * 64, k0, bhkv);
        for (int c = 0; c < DVP / 64; ++c)
          tma_load_3d(smem + L::kV + c * kBM * 128, &tv, kv_full, c * 64, k0, bhkv);
      }
      for (int it = 0; it < n_it; ++it) {
        const int s = it % kStages;
        const int bh = bhkv * group + it / n_qt;
        const int q0 = (qt0 + it % n_qt) * BQ;
        if (it >= kStages) mbar_wait(&empty[s], ((it / kStages) - 1) & 1);
        if (lane == 0) {
          unsigned char* qs = smem + L::kQ + s * L::kQBytes;
          unsigned char* os = smem + L::kO + s * L::kOBytes;
          mbar_arrive_expect_tx(&q_full[s], L::kQBytes);
          for (int c = 0; c < DP / 64; ++c)
            tma_load_3d(qs + c * BQ * 128, &tq, &q_full[s], c * 64, q0, bh);
          mbar_arrive_expect_tx(&o_full[s], L::kOBytes);
          for (int c = 0; c < DVP / 64; ++c)
            tma_load_3d(os + c * BQ * 128, &tdo, &o_full[s], c * 64, q0, bh);
        }
        float* st = stat + s * 2 * BQ;
        for (int j = lane; j < BQ; j += 32) {
          const long long r = static_cast<long long>(bh) * S + min(q0 + j, S - 1);
          st[j] = lse[r] * kLog2e;
          st[BQ + j] = dsum[r];
        }
        mbar_arrive(&o_full[s]);
      }
    }
  } else {
    setmaxnreg_inc<232>();
    const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int t4 = lane % 4;
    const int warp_key0 = k0 + wg * 64 + warp * 16;
    const int key0 = warp_key0 + lane / 4;  // this thread's keys: key0 and key0 + 8
    const uint64_t k_desc = sw128_desc(smem_addr(smem) + wg * 64 * 128, 16, 1024);
    const uint64_t v_desc = sw128_desc(smem_addr(smem + L::kV) + wg * 64 * 128, 16, 1024);
    const uint64_t q_desc = sw128_desc(smem_addr(smem + L::kQ), 16, 1024);
    const uint64_t qt_desc = sw128_desc(smem_addr(smem + L::kQ), BQ * 128, 1024);
    const uint64_t o_desc = sw128_desc(smem_addr(smem + L::kO), 16, 1024);
    const uint64_t ot_desc = sw128_desc(smem_addr(smem + L::kO), BQ * 128, 1024);

    float dk_acc[kDK ? DP / 64 : 1][32], dv_acc[kDV ? DVP / 64 : 1][32];
#pragma unroll
    for (int c = 0; c < (kDK ? DP / 64 : 1); ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) dk_acc[c][i] = 0.f;
#pragma unroll
    for (int c = 0; c < (kDV ? DVP / 64 : 1); ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) dv_acc[c][i] = 0.f;
    float sc[BQ / 2], dp[BQ / 2];
#pragma unroll
    for (int i = 0; i < BQ / 2; ++i) sc[i] = dp[i] = 0.f;
    uint32_t pf[BQ / 16][4], hi[BQ / 16][4], lo[BQ / 16][4];

    mbar_wait(kv_full, 0);
    for (int it = 0; it < n_it; ++it) {
      const int s = it % kStages;
      const uint32_t ph = (it / kStages) & 1;
      const int q0 = (qt0 + it % n_qt) * BQ;
      mbar_wait(&q_full[s], ph);
      issue_ss<DP, BQ, kBM>(sc, k_desc, desc_advance(q_desc, s * L::kQBytes));
      mbar_wait(&o_full[s], ph);
      if constexpr (kDK) issue_ss<DVP, BQ, kBM>(dp, v_desc, desc_advance(o_desc, s * L::kOBytes));
      const float* st = stat + s * 2 * BQ;
      // Whether the tile holds queries past S or, if causal, a key past a query.
      const bool masked = q0 + BQ > S || (causal && warp_key0 + 15 > q0);
      if constexpr (kDK) wgmma_wait<1>(); else wgmma_wait<0>();
      fence_regs(sc);
#pragma unroll
      for (int i = 0; i < BQ / 2; ++i) {
        const int j = 8 * (i / 4) + 2 * t4 + (i & 1);  // query q0 + j
        float p = ex2(fmaf(sc[i], scale_log2, -st[j]));
        if (masked) {
          const int key = key0 + 8 * ((i / 2) & 1);
          if (q0 + j >= S || (causal && key > q0 + j)) p = 0.f;
        }
        sc[i] = p;
      }
      if constexpr (kDV) {
        pack_a<BQ>(sc, pf);
        fence_acc<DVP>(dv_acc);
        wgmma_fence();
        rs_products<DVP, BQ>(dv_acc, pf, desc_advance(ot_desc, s * L::kOBytes));
        wgmma_commit();
      }
      if constexpr (kDK) {
        if constexpr (kDV) wgmma_wait<1>(); else wgmma_wait<0>();
        fence_regs(dp);
#pragma unroll
        for (int i = 0; i < BQ / 2; ++i) {
          const int j = 8 * (i / 4) + 2 * t4 + (i & 1);
          dp[i] = scale * (sc[i] * (dp[i] - st[BQ + j]));
        }
        pack_split<BQ>(dp, hi, lo);
        const uint64_t b = desc_advance(qt_desc, s * L::kQBytes);
        fence_acc<DP>(dk_acc);
        wgmma_fence();
        rs_products<DP, BQ>(dk_acc, hi, b);
        rs_products<DP, BQ>(dk_acc, lo, b);
        wgmma_commit();
      }
      wgmma_wait<0>();
      if constexpr (kDK) {
        fence_acc<DP>(dk_acc);
        fence_frags(hi);
        fence_frags(lo);
      }
      if constexpr (kDV) {
        fence_acc<DVP>(dv_acc);
        fence_frags(pf);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }

    const long long base = static_cast<long long>(bhkv) * T;
    if constexpr (kDK) store_rows<DP>(dk_acc, dk + base * dh, key0, t4, T, dh);
    if constexpr (kDV) store_rows<DVP>(dv_acc, dv_out + base * dv, key0, t4, T, dv);
  }
}

// ---------------------------------------------------------------------------
// dQ
// ---------------------------------------------------------------------------

// Shared memory: Q and dO (kBM rows each), the stages of K and V (BK keys),
// and the barriers.
template <int DP, int DVP, int BK>
struct DqTiles {
  static constexpr int kStages = 2;
  static constexpr int kQBytes = kBM * DP * 2;
  static constexpr int kOBytes = kBM * DVP * 2;
  static constexpr int kKBytes = BK * DP * 2;
  static constexpr int kVBytes = BK * DVP * 2;
  static constexpr int kO = kQBytes;
  static constexpr int kK = kO + kOBytes;
  static constexpr int kV = kK + kStages * kKBytes;
  static constexpr int kBar = kV + kStages * kVBytes;
  static constexpr int kSmem = kBar + 8 * (1 + 3 * kStages) + 1024;
};

// blockIdx.x = q tile counted from the last, blockIdx.y = b * h.
template <int DP, int DVP, int BK>
__global__ void __launch_bounds__(kThreads, 1)
flash_dq_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                const float* __restrict__ lse, const float* __restrict__ dsum,
                bf16* __restrict__ dq, int S, int T, int dh, int group, int causal, float scale,
                float scale_log2) {
  using L = DqTiles<DP, DVP, BK>;
  constexpr int kStages = L::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + kStages;
  uint64_t* kv_empty = v_full + kStages;

  const int bh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBM;
  const int n_tiles = key_tiles(q0, kBM, S, T, causal, BK);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&kv_empty[s], 8);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    setmaxnreg_dec<40>();
    if (threadIdx.x == 256) {
      const int kvh = bh / group;
      mbar_arrive_expect_tx(q_full, L::kQBytes + L::kOBytes);
      for (int c = 0; c < DP / 64; ++c)
        tma_load_3d(smem + c * kBM * 128, &tq, q_full, c * 64, q0, bh);
      for (int c = 0; c < DVP / 64; ++c)
        tma_load_3d(smem + L::kO + c * kBM * 128, &tdo, q_full, c * 64, q0, bh);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kStages;
        if (it >= kStages) mbar_wait(&kv_empty[s], ((it / kStages) - 1) & 1);
        unsigned char* ks = smem + L::kK + s * L::kKBytes;
        unsigned char* vs = smem + L::kV + s * L::kVBytes;
        mbar_arrive_expect_tx(&k_full[s], L::kKBytes);
        for (int c = 0; c < DP / 64; ++c)
          tma_load_3d(ks + c * BK * 128, &tk, &k_full[s], c * 64, it * BK, kvh);
        mbar_arrive_expect_tx(&v_full[s], L::kVBytes);
        for (int c = 0; c < DVP / 64; ++c)
          tma_load_3d(vs + c * BK * 128, &tv, &v_full[s], c * 64, it * BK, kvh);
      }
    }
  } else {
    setmaxnreg_inc<232>();
    const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int t4 = lane % 4;
    const int warp_row0 = q0 + wg * 64 + warp * 16;
    const int row0 = warp_row0 + lane / 4;  // this thread's rows: row0 and row0 + 8
    const uint64_t q_desc = sw128_desc(smem_addr(smem) + wg * 64 * 128, 16, 1024);
    const uint64_t o_desc = sw128_desc(smem_addr(smem + L::kO) + wg * 64 * 128, 16, 1024);
    const uint64_t k_desc = sw128_desc(smem_addr(smem + L::kK), 16, 1024);
    const uint64_t kt_desc = sw128_desc(smem_addr(smem + L::kK), BK * 128, 1024);
    const uint64_t v_desc = sw128_desc(smem_addr(smem + L::kV), 16, 1024);

    float lse2[2], dd[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {  // rows past S read row S - 1 and are never written
      const long long i = static_cast<long long>(bh) * S + min(row0 + 8 * r, S - 1);
      lse2[r] = lse[i] * kLog2e;
      dd[r] = dsum[i];
    }
    float acc[DP / 64][32];
#pragma unroll
    for (int c = 0; c < DP / 64; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;
    float sc[BK / 2], dp[BK / 2];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) sc[i] = dp[i] = 0.f;
    uint32_t hi[BK / 16][4], lo[BK / 16][4];

    mbar_wait(q_full, 0);
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % kStages;
      const uint32_t ph = (it / kStages) & 1;
      const int k0 = it * BK;
      mbar_wait(&k_full[s], ph);
      issue_ss<DP, BK, kBM>(sc, q_desc, desc_advance(k_desc, s * L::kKBytes));
      mbar_wait(&v_full[s], ph);
      issue_ss<DVP, BK, kBM>(dp, o_desc, desc_advance(v_desc, s * L::kVBytes));
      // Whether the tile holds keys past T or, if causal, past this warp's first row.
      const bool masked = k0 + BK > T || (causal && k0 + BK - 1 > warp_row0);
      wgmma_wait<1>();
      fence_regs(sc);
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const int r = (i / 2) & 1;
        float p = ex2(fmaf(sc[i], scale_log2, -lse2[r]));
        if (masked) {
          const int col = k0 + 8 * (i / 4) + 2 * t4 + (i & 1);
          if (col >= T || (causal && col > row0 + 8 * r)) p = 0.f;
        }
        sc[i] = p;
      }
      wgmma_wait<0>();
      fence_regs(dp);
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) dp[i] = scale * (sc[i] * (dp[i] - dd[(i / 2) & 1]));
      pack_split<BK>(dp, hi, lo);
      const uint64_t b = desc_advance(kt_desc, s * L::kKBytes);
      fence_acc<DP>(acc);
      wgmma_fence();
      rs_products<DP, BK>(acc, hi, b);
      rs_products<DP, BK>(acc, lo, b);
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc<DP>(acc);
      fence_frags(hi);
      fence_frags(lo);
      __syncwarp();
      if (lane == 0) mbar_arrive(&kv_empty[s]);
    }
    store_rows<DP>(acc, dq + static_cast<long long>(bh) * S * dh, row0, t4, S, dh);
  }
}

// ---------------------------------------------------------------------------
// Host
// ---------------------------------------------------------------------------

// q rows a dK/dV step: 64 where dK, dV, S^T, dP^T and the A operands fit the
// consumers' 232 registers, else 32.
template <int DP, int DVP>
constexpr int dkv_rows() {
  return DP + DVP <= 192 ? 64 : 32;
}

// Whether dK and dV take a launch each: their accumulators together would
// pass 160 floats a thread.
template <int DP, int DVP>
constexpr bool dkv_split() {
  return DP / 2 + DVP / 2 > 160;
}

// Keys a dQ step.
template <int DP>
constexpr int dq_keys() {
  return DP <= 192 ? 64 : 32;
}

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *dsum;
  void *dq, *dk, *dv;
  int bh, bhkv, S, T, dh, dv_w, causal;
  float scale;
  cudaStream_t stream;
};

template <int DP, int DVP, int BQ, bool kDK, bool kDV>
int launch_dkv(const Args& a) {
  using L = DkvTiles<DP, DVP, BQ>;
  auto kernel = flash_dkv_kernel<DP, DVP, BQ, kDK, kDV>;
  static const int attr = hopper_host::allow_smem(kernel, L::kSmem);
  if (attr != 0) return attr;
  CUtensorMap tq, tk, tv, tdo;
  int err = hopper_host::make_map_3d(&tq, a.q, a.dh, a.S, a.bh, BQ);
  if (err == 0) err = hopper_host::make_map_3d(&tk, a.k, a.dh, a.T, a.bhkv, kBM);
  if (err == 0) err = hopper_host::make_map_3d(&tv, a.v, a.dv_w, a.T, a.bhkv, kBM);
  if (err == 0) err = hopper_host::make_map_3d(&tdo, a.dout, a.dv_w, a.S, a.bh, BQ);
  if (err != 0) return err;
  const dim3 grid(a.bhkv, (a.T + kBM - 1) / kBM);
  kernel<<<grid, kThreads, L::kSmem, a.stream>>>(
      tq, tk, tv, tdo, a.lse, a.dsum, static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv),
      a.S, a.T, a.dh, a.dv_w, a.bh / a.bhkv, a.causal, a.scale, a.scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

template <int DP, int DVP>
int launch_dq(const Args& a) {
  constexpr int BK = dq_keys<DP>();
  using L = DqTiles<DP, DVP, BK>;
  auto kernel = flash_dq_kernel<DP, DVP, BK>;
  static const int attr = hopper_host::allow_smem(kernel, L::kSmem);
  if (attr != 0) return attr;
  CUtensorMap tq, tk, tv, tdo;
  int err = hopper_host::make_map_3d(&tq, a.q, a.dh, a.S, a.bh, kBM);
  if (err == 0) err = hopper_host::make_map_3d(&tk, a.k, a.dh, a.T, a.bhkv, BK);
  if (err == 0) err = hopper_host::make_map_3d(&tv, a.v, a.dv_w, a.T, a.bhkv, BK);
  if (err == 0) err = hopper_host::make_map_3d(&tdo, a.dout, a.dv_w, a.S, a.bh, kBM);
  if (err != 0) return err;
  const dim3 grid((a.S + kBM - 1) / kBM, a.bh);
  kernel<<<grid, kThreads, L::kSmem, a.stream>>>(
      tq, tk, tv, tdo, a.lse, a.dsum, static_cast<bf16*>(a.dq), a.S, a.T, a.dh,
      a.bh / a.bhkv, a.causal, a.scale, a.scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

template <int DP, int DVP>
int launch_backward(const Args& a) {
  constexpr int BQ = dkv_rows<DP, DVP>();
  int err;
  if constexpr (dkv_split<DP, DVP>()) {
    err = launch_dkv<DP, DVP, BQ, true, false>(a);
    if (err == 0) err = launch_dkv<DP, DVP, BQ, false, true>(a);
  } else {
    err = launch_dkv<DP, DVP, BQ, true, true>(a);
  }
  if (err == 0) err = launch_dq<DP, DVP>(a);
  return err;
}

template <int DP>
int backward_dv(const Args& a) {
  if (a.dv_w <= 64) return launch_backward<DP, 64>(a);
  if constexpr (DP >= 128)
    if (a.dv_w <= 128) return launch_backward<DP, 128>(a);
  if constexpr (DP >= 192)
    if (a.dv_w <= 192) return launch_backward<DP, 192>(a);
  if constexpr (DP == 256) return launch_backward<DP, 256>(a);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// The backward pass of flash_attention_train_bf16.  q, dq: (bh, S, dh); k, dk:
// (bhkv, T, dh); v, dv: (bhkv, T, dv_w); o, dout: (bh, S, dv_w); lse, dsum
// (scratch for D): (bh, S) float32; bhkv | bh; contiguous, 16-byte aligned;
// dh and dv_w <= dh multiples of 16 up to 256.  Launches dot_rows, then the
// dK/dV kernel (twice where dK and dV take a launch each), then the dQ kernel.
int flash_attention_backward_bf16(const void* q, const void* k, const void* v, const void* o,
                                  const void* lse, const void* dout, void* dsum, void* dq,
                                  void* dk, void* dv, int bh, int bhkv, int S, int T, int dh,
                                  int dv_w, int causal, float scale, void* stream) {
  if (bh <= 0 || S <= 0 || T <= 0) return 0;
  Args a{q, k, v, dout, static_cast<const float*>(lse), static_cast<const float*>(dsum),
         dq, dk, dv, bh, bhkv, S, T, dh, dv_w, causal, scale,
         static_cast<cudaStream_t>(stream)};
  const long long rows = static_cast<long long>(bh) * S;
  constexpr int kRowsPerBlock = 8;  // warps of 256 threads
  dot_rows_kernel<<<static_cast<unsigned>((rows + kRowsPerBlock - 1) / kRowsPerBlock),
                    32 * kRowsPerBlock, 0, a.stream>>>(
      static_cast<const bf16*>(o), static_cast<const bf16*>(dout), static_cast<float*>(dsum),
      rows, dv_w);
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  if (dh <= 64) return backward_dv<64>(a);
  if (dh <= 128) return backward_dv<128>(a);
  if (dh <= 192) return backward_dv<192>(a);
  return backward_dv<256>(a);
}

}  // extern "C"

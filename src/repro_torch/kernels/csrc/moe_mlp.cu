// Grouped expert SwiGLU for Hopper (sm_90a), with a plain C interface for ctypes.
//
// Replaces the Pallas kernel of src/repro/kernels/moe_mlp.py (moe_mlp /
// _moe_mlp_kernel, grid (expert, token tile)):
//   out[e] = (silu(x[e] Wg[e]) * (x[e] Wu[e])) Wd[e]
// over packed (E, C, D) capacity slabs, weights in (d_in, d_out) layout,
// f32 accumulation, output in the input type.  Two launches:
//   gate_up  h[e, c, f]   = silu(x Wg) * (x Wu), SwiGLU fused into the epilogue;
//   down     out[e, c, d] = h Wd.
// For bf16 inputs h is stored in bf16 (rounded once, as the serving path's
// moe_ffn rounds it before its down product); for float32 inputs h stays
// float32.  Unlike the Pallas kernel, the capacity need not be a multiple of
// the token tile: TMA zero-fills past it and the last tile's stores are masked.
//
// Bound on an H100 SXM: at the serving path's prefill (E=128, C=640, D=2048,
// F=768) the three products are 773 GFLOP, so the tensor cores bound it
// (0.78 ms at 989 TFLOP/s bf16); at decode (C=8) the weights are read and
// nothing else matters: 1.21 GB for all 128 experts (0.36 ms at 3.35 TB/s),
// about a quarter of that for the experts that hold a routed token.
//
// bf16 design.  Both launches are one kernel shape: a producer warp keeps a
// ring of K-stages in flight with TMA (3-D tensor maps over (E, rows, cols),
// 128-byte swizzle, behind mbarriers), and consumer warpgroups run wgmma
// with both operands in shared memory.  The weights are read in their
// (d_in, d_out) layout through the descriptor's transpose bit, so no load
// transposes anything.
//   * C > 64 (prefill): 128-row token tiles, two consumer warpgroups of 64
//     rows, four stages; A is the token tile (K-major), B four 64-column
//     weight panels side by side, read by one m64n256k16 per k16 step (the
//     descriptor's leading byte offset steps from panel to panel): 128
//     columns of Wg and the same 128 of Wu (gate/up: the SwiGLU epilogue
//     stays within the thread) or a 256-column tile of Wd (down).  The wide
//     tile reads each A tile once for 256 columns, which halves the
//     shared-memory and L2 traffic of 64-column pairs.
//   * C <= 64 (decode): the operands swap, h^T = Wg^T x^T and out^T = Wd^T
//     h^T.  A 64-column weight panel is the 64-row A operand (MN-major), the
//     C tokens are the N of m64nNBk16 (NB = C rounded up to 8, 16, 32 or 64),
//     so no row of the product is padding.  This path is bound by bytes:
//     several small CTAs per SM keep 4 stages each in flight.  It also skips
//     empty experts exactly: a CTA first reads its expert's C x K input rows;
//     if all are zero it writes +0 to its output tile and never fetches the
//     expert's weights.  The Pallas kernel's result for a zero row is +0
//     (silu(0) * 0 = 0, and 0 * W = 0 for finite W); this assumes finite
//     weights, as the model's are.  At prefill the test would have to read
//     a CTA's whole 512 KB x tile (128 rows of D = 2048) before its first
//     weight, on top of the pipeline's own reads of it, so the C > 64 path
//     computes every tile.
//
// float32 inputs take the first version's design: 64 x 64 output tiles,
// FMA on the CUDA cores.
//
// Each entry point returns cudaGetLastError() after its launches (0 = ok),
// or hopper_host::kTensorMapError + a CUresult when a tensor map is refused.

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace hopper;

__device__ __forceinline__ float silu(float x) { return x / (1.f + expf(-x)); }

constexpr int kBK = 64;           // contraction per stage: one 128-byte swizzled row
constexpr int kPanelBytes = kBK * 64 * 2;  // a 64-row x 64-column bf16 tile

// ---------------------------------------------------------------------------
// bf16, C > 64: 128-row token tiles
// ---------------------------------------------------------------------------

constexpr int kBM = 128;          // token rows per CTA: two consumer warpgroups of 64
constexpr int kThreads = 288;     // warpgroups 0, 1 consume; warp 8 produces
constexpr int kATileBytes = kBM * kBK * 2;

constexpr int kPanels = 4;        // 64-column weight panels per stage
constexpr int kStages = 4;
constexpr int kStageBytes = kATileBytes + kPanels * kPanelBytes;
constexpr int kSmem = kStages * kStageBytes + 16 * kStages + 1024;  // + barriers, alignment

// The output columns a CTA owns: 128 of h (gate/up), or 256 of out (down).
template <bool kSwiglu>
__host__ __device__ constexpr int tile_cols() {
  return kSwiglu ? 32 * kPanels : 64 * kPanels;
}

// c[e] (M x N) tile (m0 = 128 blockIdx.y, n0 = tile_cols blockIdx.x, e =
// blockIdx.z) of A[e] (M x K) times kPanels weight panels side by side: ta
// over A in boxes of 128 rows, tb0 / tb1 over Wg / Wu (gate/up: two panels of
// Wg, then the same columns of Wu) or both over Wd (down: four panels of Wd)
// in 64 x 64 boxes.  One m64n256k16 per k16 step reads the A tile once (the
// descriptor's leading byte offset steps from panel to panel): accumulator
// registers 32 p .. 32 p + 31 hold panel p.
template <bool kSwiglu>
__global__ void __launch_bounds__(kThreads, 1)
gemm_bf16_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb0,
                 const __grid_constant__ CUtensorMap tb1, bf16* __restrict__ c, int M, int K,
                 int N) {
  constexpr int P = kPanels;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * kStageBytes);
  uint64_t* empty = full + kStages;
  const int e = blockIdx.z, m0 = blockIdx.y * kBM, n0 = blockIdx.x * tile_cols<kSwiglu>();
  const int k_tiles = (K + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    if (threadIdx.x == 256) {  // producer
      for (int kt = 0; kt < k_tiles; ++kt) {
        const int s = kt % kStages;
        if (kt >= kStages) mbar_wait(&empty[s], ((kt / kStages) - 1) & 1);
        unsigned char* st = smem + s * kStageBytes;
        mbar_arrive_expect_tx(&full[s], kStageBytes);
        tma_load_3d(st, &ta, &full[s], kt * kBK, m0, e);
#pragma unroll
        for (int p = 0; p < P; ++p) {
          unsigned char* panel = st + kATileBytes + p * kPanelBytes;
          if (kSwiglu && p >= P / 2)
            tma_load_3d(panel, &tb1, &full[s], n0 + 64 * (p - P / 2), kt * kBK, e);
          else
            tma_load_3d(panel, &tb0, &full[s], n0 + 64 * p, kt * kBK, e);
        }
      }
    }
  } else {
    const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    float acc[32 * P];
#pragma unroll
    for (int i = 0; i < 32 * P; ++i) acc[i] = 0.f;
    // Stage 0's descriptors: this warpgroup's 64 rows of A, the panels of B.
    const uint64_t a_desc = sw128_desc(smem_addr(smem) + wg * 64 * 128, 16, 1024);
    const uint64_t b_desc = sw128_desc(smem_addr(smem) + kATileBytes, kPanelBytes, 1024);
    for (int kt = 0; kt < k_tiles; ++kt) {
      const int s = kt % kStages;
      mbar_wait(&full[s], (kt / kStages) & 1);
      const uint64_t a = desc_advance(a_desc, s * kStageBytes);
      const uint64_t b = desc_advance(b_desc, s * kStageBytes);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        wgmma_ss<64 * P, 0, 1>(acc, desc_advance(a, kk * 32), desc_advance(b, kk * 2048), 1);
      wgmma_commit();
      wgmma_wait<1>();  // the previous stage's products are done: release it
      if (kt > 0 && lane == 0) mbar_arrive(&empty[(kt - 1) % kStages]);
    }
    wgmma_wait<0>();
    fence_regs(acc);
    // Register i holds row row0 + 8 ((i / 2) % 2), column 8 (i / 4) + 2 t4 + i % 2
    // of the panels side by side; with kSwiglu, register i + 16 P is the up
    // product of gate register i.  Pairs of columns go out as one 32-bit store.
    const int t4 = lane % 4;
    const int row0 = m0 + wg * 64 + warp * 16 + lane / 4;
#pragma unroll
    for (int i = 0; i < (kSwiglu ? 16 : 32) * P; i += 2) {
      const int row = row0 + 8 * ((i / 2) & 1), col = n0 + 8 * (i / 4) + 2 * t4;
      if (row >= M || col >= N) continue;
      const uint32_t pair = kSwiglu ? pack_bf16(silu(acc[i]) * acc[i + 16 * P],
                                                silu(acc[i + 1]) * acc[i + 1 + 16 * P])
                                    : pack_bf16(acc[i], acc[i + 1]);
      *reinterpret_cast<uint32_t*>(c + (static_cast<long long>(e) * M + row) * N + col) = pair;
    }
  }
}

// ---------------------------------------------------------------------------
// bf16, C <= 64: operands swapped, empty experts skipped
// ---------------------------------------------------------------------------

constexpr int kSwapThreads = 160;  // warpgroup 0 consumes; warp 4 produces
constexpr int kSwapStages = 4;

// The output columns a CTA owns: 64 of h (gate/up), or 128 of out (down).
template <bool kSwiglu>
__host__ __device__ constexpr int swap_cols() {
  return kSwiglu ? 64 : 128;
}

template <int NB>
struct SwapTiles {
  static constexpr int kBBytes = NB * kBK * 2;  // NB token rows x 64
  static constexpr int kStageBytes = 2 * kPanelBytes + kBBytes;
  static constexpr int kSmem = kSwapStages * kStageBytes + 16 * kSwapStages + 1024;
};

// c[e]^T tile: rows n0 .. n0 + swap_cols - 1 of W0[e]^T (x) B[e]^T, i.e.
// c[e][t][n0 + j] for tokens t < M, from A panels ta0 / ta1 (64 k-rows x 64
// columns of the (K, N) weights; for down both are Wd's map, the second at
// column n0 + 64) and tb over B[e] (M x K) in boxes of NB rows; `b` is B's
// memory, read once for the empty-expert test.
template <int NB, bool kSwiglu>
__global__ void __launch_bounds__(kSwapThreads)
gemm_swap_bf16_kernel(const __grid_constant__ CUtensorMap ta0,
                      const __grid_constant__ CUtensorMap ta1,
                      const __grid_constant__ CUtensorMap tb, const bf16* __restrict__ b,
                      bf16* __restrict__ c, int M, int K, int N) {
  using L = SwapTiles<NB>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kSwapStages * L::kStageBytes);
  uint64_t* empty = full + kSwapStages;
  const int e = blockIdx.y, n0 = blockIdx.x * swap_cols<kSwiglu>();
  const int k_tiles = (K + kBK - 1) / kBK;
  c += static_cast<long long>(e) * M * N;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kSwapStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  // The expert's input rows, 16 bytes a load (K is a multiple of 8), 16
  // loads a thread in flight at once; a zero of either sign counts as zero.
  const uint4* rows = reinterpret_cast<const uint4*>(b + static_cast<long long>(e) * M * K);
  const int n_vec = M * K / 8;
  uint32_t bits = 0;
  for (int i0 = 0; i0 < n_vec; i0 += 16 * kSwapThreads) {
    uint4 v[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int i = i0 + j * kSwapThreads + threadIdx.x;
      v[j] = i < n_vec ? rows[i] : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int j = 0; j < 16; ++j) bits |= (v[j].x | v[j].y | v[j].z | v[j].w) & 0x7fff7fffu;
  }
  if (!__syncthreads_or(bits != 0)) {
    const bf16 zero = __float2bfloat16(0.f);
    for (int i = threadIdx.x; i < M * swap_cols<kSwiglu>(); i += blockDim.x) {
      const int col = n0 + i % swap_cols<kSwiglu>();
      if (col < N) c[static_cast<long long>(i / swap_cols<kSwiglu>()) * N + col] = zero;
    }
    return;
  }

  if (threadIdx.x >= 128) {
    if (threadIdx.x == 128) {  // producer
      for (int kt = 0; kt < k_tiles; ++kt) {
        const int s = kt % kSwapStages;
        if (kt >= kSwapStages) mbar_wait(&empty[s], ((kt / kSwapStages) - 1) & 1);
        unsigned char* st = smem + s * L::kStageBytes;
        mbar_arrive_expect_tx(&full[s], L::kStageBytes);
        tma_load_3d(st, &ta0, &full[s], n0, kt * kBK, e);
        tma_load_3d(st + kPanelBytes, &ta1, &full[s], kSwiglu ? n0 : n0 + 64, kt * kBK, e);
        tma_load_3d(st + 2 * kPanelBytes, &tb, &full[s], kt * kBK, 0, e);
      }
    }
  } else {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    float acc0[NB / 2], acc1[NB / 2];
#pragma unroll
    for (int i = 0; i < NB / 2; ++i) acc0[i] = acc1[i] = 0.f;
    // Stage 0's descriptors: the two weight panels (MN-major), the tokens.
    const uint64_t a_desc = sw128_desc(smem_addr(smem), kPanelBytes, 1024);
    const uint64_t b_desc = sw128_desc(smem_addr(smem) + 2 * kPanelBytes, 16, 1024);
    for (int kt = 0; kt < k_tiles; ++kt) {
      const int s = kt % kSwapStages;
      mbar_wait(&full[s], (kt / kSwapStages) & 1);
      const uint64_t a0 = desc_advance(a_desc, s * L::kStageBytes);
      const uint64_t a1 = desc_advance(a0, kPanelBytes);
      const uint64_t bb = desc_advance(b_desc, s * L::kStageBytes);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        const uint64_t db = desc_advance(bb, kk * 32);
        wgmma_ss<NB, 1, 0>(acc0, desc_advance(a0, kk * 2048), db, 1);
        wgmma_ss<NB, 1, 0>(acc1, desc_advance(a1, kk * 2048), db, 1);
      }
      wgmma_commit();
      wgmma_wait<1>();
      if (kt > 0 && lane == 0) mbar_arrive(&empty[(kt - 1) % kSwapStages]);
    }
    wgmma_wait<0>();
    fence_regs(acc0);
    fence_regs(acc1);
    // The product's row is output column n0 + j, its column the token t.
    const int t4 = lane % 4;
    const int j0 = warp * 16 + lane / 4;
#pragma unroll
    for (int i = 0; i < NB / 2; ++i) {
      const int t = 8 * (i / 4) + 2 * t4 + (i & 1), col = n0 + j0 + 8 * ((i / 2) & 1);
      if (t >= M) continue;
      bf16* cr = c + static_cast<long long>(t) * N;
      if constexpr (kSwiglu) {
        if (col < N) cr[col] = __float2bfloat16(silu(acc0[i]) * acc1[i]);
      } else {
        if (col < N) cr[col] = __float2bfloat16(acc0[i]);
        if (col + 64 < N) cr[col + 64] = __float2bfloat16(acc1[i]);
      }
    }
  }
}

// Tensor maps of the three weights, 64 x 64 boxes.
struct WeightMaps {
  CUtensorMap wg, wu, wd;
};

int weight_maps(WeightMaps* m, const void* wg, const void* wu, const void* wd, int E, int D,
                int F) {
  int err = hopper_host::make_map_3d(&m->wg, wg, F, D, E, kBK);
  if (err == 0) err = hopper_host::make_map_3d(&m->wu, wu, F, D, E, kBK);
  if (err == 0) err = hopper_host::make_map_3d(&m->wd, wd, D, F, E, kBK);
  return err;
}

int launch_tiles_bf16(const WeightMaps& w, const void* x, void* h, void* out, int E, int C,
                      int D, int F, cudaStream_t s) {
  static const int attr = hopper_host::allow_smem(gemm_bf16_kernel<true>, kSmem) |
                          hopper_host::allow_smem(gemm_bf16_kernel<false>, kSmem);
  if (attr != 0) return attr;
  CUtensorMap tx, th;
  int err = hopper_host::make_map_3d(&tx, x, D, C, E, kBM);
  if (err == 0) err = hopper_host::make_map_3d(&th, h, F, C, E, kBM);
  if (err != 0) return err;
  const int m_tiles = (C + kBM - 1) / kBM;
  const int n1 = tile_cols<true>(), n2 = tile_cols<false>();
  gemm_bf16_kernel<true><<<dim3((F + n1 - 1) / n1, m_tiles, E), kThreads, kSmem, s>>>(
      tx, w.wg, w.wu, static_cast<bf16*>(h), C, D, F);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  gemm_bf16_kernel<false><<<dim3((D + n2 - 1) / n2, m_tiles, E), kThreads, kSmem, s>>>(
      th, w.wd, w.wd, static_cast<bf16*>(out), C, F, D);
  return static_cast<int>(cudaGetLastError());
}

template <int NB>
int launch_swap_bf16(const WeightMaps& w, const void* x, void* h, void* out, int E, int C,
                     int D, int F, cudaStream_t s) {
  using L = SwapTiles<NB>;
  static const int attr = hopper_host::allow_smem(gemm_swap_bf16_kernel<NB, true>, L::kSmem) |
                          hopper_host::allow_smem(gemm_swap_bf16_kernel<NB, false>, L::kSmem);
  if (attr != 0) return attr;
  CUtensorMap tx, th;
  int err = hopper_host::make_map_3d(&tx, x, D, C, E, NB);
  if (err == 0) err = hopper_host::make_map_3d(&th, h, F, C, E, NB);
  if (err != 0) return err;
  const int n1 = swap_cols<true>(), n2 = swap_cols<false>();
  gemm_swap_bf16_kernel<NB, true><<<dim3((F + n1 - 1) / n1, E), kSwapThreads, L::kSmem, s>>>(
      w.wg, w.wu, tx, static_cast<const bf16*>(x), static_cast<bf16*>(h), C, D, F);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  gemm_swap_bf16_kernel<NB, false><<<dim3((D + n2 - 1) / n2, E), kSwapThreads, L::kSmem, s>>>(
      w.wd, w.wd, th, static_cast<const bf16*>(h), static_cast<bf16*>(out), C, F, D);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// float32
// ---------------------------------------------------------------------------

// 64 x 64 output tiles, 16-wide contraction chunks; thread (ty, tx) owns
// rows ty*8 .. ty*8+7 and columns tx*4 .. tx*4+3.
constexpr int kBM32 = 64;
constexpr int kBN32 = 64;
constexpr int kBK32 = 16;
constexpr int kThreads32 = 128;

template <bool kSwiglu>
__global__ void __launch_bounds__(kThreads32)
gemm_f32_kernel(const float* __restrict__ A, const float* __restrict__ B0,
                const float* __restrict__ B1, float* __restrict__ C, int M, int K, int N) {
  __shared__ float As[kBM32][kBK32 + 1];
  __shared__ float Bs0[kBK32][kBN32];
  __shared__ float Bs1[kSwiglu ? kBK32 : 1][kBN32];

  const long long e = blockIdx.z;
  const int n0 = blockIdx.x * kBN32, m0 = blockIdx.y * kBM32;
  const float* a = A + e * M * K;
  const float* b0 = B0 + e * K * N;
  const float* b1 = kSwiglu ? B1 + e * K * N : nullptr;
  float* c = C + e * M * N;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;

  float acc0[8][4] = {}, acc1[kSwiglu ? 8 : 1][4] = {};
  for (int k0 = 0; k0 < K; k0 += kBK32) {
    __syncthreads();
    for (int i = threadIdx.x; i < kBM32 * kBK32; i += blockDim.x) {
      const int r = i / kBK32, col = i % kBK32;
      As[r][col] = m0 + r < M && k0 + col < K ? a[static_cast<long long>(m0 + r) * K + k0 + col]
                                              : 0.f;
    }
    for (int i = threadIdx.x; i < kBK32 * kBN32; i += blockDim.x) {
      const int r = i / kBN32, col = i % kBN32;
      const bool in = k0 + r < K && n0 + col < N;
      const long long off = static_cast<long long>(k0 + r) * N + n0 + col;
      Bs0[r][col] = in ? b0[off] : 0.f;
      if constexpr (kSwiglu) Bs1[r][col] = in ? b1[off] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK32; ++kk) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float av = As[ty * 8 + i][kk];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc0[i][j] = fmaf(av, Bs0[kk][tx * 4 + j], acc0[i][j]);
          if constexpr (kSwiglu) acc1[i][j] = fmaf(av, Bs1[kk][tx * 4 + j], acc1[i][j]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + ty * 8 + i;
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx * 4 + j;
      if (col >= N) continue;
      float val = acc0[i][j];
      if constexpr (kSwiglu) val = silu(val) * acc1[i][j];
      c[static_cast<long long>(row) * N + col] = val;
    }
  }
}

template <typename GateUp, typename Down>
int launch_f32(GateUp gate_up, Down down, const void* x, const void* wg, const void* wu,
               const void* wd, void* h, void* out, int E, int C, int D, int F, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int m_tiles = (C + kBM32 - 1) / kBM32;
  const dim3 grid1((F + kBN32 - 1) / kBN32, m_tiles, E);
  gate_up<<<grid1, kThreads32, 0, s>>>(static_cast<const float*>(x), static_cast<const float*>(wg),
                                       static_cast<const float*>(wu), static_cast<float*>(h), C, D,
                                       F);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid2((D + kBN32 - 1) / kBN32, m_tiles, E);
  down<<<grid2, kThreads32, 0, s>>>(static_cast<const float*>(h), static_cast<const float*>(wd),
                                    nullptr, static_cast<float*>(out), C, F, D);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x, out: (E, C, D); wg, wu: (E, D, F); wd: (E, F, D); h: (E, C, F) scratch.
// All contiguous and 16-byte aligned; D and F multiples of 8.
int moe_mlp_bf16(const void* x, const void* wg, const void* wu, const void* wd, void* h,
                 void* out, int E, int C, int D, int F, void* stream) {
  if (E <= 0 || C <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  WeightMaps w;
  const int err = weight_maps(&w, wg, wu, wd, E, D, F);
  if (err != 0) return err;
  if (C <= 8) return launch_swap_bf16<8>(w, x, h, out, E, C, D, F, s);
  if (C <= 16) return launch_swap_bf16<16>(w, x, h, out, E, C, D, F, s);
  if (C <= 32) return launch_swap_bf16<32>(w, x, h, out, E, C, D, F, s);
  if (C <= 64) return launch_swap_bf16<64>(w, x, h, out, E, C, D, F, s);
  return launch_tiles_bf16(w, x, h, out, E, C, D, F, s);
}

int moe_mlp_f32(const void* x, const void* wg, const void* wu, const void* wd, void* h,
                void* out, int E, int C, int D, int F, void* stream) {
  if (E <= 0 || C <= 0) return 0;
  return launch_f32(gemm_f32_kernel<true>, gemm_f32_kernel<false>, x, wg, wu, wd, h, out, E, C,
                    D, F, stream);
}

}  // extern "C"

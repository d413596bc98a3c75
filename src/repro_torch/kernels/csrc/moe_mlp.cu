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
// the token tile: the last tile is masked.
//
// Bound on an H100 SXM: at the serving path's prefill (E=128, C=640, D=2048,
// F=768) the three products are 773 GFLOP, so the tensor cores bound it
// (0.78 ms at 989 TFLOP/s bf16); at decode (C=8) every expert's weights are
// still read, 1.21 GB, so device memory bounds it (0.36 ms at 3.35 TB/s).
// This first version: one CTA of 4 warps per (64-column output tile,
// 64-row token tile, expert); the contraction runs in 32-wide chunks staged
// in shared memory (D=2048 does not fit one block whole), the weight chunk
// transposed on the way in so each mma.sync m16n8k16 (bf16 in, f32
// accumulate) reads its B operand as 32-bit words; each warp owns 16 token
// rows by 64 columns.  Synchronous loads, no TMA, wgmma or pipelining yet,
// and empty experts are not skipped.
//
// float32 inputs take the same tiles with FMA on the CUDA cores.
//
// Each entry point returns cudaGetLastError() after its launches (0 = ok).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;
constexpr int kBM = 64;   // token rows per CTA
constexpr int kBN = 64;   // output columns per CTA
constexpr int kBK = 32;   // contraction chunk (bf16)
constexpr int kLd = kBK + 8;  // padded shared-memory row, bf16 elements

__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ float silu(float x) { return x / (1.f + expf(-x)); }

// C[e] = A[e] B0[e] (M x K times K x N), or with kSwiglu
// C[e] = silu(A[e] B0[e]) * (A[e] B1[e]).  K and N are multiples of 8.
template <bool kSwiglu>
__global__ void __launch_bounds__(kThreads)
gemm_bf16_kernel(const bf16* __restrict__ A, const bf16* __restrict__ B0,
                 const bf16* __restrict__ B1, bf16* __restrict__ C, int M, int K, int N) {
  __shared__ __align__(16) bf16 As[kBM * kLd];
  __shared__ __align__(16) bf16 Bs0[kBN * kLd];  // transposed: [n][k]
  __shared__ __align__(16) bf16 Bs1[kSwiglu ? kBN * kLd : 1];

  const long long e = blockIdx.z;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM;
  const bf16* a = A + e * M * K;
  const bf16* b0 = B0 + e * K * N;
  const bf16* b1 = kSwiglu ? B1 + e * K * N : nullptr;
  bf16* c = C + e * M * N;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;

  float acc0[kBN / 8][4], acc1[kSwiglu ? kBN / 8 : 1][4];
#pragma unroll
  for (int n = 0; n < kBN / 8; ++n) {
    acc0[n][0] = acc0[n][1] = acc0[n][2] = acc0[n][3] = 0.f;
    if constexpr (kSwiglu) acc1[n][0] = acc1[n][1] = acc1[n][2] = acc1[n][3] = 0.f;
  }

  for (int k0 = 0; k0 < K; k0 += kBK) {
    __syncthreads();
    // A chunk: kBM rows x kBK columns, 16-byte pieces (K % 8 == 0).
    for (int i = threadIdx.x; i < kBM * (kBK / 8); i += blockDim.x) {
      const int r = i / (kBK / 8), col = (i % (kBK / 8)) * 8;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (m0 + r < M && k0 + col < K)
        val = *reinterpret_cast<const uint4*>(a + static_cast<long long>(m0 + r) * K + k0 + col);
      *reinterpret_cast<uint4*>(As + r * kLd + col) = val;
    }
    // B chunk: kBK rows x kBN columns, stored transposed.
    for (int i = threadIdx.x; i < kBK * (kBN / 8); i += blockDim.x) {
      const int r = i % kBK, col = (i / kBK) * 8;
      const bool in = k0 + r < K && n0 + col < N;
      const long long off = static_cast<long long>(k0 + r) * N + n0 + col;
      uint4 v0 = make_uint4(0, 0, 0, 0), v1 = make_uint4(0, 0, 0, 0);
      if (in) v0 = *reinterpret_cast<const uint4*>(b0 + off);
      if constexpr (kSwiglu) {
        if (in) v1 = *reinterpret_cast<const uint4*>(b1 + off);
      }
      const bf16* p0 = reinterpret_cast<const bf16*>(&v0);
      const bf16* p1 = reinterpret_cast<const bf16*>(&v1);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        Bs0[(col + j) * kLd + r] = p0[j];
        if constexpr (kSwiglu) Bs1[(col + j) * kLd + r] = p1[j];
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      const bf16* ar = As + (warp * 16 + g) * kLd + kk + 2 * t;
      const uint32_t a0 = ld32(ar), a1 = ld32(ar + 8 * kLd);
      const uint32_t a2 = ld32(ar + 8), a3 = ld32(ar + 8 * kLd + 8);
#pragma unroll
      for (int n = 0; n < kBN / 8; ++n) {
        const int off = (n * 8 + g) * kLd + kk + 2 * t;
        mma_bf16(acc0[n], a0, a1, a2, a3, ld32(Bs0 + off), ld32(Bs0 + off + 8));
        if constexpr (kSwiglu)
          mma_bf16(acc1[n], a0, a1, a2, a3, ld32(Bs1 + off), ld32(Bs1 + off + 8));
      }
    }
  }

  // Accumulator element (n, e) is row warp*16 + g (+8 for e >= 2), column
  // n*8 + 2t (+1 for odd e); pairs of columns are stored as one 32-bit word.
#pragma unroll
  for (int n = 0; n < kBN / 8; ++n) {
    const int col = n0 + n * 8 + 2 * t;
    if (col >= N) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + warp * 16 + g + 8 * half;
      if (row >= M) continue;
      float v0 = acc0[n][2 * half], v1 = acc0[n][2 * half + 1];
      if constexpr (kSwiglu) {
        v0 = silu(v0) * acc1[n][2 * half];
        v1 = silu(v1) * acc1[n][2 * half + 1];
      }
      __nv_bfloat162 pair = __floats2bfloat162_rn(v0, v1);
      *reinterpret_cast<__nv_bfloat162*>(c + static_cast<long long>(row) * N + col) = pair;
    }
  }
}

// float32: the same (64 x 64) output tiles, 16-wide contraction chunks;
// thread (ty, tx) owns rows ty*8 .. ty*8+7 and columns tx*4 .. tx*4+3.
constexpr int kBK32 = 16;

template <bool kSwiglu>
__global__ void __launch_bounds__(kThreads)
gemm_f32_kernel(const float* __restrict__ A, const float* __restrict__ B0,
                const float* __restrict__ B1, float* __restrict__ C, int M, int K, int N) {
  __shared__ float As[kBM][kBK32 + 1];
  __shared__ float Bs0[kBK32][kBN];
  __shared__ float Bs1[kSwiglu ? kBK32 : 1][kBN];

  const long long e = blockIdx.z;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM;
  const float* a = A + e * M * K;
  const float* b0 = B0 + e * K * N;
  const float* b1 = kSwiglu ? B1 + e * K * N : nullptr;
  float* c = C + e * M * N;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;

  float acc0[8][4] = {}, acc1[kSwiglu ? 8 : 1][4] = {};
  for (int k0 = 0; k0 < K; k0 += kBK32) {
    __syncthreads();
    for (int i = threadIdx.x; i < kBM * kBK32; i += blockDim.x) {
      const int r = i / kBK32, col = i % kBK32;
      As[r][col] = m0 + r < M && k0 + col < K ? a[static_cast<long long>(m0 + r) * K + k0 + col]
                                              : 0.f;
    }
    for (int i = threadIdx.x; i < kBK32 * kBN; i += blockDim.x) {
      const int r = i / kBN, col = i % kBN;
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

template <typename T, typename GateUp, typename Down>
int launch_pair(GateUp gate_up, Down down, const void* x, const void* wg, const void* wu,
                const void* wd, void* h, void* out, int E, int C, int D, int F, void* stream) {
  if (E <= 0 || C <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int m_tiles = (C + kBM - 1) / kBM;
  const dim3 grid1((F + kBN - 1) / kBN, m_tiles, E);
  gate_up<<<grid1, kThreads, 0, s>>>(static_cast<const T*>(x), static_cast<const T*>(wg),
                                     static_cast<const T*>(wu), static_cast<T*>(h), C, D, F);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid2((D + kBN - 1) / kBN, m_tiles, E);
  down<<<grid2, kThreads, 0, s>>>(static_cast<const T*>(h), static_cast<const T*>(wd), nullptr,
                                  static_cast<T*>(out), C, F, D);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x, out: (E, C, D); wg, wu: (E, D, F); wd: (E, F, D); h: (E, C, F) scratch.
// All contiguous and 16-byte aligned; D and F multiples of 8.
int moe_mlp_bf16(const void* x, const void* wg, const void* wu, const void* wd, void* h,
                 void* out, int E, int C, int D, int F, void* stream) {
  return launch_pair<bf16>(gemm_bf16_kernel<true>, gemm_bf16_kernel<false>, x, wg, wu, wd, h,
                           out, E, C, D, F, stream);
}

int moe_mlp_f32(const void* x, const void* wg, const void* wu, const void* wd, void* h,
                void* out, int E, int C, int D, int F, void* stream) {
  return launch_pair<float>(gemm_f32_kernel<true>, gemm_f32_kernel<false>, x, wg, wu, wd, h,
                            out, E, C, D, F, stream);
}

}  // extern "C"

// Flash attention for Hopper (sm_90a), with a plain C interface for ctypes.
//
// Replaces the Pallas kernel of src/repro/kernels/flash_attention.py
// (flash_attention / _flash_kernel, grid (B*H, S/q_block)): online-softmax
// attention over (B, H, S|T, Dh) with K/V already head-repeated, f32 m/l/acc,
// p rounded to V's type before the PV product, l clamped at 1e-20, and a
// top-left causal mask qpos >= kpos (so S != T works).  Unlike the Pallas
// kernel, S and T need not be multiples of a tile: the ragged edge is masked
// here (rows past S are not written, keys past T score -inf).
//
// Bound on an H100 SXM: at the serving path's prefill (B=4, H=32,
// S=T=2048, Dh=128, causal) the two products are 137 GFLOP against 268 MB
// of q/k/v/o, so the tensor cores bound it (0.14 ms at 989 TFLOP/s bf16),
// not device memory (0.08 ms at 3.35 TB/s).  This first version keeps the
// design simple: one CTA of 4 warps per (b*h, 64-row q tile); the Q tile and
// one 64-row K tile and V tile (V transposed) sit in shared memory, loaded
// synchronously; QK^T and PV run on the tensor cores through mma.sync
// m16n8k16 (bf16 in, f32 accumulate), each warp owning 16 q rows, with the
// scores, the running max/sum and the output accumulator in registers (the
// m16n8k16 accumulator layout is the A-operand layout, so P feeds PV without
// a round trip through shared memory).  Causal CTAs stop at the diagonal
// tile.  No TMA, wgmma or pipelining yet.
//
// float32 inputs take the same tiling with FMA on the CUDA cores
// (64-row q tiles, 32-row K/V tiles, everything in shared memory).
//
// Each entry point returns cudaGetLastError() after its launch (0 = ok).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;  // 4 warps
constexpr int kBQ = 64;        // q rows per CTA (16 per warp)
constexpr int kBK = 64;        // keys per tile (bf16 path)
constexpr int kPad = 8;        // bf16 row padding in shared memory (16 bytes)

__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// rows x dh tile of a (rows_total, dh) matrix into shared memory with row
// stride ld, 16-byte chunks; rows at or past n_rows are zero.
__device__ __forceinline__ void load_rows(bf16* dst, int ld, const bf16* src, int row0,
                                          int n_rows, int rows, int dh) {
  const int chunks = dh / 8;
  for (int i = threadIdx.x; i < rows * chunks; i += blockDim.x) {
    const int r = i / chunks, c = (i % chunks) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row0 + r < n_rows)
      val = *reinterpret_cast<const uint4*>(src + static_cast<long long>(row0 + r) * dh + c);
    *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
  }
}

// The same, transposed: dst[c * ld + r] = src[row0 + r, c].
__device__ __forceinline__ void load_rows_t(bf16* dst, int ld, const bf16* src, int row0,
                                            int n_rows, int rows, int dh) {
  const int chunks = dh / 8;
  for (int i = threadIdx.x; i < rows * chunks; i += blockDim.x) {
    const int r = i % rows, c = (i / rows) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row0 + r < n_rows)
      val = *reinterpret_cast<const uint4*>(src + static_cast<long long>(row0 + r) * dh + c);
    const bf16* v = reinterpret_cast<const bf16*>(&val);
#pragma unroll
    for (int j = 0; j < 8; ++j) dst[(c + j) * ld + r] = v[j];
  }
}

// Number of key tiles a CTA with q rows [q0, q0 + kBQ) visits.
__device__ __forceinline__ int key_tiles(int q0, int S, int T, int causal, int bk) {
  const int q_end = min(q0 + kBQ, S);
  const int kv_end = causal ? min(T, q_end) : T;  // keys j <= i < q_end
  return (kv_end + bk - 1) / bk;
}

// One CTA per (q tile = blockIdx.x, b*h = blockIdx.y).  DMAX >= dh bounds the
// register accumulator; loops over head columns are unrolled to DMAX / 8 and
// guarded by dh, so the accumulator stays in registers.
template <int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, bf16* __restrict__ o, int S, int T, int dh,
                  int causal, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ld = dh + kPad;
  const int ldv = kBK + kPad;
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [kBQ][ld]
  bf16* Ks = Qs + kBQ * ld;                      // [kBK][ld]
  bf16* Vt = Ks + kBK * ld;                      // [dh][ldv], V transposed

  const long long bh = blockIdx.y;
  const int q0 = blockIdx.x * kBQ;
  const bf16* qb = q + bh * S * dh;
  const bf16* kb = k + bh * T * dh;
  const bf16* vb = v + bh * T * dh;
  bf16* ob = o + bh * S * dh;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = q0 + warp * 16 + g;  // this thread's rows: row0 and row0 + 8

  load_rows(Qs, ld, qb, q0, S, kBQ, dh);

  float acc[DMAX / 8][4];
#pragma unroll
  for (int j = 0; j < DMAX / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m_run[2] = {-CUDART_INF_F, -CUDART_INF_F};
  float l_run[2] = {0.f, 0.f};

  const int n_tiles = key_tiles(q0, S, T, causal, kBK);
  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * kBK;
    __syncthreads();  // the previous tile is no longer read
    load_rows(Ks, ld, kb, k0, T, kBK, dh);
    load_rows_t(Vt, ldv, vb, k0, T, kBK, dh);
    __syncthreads();

    // s = q k^T for this warp's 16 rows x 64 keys.
    float s[kBK / 8][4];
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    for (int kk = 0; kk < dh; kk += 16) {
      const bf16* qa = Qs + (warp * 16 + g) * ld + kk + 2 * t;
      const uint32_t a0 = ld32(qa), a1 = ld32(qa + 8 * ld);
      const uint32_t a2 = ld32(qa + 8), a3 = ld32(qa + 8 * ld + 8);
#pragma unroll
      for (int n = 0; n < kBK / 8; ++n) {
        const bf16* kr = Ks + (n * 8 + g) * ld + kk + 2 * t;
        mma_bf16(s[n], a0, a1, a2, a3, ld32(kr), ld32(kr + 8));
      }
    }

    // Scale, mask, and the online-softmax update of rows row0 (e < 2) and
    // row0 + 8 (e >= 2).  Each row's 64 scores are spread over the 4 threads
    // of a quad (t = 0..3), so row reductions shuffle across the quad.
    float m_cur[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row0 + (e >= 2 ? 8 : 0);
        const int col = k0 + n * 8 + 2 * t + (e & 1);
        const bool ok = col < T && (!causal || row >= col);
        s[n][e] = ok ? s[n][e] * scale : -CUDART_INF_F;
        m_cur[e >> 1] = fmaxf(m_cur[e >> 1], s[n][e]);
      }
    }
    float alpha[2], safe_m[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m_cur[r] = fmaxf(m_cur[r], __shfl_xor_sync(0xffffffffu, m_cur[r], 1));
      m_cur[r] = fmaxf(m_cur[r], __shfl_xor_sync(0xffffffffu, m_cur[r], 2));
      const float m_new = fmaxf(m_run[r], m_cur[r]);
      safe_m[r] = m_new == -CUDART_INF_F ? 0.f : m_new;
      alpha[r] = m_run[r] == -CUDART_INF_F ? 0.f : expf(m_run[r] - safe_m[r]);
      m_run[r] = m_new;
    }
    float rowsum[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = s[n][e] == -CUDART_INF_F ? 0.f : expf(s[n][e] - safe_m[e >> 1]);
        s[n][e] = p;
        rowsum[e >> 1] += p;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rowsum[r] += __shfl_xor_sync(0xffffffffu, rowsum[r], 1);
      rowsum[r] += __shfl_xor_sync(0xffffffffu, rowsum[r], 2);
      l_run[r] = l_run[r] * alpha[r] + rowsum[r];
    }
#pragma unroll
    for (int j = 0; j < DMAX / 8; ++j) {
      acc[j][0] *= alpha[0];
      acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1];
      acc[j][3] *= alpha[1];
    }

    // acc += p v: the accumulators of key columns 16c..16c+15 (n-tiles 2c,
    // 2c+1) are the A operand of k-step c, rounded to bf16.
#pragma unroll
    for (int c = 0; c < kBK / 16; ++c) {
      const uint32_t a0 = pack_bf16(s[2 * c][0], s[2 * c][1]);
      const uint32_t a1 = pack_bf16(s[2 * c][2], s[2 * c][3]);
      const uint32_t a2 = pack_bf16(s[2 * c + 1][0], s[2 * c + 1][1]);
      const uint32_t a3 = pack_bf16(s[2 * c + 1][2], s[2 * c + 1][3]);
#pragma unroll
      for (int j = 0; j < DMAX / 8; ++j) {
        if (j * 8 < dh) {
          const bf16* vr = Vt + (j * 8 + g) * ldv + c * 16 + 2 * t;
          mma_bf16(acc[j], a0, a1, a2, a3, ld32(vr), ld32(vr + 8));
        }
      }
    }
  }

  const float inv0 = 1.f / fmaxf(l_run[0], 1e-20f);
  const float inv1 = 1.f / fmaxf(l_run[1], 1e-20f);
#pragma unroll
  for (int j = 0; j < DMAX / 8; ++j) {
    if (j * 8 < dh) {
      const int col = j * 8 + 2 * t;
      if (row0 < S)
        *reinterpret_cast<uint32_t*>(ob + static_cast<long long>(row0) * dh + col) =
            pack_bf16(acc[j][0] * inv0, acc[j][1] * inv0);
      if (row0 + 8 < S)
        *reinterpret_cast<uint32_t*>(ob + static_cast<long long>(row0 + 8) * dh + col) =
            pack_bf16(acc[j][2] * inv1, acc[j][3] * inv1);
    }
  }
}

// float32: the same tiles with 32-row K/V tiles, all in shared memory, FMA
// on the CUDA cores.  Scores and p live in Ss; the accumulator in Os.
constexpr int kBK32 = 32;

__global__ void __launch_bounds__(kThreads)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int S, int T, int dh,
                 int causal, float scale) {
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
  const float* kb = k + bh * T * dh;
  const float* vb = v + bh * T * dh;
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

  const int n_tiles = key_tiles(q0, S, T, causal, kBK32);
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

// q, o: (BH, S, dh); k, v: (BH, T, dh), contiguous, 16-byte aligned; dh a
// multiple of 16 and at most 256.
int flash_attention_bf16(const void* q, const void* k, const void* v, void* o, int bh, int S,
                         int T, int dh, int causal, float scale, void* stream) {
  if (bh <= 0 || S <= 0) return 0;
  const size_t smem = sizeof(bf16) * (static_cast<size_t>(kBQ + kBK) * (dh + kPad) +
                                      static_cast<size_t>(dh) * (kBK + kPad));
  const dim3 grid((S + kBQ - 1) / kBQ, bh);
  auto run = [&](auto kernel) -> int {
    if (smem > 48 * 1024) {
      cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<bf16*>(o), S, T, dh, causal, scale);
    return static_cast<int>(cudaGetLastError());
  };
  if (dh <= 64) return run(flash_bf16_kernel<64>);
  if (dh <= 128) return run(flash_bf16_kernel<128>);
  return run(flash_bf16_kernel<256>);
}

int flash_attention_f32(const void* q, const void* k, const void* v, void* o, int bh, int S,
                        int T, int dh, int causal, float scale, void* stream) {
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
  flash_f32_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), S, T, dh, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

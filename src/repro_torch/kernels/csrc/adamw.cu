// AdamW's update and the gradients' global norm for Hopper (sm_90a), with a
// plain C interface for ctypes.
//
// Replaces no Pallas kernel: the reference's optimizer (src/repro/optim/
// adamw.py) is plain jnp, which XLA fuses; the port ran it as ~14 ATen
// elementwise passes over every float32 leaf (a gradient scale, two passes on
// m, three on v, five for the bias-corrected step, the decay, the learning
// rate and the subtraction), ~144 bytes a parameter.
//
// Bound on an H100 SXM: device memory.  The work needs one read of g for the
// global norm (4 B a float32 parameter), then one pass that reads p, g, m and
// v and writes p, m and v (28 B): 32 B a parameter, 29.75 ms at 3.35 TB/s for
// the 3,114,814,464 parameters of qwen3-moe's four-layer training stage.
//
// Design: each kernel reads and writes each tensor once, 16 bytes a load.
//   * adamw_norm_partial_kernel: one launch a leaf; a grid-stride loop squares
//     and sums g in float32 and each block writes one partial at the leaf's
//     offset of a float32 scratch buffer.
//   * adamw_norm_finish_kernel: one block sums every partial in a fixed index
//     order and writes the norm and the clip scale
//     min(clip / max(norm, 1e-9), 1) (1 without a clip).  No atomics: the
//     norm is the same bits from run to run.  On a mesh, adamw_norm_sum_kernel
//     first sums a rank's partials alone (the same fixed order), the ranks'
//     sums are added over the mesh, and the finish takes that total.
//   * adamw_update_kernel<P, G, M>: one launch a leaf, in place, 8 elements a
//     thread an iteration (two 16-byte loads of a float32 tensor, one of a
//     bf16 tensor); a scalar loop takes a ragged tail, or the whole leaf when
//     a base pointer is not 16-byte aligned.  The arithmetic is float32 in the
//     loop's order and with its roundings, IEEE division and square root:
//       gf = g scale;  m = b1 m + (1 - b1) gf;  v = b2 v + (1 - b2) gf^2
//       step = (m / bc1) / (sqrt(v / bc2) + eps) + wd p;  p -= lr step
//     where each ATen pass rounds once: a product, quotient or root alone,
//     and an add with alpha (a + alpha b) as one fma, as nvcc compiles ATen's
//     kernel; a bf16 tensor is widened on load and rounded to nearest even
//     on store.  scale, lr, bc1 and bc2 are read from 0-d device tensors, so the
//     host never waits for them.
//
// Each entry point returns cudaGetLastError() after its launch (0 = ok).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kFinishThreads = 1024;
constexpr int kVec = 8;  // elements a thread an iteration of the update

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void narrow(float* dst, float x) { *dst = x; }
__device__ __forceinline__ void narrow(bf16* dst, float x) { *dst = __float2bfloat16_rn(x); }

__device__ __forceinline__ void load8(const float* src, float (&x)[kVec]) {
  const float4 a = reinterpret_cast<const float4*>(src)[0];
  const float4 b = reinterpret_cast<const float4*>(src)[1];
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

__device__ __forceinline__ void load8(const bf16* src, float (&x)[kVec]) {
  const uint4 u = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < kVec / 2; ++k) {
    const float2 f = __bfloat1622float2(h[k]);
    x[2 * k] = f.x;
    x[2 * k + 1] = f.y;
  }
}

__device__ __forceinline__ void store8(float* dst, const float (&x)[kVec]) {
  reinterpret_cast<float4*>(dst)[0] = make_float4(x[0], x[1], x[2], x[3]);
  reinterpret_cast<float4*>(dst)[1] = make_float4(x[4], x[5], x[6], x[7]);
}

__device__ __forceinline__ void store8(bf16* dst, const float (&x)[kVec]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < kVec / 2; ++k) h[k] = __floats2bfloat162_rn(x[2 * k], x[2 * k + 1]);
  *reinterpret_cast<uint4*>(dst) = u;
}

// The sum of every thread's value in a fixed order (a tree over the warps'
// lanes, then over the warps); thread 0 gets the block's total.
template <int kBlock>
__device__ __forceinline__ float block_sum(float s) {
  __shared__ float warp_sums[kBlock / 32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  if (lane == 0) warp_sums[warp] = s;
  __syncthreads();
  if (warp == 0) {
    s = lane < kBlock / 32 ? warp_sums[lane] : 0.0f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
  }
  return s;
}

// One partial sum of squares a block over g[0, n).  16-byte loads: 4 float32
// or 8 bf16 values a thread a load, each lane of the vector summed apart.
template <typename G>
__global__ void __launch_bounds__(kThreads)
adamw_norm_partial_kernel(const G* __restrict__ g, long long n, float* __restrict__ partial) {
  constexpr int kLanes = 16 / sizeof(G);
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long first = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  float acc[kLanes];
#pragma unroll
  for (int j = 0; j < kLanes; ++j) acc[j] = 0.0f;
  const long long n_vec = reinterpret_cast<uintptr_t>(g) % 16 == 0 ? n / kLanes : 0;
  for (long long i = first; i < n_vec; i += stride) {
    const uint4 u = reinterpret_cast<const uint4*>(g)[i];
    const G* x = reinterpret_cast<const G*>(&u);
#pragma unroll
    for (int j = 0; j < kLanes; ++j) {
      const float f = widen(x[j]);
      acc[j] = __fadd_rn(acc[j], __fmul_rn(f, f));
    }
  }
  for (long long i = n_vec * kLanes + first; i < n; i += stride) {
    const float f = widen(g[i]);
    acc[0] = __fadd_rn(acc[0], __fmul_rn(f, f));
  }
  float s = 0.0f;
#pragma unroll
  for (int j = 0; j < kLanes; ++j) s += acc[j];
  s = block_sum<kThreads>(s);
  if (threadIdx.x == 0) partial[blockIdx.x] = s;
}

// partial[0, count) summed in index order by one block of kFinishThreads;
// thread 0 gets the total.
__device__ __forceinline__ float ordered_sum(const float* __restrict__ partial, long long count) {
  float s = 0.0f;
  for (long long i = threadIdx.x; i < count; i += kFinishThreads) s += partial[i];
  return block_sum<kFinishThreads>(s);
}

__global__ void __launch_bounds__(kFinishThreads)
adamw_norm_sum_kernel(const float* __restrict__ partial, long long count,
                      float* __restrict__ total) {
  const float s = ordered_sum(partial, count);
  if (threadIdx.x == 0) *total = s;
}

// The norm over all partials and the clip scale; NaN passes through both, as
// through torch.clamp.
__global__ void __launch_bounds__(kFinishThreads)
adamw_norm_finish_kernel(const float* __restrict__ partial, long long count, float clip,
                         int has_clip, float* __restrict__ norm, float* __restrict__ scale) {
  const float s = ordered_sum(partial, count);
  if (threadIdx.x == 0) {
    const float gn = __fsqrt_rn(s);
    *norm = gn;
    float sc = 1.0f;
    if (has_clip) {
      const float lo = gn < 1e-9f ? 1e-9f : gn;
      sc = __fmul_rn(__frcp_rn(lo), clip);  // clip / t is reciprocal(t) * clip in torch
      sc = sc > 1.0f ? 1.0f : sc;
    }
    *scale = sc;
  }
}

struct Hyper {
  float b1, b2, one_minus_b1, one_minus_b2, eps, wd;
};

// One element of the update, pass by pass as the loop runs it (each line's
// rounding is its ATen kernel's); m and v come back in float32 (their stored
// type's rounding is the store's).
__device__ __forceinline__ void adamw_element(float& p, float g, float& m, float& v, float scale,
                                              float lr, float bc1, float bc2, const Hyper& h) {
  const float gf = __fmul_rn(g, scale);
  m = __fmaf_rn(h.one_minus_b1, gf, __fmul_rn(m, h.b1));
  v = __fmaf_rn(h.one_minus_b2, __fmul_rn(gf, gf), __fmul_rn(v, h.b2));
  const float denom = __fadd_rn(__fsqrt_rn(__fdiv_rn(v, bc2)), h.eps);
  float step = __fdiv_rn(__fdiv_rn(m, bc1), denom);
  step = __fmaf_rn(h.wd, p, step);
  p = __fsub_rn(p, __fmul_rn(step, lr));
}

template <typename P, typename G, typename M>
__global__ void __launch_bounds__(kThreads)
adamw_update_kernel(P* __restrict__ p, const G* __restrict__ g, M* __restrict__ m,
                    M* __restrict__ v, long long n, const float* __restrict__ scale_ptr,
                    const float* __restrict__ lr_ptr, const float* __restrict__ bc1_ptr,
                    const float* __restrict__ bc2_ptr, Hyper h) {
  const float scale = *scale_ptr, lr = *lr_ptr, bc1 = *bc1_ptr, bc2 = *bc2_ptr;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long first = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const uintptr_t bases = reinterpret_cast<uintptr_t>(p) | reinterpret_cast<uintptr_t>(g) |
                          reinterpret_cast<uintptr_t>(m) | reinterpret_cast<uintptr_t>(v);
  const bool aligned = bases % 16 == 0;
  const long long n_vec = aligned ? n / kVec : 0;
  for (long long i = first; i < n_vec; i += stride) {
    const long long at = i * kVec;
    float pf[kVec], gf[kVec], mf[kVec], vf[kVec];
    load8(p + at, pf);
    load8(g + at, gf);
    load8(m + at, mf);
    load8(v + at, vf);
#pragma unroll
    for (int j = 0; j < kVec; ++j)
      adamw_element(pf[j], gf[j], mf[j], vf[j], scale, lr, bc1, bc2, h);
    store8(p + at, pf);
    store8(m + at, mf);
    store8(v + at, vf);
  }
  for (long long i = n_vec * kVec + first; i < n; i += stride) {
    float pf = widen(p[i]), mf = widen(m[i]), vf = widen(v[i]);
    adamw_element(pf, widen(g[i]), mf, vf, scale, lr, bc1, bc2, h);
    narrow(p + i, pf);
    narrow(m + i, mf);
    narrow(v + i, vf);
  }
}

template <typename P, typename G, typename M>
void launch_update(void* p, const void* g, void* m, void* v, long long n, const void* scale,
                   const void* lr, const void* bc1, const void* bc2, const Hyper& h, int blocks,
                   cudaStream_t stream) {
  adamw_update_kernel<P, G, M><<<blocks, kThreads, 0, stream>>>(
      static_cast<P*>(p), static_cast<const G*>(g), static_cast<M*>(m), static_cast<M*>(v), n,
      static_cast<const float*>(scale), static_cast<const float*>(lr),
      static_cast<const float*>(bc1), static_cast<const float*>(bc2), h);
}

template <typename P, typename G>
void launch_update_m(int m_bf16, void* p, const void* g, void* m, void* v, long long n,
                     const void* scale, const void* lr, const void* bc1, const void* bc2,
                     const Hyper& h, int blocks, cudaStream_t stream) {
  if (m_bf16)
    launch_update<P, G, bf16>(p, g, m, v, n, scale, lr, bc1, bc2, h, blocks, stream);
  else
    launch_update<P, G, float>(p, g, m, v, n, scale, lr, bc1, bc2, h, blocks, stream);
}

template <typename P>
void launch_update_g(int g_bf16, int m_bf16, void* p, const void* g, void* m, void* v,
                     long long n, const void* scale, const void* lr, const void* bc1,
                     const void* bc2, const Hyper& h, int blocks, cudaStream_t stream) {
  if (g_bf16)
    launch_update_m<P, bf16>(m_bf16, p, g, m, v, n, scale, lr, bc1, bc2, h, blocks, stream);
  else
    launch_update_m<P, float>(m_bf16, p, g, m, v, n, scale, lr, bc1, bc2, h, blocks, stream);
}

}  // namespace

extern "C" {

// Partial sums of squares of g[0, n) (bf16 when g_bf16, else float32) into
// partial[0, blocks).
int adamw_norm_partial(const void* g, long long n, int g_bf16, void* partial, int blocks,
                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (g_bf16)
    adamw_norm_partial_kernel<bf16><<<blocks, kThreads, 0, s>>>(
        static_cast<const bf16*>(g), n, static_cast<float*>(partial));
  else
    adamw_norm_partial_kernel<float><<<blocks, kThreads, 0, s>>>(
        static_cast<const float*>(g), n, static_cast<float*>(partial));
  return static_cast<int>(cudaGetLastError());
}

// total[0] = the sum of partial[0, count).
int adamw_norm_sum(const void* partial, long long count, void* total, void* stream) {
  adamw_norm_sum_kernel<<<1, kFinishThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(partial), count, static_cast<float*>(total));
  return static_cast<int>(cudaGetLastError());
}

// norm = sqrt(sum of partial[0, count)); scale = the clip scale (1 unless
// has_clip).
int adamw_norm_finish(const void* partial, long long count, float clip, int has_clip,
                      void* norm, void* scale, void* stream) {
  adamw_norm_finish_kernel<<<1, kFinishThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(partial), count, clip, has_clip, static_cast<float*>(norm),
      static_cast<float*>(scale));
  return static_cast<int>(cudaGetLastError());
}

// The update of one leaf in place: p (bf16 when p_bf16), g (g_bf16), m and v
// (m_bf16), each of n elements.
int adamw_update(void* p, const void* g, void* m, void* v, long long n, int p_bf16, int g_bf16,
                 int m_bf16, const void* scale, const void* lr, const void* bc1, const void* bc2,
                 float b1, float b2, float one_minus_b1, float one_minus_b2, float eps, float wd,
                 int blocks, void* stream) {
  const Hyper h{b1, b2, one_minus_b1, one_minus_b2, eps, wd};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p_bf16)
    launch_update_g<bf16>(g_bf16, m_bf16, p, g, m, v, n, scale, lr, bc1, bc2, h, blocks, s);
  else
    launch_update_g<float>(g_bf16, m_bf16, p, g, m, v, n, scale, lr, bc1, bc2, h, blocks, s);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

// EP-SpMV kernels for Hopper (sm_90a), with a plain C interface for ctypes.
//
// Replaces the Pallas kernels of src/repro/kernels/ep_spmv.py:
//   ep_spmv_smem_*    <- spmv_software_cache (_smem_kernel), grid (k,)
//   ep_spmv_stream_*  <- spmv_streaming (_stream_kernel), grid (k,), and
//                        spmv_streaming_batched (_stream_kernel_batched), grid (B, k)
//   ep_combine_*      <- the combine y.at[y_gidx].add(partials) of kernels/ops.py
//
// All four are gathers and reductions bound by device-memory bytes: two
// flops per task against 12 bytes of task operands.  The software-cache
// kernel stages its cluster's packed x tile in shared memory once, so the
// gathers x_tile[x_lidx] never leave the SM (the paper's __shared__ design).
// The streaming kernel gathers from the whole x through the read-only path
// (__ldg), leaving reuse to L1/L2 (the paper's texture-cache variant).
//
// Determinism: no atomics.  Each output (a y slot of a tile, or a row of y)
// is owned by one thread that sums its inputs in ascending input order,
// starting from zero, with products and sums rounded separately (no FMA
// contraction) -- the arithmetic of the reference's sequential scatter-add.
// The result does not depend on the launch shape, so a request gives the
// same bits alone or inside a stacked batch, through a bucket or its own plan.
//
// Each entry point returns cudaGetLastError() after its launch (0 = ok).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

// One CTA per cluster row r of (rows, e_max) task tiles.  Each row's tasks
// are packed in y order, so task slots seg[r, j] .. seg[r, j + 1] are the
// run of y slot j; slots from seg[r, y_max] on (zero padding) are in no run.
// Thread t owns y slots t, t + blockDim.x, ...
template <typename T>
__global__ void __launch_bounds__(kThreads)
smem_kernel(const T* __restrict__ vals, const int* __restrict__ x_lidx,
            const int* __restrict__ seg, const T* __restrict__ x_packed, T* __restrict__ out,
            int e_max, int x_max, int y_max) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* x_tile = reinterpret_cast<T*>(smem_raw);
  const long long r = blockIdx.x;
  const T* xp = x_packed + r * x_max;
  for (int i = threadIdx.x; i < x_max; i += blockDim.x) x_tile[i] = xp[i];
  __syncthreads();
  const T* v = vals + r * e_max;
  const int* xl = x_lidx + r * e_max;
  const int* sg = seg + r * (y_max + 1);
  T* o = out + r * y_max;
  for (int j = threadIdx.x; j < y_max; j += blockDim.x) {
    T acc = T(0);
    const int end = sg[j + 1];
    for (int t = sg[j]; t < end; ++t) acc = add_rn(acc, mul_rn(v[t], x_tile[xl[t]]));
    o[j] = acc;
  }
}

// One CTA per (request b = blockIdx.y, cluster p = blockIdx.x); row
// r = b * k + p of the (B * k, e_max) task tiles gathers from x[b, :].
template <typename T>
__global__ void __launch_bounds__(kThreads)
stream_kernel(const T* __restrict__ vals, const int* __restrict__ xg_task,
              const int* __restrict__ seg, const T* __restrict__ x,
              T* __restrict__ out, int k, int e_max, int n_cols, int y_max) {
  const long long b = blockIdx.y;
  const long long r = b * k + blockIdx.x;
  const T* xb = x + b * n_cols;
  const T* v = vals + r * e_max;
  const int* xg = xg_task + r * e_max;
  const int* sg = seg + r * (y_max + 1);
  T* o = out + r * y_max;
  for (int j = threadIdx.x; j < y_max; j += blockDim.x) {
    T acc = T(0);
    const int end = sg[j + 1];
    for (int t = sg[j]; t < end; ++t) acc = add_rn(acc, mul_rn(v[t], __ldg(xb + xg[t])));
    o[j] = acc;
  }
}

// One thread per output row i: y[i] = sum of partials[src[t]] for
// t in row_ptr[i] .. row_ptr[i + 1], in that order.  The sentinel row has no
// entries in the table, so it is never written.
template <typename T>
__global__ void __launch_bounds__(kThreads)
combine_kernel(const T* __restrict__ partials, const int* __restrict__ row_ptr,
               const int* __restrict__ src, T* __restrict__ y, int n_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_out) return;
  T acc = T(0);
  const int end = row_ptr[i + 1];
  for (int t = row_ptr[i]; t < end; ++t) acc = add_rn(acc, partials[src[t]]);
  y[i] = acc;
}

template <typename T>
int launch_smem(const void* vals, const void* x_lidx, const void* seg,
                const void* x_packed, void* out, int rows, int e_max, int x_max,
                int y_max, void* stream) {
  const size_t smem = static_cast<size_t>(x_max) * sizeof(T);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        smem_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (rows > 0 && y_max > 0) {
    smem_kernel<T><<<rows, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(vals), static_cast<const int*>(x_lidx),
        static_cast<const int*>(seg), static_cast<const T*>(x_packed),
        static_cast<T*>(out), e_max, x_max, y_max);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_stream(const void* vals, const void* xg_task, const void* seg,
                  const void* x, void* out, int batch, int k, int e_max, int n_cols,
                  int y_max, void* stream) {
  if (batch > 0 && k > 0 && y_max > 0) {
    const dim3 grid(static_cast<unsigned>(k), static_cast<unsigned>(batch));
    stream_kernel<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(vals), static_cast<const int*>(xg_task),
        static_cast<const int*>(seg), static_cast<const T*>(x), static_cast<T*>(out),
        k, e_max, n_cols, y_max);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_combine(const void* partials, const void* row_ptr, const void* src, void* y,
                   int n_out, void* stream) {
  if (n_out > 0) {
    const int blocks = (n_out + kThreads - 1) / kThreads;
    combine_kernel<T><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(partials), static_cast<const int*>(row_ptr),
        static_cast<const int*>(src), static_cast<T*>(y), n_out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int ep_spmv_smem_f32(const void* vals, const void* x_lidx, const void* seg,
                     const void* x_packed, void* out, int rows, int e_max, int x_max,
                     int y_max, void* stream) {
  return launch_smem<float>(vals, x_lidx, seg, x_packed, out, rows, e_max, x_max,
                            y_max, stream);
}

int ep_spmv_smem_f64(const void* vals, const void* x_lidx, const void* seg,
                     const void* x_packed, void* out, int rows, int e_max, int x_max,
                     int y_max, void* stream) {
  return launch_smem<double>(vals, x_lidx, seg, x_packed, out, rows, e_max, x_max,
                             y_max, stream);
}

int ep_spmv_stream_f32(const void* vals, const void* xg_task, const void* seg,
                       const void* x, void* out, int batch, int k, int e_max,
                       int n_cols, int y_max, void* stream) {
  return launch_stream<float>(vals, xg_task, seg, x, out, batch, k, e_max, n_cols,
                              y_max, stream);
}

int ep_spmv_stream_f64(const void* vals, const void* xg_task, const void* seg,
                       const void* x, void* out, int batch, int k, int e_max,
                       int n_cols, int y_max, void* stream) {
  return launch_stream<double>(vals, xg_task, seg, x, out, batch, k, e_max, n_cols,
                               y_max, stream);
}

int ep_combine_f32(const void* partials, const void* row_ptr, const void* src, void* y,
                   int n_out, void* stream) {
  return launch_combine<float>(partials, row_ptr, src, y, n_out, stream);
}

int ep_combine_f64(const void* partials, const void* row_ptr, const void* src, void* y,
                   int n_out, void* stream) {
  return launch_combine<double>(partials, row_ptr, src, y, n_out, stream);
}

}  // extern "C"

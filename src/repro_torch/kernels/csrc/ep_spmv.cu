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
// (__ldg), leaving reuse to L1/L2 (the paper's texture-cache variant).  It
// works task-parallel: all lanes of a CTA stream consecutive tasks with
// 16-byte loads and gather x with many loads in flight, stage the rounded
// products in shared memory, and then each y slot sums its run from there.
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

#include <cstdint>

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

// The streaming kernel.  One CTA per window of kWindow consecutive y slots
// of one row r = b * k + p of the (B * k, e_max) task tiles (request b,
// cluster p), gathering from x[b, :]; windows of a row are independent.
// The window's tasks are one contiguous range seg[w0] .. seg[w1] (the tasks
// of a row are packed in y order), streamed in chunks of kChunkVectors
// 16-byte vectors a lane (2,048 f32 or 1,024 f64 task slots a CTA):
//   A  every lane takes consecutive tasks: 16-byte loads of vals and xg_task
//      (a scalar head and tail where a vector would cross the window's range,
//      or where the row start is not 16-byte aligned), all of a lane's x
//      gathers issued before any is used, and the rounded products written
//      to shared memory.  The task stream is read once and loaded
//      evict-first (__ldcs), so it does not push the x sectors that the
//      window's gathers share out of L1 (on the dedicated plan, 811 32-byte
//      sectors serve a tile's 4,067 gathers);
//   B  each y slot of the window (thread t owns slots w0 + t + 256 i, i < 4)
//      adds the products of its run that fall in the chunk, in slot order,
//      to its running sum -- a run longer than a chunk carries its sum into
//      the next chunk in order, never as a partial sum added later.
// The next chunk's loads are issued before B, so they are in flight while
// the sums run.  A window whose runs are all empty writes zeros without
// reading its runs.  Chunks are aligned to the vector grid of the global
// task index, so only a window's first and last vectors can be partial.
// The window and chunk sizes are the fastest of the design variants timed
// on the main path's plans.
constexpr int kStreamThreads = 256;
constexpr int kSlotsPerThread = 4;
constexpr int kWindow = kStreamThreads * kSlotsPerThread;  // y slots per CTA
constexpr int kChunkVectors = 2;  // 16-byte vectors of tasks a lane loads per chunk

template <typename T> struct Wide;  // the 16-byte vector of T and its index vector
template <> struct Wide<float> { using V = float4; using I = int4; static constexpr int kN = 4; };
template <> struct Wide<double> { using V = double2; using I = int2; static constexpr int kN = 2; };

__device__ __forceinline__ void unpack(const float4& a, float* d) { d[0] = a.x; d[1] = a.y; d[2] = a.z; d[3] = a.w; }
__device__ __forceinline__ void unpack(const double2& a, double* d) { d[0] = a.x; d[1] = a.y; }
__device__ __forceinline__ void unpack(const int4& a, int* d) { d[0] = a.x; d[1] = a.y; d[2] = a.z; d[3] = a.w; }
__device__ __forceinline__ void unpack(const int2& a, int* d) { d[0] = a.x; d[1] = a.y; }
__device__ __forceinline__ float4 pack(const float* s) { return make_float4(s[0], s[1], s[2], s[3]); }
__device__ __forceinline__ double2 pack(const double* s) { return make_double2(s[0], s[1]); }

// Loads the tasks of the chunk that starts at row slot q into (v, xi):
// lane slot u * kN + i holds task q + (u * kStreamThreads + tid) * kN + i,
// or 0 where that task is outside [a, e).
template <typename T, int U>
__device__ __forceinline__ void load_chunk(const T* __restrict__ vals, const int* __restrict__ xg,
                                           int q, int a, int e, bool wide, T (&v)[U][Wide<T>::kN],
                                           int (&xi)[U][Wide<T>::kN]) {
  using V = typename Wide<T>::V;
  using I = typename Wide<T>::I;
  constexpr int N = Wide<T>::kN;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int t0 = q + (u * kStreamThreads + static_cast<int>(threadIdx.x)) * N;
    if (wide && t0 >= a && t0 + N <= e) {
      unpack(__ldcs(reinterpret_cast<const V*>(vals + t0)), v[u]);
      unpack(__ldcs(reinterpret_cast<const I*>(xg + t0)), xi[u]);
    } else {
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const int t = t0 + i;
        v[u][i] = T(0);
        xi[u][i] = 0;
        if (t >= a && t < e) {
          v[u][i] = __ldcs(vals + t);
          xi[u][i] = __ldcs(xg + t);
        }
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kStreamThreads)
stream_kernel(const T* __restrict__ vals, const int* __restrict__ xg_task,
              const int* __restrict__ seg, const T* __restrict__ x,
              T* __restrict__ out, int k, int e_max, int n_cols, int y_max, int n_windows) {
  using V = typename Wide<T>::V;
  using I = typename Wide<T>::I;
  constexpr int N = Wide<T>::kN;
  constexpr int U = kChunkVectors;
  constexpr int kChunk = U * N * kStreamThreads;  // task slots staged at once
  __shared__ __align__(16) T prod[kChunk];  // the chunk's rounded products

  const long long r = blockIdx.x / n_windows;
  const int w0 = static_cast<int>(blockIdx.x % n_windows) * kWindow;
  const int w1 = min(w0 + kWindow, y_max);
  const int* sg = seg + r * (y_max + 1);
  const int a = __ldg(sg + w0), e = __ldg(sg + w1);  // the window's tasks: [a, e)

  int lo[kSlotsPerThread], hi[kSlotsPerThread];
  T acc[kSlotsPerThread];
#pragma unroll
  for (int s = 0; s < kSlotsPerThread; ++s) {
    const int j = w0 + s * kStreamThreads + static_cast<int>(threadIdx.x);
    const bool in = a < e && j < w1;
    lo[s] = in ? __ldg(sg + j) : 0;
    hi[s] = in ? __ldg(sg + j + 1) : 0;
    acc[s] = T(0);
  }
  if (a < e) {
    const long long base = r * e_max;  // global index of the row's first task slot
    const T* v = vals + base;
    const int* xg = xg_task + base;
    const T* xb = x + (r / k) * n_cols;
    const bool wide = reinterpret_cast<uintptr_t>(vals) % sizeof(V) == 0 &&
                      reinterpret_cast<uintptr_t>(xg_task) % sizeof(I) == 0;
    const int q0 = a - static_cast<int>((base + a) % N);  // the vector grid at or below a
    const int n_chunks = (e - q0 + kChunk - 1) / kChunk;
    T tv[U][N];
    int ti[U][N];
    load_chunk<T, U>(v, xg, q0, a, e, wide, tv, ti);
    for (int c = 0; c < n_chunks; ++c) {
      const int q = q0 + c * kChunk;
      T xv[U][N];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int t0 = q + (u * kStreamThreads + static_cast<int>(threadIdx.x)) * N;
#pragma unroll
        for (int i = 0; i < N; ++i) {
          const int t = t0 + i;
          xv[u][i] = (t >= a && t < e) ? __ldg(xb + ti[u][i]) : T(0);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        T p[N];
#pragma unroll
        for (int i = 0; i < N; ++i) p[i] = mul_rn(tv[u][i], xv[u][i]);
        *reinterpret_cast<V*>(prod + (u * kStreamThreads + threadIdx.x) * N) = pack(p);
      }
      __syncthreads();
      if (c + 1 < n_chunks) load_chunk<T, U>(v, xg, q + kChunk, a, e, wide, tv, ti);
#pragma unroll
      for (int s = 0; s < kSlotsPerThread; ++s) {
        const int end = min(hi[s], q + kChunk);
        for (int t = max(lo[s], q); t < end; ++t) acc[s] = add_rn(acc[s], prod[t - q]);
      }
      __syncthreads();
    }
  }
  T* o = out + r * y_max;
#pragma unroll
  for (int s = 0; s < kSlotsPerThread; ++s) {
    const int j = w0 + s * kStreamThreads + static_cast<int>(threadIdx.x);
    if (j < w1) o[j] = acc[s];
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
    const int n_windows = (y_max + kWindow - 1) / kWindow;
    const long long blocks = static_cast<long long>(batch) * k * n_windows;
    stream_kernel<T><<<static_cast<unsigned>(blocks), kStreamThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(vals), static_cast<const int*>(xg_task),
        static_cast<const int*>(seg), static_cast<const T*>(x), static_cast<T*>(out),
        k, e_max, n_cols, y_max, n_windows);
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

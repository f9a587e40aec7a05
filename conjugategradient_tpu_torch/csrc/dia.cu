// Hand-written Hopper (sm_90a) kernels for the flat banded (DIA) path.
//
// Built by conjugategradient_tpu_torch/ops/_build.py into its own shared
// library with a plain C interface and called through ctypes from
// conjugategradient_tpu_torch/ops/cuda_dia.py, whose plain PyTorch twins
// (spmv_dia_ref, spmv_dot_dia_ref, spmm_dia_ref) define what each kernel must
// compute.  Kernels launch on the caller's stream, allocate nothing and do
// not synchronise; each C entry returns cudaGetLastError().
//
// ---------------------------------------------------------------------------
// Kernel 4: DIA SpMV, y[i] = sum_k data[k, i] * x[i + offsets[k]], and its
//   fused form that also returns p . (A p).
//   Replaces conjugategradient_tpu/ops/pallas_spmv.py::_cm_kernel (:193,
//   pallas_call at :257 in _group_spmv); the fused form is the contract of
//   spmv_dot_dia_pallas (:329).
//   Bound on the H100: device-memory bandwidth.  The coefficient stream is
//   ndiags * n legs (132 MB in fp32 for the band-160 flagship, n = 207,402),
//   above the 50 MB L2, so every SpMV streams it from HBM; x (0.8 MB) and y
//   are noise beside it.
//   Design: one thread per row.  data is row-major (ndiags, n), as the host
//   DiaMatrix stores it, so data[k, i] across a warp is one coalesced
//   128-byte read per leg with no relayout (the TPU's 128-lane column-major
//   relayout and its chained diagonal groups have no counterpart).  A block
//   of 256 rows touches a window of 256 + (bandwidth span) entries of x,
//   which stays in L1/L2.  A neighbour outside [0, n) is never read and
//   contributes 0, exactly what the JAX package's zero-padded x gives.
//   Offsets travel by value (<= MAX_DIAGS = 256, enough for band 160).  Legs
//   are summed in A.offsets order with an explicit fma, so the kernel and
//   its twin differ only by FMA contraction, and SpMM column j equals the
//   SpMV of column j bit for bit.
//   Instantiations (leg type / vector and accumulator type): fp32/fp32,
//   bf16/fp32 (half the matrix bytes, fp32 accumulate, as _cm_kernel does
//   for a bf16 matrix) and fp64/fp64 (the refinement's device residual).
//   Fused p.Ap: each block reduces its rows' y[i] * p[i] in a fixed tree into
//   one partial; a one-block second kernel sums the partials in a fixed
//   order, so the result is deterministic run to run.
//
// Kernel 5: DIA SpMM for K right-hand sides held as (K, n), each column
//   contiguous.  Replaces pallas_spmv.py::_cm_kernel_multi (:421,
//   pallas_call at :464 in _group_spmm).  Each coefficient is read once and
//   applied to all K columns held in registers, so the dominant matrix
//   stream is amortised K-fold.  Templated on K in {1, 2, 4, 8}; the wrapper
//   runs larger or odd k in chunks.  fp32 and bf16-leg instantiations.
// ---------------------------------------------------------------------------

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define MAX_DIAGS 256
#define THREADS 256

struct Offsets {
  int n;
  int off[MAX_DIAGS];
};

enum Code { FP32 = 0, BF16 = 1, FP64 = 2 };

__device__ __forceinline__ float to_acc(float v) { return v; }
__device__ __forceinline__ float to_acc(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ double to_acc(double v) { return v; }
__device__ __forceinline__ float madd(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double madd(double a, double b, double c) { return fma(a, b, c); }

// (A x)[i], legs in offsets order; rows outside the band's reach skip the leg
template <typename L, typename V>
__device__ __forceinline__ V row_sum(const L* __restrict__ data, const V* __restrict__ x,
                                     int n, const Offsets& offs, int i) {
  V acc = 0;
#pragma unroll 4
  for (int k = 0; k < offs.n; ++k) {
    const int j = i + offs.off[k];
    if (j >= 0 && j < n) acc = madd(to_acc(data[(long long)k * n + i]), x[j], acc);
  }
  return acc;
}

template <typename L, typename V>
__global__ void __launch_bounds__(THREADS)
spmv_dia_kernel(const L* __restrict__ data, const V* __restrict__ x, V* __restrict__ y, int n,
                Offsets offs) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i < n) y[i] = row_sum(data, x, n, offs, i);
}

// y = A p and one partial of p . y per block (fixed-order tree)
template <typename L, typename V>
__global__ void __launch_bounds__(THREADS)
spmv_dot_dia_kernel(const L* __restrict__ data, const V* __restrict__ p, V* __restrict__ y,
                    V* __restrict__ partial, int n, Offsets offs) {
  __shared__ V s[THREADS];
  const int i = blockIdx.x * THREADS + threadIdx.x;
  V prod = 0;
  if (i < n) {
    const V v = row_sum(data, p, n, offs, i);
    y[i] = v;
    prod = v * p[i];
  }
  s[threadIdx.x] = prod;
  __syncthreads();
  for (int w = THREADS / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) s[threadIdx.x] += s[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) partial[blockIdx.x] = s[0];
}

// one block: strided fixed-order sums of the partials, then a fixed tree
template <typename V>
__global__ void __launch_bounds__(THREADS)
sum_partials_kernel(const V* __restrict__ partial, int m, V* __restrict__ out) {
  __shared__ V s[THREADS];
  V acc = 0;
  for (int b = threadIdx.x; b < m; b += THREADS) acc += partial[b];
  s[threadIdx.x] = acc;
  __syncthreads();
  for (int w = THREADS / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) s[threadIdx.x] += s[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) *out = s[0];
}

// Y[c, i] = sum_k data[k, i] * X[c, i + offsets[k]] for K columns of stride ld
template <typename L, int K>
__global__ void __launch_bounds__(THREADS)
spmm_dia_kernel(const L* __restrict__ data, const float* __restrict__ X, float* __restrict__ Y,
                int n, long long ld, Offsets offs) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  float acc[K];
#pragma unroll
  for (int c = 0; c < K; ++c) acc[c] = 0.0f;
#pragma unroll 2
  for (int k = 0; k < offs.n; ++k) {
    const int j = i + offs.off[k];
    if (j >= 0 && j < n) {
      const float d = to_acc(data[(long long)k * n + i]);
#pragma unroll
      for (int c = 0; c < K; ++c) acc[c] = madd(d, X[c * ld + j], acc[c]);
    }
  }
#pragma unroll
  for (int c = 0; c < K; ++c) Y[c * ld + i] = acc[c];
}

static int fill_offsets(Offsets* o, int ndiags, const int* offsets) {
  if (ndiags < 1 || ndiags > MAX_DIAGS) return (int)cudaErrorInvalidValue;
  o->n = ndiags;
  for (int k = 0; k < ndiags; ++k) o->off[k] = offsets[k];
  return 0;
}

static inline int blocks_of(int n) { return (n + THREADS - 1) / THREADS; }

template <typename L, typename V>
static int launch_spmv(const void* data, const void* x, void* y, int n, const Offsets& o,
                       cudaStream_t st) {
  spmv_dia_kernel<L, V><<<blocks_of(n), THREADS, 0, st>>>((const L*)data, (const V*)x, (V*)y, n,
                                                          o);
  return (int)cudaGetLastError();
}

template <typename L, typename V>
static int launch_spmv_dot(const void* data, const void* p, void* y, void* partial, void* dot,
                           int n, const Offsets& o, cudaStream_t st) {
  const int nb = blocks_of(n);
  spmv_dot_dia_kernel<L, V><<<nb, THREADS, 0, st>>>((const L*)data, (const V*)p, (V*)y,
                                                    (V*)partial, n, o);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  sum_partials_kernel<V><<<1, THREADS, 0, st>>>((const V*)partial, nb, (V*)dot);
  return (int)cudaGetLastError();
}

template <typename L>
static int launch_spmm(int k, const void* data, const void* X, void* Y, int n, long long ld,
                       const Offsets& o, cudaStream_t st) {
  const L* d = (const L*)data;
  const float* x = (const float*)X;
  float* y = (float*)Y;
  switch (k) {
    case 1: spmm_dia_kernel<L, 1><<<blocks_of(n), THREADS, 0, st>>>(d, x, y, n, ld, o); break;
    case 2: spmm_dia_kernel<L, 2><<<blocks_of(n), THREADS, 0, st>>>(d, x, y, n, ld, o); break;
    case 4: spmm_dia_kernel<L, 4><<<blocks_of(n), THREADS, 0, st>>>(d, x, y, n, ld, o); break;
    case 8: spmm_dia_kernel<L, 8><<<blocks_of(n), THREADS, 0, st>>>(d, x, y, n, ld, o); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" {

const char* cg_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// code: 0 fp32 legs / fp32 x, 1 bf16 legs / fp32 x, 2 fp64 legs / fp64 x
int cg_spmv_dia(int code, const void* data, const void* x, void* y, int n, int ndiags,
                const int* offsets, void* stream) {
  Offsets o;
  int err = fill_offsets(&o, ndiags, offsets);
  if (err) return err;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (code) {
    case FP32: return launch_spmv<float, float>(data, x, y, n, o, st);
    case BF16: return launch_spmv<__nv_bfloat16, float>(data, x, y, n, o, st);
    case FP64: return launch_spmv<double, double>(data, x, y, n, o, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// partial: ceil(n / 256) scratch values; dot: one value (p . A p)
int cg_spmv_dot_dia(int code, const void* data, const void* p, void* y, void* partial, void* dot,
                    int n, int ndiags, const int* offsets, void* stream) {
  Offsets o;
  int err = fill_offsets(&o, ndiags, offsets);
  if (err) return err;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (code) {
    case FP32: return launch_spmv_dot<float, float>(data, p, y, partial, dot, n, o, st);
    case BF16: return launch_spmv_dot<__nv_bfloat16, float>(data, p, y, partial, dot, n, o, st);
    case FP64: return launch_spmv_dot<double, double>(data, p, y, partial, dot, n, o, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// k in {1, 2, 4, 8} columns starting at X / Y, column stride ld; code 0 or 1
int cg_spmm_dia(int code, int k, const void* data, const void* X, void* Y, int n, long long ld,
                int ndiags, const int* offsets, void* stream) {
  Offsets o;
  int err = fill_offsets(&o, ndiags, offsets);
  if (err) return err;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (code) {
    case FP32: return launch_spmm<float>(k, data, X, Y, n, ld, o, st);
    case BF16: return launch_spmm<__nv_bfloat16>(k, data, X, Y, n, ld, o, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"

// Hand-written Hopper (sm_90a) kernel for the variable-coefficient MGCG path.
//
// Built by conjugategradient_tpu_torch/ops/_build.py into its own shared
// library with a plain C interface and called through ctypes from
// conjugategradient_tpu_torch/ops/cuda_stencil.py, whose plain PyTorch twin
// (spmv_stencil_ref) defines what the kernel must compute.  The kernel
// launches on the caller's stream, allocates nothing and does not
// synchronise; the C entry returns cudaGetLastError().
//
// ---------------------------------------------------------------------------
// Kernel 3: variable-coefficient stencil SpMV,
//   y[p] = sum_k legs[k][p] * x[p + shift_k], 2-D and 3-D,
//   x zero outside the grid.
//   Replaces conjugategradient_tpu/ops/pallas_stencil.py::_kernel_var (:177,
//   pallas_call at :205 in _build_var, entry spmv_stencil_pallas :226).
//   Bound on the H100: device-memory bandwidth.  The legs are the traffic:
//   nlegs grid-sized arrays read once per product, against one read of x
//   and one write of y (the 2 * d neighbour re-reads of x hit L1/L2).  At
//   255^3 with 7 fp32 legs that is (7 + 2) * 4 B * 16.58M = 597 MB; a
//   127^3 Galerkin level with 27 legs moves (27 + 2) * 4 B * 2.05M = 238 MB.
//   Design: one thread per output point, x fastest, so a warp reads 128
//   contiguous bytes of each fp32 leg (64 of a bf16 leg) and of x's window.
//   Legs are read at k * n + p with 64-bit index math.  Shifts travel by
//   value (<= MAX_LEGS = 27, the Galerkin 3-D coarse levels).  A 2-D grid
//   (ny, nx) runs as the 3-D grid (1, ny, nx).  The TPU slab halos, the
//   8-row 2-D halo blocks and the per-slab leg blocks have no counterpart.
//   Masking: a neighbour outside the grid is never read and contributes 0.
//   The kernel does not rely on the zero legs there: 0 * NaN = NaN, so a
//   read of memory beyond the grid would leak (the reference's fault
//   92c5bd5, _kernel_var's domain mask).
//   Legs are summed in A.shifts order with an explicit fma, so the kernel
//   and its twin differ only by FMA contraction.
//   Instantiations (leg type / vector and accumulator type): fp32/fp32,
//   bf16/fp32 (half the leg bytes, upcast in registers, as _kernel_var does)
//   and fp64/fp64, the same set as kernel 4, so an fp64 MGCG on the card
//   launches a kernel at every level.
// ---------------------------------------------------------------------------

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define MAX_LEGS 27

struct Shifts {
  int n;
  signed char sz[MAX_LEGS];
  signed char sy[MAX_LEGS];
  signed char sx[MAX_LEGS];
};

enum Code { FP32 = 0, BF16 = 1, FP64 = 2 };

__device__ __forceinline__ float to_acc(float v) { return v; }
__device__ __forceinline__ float to_acc(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ double to_acc(double v) { return v; }
__device__ __forceinline__ float madd(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double madd(double a, double b, double c) { return fma(a, b, c); }

template <typename L, typename V>
__global__ void spmv_var_kernel(const L* __restrict__ legs, const V* __restrict__ x,
                                V* __restrict__ y, int nz, int ny, int nx, Shifts sh) {
  const int ix = blockIdx.x * blockDim.x + threadIdx.x;
  const int iy = blockIdx.y * blockDim.y + threadIdx.y;
  const int iz = blockIdx.z;
  if (ix >= nx || iy >= ny) return;
  const long long n = (long long)nz * ny * nx;
  const long long p = ((long long)iz * ny + iy) * nx + ix;
  V acc = 0;
  for (int k = 0; k < sh.n; ++k) {
    const int jz = iz + sh.sz[k], jy = iy + sh.sy[k], jx = ix + sh.sx[k];
    if (jz < 0 || jz >= nz || jy < 0 || jy >= ny || jx < 0 || jx >= nx) continue;
    acc = madd(to_acc(legs[(long long)k * n + p]), x[((long long)jz * ny + jy) * nx + jx], acc);
  }
  y[p] = acc;
}

template <typename L, typename V>
static int launch(const void* legs, const void* x, void* y, int nz, int ny, int nx,
                  const Shifts& sh, cudaStream_t st) {
  const dim3 block(32, 8, 1);
  const dim3 grid((nx + 31) / 32, (ny + 7) / 8, nz);
  spmv_var_kernel<L, V><<<grid, block, 0, st>>>((const L*)legs, (const V*)x, (V*)y, nz, ny, nx,
                                                sh);
  return (int)cudaGetLastError();
}

extern "C" {

const char* cg_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// code: 0 fp32 legs / fp32 x, 1 bf16 legs / fp32 x, 2 fp64 legs / fp64 x.
// legs: (nlegs, nz, ny, nx) contiguous; shifts: nlegs (dz, dy, dx) triples,
// each component in {-1, 0, 1}.
int cg_spmv_var(int code, const void* legs, const void* x, void* y, int nz, int ny, int nx,
                int nlegs, const int* shifts, void* stream) {
  if (nlegs < 1 || nlegs > MAX_LEGS || nz < 1 || nz > 65535) return (int)cudaErrorInvalidValue;
  Shifts sh;
  sh.n = nlegs;
  for (int k = 0; k < nlegs; ++k) {
    sh.sz[k] = (signed char)shifts[3 * k + 0];
    sh.sy[k] = (signed char)shifts[3 * k + 1];
    sh.sx[k] = (signed char)shifts[3 * k + 2];
  }
  const cudaStream_t st = (cudaStream_t)stream;
  switch (code) {
    case FP32: return launch<float, float>(legs, x, y, nz, ny, nx, sh, st);
    case BF16: return launch<__nv_bfloat16, float>(legs, x, y, nz, ny, nx, sh, st);
    case FP64: return launch<double, double>(legs, x, y, nz, ny, nx, sh, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"

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
//   Design: a latency-hiding streaming kernel.  The first design (one point
//   per thread, a rolled loop over a by-value shift struct indexed with the
//   runtime leg number) sat at a third of the read rate: the struct went to
//   an 88-byte stack frame, every leg paid six compares, a branch and a
//   64-bit multiply, and the rolled loop kept about two loads in flight.
//   Now:
//   - The leg count is a template parameter for the counts the hierarchies
//     produce (5: 2-D fine, 9: 2-D Galerkin, 7: 3-D fine, 27: 3-D
//     Galerkin); the leg loop is unrolled and each leg's shift is folded on
//     the host into one constant offset (sz * ny * nx + sy * nx + sx) that
//     lives in the __grid_constant__ Plan.  Every other count (1..27) runs
//     the 27-leg instantiation with the count read from the Plan.  Every
//     index into the Plan is a compile-time constant: no stack frame.
//   - A (32, 8) block owns a ZRUN-plane run in z (4 planes, tuned by
//     scripts/stencil_tuning.py); each thread marches its
//     (y, x) column through the run.  A block whose points and their
//     one-point neighbourhood (only along axes the shifts use) lie inside
//     the grid takes a branch-free path; the test is uniform over the block.
//     The other blocks mask each leg with a per-thread (y, x) bit mask,
//     computed once, and a per-plane z mask at the two end planes.
//   - The interior path loads B points' legs and x neighbours (B * nlegs of
//     each, B from the leg count and width) before the first FMA, so
//     about 30-60 loads are in flight per thread (at most 256 bytes of
//     them, so fp64 with 27 legs loads in two groups and does not spill).  Index math is 32-bit
//     within a leg; each leg's base is k * n in 64 bits (27 * 511^3
//     overflows int32).  Legs load with the evict-first hint (__ldcs), x
//     through the read-only path (__ldg), so the legs do not push x out of
//     L1/L2.  No vector loads: a 255-wide row starts on 4 bytes.
//   - A 2-D grid (ny, nx) runs as the 3-D grid (ny, 1, nx) with shifts
//     (sy, 0, sx), so its rows are the marched axis.
//   The TPU slab halos, the 8-row 2-D halo blocks and the per-slab leg blocks
//   have no counterpart.
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
//
// ---------------------------------------------------------------------------
// Kernel 3, wide (spmv_var_wide_kernel): the same product where the tuned
//   kernel's halo-1 design does not reach: per-axis |shift| up to
//   WIDE_HALO = 7, 1 to WIDE_LEGS = 3375 legs, 1-D, 2-D and 3-D grids.
//   These are the Galerkin levels of the hybrid (cell-centered),
//   semicoarsening and smoothed-aggregation transfers: |shift| 2 with 81 legs
//   at a 3-D hybrid level, 21-25 at 2-D, 5 at 1-D, 125 at a first
//   aggregation level; each further smoothed-aggregation level widens the
//   stencil (the 256^3 Poisson hierarchy reaches 343 legs at |shift| 3 on
//   32^3 and 1331 at |shift| 5 on 16^3).  The Pallas kernel stops at
//   |shift| <= 1 and the JAX package runs these levels through XLA's
//   pad-and-slice (conjugategradient_tpu/ops/stencil.py:70-90); on the card
//   that plain form is ~3 eager ops per leg.
//   Bound on the H100: device-memory bandwidth, the legs again: a 128^3
//   level with 81 fp32 legs moves (81 + 2) * 4 B * 2.10M = 696 MB, 0.208 ms
//   at 3.35 TB/s.  The deep levels' legs lie in the 50 MB L2 between
//   products (16^3 x 1331: 12.5 MB in the grid), so there latency, not
//   bytes, is what a design must hide.
//   Design: a gather with no matrix product (no wgmma, no TMA); what sets
//   its time is warps in flight and loads in flight per thread.  The first
//   design gave each thread a whole (y, x) column and every leg: on
//   the deep aggregation levels (32^3 with 343 legs, 16^3 with 1331) that
//   left 32,768 or 4096 threads each walking a chain of hundreds of loads,
//   at 18% and 2% of the bound and 1.6x and 5.9x cuSPARSE's CSR product.
//   Now the legs are split across threads where the points do not fill the
//   card:
//   - A block is bx x-lanes by `rows` rows of points by `split` (S) slices
//     of the leg list (blockDim = (bx, rows * S)): lanes run along x, so a
//     leg's loads at k * n + p stay coalesced, and the threads of slice s
//     take legs [s * nlegs / S, (s + 1) * nlegs / S) in A.shifts order (no
//     slice empty: S <= nlegs).  The wrapper picks the launch
//     (ops/cuda_stencil.py::wide_geometry): S = 1 with a WIDE_ZRUN-plane z
//     run where the view's runs fill the card (128^3 x 81); otherwise one
//     plane a thread and S the largest power of two whose threads still run
//     in one wave (1024 an SM) with at least WIDE_MIN_SLICE legs a slice
//     (S = 1 at 512^2 x 21 and 64^3 x 125, 4 at 32^3 x 343, 32 at 16^3 x
//     1331; on the H100 that beat twice as many threads with half the legs
//     each).  An unsplit launch is the first design's, term for term.
//   - Each thread sums its slice with an explicit fma into a register; at
//     S > 1 the partials go to shared memory and one thread per point adds
//     them in slice order.  Deterministic, no atomics.  Rounding: at S = 1
//     the sum is the twin's, term by term (up to FMA contraction); at S > 1
//     it is grouped by slice, ((s_0 + s_1) + s_2) + ..., each s_i a
//     sequential sum, so it differs from the twin's sequential order by
//     rounding (within the card tests' 1e-5 / 1e-13 of max |y|).
//   - The leg table (an int2 per leg: folded offset, packed shift bytes,
//     built and cached by the wrapper: too many legs for the parameter
//     space) is staged in dynamic shared memory once per block (27 KB at
//     3375 legs; with the partials, at most 35 KB, under the 48 KB a block
//     gets without opting in), and read from there with broadcast loads.
//   - The legs go in groups: every load of a group before its first FMA.
//     With one plane a thread a group is WIDE_GROUP_BYTES of leg and x
//     registers (16 fp32 or bf16 legs, 8 fp64; blocks of up to 1024
//     threads cap a thread at 64 registers); with a z run it is
//     WIDE_RUN_GROUP = 8 legs, whose (y, x) test and table entries stay in
//     registers for the run (16 took 125 registers at 128^3).  The group
//     loop is not unrolled (a fully unrolled 125-leg loop took 255
//     registers).  No stack, no spills (chip_smoke.py checks the ptxas
//     report).
//   - Each leg is tested against the grid (its (y, x) test once per group,
//     its z test per plane): no leg masks and no interior fast path, so the
//     halo-1 kernel's 32-bit masks and end-plane masking do not carry over.
//   Masking and the three leg/state instantiations are the narrow kernel's:
//   a neighbour outside the grid is never read.
// ---------------------------------------------------------------------------

#include <climits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define MAX_LEGS 27
#define THREADS 256
// design constants; scripts/stencil_tuning.py builds other values with -D
#ifndef ZRUN
#define ZRUN 4  // z planes a thread marches
#endif
#ifndef BATCH_BYTES
#define BATCH_BYTES 16  // accumulator-width bytes of each stream per load batch
#endif

struct Plan {
  int n;                  // legs (read by the generic instantiation only)
  int off[MAX_LEGS];      // sz * ny * nx + sy * nx + sx
  signed char sy[MAX_LEGS];
  signed char sx[MAX_LEGS];
  unsigned zlo, zhi;      // legs valid at z = 0 (sz >= 0) and at z = nz - 1 (sz <= 0)
  int hz, hy, hx;         // 1 where some shift moves along the axis
};

enum Code { FP32 = 0, BF16 = 1, FP64 = 2 };

__device__ __forceinline__ float to_acc(float v) { return v; }
__device__ __forceinline__ float to_acc(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ double to_acc(double v) { return v; }
__device__ __forceinline__ float madd(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double madd(double a, double b, double c) { return fma(a, b, c); }

// legs stream once: evict-first
__device__ __forceinline__ float ld_leg(const float* p) { return __ldcs(p); }
__device__ __forceinline__ double ld_leg(const double* p) { return __ldcs(p); }
__device__ __forceinline__ __nv_bfloat16 ld_leg(const __nv_bfloat16* p) {
  return __ushort_as_bfloat16(__ldcs(reinterpret_cast<const unsigned short*>(p)));
}

// points per batch of loads: about BATCH_BYTES of accumulator-width loads
// of each stream (legs, x) in flight per thread
template <typename V>
__host__ __device__ constexpr int batch(int k) {
  return k * (int)sizeof(V) <= BATCH_BYTES ? 4 : (k * (int)sizeof(V) <= 2 * BATCH_BYTES ? 2 : 1);
}

// legs per group of loads: at most 256 bytes (64 registers) of leg and x
// values in flight, so the fp64 27-leg instantiation does not spill
template <typename L, typename V>
__host__ __device__ constexpr int group(int k, int b) {
  return b * k * (int)(sizeof(L) + sizeof(V)) <= 256 ? k : 256 / (b * (int)(sizeof(L) + sizeof(V)));
}

// y at B points p, p + plane, ...: legs loaded group by group, every load
// of a group before its first FMA, legs summed in order.  MASK: leg k only
// where bit k of m is set (its neighbour lies in the grid).
template <int K, int B, bool MASK, typename L, typename V>
__device__ __forceinline__ void points(const L* __restrict__ legs, size_t n,
                                       const V* __restrict__ x, V* __restrict__ y, int p,
                                       int plane, const Plan& plan, int nl, unsigned m) {
  constexpr int KG = group<L, V>(K, B);
  V acc[B];
#pragma unroll
  for (int j = 0; j < B; ++j) acc[j] = V(0);
#pragma unroll
  for (int k0 = 0; k0 < K; k0 += KG) {
    L lv[B][KG];
    V xv[B][KG];
#pragma unroll
    for (int j = 0; j < B; ++j)
#pragma unroll
      for (int kk = 0; kk < KG; ++kk) {
        const int k = k0 + kk;
        lv[j][kk] = L(0.0f);
        xv[j][kk] = V(0);
        if (k < K && k < nl && (!MASK || ((m >> k) & 1u))) {
          lv[j][kk] = ld_leg(legs + (size_t)k * n + (p + j * plane));
          xv[j][kk] = __ldg(x + (p + j * plane + plan.off[k]));
        }
      }
#pragma unroll
    for (int j = 0; j < B; ++j)
#pragma unroll
      for (int kk = 0; kk < KG; ++kk) {
        const int k = k0 + kk;
        if (k < K && k < nl && (!MASK || ((m >> k) & 1u)))
          acc[j] = madd(to_acc(lv[j][kk]), xv[j][kk], acc[j]);
      }
  }
#pragma unroll
  for (int j = 0; j < B; ++j) y[p + j * plane] = acc[j];
}

template <typename L, typename V, int NL>
__global__ void __launch_bounds__(THREADS)
spmv_var_kernel(const L* __restrict__ legs, const V* __restrict__ x, V* __restrict__ y, int nz,
                int ny, int nx, const __grid_constant__ Plan plan) {
  constexpr int K = NL > 0 ? NL : MAX_LEGS;
  constexpr int B = batch<V>(K);
  static_assert(ZRUN % B == 0, "a full run is whole batches");
  const int nl = NL > 0 ? NL : plan.n;
  const int bx0 = blockIdx.x * blockDim.x, by0 = blockIdx.y * blockDim.y;
  const int z0 = blockIdx.z * ZRUN;
  const int ix = bx0 + threadIdx.x, iy = by0 + threadIdx.y;
  const bool interior = bx0 >= plan.hx && bx0 + (int)blockDim.x <= nx - plan.hx &&
                        by0 >= plan.hy && by0 + (int)blockDim.y <= ny - plan.hy &&
                        z0 >= plan.hz && z0 + ZRUN <= nz - plan.hz;
  if (ix >= nx || iy >= ny) return;
  const int plane = ny * nx;
  const size_t n = (size_t)plane * nz;
  int p = (z0 * ny + iy) * nx + ix;

  if (interior) {
    for (int j0 = 0; j0 < ZRUN; j0 += B, p += B * plane)
      points<K, B, false>(legs, n, x, y, p, plane, plan, nl, 0u);
    return;
  }
  // boundary block: a leg whose neighbour leaves the grid is not read
  unsigned mxy = 0;
#pragma unroll
  for (int k = 0; k < K; ++k)
    if (k < nl && (unsigned)(ix + plan.sx[k]) < (unsigned)nx &&
        (unsigned)(iy + plan.sy[k]) < (unsigned)ny)
      mxy |= 1u << k;
  const int zend = min(z0 + ZRUN, nz);
  for (int z = z0; z < zend; ++z, p += plane) {
    unsigned m = mxy;
    if (z == 0) m &= plan.zlo;
    if (z == nz - 1) m &= plan.zhi;
    points<K, 1, true>(legs, n, x, y, p, plane, plan, nl, m);
  }
}

template <typename L, typename V>
static int launch(int spec, const void* legs, const void* x, void* y, int nz, int ny, int nx,
                  const Plan& plan, cudaStream_t st) {
  // a 2-D grid arrives as (ny, 1, nx): one row of threads per block
  const dim3 block = ny == 1 ? dim3(nx > 128 ? 256 : (nx > 32 ? 128 : 32), 1, 1) : dim3(32, 8, 1);
  const dim3 grid((nx + block.x - 1) / block.x, (ny + block.y - 1) / block.y,
                  (nz + ZRUN - 1) / ZRUN);
  const L* l = (const L*)legs;
  const V* xv = (const V*)x;
  V* yv = (V*)y;
  switch (spec) {
    case 0: spmv_var_kernel<L, V, 0><<<grid, block, 0, st>>>(l, xv, yv, nz, ny, nx, plan); break;
    case 5: spmv_var_kernel<L, V, 5><<<grid, block, 0, st>>>(l, xv, yv, nz, ny, nx, plan); break;
    case 7: spmv_var_kernel<L, V, 7><<<grid, block, 0, st>>>(l, xv, yv, nz, ny, nx, plan); break;
    case 9: spmv_var_kernel<L, V, 9><<<grid, block, 0, st>>>(l, xv, yv, nz, ny, nx, plan); break;
    case 27: spmv_var_kernel<L, V, 27><<<grid, block, 0, st>>>(l, xv, yv, nz, ny, nx, plan); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// the wide kernel
// ---------------------------------------------------------------------------

#define WIDE_LEGS 3375  // 15^3: every shift of the halo-7 box
#define WIDE_HALO 7
#define WIDE_ZRUN 4            // z planes a thread marches where the runs fill the card
#define WIDE_THREADS 256       // threads of an unsplit block
#define WIDE_MAX_THREADS 1024  // threads of a split block
#define WIDE_RUN_GROUP 8       // legs per group of loads, unsplit
// design constants; scripts/stencil_tuning.py builds other values with -D
#ifndef WIDE_GROUP_BYTES
#define WIDE_GROUP_BYTES 128  // leg and x register bytes a split thread loads before its first FMA
#endif

// legs per group of loads: unsplit, WIDE_RUN_GROUP (the group's table
// entries stay in registers for the z run); split, WIDE_GROUP_BYTES of leg
// and x registers (a bf16 leg takes a 32-bit one), at most 32 (a group's
// mask is one 32-bit word)
template <typename L, typename V, bool SPLIT>
__host__ __device__ constexpr int wide_group() {
  constexpr int g = WIDE_GROUP_BYTES / (int)((sizeof(L) < 4 ? 4 : sizeof(L)) + sizeof(V));
  return !SPLIT ? WIDE_RUN_GROUP : (g < 1 ? 1 : (g > 32 ? 32 : g));
}

// one leg of the table: x = folded offset, y = (sz, sy, sx) as three
// signed bytes (bits 0-7, 8-15, 16-23)
__device__ __forceinline__ int shift_of(int packed, int byte) {
  return (int)(signed char)((packed >> (8 * byte)) & 0xff);
}

// bytes of the staged table, rounded up so the partials behind it align
__host__ __device__ __forceinline__ int wide_table_bytes(int nlegs) {
  return (nlegs * (int)sizeof(int2) + 15) / 16 * 16;
}

// blockDim = (bx, rows * split): thread (tx, ty) takes point (ix, iy) =
// (blockIdx.x * bx + tx, blockIdx.y * rows + ty % rows) and slice
// ty / rows of the leg list (SPLIT; else split is 1); ZR planes from
// z0 = blockIdx.z * ZR (ZR is 1 when split).
template <typename L, typename V, int ZR, bool SPLIT>
__global__ void __launch_bounds__(SPLIT ? WIDE_MAX_THREADS : WIDE_THREADS)
spmv_var_wide_kernel(const L* __restrict__ legs, const V* __restrict__ x, V* __restrict__ y,
                     const int2* __restrict__ table, int nlegs, int nz, int ny, int nx,
                     int rows) {
  static_assert(!SPLIT || ZR == 1, "a split launch takes one plane a thread");
  constexpr int G = wide_group<L, V, SPLIT>();
  // the leg table, staged once per block
  extern __shared__ __align__(16) unsigned char wide_smem[];
  int2* tab = reinterpret_cast<int2*>(wide_smem);
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  for (int k = tid; k < nlegs; k += blockDim.x * blockDim.y) tab[k] = __ldg(table + k);
  __syncthreads();

  const int split = SPLIT ? blockDim.y / rows : 1;
  const int s = SPLIT ? threadIdx.y / rows : 0, ty = threadIdx.y - s * rows;
  const int ix = blockIdx.x * blockDim.x + threadIdx.x;
  const int iy = blockIdx.y * rows + ty;
  const int z0 = blockIdx.z * ZR;
  const bool live = ix < nx && iy < ny && z0 < nz;
  const int nr = min(ZR, nz - z0);
  const int plane = ny * nx;
  const size_t n = (size_t)plane * nz;
  const int p0 = (z0 * ny + iy) * nx + ix;
  // this thread's slice of the legs, in order
  const int lo = (int)((long long)s * nlegs / split);
  const int hi = (int)((long long)(s + 1) * nlegs / split);
  V acc[ZR];
#pragma unroll
  for (int r = 0; r < ZR; ++r) acc[r] = V(0);
  if (live) {
#pragma unroll 1
    for (int k0 = lo; k0 < hi; k0 += G) {
      // the group's table entries and (y, x) test, once for the z run
      int off[G], sz[G];
      unsigned mxy = 0u;
#pragma unroll
      for (int j = 0; j < G; ++j) {
        off[j] = 0;
        sz[j] = 0;
        if (k0 + j < hi) {
          const int2 e = tab[k0 + j];
          off[j] = e.x;
          sz[j] = shift_of(e.y, 0);
          if ((unsigned)(iy + shift_of(e.y, 1)) < (unsigned)ny &&
              (unsigned)(ix + shift_of(e.y, 2)) < (unsigned)nx)
            mxy |= 1u << j;
        }
      }
#pragma unroll
      for (int r = 0; r < ZR; ++r) {
        if (r >= nr) break;
        const int p = p0 + r * plane;
        L lv[G];
        V xv[G];
        unsigned m = 0u;
#pragma unroll
        for (int j = 0; j < G; ++j) {
          lv[j] = L(0.0f);
          xv[j] = V(0);
          if (((mxy >> j) & 1u) && (unsigned)(z0 + r + sz[j]) < (unsigned)nz) {
            m |= 1u << j;
            lv[j] = ld_leg(legs + (size_t)(k0 + j) * n + p);
            xv[j] = __ldg(x + (p + off[j]));
          }
        }
#pragma unroll
        for (int j = 0; j < G; ++j)
          if ((m >> j) & 1u) acc[r] = madd(to_acc(lv[j]), xv[j], acc[r]);
      }
    }
  }
  if constexpr (SPLIT) {
    // the partials through shared memory, added in slice order
    V* part = reinterpret_cast<V*>(wide_smem + wide_table_bytes(nlegs));
    const int pts = blockDim.x * rows, q = ty * blockDim.x + threadIdx.x;
    part[s * pts + q] = acc[0];
    __syncthreads();
    if (s == 0 && live) {
      V t = part[q];
      for (int u = 1; u < split; ++u) t += part[u * pts + q];
      y[p0] = t;
    }
  } else if (live) {
#pragma unroll
    for (int r = 0; r < ZR; ++r)
      if (r < nr) y[p0 + r * plane] = acc[r];
  }
}

template <typename L, typename V>
static int launch_wide(const void* legs, const void* x, void* y, const int2* table, int nlegs,
                       int nz, int ny, int nx, int bx, int rows, int split, int zrun, dim3 grid,
                       cudaStream_t st) {
  const dim3 block(bx, rows * split, 1);
  const L* l = (const L*)legs;
  const V* xv = (const V*)x;
  V* yv = (V*)y;
  const size_t tab = wide_table_bytes(nlegs);
  if (split > 1)
    spmv_var_wide_kernel<L, V, 1, true><<<grid, block, tab + (size_t)bx * rows * split * sizeof(V),
                                           st>>>(l, xv, yv, table, nlegs, nz, ny, nx, rows);
  else if (zrun == 1)
    spmv_var_wide_kernel<L, V, 1, false><<<grid, block, tab, st>>>(l, xv, yv, table, nlegs, nz, ny,
                                                                  nx, rows);
  else
    spmv_var_wide_kernel<L, V, WIDE_ZRUN, false><<<grid, block, tab, st>>>(
        l, xv, yv, table, nlegs, nz, ny, nx, rows);
  return (int)cudaGetLastError();
}

extern "C" {

const char* cg_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// code: 0 fp32 legs / fp32 x, 1 bf16 legs / fp32 x, 2 fp64 legs / fp64 x.
// spec: the instantiation, nlegs itself for a specialised count (5, 7, 9,
// 27) or 0 for the generic one.  legs: (nlegs, nz, ny, nx) contiguous;
// shifts: nlegs (dz, dy, dx) triples, each component in {-1, 0, 1}.
int cg_spmv_var(int code, int spec, const void* legs, const void* x, void* y, int nz, int ny,
                int nx, int nlegs, const int* shifts, void* stream) {
  if (nlegs < 1 || nlegs > MAX_LEGS || nz < 1 || ny < 1 || nx < 1) return (int)cudaErrorInvalidValue;
  if (spec != 0 && spec != nlegs) return (int)cudaErrorInvalidValue;
  int sz[MAX_LEGS], sy[MAX_LEGS], sx[MAX_LEGS];
  for (int k = 0; k < nlegs; ++k) {
    sz[k] = shifts[3 * k + 0];
    sy[k] = shifts[3 * k + 1];
    sx[k] = shifts[3 * k + 2];
  }
  if (nz == 1) {  // march over rows: (1, ny, nx) -> (ny, 1, nx)
    nz = ny;
    ny = 1;
    for (int k = 0; k < nlegs; ++k) {
      const int t = sz[k];
      sz[k] = sy[k];
      sy[k] = t;
    }
  }
  const long long plane = (long long)ny * nx;
  if (plane * nz + (ZRUN + 2) * plane > INT_MAX || (nz + ZRUN - 1) / ZRUN > 65535)
    return (int)cudaErrorInvalidValue;
  Plan plan = {};
  plan.n = nlegs;
  for (int k = 0; k < nlegs; ++k) {
    plan.off[k] = (int)(sz[k] * plane + sy[k] * nx + sx[k]);
    plan.sy[k] = (signed char)sy[k];
    plan.sx[k] = (signed char)sx[k];
    if (sz[k] >= 0) plan.zlo |= 1u << k;
    if (sz[k] <= 0) plan.zhi |= 1u << k;
    plan.hz |= sz[k] != 0;
    plan.hy |= sy[k] != 0;
    plan.hx |= sx[k] != 0;
  }
  const cudaStream_t st = (cudaStream_t)stream;
  switch (code) {
    case FP32: return launch<float, float>(spec, legs, x, y, nz, ny, nx, plan, st);
    case BF16: return launch<__nv_bfloat16, float>(spec, legs, x, y, nz, ny, nx, plan, st);
    case FP64: return launch<double, double>(spec, legs, x, y, nz, ny, nx, plan, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The wide kernel.  code: as cg_spmv_var.  legs: (nlegs, nz, ny, nx)
// contiguous with 1 <= nlegs <= WIDE_LEGS, on the view the wrapper built
// (ops/cuda_stencil.py::wide_view: a 1-D or 2-D grid marches its rows as
// (1, 1, n) or (ny, 1, nx)); table: nlegs int2 entries on the device, each
// leg's folded offset and its (sz, sy, sx) bytes on that view, every
// component in [-WIDE_HALO, WIDE_HALO].  The launch is the wrapper's
// (ops/cuda_stencil.py::wide_geometry), which must cover the view exactly:
// (bx, rows) points a block, split slices of the leg list (1 <= split <=
// nlegs, bx * rows * split threads), zrun planes a thread (1, or WIDE_ZRUN
// at split 1), (gx, gy, gz) blocks.
int cg_spmv_var_wide(int code, const void* legs, const void* x, void* y, const void* table,
                     int nlegs, int nz, int ny, int nx, int bx, int rows, int split, int zrun,
                     int gx, int gy, int gz, void* stream) {
  if (nlegs < 1 || nlegs > WIDE_LEGS || nz < 1 || ny < 1 || nx < 1 || table == nullptr ||
      (zrun != 1 && zrun != WIDE_ZRUN) || split < 1 || split > nlegs ||
      (zrun != 1 && split != 1))
    return (int)cudaErrorInvalidValue;
  const long long threads = (long long)bx * rows * split;
  if (bx < 1 || rows < 1 || threads > (split > 1 ? WIDE_MAX_THREADS : WIDE_THREADS) ||
      gx != (nx + bx - 1) / bx || gy != (ny + rows - 1) / rows || gz != (nz + zrun - 1) / zrun ||
      gy > 65535 || gz > 65535)
    return (int)cudaErrorInvalidValue;
  const long long plane = (long long)ny * nx;
  if (plane * nz + (WIDE_HALO + 1) * plane > INT_MAX) return (int)cudaErrorInvalidValue;
  const int2* t = (const int2*)table;
  const dim3 grid(gx, gy, gz);
  const cudaStream_t st = (cudaStream_t)stream;
  switch (code) {
    case FP32:
      return launch_wide<float, float>(legs, x, y, t, nlegs, nz, ny, nx, bx, rows, split, zrun,
                                       grid, st);
    case BF16:
      return launch_wide<__nv_bfloat16, float>(legs, x, y, t, nlegs, nz, ny, nx, bx, rows, split,
                                               zrun, grid, st);
    case FP64:
      return launch_wide<double, double>(legs, x, y, t, nlegs, nz, ny, nx, bx, rows, split, zrun,
                                         grid, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"

// Hand-written Hopper (sm_90a) kernels for the MGCG Poisson path.
//
// Built by conjugategradient_tpu_torch/ops/_build.py into a shared library
// with a plain C interface and called through ctypes from
// conjugategradient_tpu_torch/ops/cuda_stencil.py, whose plain PyTorch
// twins (spmv_const_stencil_ref, cheb_smooth_const_ref) define what each
// kernel must compute.  Kernels launch on the caller's stream, allocate
// nothing and do not synchronise; each C entry returns cudaGetLastError().
//
// ---------------------------------------------------------------------------
// Kernel 1: const-stencil SpMV, y = sum_k c_k * shift_k(x), 1-D, 2-D and
//   3-D, fp32 and fp64.
//   Replaces conjugategradient_tpu/ops/pallas_stencil.py::_kernel (:127,
//   pallas_call at :152).
//   Bound on the H100: device-memory bandwidth.  The operator has no matrix
//   bytes (the coefficients travel in a __grid_constant__ plan), so the
//   minimum traffic is one read of x and one write of y: 132.7 MB at 255^3
//   in fp32, 0.0396 ms at 3.35 TB/s.  A 1023^2 grid (8.4 MB) lies in the
//   50 MB L2, where the launch, not HBM, bounds it.
//   The first design (one thread per point, a rolled loop over a by-value
//   struct of shifts, a bounds test and a 64-bit address per leg, the 2 * d
//   neighbour re-reads left to L1/L2) ran at 0.1752 ms (23% of the bound).
//   This one applies kernel 3's recipe with zero matrix bytes:
//   - Every grid runs on a 3-D view (ops/cuda_stencil.py::const_view): a
//     2-D grid (ny, nx) as (ny, 1, nx), so its rows are the marched axis; a
//     1-D grid as (1, 1, n) with one row of threads per block.
//   - The patterns the hierarchies produce are compile-time (P): the 1-D
//     3-point, the 2-D 5-point star and 9-point box, the 3-D 7-point star
//     and 27-point box, each in the order dia_to_stencil gives (the C entry
//     checks the wrapper's choice).  Other shift lists read theirs at run
//     time (P = 0) and keep their order.
//   - A thread owns an (x, y) column and marches a CONST_ZRUN-plane run in
//     z.  A pattern's thread loads every x value its run reads once, all
//     before the first FMA, into registers: the planes z0 - 1 .. z0 + ZR of
//     its column and the in-plane neighbours the pattern reads (need<P, ZR>,
//     a closed form so that every index is a compile-time constant), so the
//     7-point star loads 5.5 values per point instead of 7 and the 27-point
//     box 13.5 instead of 27.
//   - A block whose neighbourhood lies inside the grid (uniform over the
//     block) reads without a test.  A border block of a pattern fills the
//     same registers with each value tested against the grid: outside it
//     is 0 and never read, the zero that the twin's padding gives (no read
//     past the grid carries a NaN in: 0 * NaN = NaN, the reference's fault
//     92c5bd5).  The run-time pattern tests each leg in border blocks.
//   Measured (scripts/stencil_tuning.py; NVIDIA H100 80GB HBM3, 700.00 W):
//   255^3 7-point fp32 0.0551 ms (72% of the bound), fp64 0.0964 ms;
//   127^3 27-point 0.0123 / 0.0187 ms; 1023^2 5-point 0.0038 ms and the
//   1-D 3-point at 2^20 - 1 0.0039 ms, replayed from a CUDA graph.  A
//   shared tile of each plane with a one-point halo instead of L1 was tried
//   and lost for the star (0.0774 ms) and for the box (0.0175 ms), and was
//   removed; runs of 2 and 8 planes lost at 255^3 or 127^3.
//   The launch geometry is the wrapper's (ops/cuda_stencil.py::
//   const_geometry: the block, and the grid that covers the view with the
//   z run this library reports through cg_spmv_const_zrun).
//   Legs are summed in A.shifts order with an explicit fma, so the kernel
//   and its twin differ only by FMA contraction.  The TPU slab halos, the
//   8-row 2-D halo blocks and the Mosaic concat workaround have no
//   counterpart.
//
// Kernel 2: fused degree-d Chebyshev smoothing on D^-1 A (3-D), optionally
//   from a zero x0 and optionally emitting r = D^-1 (b - A x_out).
//   Replaces conjugategradient_tpu/ops/pallas_stencil.py::_cheb_kernel
//   (:288, pallas_call at :376); same schedule as
//   precond/smoothers.py::chebyshev_smooth.
//   Bound on the H100: device-memory traffic of the unfused form (about ten
//   full passes per degree step); fused, it reads b [and x0] and writes x
//   [and r] once, plus the halo overlap of the tiles.
//   Design: a z-marching wavefront (2.5-D tiling with temporal blocking).
//   The TPU slab spans whole planes and needs a z-halo only; a 255 x 255
//   fp32 plane (260 KB) is more than a block's 227 KB of shared memory.
//   The first design tiled all three axes with a halo of h on every face
//   (b read and every stage computed 2.5x at h = 2, four index-decoding
//   passes and three block barriers per degree step); this one keeps the
//   halo in x and y only:
//   - A block owns a TX x TY (x, y) column tile plus h on each side, one
//     thread per column of the extended tile, and marches a chunk of cz
//     planes in z from h planes before the chunk to h planes after it.
//     Planes outside the domain read 0 and are never loaded.
//   - The recurrence is a pipeline of NA stages, one per application of A
//     (A x0 for a given x0, then A d_k for each d the outputs need).
//     Stage s works on plane t - 2s while stage 0 loads plane t; it reads
//     its operand (x0 or d_k) at planes q - 1, q, q + 1 from a four-plane
//     ring in shared memory, written by stage s - 1 in earlier steps, and
//     writes the next operand into ring s.  Two planes of lag per stage
//     (not one) let a single __syncthreads() per plane step order every
//     ring write before its reads: the plane a stage writes is never one
//     that the next stage reads in the same step.
//   - The pointwise state (r and x of the plane a stage hands on) stays in
//     the owning thread's registers, a two-deep delay line per stage.
//   - b [and x0] for plane t + 1 are loaded into registers at the top of
//     step t, so the load is in flight across the barrier and the stages.
//   - Each thread's (x, y) is fixed for the whole march and z is the loop
//     counter: no per-element division.  Every extent is a compile-time
//     constant of the (degree, x0 given, residual) instantiation.
//   Erosion: a column on the tile's outer face has neighbours outside the
//   tile and skips each application (stale); a plane before the chunk's
//   first loaded plane reads the ring's initial zeros.  Either way the wrong
//   region grows by one point per application, and h >= NA applications
//   leave the interior tile of the chunk exact (h =
//   _cheb_halo(degree, zero_x, want_resid)).
//   Masking rule: a point outside the global domain must read as 0 at EVERY
//   application of A, not only at load time (recurrence state outside the
//   domain becomes nonzero after the first application; the reference's
//   fault e98533c).  The operands of A are x0, loaded as 0 outside the
//   domain, and d, written as 0 there each time it is produced, so every
//   application reads a literal 0 outside the domain without a check.
//   Out-of-domain points are never loaded from memory, so padding cannot
//   carry a NaN into the sum (0 * NaN = NaN; the reference's fault 92c5bd5).
//   The recurrence scalars are computed in double precision on the host and
//   passed as fp32, as _cheb_kernel does; the last r update is skipped when
//   no residual is wanted.  Each update keeps the twin's order: r = (b - A
//   x0) * invd, r -= invd * (A d), d = a_k d + b_k r, x += d.
// ---------------------------------------------------------------------------

#include <climits>
#include <cuda_runtime.h>

#define MAX_LEGS 27
#define MAX_DEGREE 5
#define THREADS 256
// kernel 1's design constant; scripts/stencil_tuning.py builds other values
// with -D (the wrapper reads it through cg_spmv_const_zrun)
#ifndef CONST_ZRUN
#define CONST_ZRUN 4  // planes a thread marches (1 for the 1-D 3-point pattern)
#endif
// kernel 2's design constants; scripts/stencil_tuning.py builds other
// values with -D (the wrapper's cheb_geometry mirrors the defaults)
#ifndef CHEB_TY
#define CHEB_TY 16  // interior tile rows for h <= 4 (8 above)
#endif
#ifndef CHEB_MINB
#define CHEB_MINB 2  // blocks per SM asked of ptxas for h <= 2
#endif

struct Legs {
  int n;
  float c[MAX_LEGS];
  signed char sz[MAX_LEGS];
  signed char sy[MAX_LEGS];
  signed char sx[MAX_LEGS];
};

struct Cheb {
  float theta;             // d_0 = r_0 / theta
  float a[MAX_DEGREE];     // d_{k+1} = a[k] * d_k + b[k] * r_{k+1}
  float b[MAX_DEGREE];
};

// the legs of kernel 2: z shift and the in-plane offset sy * EX + sx of the
// extended tile
struct TileLegs {
  int n;
  float c[MAX_LEGS];
  int sz[MAX_LEGS];
  int oxy[MAX_LEGS];
};

// Compile-time shifts of the standard patterns, in the order dia_to_stencil
// gives them (offsets ascending), on the kernels' 3-D view (z, y, x) of the
// grid (a 2-D grid (ny, nx) is viewed as (ny, 1, nx), a 1-D one as
// (1, 1, n)): P = 3, the 1-D 3-point; P = 5 and P = 9, the 2-D 5-point star
// and 9-point box; P = 7, the 3-D 7-point star of every rediscretized
// Poisson level; P = 27, the 27-point box of the const-detected Galerkin
// levels.  P = 0 reads the shifts at run time.
template <int P>
__host__ __device__ constexpr int pat_z(int k) {
  return P == 3   ? 0
         : P == 5 ? (k == 0 ? -1 : (k == 4 ? 1 : 0))
         : P == 9 ? k / 3 - 1
         : P == 7 ? (k == 0 ? -1 : (k == 6 ? 1 : 0))
                  : k / 9 - 1;
}
template <int P>
__host__ __device__ constexpr int pat_y(int k) {
  return (P == 3 || P == 5 || P == 9) ? 0
         : P == 7                     ? (k == 1 ? -1 : (k == 5 ? 1 : 0))
                                      : (k / 3) % 3 - 1;
}
template <int P>
__host__ __device__ constexpr int pat_x(int k) {
  return P == 3   ? k - 1
         : P == 5 ? (k == 1 ? -1 : (k == 3 ? 1 : 0))
         : P == 7 ? (k == 2 ? -1 : (k == 4 ? 1 : 0))
                  : k % 3 - 1;  // P = 9, 27
}

// Kernel 1's legs on the 3-D view: the coefficients in the state's type,
// and for the run-time pattern the shifts and their folded offsets
// (sz * ny * nx + sy * nx + sx).  hz, hy, hx: 1 where a shift moves along
// the axis (the depth of the border a block must clear to be interior).
template <typename T>
struct ConstPlan {
  int n;
  T c[MAX_LEGS];
  int off[MAX_LEGS];
  signed char sz[MAX_LEGS];
  signed char sy[MAX_LEGS];
  signed char sx[MAX_LEGS];
  int hz, hy, hx;
};

__device__ __forceinline__ float madd(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double madd(double a, double b, double c) { return fma(a, b, c); }

// True where some leg of pattern P reads in-plane neighbour (dy, dx) of the
// plane dq planes from the run's first, for some plane of a ZR-plane run, in
// closed form so that every use folds to a constant: the boxes read every
// neighbour of the planes -1 .. ZR (the 2-D box, on its (ny, 1, nx) view,
// only dy = 0); the stars read the centre of the planes -1 .. ZR and their
// in-plane arms on the run's own planes; the 1-D 3-point its one plane.
template <int P, int ZR>
__host__ __device__ constexpr bool need(int dq, int dy, int dx) {
  const bool run = dq >= 0 && dq < ZR, ends = dq >= -1 && dq <= ZR;
  return P == 27  ? ends
         : P == 9 ? dy == 0 && ends
         : P == 3 ? dy == 0 && run
         : (dy == 0 && dx == 0) ? ends
         : P == 5 ? dy == 0 && run
                  : (dy == 0 || dx == 0) && run;  // P = 7
}

template <int P>
__host__ __device__ constexpr int zrun_of() { return P == 3 ? 1 : CONST_ZRUN; }

// y = sum_k c_k * shift_k(x) on the 3-D view, a ZR-plane run in z per
// thread.  An interior block (every point's neighbourhood inside the grid)
// of a compile-time pattern loads each x value its run needs once, all
// before the first FMA: the planes z0 - 1 .. z0 + ZR of its own column and
// the in-plane neighbours the pattern reads, kept in registers (v), so a
// plane's centre value serves the z - 1, z and z + 1 legs of three points.
// A border block of a pattern fills the same registers, each value tested
// against the grid (0 outside, never read); a border block of the run-time
// pattern tests each leg.  Legs are summed in order with an explicit fma.
template <typename T, int P>
__global__ void __launch_bounds__(THREADS)
spmv_const_kernel(const T* __restrict__ x, T* __restrict__ y, int nz, int ny, int nx,
                  const __grid_constant__ ConstPlan<T> plan) {
  constexpr int ZR = zrun_of<P>();
  const int bx0 = blockIdx.x * blockDim.x, by0 = blockIdx.y * blockDim.y;
  const int z0 = blockIdx.z * ZR;
  const int ix = bx0 + threadIdx.x, iy = by0 + threadIdx.y;
  const bool interior = bx0 >= plan.hx && bx0 + (int)blockDim.x <= nx - plan.hx &&
                        by0 >= plan.hy && by0 + (int)blockDim.y <= ny - plan.hy &&
                        z0 >= plan.hz && z0 + ZR <= nz - plan.hz;
  if (ix >= nx || iy >= ny) return;
  const int plane = ny * nx;
  const int p0 = (z0 * ny + iy) * nx + ix;

  if constexpr (P > 0) {
    T v[ZR + 2][3][3];
    if (interior) {
#pragma unroll
      for (int q = 0; q < ZR + 2; ++q)
#pragma unroll
        for (int a = 0; a < 3; ++a)
#pragma unroll
          for (int b = 0; b < 3; ++b)
            if (need<P, ZR>(q - 1, a - 1, b - 1))
              v[q][a][b] = __ldg(x + (p0 + (q - 1) * plane + (a - 1) * nx + (b - 1)));
    } else {
      // border block: a neighbour outside the grid is not read; its leg
      // takes the 0 that the twin's zero padding gives
#pragma unroll
      for (int q = 0; q < ZR + 2; ++q)
#pragma unroll
        for (int a = 0; a < 3; ++a)
#pragma unroll
          for (int b = 0; b < 3; ++b)
            if (need<P, ZR>(q - 1, a - 1, b - 1)) {
              const bool in = (unsigned)(z0 + q - 1) < (unsigned)nz &&
                              (unsigned)(iy + a - 1) < (unsigned)ny &&
                              (unsigned)(ix + b - 1) < (unsigned)nx;
              v[q][a][b] = in ? __ldg(x + (p0 + (q - 1) * plane + (a - 1) * nx + (b - 1))) : T(0);
            }
    }
#pragma unroll
    for (int j = 0; j < ZR; ++j) {
      if (z0 + j < nz) {  // the last run of a ragged grid is short
        T acc = T(0);
#pragma unroll
        for (int k = 0; k < P; ++k)
          acc = madd(plan.c[k], v[j + pat_z<P>(k) + 1][pat_y<P>(k) + 1][pat_x<P>(k) + 1], acc);
        y[p0 + j * plane] = acc;
      }
    }
  } else {
    // the run-time pattern, legs read by index: each leg tested against
    // the grid, except in an interior block
    const int zend = min(z0 + ZR, nz);
    for (int z = z0, p = p0; z < zend; ++z, p += plane) {
      T acc = T(0);
#pragma unroll 4
      for (int k = 0; k < plan.n; ++k)
        if (interior || ((unsigned)(z + plan.sz[k]) < (unsigned)nz &&
                         (unsigned)(iy + plan.sy[k]) < (unsigned)ny &&
                         (unsigned)(ix + plan.sx[k]) < (unsigned)nx))
          acc = madd(plan.c[k], __ldg(x + (p + plan.off[k])), acc);
      y[p] = acc;
    }
  }
}

// Geometry of one (degree, x0 given, residual) instantiation of kernel 2;
// ops/cuda_stencil.py::cheb_geometry mirrors it and the C entry checks the
// two agree.
template <int DEG, bool X0, bool RES>
struct Wave {
  static constexpr int NA = (X0 ? 1 : 0) + DEG - 1 + (RES ? 1 : 0);  // applications of A
  static constexpr int H = DEG + ((X0 && RES) ? 1 : 0);               // _cheb_halo
  static constexpr int TX = 32, TY = H <= 4 ? CHEB_TY : 8;            // interior tile
  static constexpr int EX = TX + 2 * H, EY = TY + 2 * H, PL = EX * EY;
  static constexpr int NT = PL;                                       // one thread per column
  static constexpr int MINB = H <= 2 ? CHEB_MINB : 1;
  static constexpr size_t SMEM = (size_t)NA * 4 * PL * sizeof(float);
  static constexpr int M = NA > 0 ? NA : 1;
};

// Kernel 2 takes the 3-D patterns P = 7 and P = 27 of pat_z/pat_y/pat_x;
// P = 0 reads the shifts from TileLegs.
template <int DEG, bool X0, bool RES, int P>
__global__ void __launch_bounds__(Wave<DEG, X0, RES>::NT, Wave<DEG, X0, RES>::MINB)
cheb_const_kernel(const float* __restrict__ b, const float* __restrict__ x0,
                  const float* __restrict__ invd_ptr, float* __restrict__ x_out,
                  float* __restrict__ r_out, int nz, int ny, int nx, int cz,
                  const __grid_constant__ TileLegs legs, const __grid_constant__ Cheb ch) {
  using W = Wave<DEG, X0, RES>;
  constexpr int NA = W::NA, H = W::H, EX = W::EX, EY = W::EY, PL = W::PL, M = W::M;
  extern __shared__ float ring[];  // [NA][4][PL]: operand of stage s + 1, plane q at slot q & 3
  const int tid = threadIdx.x;
  const int tx = tid % EX, ty = tid / EX;
  const int gx = blockIdx.x * W::TX - H + tx, gy = blockIdx.y * W::TY - H + ty;
  const bool inxy = (unsigned)gx < (unsigned)nx && (unsigned)gy < (unsigned)ny;
  const bool face = tx == 0 || tx == EX - 1 || ty == 0 || ty == EY - 1;
  const bool own = inxy && tx >= H && tx < EX - H && ty >= H && ty < EY - H;
  const int plane = ny * nx;
  const int col = gy * nx + gx;  // used only where inxy
  const int z0 = blockIdx.z * cz, z1 = min(z0 + cz, nz);
  const int zload = min(z1 + H, nz);  // planes [z0 - H, zload) are loaded
  const float invd = *invd_ptr;

  for (int i = tid; i < NA * 4 * PL; i += W::NT) ring[i] = 0.0f;

  // the pointwise (r, x) each stage hands on: [0] from the last step, [1]
  // from the one before, which the next stage (two planes behind) takes
  float r1[M], x1[M], r2[M], x2[M];
#pragma unroll
  for (int s = 0; s < M; ++s) r1[s] = x1[s] = r2[s] = x2[s] = 0.0f;

  float nb = 0.0f, nx0 = 0.0f;
  auto load = [&](int t) {
    nb = 0.0f;
    nx0 = 0.0f;
    if (inxy && t >= 0 && t < zload) {
      nb = __ldg(b + (t * plane + col));
      if (X0) nx0 = __ldg(x0 + (t * plane + col));
    }
  };
  load(z0 - H);
  const int tend = z1 - 1 + 2 * NA;
  for (int t = z0 - H; t <= tend; ++t) {
    const float cb = nb, cx = nx0;
    load(t + 1);
    __syncthreads();  // ring writes of the earlier steps are visible; their reads are done
    float nr[M], nxv[M];
    {  // stage 0: plane t
      const bool in = inxy && (unsigned)t < (unsigned)nz;
      float r, x;
      if (X0) {
        r = cb;  // b, scaled by stage 1
        x = cx;
        if (NA > 0) ring[(t & 3) * PL + tid] = cx;
      } else {
        r = invd * cb;
        const float d = in ? r / ch.theta : 0.0f;
        x = d;
        if (NA > 0) ring[(t & 3) * PL + tid] = d;
      }
      if (NA == 0) {
        if (own && t >= z0 && t < z1) x_out[t * plane + col] = x;
      } else {
        nr[0] = r;
        nxv[0] = x;
      }
    }
#pragma unroll
    for (int s = 1; s <= NA; ++s) {  // stage s: application s of A, at plane t - 2s
      const int q = t - 2 * s;
      const bool in = inxy && (unsigned)q < (unsigned)nz;
      const float* R = ring + (s - 1) * 4 * PL + tid;
      float a = 0.0f;
      if (!face) {
        if constexpr (P == 0) {
#pragma unroll
          for (int k = 0; k < MAX_LEGS; ++k)
            if (k < legs.n) a += legs.c[k] * R[((q + legs.sz[k]) & 3) * PL + legs.oxy[k]];
        } else {  // the plane of each leg and its in-plane offset are constants
          const float* Z[3] = {R + ((q - 1) & 3) * PL, R + (q & 3) * PL, R + ((q + 1) & 3) * PL};
#pragma unroll
          for (int k = 0; k < P; ++k)
            a += legs.c[k] * Z[pat_z<P>(k) + 1][pat_y<P>(k) * EX + pat_x<P>(k)];
        }
      }
      float r = r2[s - 1], x = x2[s - 1];
      float* next = ring + s * 4 * PL + (q & 3) * PL + tid;
      if (X0 && s == 1) {  // r_0 = D^-1 (b - A x0), d_0 = r_0 / theta, x = x0 + d_0
        if (!face) r -= a;
        r *= invd;
        const float d = in ? r / ch.theta : 0.0f;
        x += d;
        if (s < NA) *next = d;
      } else {  // application of d_k
        const int k = s - 1 - (X0 ? 1 : 0);
        if (!face) r -= invd * a;
        if (k < DEG - 1) {
          const float d = in ? ch.a[k] * R[(q & 3) * PL] + ch.b[k] * r : 0.0f;
          x += d;
          if (s < NA) *next = d;
        }
      }
      if (s < NA) {
        nr[s] = r;
        nxv[s] = x;
      } else if (own && q >= z0 && q < z1) {
        x_out[q * plane + col] = x;
        if (RES) r_out[q * plane + col] = r;
      }
    }
#pragma unroll
    for (int s = 0; s < NA; ++s) {
      r2[s] = r1[s];
      x2[s] = x1[s];
      r1[s] = nr[s];
      x1[s] = nxv[s];
    }
  }
}

template <int P>
static bool is_pattern(const Legs& legs) {
  if (legs.n != P) return false;
  for (int k = 0; k < P; ++k)
    if (legs.sz[k] != pat_z<P>(k) || legs.sy[k] != pat_y<P>(k) || legs.sx[k] != pat_x<P>(k))
      return false;
  return true;
}

template <int DEG, bool X0, bool RES>
static int launch_cheb(const float* b, const float* x0, const float* invd, float* x_out,
                       float* r_out, int nz, int ny, int nx, int h, int tx, int ty, int cz,
                       const Legs& legs, const Cheb& ch, cudaStream_t stream) {
  using W = Wave<DEG, X0, RES>;
  if (h != W::H || tx != W::TX || ty != W::TY) return (int)cudaErrorInvalidValue;
  TileLegs tl = {};
  tl.n = legs.n;
  for (int k = 0; k < legs.n; ++k) {
    tl.c[k] = legs.c[k];
    tl.sz[k] = legs.sz[k];
    tl.oxy[k] = legs.sy[k] * W::EX + legs.sx[k];
  }
  const int pattern = is_pattern<7>(legs) ? 7 : (is_pattern<27>(legs) ? 27 : 0);
  auto kernel = pattern == 7    ? cheb_const_kernel<DEG, X0, RES, 7>
                : pattern == 27 ? cheb_const_kernel<DEG, X0, RES, 27>
                                : cheb_const_kernel<DEG, X0, RES, 0>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)W::SMEM);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((nx + W::TX - 1) / W::TX, (ny + W::TY - 1) / W::TY, (nz + cz - 1) / cz);
  kernel<<<grid, W::NT, W::SMEM, stream>>>(b, x0, invd, x_out, r_out, nz, ny, nx, cz, tl, ch);
  return (int)cudaGetLastError();
}

static int fill_legs(Legs* legs, int nlegs, const float* coeffs, const int* shifts) {
  if (nlegs < 1 || nlegs > MAX_LEGS) return (int)cudaErrorInvalidValue;
  legs->n = nlegs;
  for (int k = 0; k < nlegs; ++k) {
    legs->c[k] = coeffs[k];
    legs->sz[k] = (signed char)shifts[3 * k + 0];
    legs->sy[k] = (signed char)shifts[3 * k + 1];
    legs->sx[k] = (signed char)shifts[3 * k + 2];
  }
  return 0;
}

enum Code { FP32 = 0, FP64 = 2 };

template <int P>
static bool const_pattern(int nlegs, const int* shifts) {
  if (nlegs != P) return false;
  for (int k = 0; k < P; ++k)
    if (shifts[3 * k] != pat_z<P>(k) || shifts[3 * k + 1] != pat_y<P>(k) ||
        shifts[3 * k + 2] != pat_x<P>(k))
      return false;
  return true;
}

template <typename T>
static int launch_const(int spec, const void* x, void* y, int nz, int ny, int nx, int nlegs,
                        const double* coeffs, const int* shifts, dim3 grid, dim3 block,
                        cudaStream_t st) {
  ConstPlan<T> plan = {};
  plan.n = nlegs;
  const long long plane = (long long)ny * nx;
  for (int k = 0; k < nlegs; ++k) {
    const int sz = shifts[3 * k], sy = shifts[3 * k + 1], sx = shifts[3 * k + 2];
    plan.c[k] = (T)coeffs[k];
    plan.off[k] = (int)(sz * plane + sy * nx + sx);
    plan.sz[k] = (signed char)sz;
    plan.sy[k] = (signed char)sy;
    plan.sx[k] = (signed char)sx;
    plan.hz |= sz != 0;
    plan.hy |= sy != 0;
    plan.hx |= sx != 0;
  }
  const T* xv = (const T*)x;
  T* yv = (T*)y;
  switch (spec) {
    case 0: spmv_const_kernel<T, 0><<<grid, block, 0, st>>>(xv, yv, nz, ny, nx, plan); break;
    case 3: spmv_const_kernel<T, 3><<<grid, block, 0, st>>>(xv, yv, nz, ny, nx, plan); break;
    case 5: spmv_const_kernel<T, 5><<<grid, block, 0, st>>>(xv, yv, nz, ny, nx, plan); break;
    case 7: spmv_const_kernel<T, 7><<<grid, block, 0, st>>>(xv, yv, nz, ny, nx, plan); break;
    case 9: spmv_const_kernel<T, 9><<<grid, block, 0, st>>>(xv, yv, nz, ny, nx, plan); break;
    case 27: spmv_const_kernel<T, 27><<<grid, block, 0, st>>>(xv, yv, nz, ny, nx, plan); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" {

const char* cg_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// Kernel 1's z run for pattern spec: the planes a thread marches, a
// compile-time constant of the library (the wrapper's geometry covers the
// view with it)
int cg_spmv_const_zrun(int spec) { return spec == 3 ? zrun_of<3>() : zrun_of<0>(); }

// Kernel 1.  code: 0 fp32, 2 fp64.  (nz, ny, nx): the 3-D view of the grid
// (ops/cuda_stencil.py::const_view); shifts: nlegs (dz, dy, dx) triples on
// it, each component in {-1, 0, 1}; coeffs: nlegs values, cast to the
// state's type here.  spec: the pattern (3, 5, 7, 9, 27; the shifts must be
// exactly its own) or 0 for the run-time one.  (bx, by) threads a block and
// (gx, gy, gz) blocks: the wrapper's geometry, which must cover the view
// (gz runs of cg_spmv_const_zrun(spec) planes).
int cg_spmv_const(int code, int spec, const void* x, void* y, int nz, int ny, int nx,
                  int nlegs, const double* coeffs, const int* shifts, int bx, int by, int gx,
                  int gy, int gz, void* stream) {
  if (nlegs < 1 || nlegs > MAX_LEGS || nz < 1 || ny < 1 || nx < 1) return (int)cudaErrorInvalidValue;
  for (int i = 0; i < 3 * nlegs; ++i)
    if (shifts[i] < -1 || shifts[i] > 1) return (int)cudaErrorInvalidValue;
  const bool pattern_ok = spec == 0 || (spec == 3 && const_pattern<3>(nlegs, shifts)) ||
                          (spec == 5 && const_pattern<5>(nlegs, shifts)) ||
                          (spec == 7 && const_pattern<7>(nlegs, shifts)) ||
                          (spec == 9 && const_pattern<9>(nlegs, shifts)) ||
                          (spec == 27 && const_pattern<27>(nlegs, shifts));
  if (!pattern_ok) return (int)cudaErrorInvalidValue;
  const long long zr = cg_spmv_const_zrun(spec), plane = (long long)ny * nx;
  if (bx < 1 || by < 1 || bx * by > THREADS || gx < 1 || gy < 1 || gz < 1 || gy > 65535 ||
      gz > 65535 || (long long)gx * bx < nx || (long long)gy * by < ny || gz * zr < nz ||
      plane * nz + (zr + 2) * plane > INT_MAX)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(gx, gy, gz), block(bx, by, 1);
  const cudaStream_t st = (cudaStream_t)stream;
  switch (code) {
    case FP32: return launch_const<float>(spec, x, y, nz, ny, nx, nlegs, coeffs, shifts, grid, block, st);
    case FP64: return launch_const<double>(spec, x, y, nz, ny, nx, nlegs, coeffs, shifts, grid, block, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// x0 == NULL: zero initial guess; r_out == NULL: no residual output.
// alpha/beta: degree - 1 recurrence coefficients each.  (h, tx, ty, cz):
// halo, interior tile and z chunk of ops/cuda_stencil.py::cheb_geometry; the
// entry refuses a halo or tile that is not the instantiation's own.
int cg_cheb_const(const float* b, const float* x0, const float* invd, float* x_out,
                  float* r_out, int nz, int ny, int nx, int nlegs, const float* coeffs,
                  const int* shifts, int degree, int h, int tx, int ty, int cz, float theta,
                  const float* alpha, const float* beta, void* stream) {
  Legs legs;
  int err = fill_legs(&legs, nlegs, coeffs, shifts);
  if (err) return err;
  if (degree < 1 || degree > MAX_DEGREE || cz < 1 || nz < 1 || ny < 1 || nx < 1 ||
      (long long)nz * ny * nx > INT_MAX || (nz + cz - 1) / cz > 65535)
    return (int)cudaErrorInvalidValue;
  Cheb ch;
  ch.theta = theta;
  for (int k = 0; k < MAX_DEGREE; ++k) {
    ch.a[k] = k < degree - 1 ? alpha[k] : 0.0f;
    ch.b[k] = k < degree - 1 ? beta[k] : 0.0f;
  }
  const cudaStream_t st = (cudaStream_t)stream;
  const int variant = (degree - 1) * 4 + (x0 != nullptr) * 2 + (r_out != nullptr);
#define CHEB_CASE(D, X, R)                                                                     \
  case (D - 1) * 4 + X * 2 + R:                                                                \
    return launch_cheb<D, (X != 0), (R != 0)>(b, x0, invd, x_out, r_out, nz, ny, nx, h, tx, ty, cz, legs, ch, \
                                st);
#define CHEB_DEGREE(D) CHEB_CASE(D, 0, 0) CHEB_CASE(D, 0, 1) CHEB_CASE(D, 1, 0) CHEB_CASE(D, 1, 1)
  switch (variant) {
    CHEB_DEGREE(1)
    CHEB_DEGREE(2)
    CHEB_DEGREE(3)
    CHEB_DEGREE(4)
    CHEB_DEGREE(5)
    default: return (int)cudaErrorInvalidValue;
  }
#undef CHEB_DEGREE
#undef CHEB_CASE
}

}  // extern "C"

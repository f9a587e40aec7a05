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
// Kernel 1: const-stencil SpMV, y = sum_k c_k * shift_k(x), 2-D and 3-D.
//   Replaces conjugategradient_tpu/ops/pallas_stencil.py::_kernel (:127,
//   pallas_call at :152).
//   Bound on the H100: device-memory bandwidth.  The operator has no matrix
//   bytes (coefficients and shifts travel by value in a <= 27-leg struct),
//   so the minimum traffic is one read of x and one write of y, 8 B per row.
//   Design: one thread per output point, x fastest (a warp reads 32
//   consecutive floats of each leg's window); the 2*d neighbour re-reads are
//   left to L1/L2.  A 2-D grid (L, nx) runs as a 3-D grid (1, L, nx).
//   Measured at 255^3 (NVIDIA H100 80GB HBM3, 700.00 W) it moves the
//   minimum 133 MB at ~0.77 TB/s effective;
//   unrolling the leg loop over the struct's capacity made it slower
//   (0.195 vs 0.174 ms), so the loop stays rolled.
//   Legs are summed in A.shifts order, as _kernel does, so the kernel and
//   its twin differ only by FMA contraction.  The TPU slab halos, the 8-row
//   2-D halo blocks and the Mosaic concat workaround have no counterpart.
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

__device__ __forceinline__ bool inside(int z, int y, int x, int nz, int ny, int nx) {
  return z >= 0 && z < nz && y >= 0 && y < ny && x >= 0 && x < nx;
}

__global__ void spmv_const_kernel(const float* __restrict__ x, float* __restrict__ y,
                                  int nz, int ny, int nx, Legs legs) {
  const int ix = blockIdx.x * blockDim.x + threadIdx.x;
  const int iy = blockIdx.y * blockDim.y + threadIdx.y;
  const int iz = blockIdx.z;
  if (ix >= nx || iy >= ny) return;
  float acc = 0.0f;
  for (int k = 0; k < legs.n; ++k) {
    const int jz = iz + legs.sz[k], jy = iy + legs.sy[k], jx = ix + legs.sx[k];
    float v = 0.0f;
    if (inside(jz, jy, jx, nz, ny, nx)) v = x[((long long)jz * ny + jy) * nx + jx];
    acc += legs.c[k] * v;
  }
  y[((long long)iz * ny + iy) * nx + ix] = acc;
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

// Compile-time shifts of the two standard patterns, in the order
// dia_to_stencil gives them (offsets ascending): P = 7, the 7-point star of
// every rediscretized Poisson level; P = 27, the 27-point box of the
// const-detected Galerkin levels.  P = 0 reads the shifts from TileLegs.
template <int P>
__host__ __device__ constexpr int pat_z(int k) {
  return P == 7 ? (k == 0 ? -1 : (k == 6 ? 1 : 0)) : k / 9 - 1;
}
template <int P>
__host__ __device__ constexpr int pat_y(int k) {
  return P == 7 ? (k == 1 ? -1 : (k == 5 ? 1 : 0)) : (k / 3) % 3 - 1;
}
template <int P>
__host__ __device__ constexpr int pat_x(int k) {
  return P == 7 ? (k == 2 ? -1 : (k == 4 ? 1 : 0)) : k % 3 - 1;
}

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

extern "C" {

const char* cg_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// shifts: nlegs (dz, dy, dx) triples, each component in {-1, 0, 1}
int cg_spmv_const(const float* x, float* y, int nz, int ny, int nx, int nlegs,
                  const float* coeffs, const int* shifts, void* stream) {
  Legs legs;
  int err = fill_legs(&legs, nlegs, coeffs, shifts);
  if (err) return err;
  const dim3 block(32, 8, 1);
  const dim3 grid((nx + 31) / 32, (ny + 7) / 8, nz);
  spmv_const_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(x, y, nz, ny, nx, legs);
  return (int)cudaGetLastError();
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

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
//   Measured at 255^3 it moves the minimum 133 MB at ~0.77 TB/s effective;
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
//   full passes per degree step); fused, it reads b [and x] and writes x
//   [and r] once, plus the halo overlap of the tiles.
//   Tile and halo: the TPU slab spans whole planes and only needs a z-halo,
//   but a 255 x 255 fp32 plane (260 KB) is more than a block's 227 KB of
//   shared memory, so all three axes are tiled.  Each block owns an
//   8 x 8 x 32 (z, y, x) interior tile and loads it with a halo of
//   h = _cheb_halo(degree, zero_x, want_resid) on EVERY face: degree, or
//   degree + 1 for a given x0 with residual output.  The points on the
//   tile's outer face have neighbours outside the tile; they skip each
//   application of A and go stale, so the valid region erodes by one point
//   per face per application, and h applications on the deepest path leave
//   the interior exact.  The kernel is templated on h, so every tile extent
//   is a compile-time constant and the index arithmetic is cheap.  Three
//   tile arrays (x, r, d; b is loaded straight into r) take
//   3 * (8+2h)(8+2h)(32+2h) * 4 B: 62 KB at h = 2, 211 KB at h = 6, hence
//   MAX_DEGREE = 5 and the dynamic shared-memory opt-in.
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
//   no residual is wanted.
// ---------------------------------------------------------------------------

#include <cuda_runtime.h>

#define MAX_LEGS 27
#define MAX_DEGREE 5

#define TX 32
#define TY 8
#define TZ 8
#define CHEB_THREADS 256

struct Legs {
  int n;
  float c[MAX_LEGS];
  signed char sz[MAX_LEGS];
  signed char sy[MAX_LEGS];
  signed char sx[MAX_LEGS];
};

struct Cheb {
  int degree;
  float theta;             // d_0 = r_0 / theta
  float a[MAX_DEGREE];     // d_{k+1} = a[k] * d_k + b[k] * r_{k+1}
  float b[MAX_DEGREE];
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

// Tile geometry for halo H; every extent is a compile-time constant, so the
// index arithmetic below is multiply-shift, not division.
template <int H>
struct Tile {
  static constexpr int EX = TX + 2 * H, EY = TY + 2 * H, EZ = TZ + 2 * H;
  static constexpr int E = EX * EY * EZ;
};

// (A s)[i] at a tile point whose neighbours all lie in the tile.  s is zero
// at every out-of-domain point (the masking invariant), so no check is needed.
__device__ __forceinline__ float apply_tile(const float* s, int i, const int* off,
                                            const Legs& legs) {
  float acc = 0.0f;
#pragma unroll
  for (int k = 0; k < MAX_LEGS; ++k)
    if (k < legs.n) acc += legs.c[k] * s[i + off[k]];
  return acc;
}

template <int H>
__global__ void __launch_bounds__(CHEB_THREADS)
cheb_const_kernel(const float* __restrict__ b, const float* __restrict__ x0,
                  const float* __restrict__ invd_ptr, float* __restrict__ x_out,
                  float* __restrict__ r_out, int nz, int ny, int nx, Legs legs, Cheb ch) {
  using T = Tile<H>;
  extern __shared__ float smem[];
  float* sx = smem;
  float* sr = smem + T::E;
  float* sd = smem + 2 * T::E;
  const int gx0 = blockIdx.x * TX - H, gy0 = blockIdx.y * TY - H, gz0 = blockIdx.z * TZ - H;
  const float invd = *invd_ptr;
  const bool zero_x = (x0 == nullptr);
  const bool want_resid = (r_out != nullptr);
  int off[MAX_LEGS];
#pragma unroll
  for (int k = 0; k < MAX_LEGS; ++k)
    off[k] = k < legs.n ? (legs.sz[k] * T::EY + legs.sy[k]) * T::EX + legs.sx[k] : 0;

  // load b into r and x0 into x; out-of-domain points are set to 0, not loaded
  for (int i = threadIdx.x; i < T::E; i += CHEB_THREADS) {
    const int px = i % T::EX, py = (i / T::EX) % T::EY, pz = i / (T::EX * T::EY);
    const int gz = gz0 + pz, gy = gy0 + py, gx = gx0 + px;
    const bool in = inside(gz, gy, gx, nz, ny, nx);
    const long long g = ((long long)gz * ny + gy) * nx + gx;
    sr[i] = in ? b[g] : 0.0f;
    sx[i] = (in && !zero_x) ? x0[g] : 0.0f;
  }
  __syncthreads();

  // r = D^-1 (b - A x0) (or D^-1 b), d = r / theta, zero outside the domain.
  // Points on the tile's outer face have neighbours outside the tile: they
  // skip the application and go stale (the erosion the halo pays for).
  for (int i = threadIdx.x; i < T::E; i += CHEB_THREADS) {
    const int px = i % T::EX, py = (i / T::EX) % T::EY, pz = i / (T::EX * T::EY);
    const bool face = px == 0 || px == T::EX - 1 || py == 0 || py == T::EY - 1 ||
                      pz == 0 || pz == T::EZ - 1;
    const bool in = inside(gz0 + pz, gy0 + py, gx0 + px, nz, ny, nx);
    float r = sr[i];
    if (!zero_x && !face) r -= apply_tile(sx, i, off, legs);
    r *= invd;
    sr[i] = r;
    sd[i] = in ? r / ch.theta : 0.0f;
  }
  __syncthreads();

  for (int k = 0; k < ch.degree; ++k) {
    const bool last = (k == ch.degree - 1);
    const bool update_r = !(last && !want_resid);
    for (int i = threadIdx.x; i < T::E; i += CHEB_THREADS) {
      sx[i] += sd[i];
      if (update_r) {
        const int px = i % T::EX, py = (i / T::EX) % T::EY, pz = i / (T::EX * T::EY);
        const bool face = px == 0 || px == T::EX - 1 || py == 0 || py == T::EY - 1 ||
                          pz == 0 || pz == T::EZ - 1;
        if (!face) sr[i] -= invd * apply_tile(sd, i, off, legs);
      }
    }
    if (!last) {
      __syncthreads();  // every read of d by the application is done
      for (int i = threadIdx.x; i < T::E; i += CHEB_THREADS) {
        const int px = i % T::EX, py = (i / T::EX) % T::EY, pz = i / (T::EX * T::EY);
        const bool in = inside(gz0 + pz, gy0 + py, gx0 + px, nz, ny, nx);
        sd[i] = in ? ch.a[k] * sd[i] + ch.b[k] * sr[i] : 0.0f;
      }
      __syncthreads();
    }
  }
  __syncthreads();

  // the interior tile is exact: write its in-domain points
  for (int i = threadIdx.x; i < TX * TY * TZ; i += CHEB_THREADS) {
    const int px = i % TX, py = (i / TX) % TY, pz = i / (TX * TY);
    const int gz = gz0 + H + pz, gy = gy0 + H + py, gx = gx0 + H + px;
    if (!inside(gz, gy, gx, nz, ny, nx)) continue;
    const int s = ((pz + H) * T::EY + (py + H)) * T::EX + (px + H);
    const long long g = ((long long)gz * ny + gy) * nx + gx;
    x_out[g] = sx[s];
    if (want_resid) r_out[g] = sr[s];
  }
}

template <int H>
static int launch_cheb(const float* b, const float* x0, const float* invd, float* x_out,
                       float* r_out, int nz, int ny, int nx, const Legs& legs, const Cheb& ch,
                       cudaStream_t stream) {
  const size_t smem = 3 * (size_t)Tile<H>::E * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(cheb_const_kernel<H>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((nx + TX - 1) / TX, (ny + TY - 1) / TY, (nz + TZ - 1) / TZ);
  cheb_const_kernel<H><<<grid, CHEB_THREADS, smem, stream>>>(b, x0, invd, x_out, r_out, nz,
                                                             ny, nx, legs, ch);
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
// alpha/beta: degree - 1 recurrence coefficients each.
int cg_cheb_const(const float* b, const float* x0, const float* invd, float* x_out,
                  float* r_out, int nz, int ny, int nx, int nlegs, const float* coeffs,
                  const int* shifts, int degree, int h, float theta, const float* alpha,
                  const float* beta, void* stream) {
  Legs legs;
  int err = fill_legs(&legs, nlegs, coeffs, shifts);
  if (err) return err;
  if (degree < 1 || degree > MAX_DEGREE || h < degree || h > MAX_DEGREE + 1)
    return (int)cudaErrorInvalidValue;
  Cheb ch;
  ch.degree = degree;
  ch.theta = theta;
  for (int k = 0; k < MAX_DEGREE; ++k) {
    ch.a[k] = k < degree - 1 ? alpha[k] : 0.0f;
    ch.b[k] = k < degree - 1 ? beta[k] : 0.0f;
  }
  const cudaStream_t st = (cudaStream_t)stream;
  switch (h) {
    case 1: return launch_cheb<1>(b, x0, invd, x_out, r_out, nz, ny, nx, legs, ch, st);
    case 2: return launch_cheb<2>(b, x0, invd, x_out, r_out, nz, ny, nx, legs, ch, st);
    case 3: return launch_cheb<3>(b, x0, invd, x_out, r_out, nz, ny, nx, legs, ch, st);
    case 4: return launch_cheb<4>(b, x0, invd, x_out, r_out, nz, ny, nx, legs, ch, st);
    case 5: return launch_cheb<5>(b, x0, invd, x_out, r_out, nz, ny, nx, legs, ch, st);
    case 6: return launch_cheb<6>(b, x0, invd, x_out, r_out, nz, ny, nx, legs, ch, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"

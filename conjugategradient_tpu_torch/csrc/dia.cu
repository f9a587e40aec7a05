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
//   Offsets travel by value, at most MAX_DIAGS = 256 a launch (band 160 has
//   159).  Legs are summed in A.offsets order with an explicit fma, so the
//   kernel and its twin differ only by FMA contraction, and SpMM column j
//   equals the SpMV of column j bit for bit.
//   More than MAX_DIAGS diagonals (a Galerkin level of a DIA-layout
//   hierarchy carries 343 or 1331; a loaded band may carry any number):
//   the wrapper (ops/cuda_dia.py::dia_groups) cuts A.offsets into
//   consecutive groups of at most MAX_DIAGS legs and launches once per
//   group, as the JAX package chains its groups of 32 diagonals through
//   y_in.  Every launch after the first passes accumulate = 1: each thread
//   starts its sum from the y[i] the previous launch wrote (the same type as
//   its accumulator) and goes on fma by fma, so the chained result takes its
//   legs in the same order, term by term, as one pass and as the twin.  The
//   fused p.Ap is taken by the last group's launch only.  A launch of up to
//   MAX_DIAGS diagonals (every band-160 launch) is the single launch it was.
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
//   runs larger or odd k in chunks.  Instantiations as kernel 4's: fp32,
//   bf16 legs with fp32 columns, and fp64.
//   Bound on the H100: device-memory bandwidth, the legs (132 MB fp32 at
//   the flagship) and X and Y once each: 138.5 MB at k = 4, 0.0413 ms.
//   The first design (one thread per row, a two-leg unrolled loop with a
//   bounds branch per leg) kept about two coefficient loads in flight per
//   thread and ran at 0.0838 ms (49%).  This one:
//   - A block of SPMM_THREADS rows whose rows all have every diagonal
//     inside [0, n) takes a path without tests; the others skip a leg whose
//     neighbour leaves [0, n) and never read it.
//   - The coefficient stream is software-pipelined in registers: the next
//     batch of B coefficients (__ldcs, evict-first, so they do not push X
//     out of L1) is loaded before the FMAs of this one.  B is SPMM_LEGS = 16
//     for fp32 legs with K <= 4 on more than 16 legs, else SPMM_LEGS_SHORT
//     = 8 (K = 8 and bf16 and fp64 legs ran as fast or faster with it).
//   - Where a leg reads at least 32 bytes of X per row (fp32 K = 8, fp64
//     K >= 4) or eight times its coefficient's bytes (bf16 legs, K >= 4),
//     and the band spans at most SPMM_SPAN = 1024 rows, the block first
//     stages its X window in shared memory (spmm_dia_kernel_stage), where a
//     warp's read at any offset is one wavefront (two through L1 when
//     unaligned).  The staged form is held to SPMM_STAGE_MINB = 4 blocks per
//     SM (64 registers): left to itself ptxas gave fp64 K = 4 80 registers
//     and 3 blocks per SM.  fp64 k = 4: unstaged 0.1206 ms, staged 0.1142,
//     staged and capped 0.1002.
//   Measured (scripts/dia_tuning.py; NVIDIA H100 80GB HBM3, 700.00 W):
//   band 160 k = 4 fp32 0.0639 ms (65% of the bound), fp64 0.1002 ms (83%),
//   bf16 legs 0.0605 ms; k = 8 fp32 0.0733 ms (unstaged 0.0881); the 255^3
//   seven-diagonal operator at k = 4 0.3836 ms (77%).  What did not help
//   fp32 k = 4 (the same script): deeper or shallower batches (4, 8, 12,
//   24 legs: 0.0664-0.0883 ms), staging X, 64- or 128-row blocks.  Tried,
//   slower and removed: L2-only (__ldcg) or read-only-path (__ldg)
//   coefficient loads, a register cap on the unstaged form so that the
//   flagship's 811 blocks (3241 of 64 rows) fit one wave (0.0860 ms: 8-leg
//   batches in 40 registers), and a cp.async copy pipeline of the
//   coefficients into shared memory.
//   Each thread sums its own row's legs in A.offsets order with an explicit
//   fma, so column j equals kernel 4's SpMV of column j bit for bit.  More
//   than MAX_DIAGS diagonals chain in groups as kernel 4's do: a launch with
//   accumulate = 1 starts each column's sum from the Y the previous group
//   wrote.  Such a launch takes an instantiation of its own (ACC, unstaged,
//   SPMM_LEGS_SHORT legs a batch, at most 4 columns: ptxas held fp64 K = 8
//   to 64 registers and spilled), so the kernels of up to MAX_DIAGS
//   diagonals are the code they were; a run-time flag read in every kernel
//   had taken fp64 K = 8 staged past its 64-register cap into spills.
//
// Kernel 6: the single-call accumulating DIA SpMM, the same Y = A X as
//   kernel 5 with the diagonals taken in groups.  Replaces
//   scripts/spmm_acc_experiment.py::kernel (:64, pallas_call at :108 in
//   apply_acc), whose sequential group axis keeps the output tile resident
//   while every group is added into it.
//   Bound on the H100: device-memory bandwidth, as kernel 5 (the legs, then
//   X and Y once each): 290.3 MB, 0.0867 ms at n = 414,720, band 160,
//   K = 8.  Beside it, each leg reads K values of X per row from shared
//   memory: 2.1 GB at that shape, at least 0.06 ms at 128 bytes a clock per
//   SM (1.98 GHz), so at K = 8 shared memory is nearly a second bound.
//   The group plan is the host's (ops/cuda_dia.py::plan_dia_groups):
//   offsets ascending, a new group when hi - lo would pass ACC_SPAN or the
//   group holds ACC_LMAX = 48 legs (the JAX plan's _LMAX_MULTI), the group
//   holding offset 0 last.  It travels as a __grid_constant__ parameter, so
//   the per-leg reads stay in parameter space instead of a local copy.  Legs
//   stay row-major (ndiags, n): no relayout.
//   The first design (one window staged by plain loads per group, two
//   barriers per group, one coefficient load at a time with a bounds test
//   per leg) ran at 35% of the bound.  This one takes kernel 5's recipe and
//   a loop over the groups inside the block in place of the TPU's
//   sequential grid axis:
//   - One block of ACC_TILE rows, one thread per row, K columns of y and of
//     the group's partial in registers; y is written once, at the end.
//   - The coefficient stream is pipelined in registers across the whole
//     plan: batches of ACC_LEGS consecutive plan legs (__ldcs,
//     evict-first) that run across group boundaries, the next batch
//     requested before this batch's FMAs.  A batch is summed in segments
//     that end at group boundaries, where the partial is added into y; at
//     K <= 4 a batch inside one group runs without a range test.
//   - Each group's window X[c, i0 + lo .. i0 + ACC_TILE + hi) of all K
//     columns is copied with cp.async into a ring of ACC_STAGES buffers:
//     group g + ACC_STAGES - 1's while group g is summed, one wait and one
//     barrier per group.  Entries outside [0, n) are not copied.  The
//     buffers are sized by the plan's widest group (dynamic shared memory,
//     min(groups, ACC_STAGES) * K * (ACC_TILE + span) fp32).
//   - A block whose rows all have every neighbour inside [0, n) sums without
//     tests; the others skip a leg whose neighbour leaves [0, n) and never
//     read it (a zero-filled entry times a coefficient would turn 0 * NaN
//     into NaN).
//   Legs are summed in plan order into the partial with an explicit fma, and
//   the partial added into y, exactly as the twin spmm_dia_acc_ref does, so
//   the two differ only by FMA contraction.  Kernel 6 and kernel 5 round in
//   different orders.  Kernel 6 keeps the MAX_DIAGS limit (its plan is one
//   struct); only the experiment calls it.
// ---------------------------------------------------------------------------

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define MAX_DIAGS 256
#define THREADS 256
#define ACC_SPAN 512
#define ACC_LMAX 48
// kernel 6's design constants; scripts/dia_tuning.py builds other values
// with -D
#ifndef ACC_TILE
#define ACC_TILE 256  // rows per block, one thread each
#endif
#ifndef ACC_LEGS
#define ACC_LEGS 8  // coefficients per batch of each row's stream
#endif
#ifndef ACC_STAGES
#define ACC_STAGES 3  // window buffers in the ring (at least 2)
#endif
// kernel 5's design constants; scripts/dia_tuning.py builds other values
// with -D
#ifndef SPMM_THREADS
#define SPMM_THREADS 256  // rows per block, one thread each
#endif
#ifndef SPMM_LEGS
#define SPMM_LEGS 16  // coefficients per batch: fp32 legs, K <= 4, more than 16 legs
#endif
#ifndef SPMM_LEGS_SHORT
#define SPMM_LEGS_SHORT 8  // coefficients per batch otherwise
#endif
#ifndef SPMM_SPAN
#define SPMM_SPAN 1024  // widest leg span (hi - lo) whose X window may be staged in shared memory
#endif
#ifndef SPMM_STAGE_BYTES
#define SPMM_STAGE_BYTES 32  // least X bytes a leg reads per row for the window to be staged
#endif
#ifndef SPMM_STAGE_MINB
#define SPMM_STAGE_MINB 4  // blocks per SM asked of ptxas for the staged form (64 registers)
#endif

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

// (A x)[i] added to acc, legs in offsets order; rows outside the band's
// reach skip the leg
template <typename L, typename V>
__device__ __forceinline__ V row_sum(const L* __restrict__ data, const V* __restrict__ x,
                                     int n, const Offsets& offs, int i, V acc) {
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
                Offsets offs, int accumulate) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i < n) y[i] = row_sum(data, x, n, offs, i, accumulate ? y[i] : V(0));
}

// y = A p (continued from y when accumulate) and one partial of p . y per
// block (fixed-order tree)
template <typename L, typename V>
__global__ void __launch_bounds__(THREADS)
spmv_dot_dia_kernel(const L* __restrict__ data, const V* __restrict__ p, V* __restrict__ y,
                    V* __restrict__ partial, int n, Offsets offs, int accumulate) {
  __shared__ V s[THREADS];
  const int i = blockIdx.x * THREADS + threadIdx.x;
  V prod = 0;
  if (i < n) {
    const V v = row_sum(data, p, n, offs, i, accumulate ? y[i] : V(0));
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

// kernel 5's legs: the offsets, and the least and greatest offset clamped
// to 0 (lo <= 0 <= hi) for the interior test
struct SpmmOffsets {
  int n;
  int lo, hi;
  int off[MAX_DIAGS];
};

// coefficients stream once: evict-first, so they do not push X out of L1
__device__ __forceinline__ float ld_leg(const float* p) { return __ldcs(p); }
__device__ __forceinline__ double ld_leg(const double* p) { return __ldcs(p); }
__device__ __forceinline__ __nv_bfloat16 ld_leg(const __nv_bfloat16* p) {
  return __ushort_as_bfloat16(__ldcs(reinterpret_cast<const unsigned short*>(p)));
}

// coefficients of B legs starting at leg k0, or 0 past the last leg
template <typename L, int B>
__device__ __forceinline__ void load_legs(L (&d)[B], const L* __restrict__ row, int n, int nd,
                                          int k0) {
#pragma unroll
  for (int b = 0; b < B; ++b)
    d[b] = k0 + b < nd ? ld_leg(row + (size_t)(k0 + b) * n) : L(0.0f);
}

// Y[c, i] = sum_k data[k, i] * X[c, i + offsets[k]] for K columns of stride
// ld, one thread per row, legs in offsets order (ACC: added to the Y an
// earlier group of a chained launch wrote).  The coefficient stream is
// software-pipelined in registers: the B coefficients of the next batch are
// loaded before the FMAs of this one, so two batches of loads are in flight
// per thread.  MASK (blocks near either end of [0, n)): a leg whose neighbour
// leaves [0, n) is not read and adds nothing.  STAGE: X comes from the
// block's window win[c * W + (j - i0 - lo)] in shared memory instead of
// through L1.
template <typename L, typename V, int K, int B, bool MASK, bool STAGE, bool ACC>
__device__ __forceinline__ void spmm_row(const L* __restrict__ row, const V* __restrict__ X,
                                         V* __restrict__ Y, int n, long long ld,
                                         const SpmmOffsets& offs, int i, const V* win, int W) {
  V acc[K];
#pragma unroll
  for (int c = 0; c < K; ++c) acc[c] = ACC ? Y[c * ld + i] : V(0);
  const int nd = offs.n;
  L cur[B], nxt[B];
  load_legs(cur, row, n, nd, 0);
  for (int k0 = 0; k0 < nd; k0 += B) {
    if (k0 + B < nd) load_legs(nxt, row, n, nd, k0 + B);
#pragma unroll
    for (int b = 0; b < B; ++b) {
      const int k = k0 + b;
      const int j = i + (k < nd ? offs.off[k] : 0);
      if (k < nd && (!MASK || (unsigned)j < (unsigned)n)) {
        const V d = to_acc(cur[b]);
#pragma unroll
        for (int c = 0; c < K; ++c)
          acc[c] = madd(d, STAGE ? win[c * W + (j - i + threadIdx.x - offs.lo)] : __ldg(X + (c * ld + j)),
                        acc[c]);
      }
    }
#pragma unroll
    for (int b = 0; b < B; ++b) cur[b] = nxt[b];
  }
#pragma unroll
  for (int c = 0; c < K; ++c) Y[c * ld + i] = acc[c];
}

// One block of kernel 5.  STAGE (wide columns, a leg span of at most
// SPMM_SPAN): the block first copies the window X[c, i0 + lo .. i0 +
// SPMM_THREADS + hi) of every column, the part inside [0, n), into shared
// memory, where a warp's reads at any offset take one wavefront (through L1
// an unaligned read takes two); each thread requests up to four columns of a
// window entry before it stores them.
template <typename L, typename V, int K, int B, bool STAGE, bool ACC>
__device__ __forceinline__ void spmm_block(const L* __restrict__ data, const V* __restrict__ X,
                                           V* __restrict__ Y, int n, long long ld,
                                           const SpmmOffsets& offs) {
  extern __shared__ __align__(16) unsigned char smem[];
  V* win = reinterpret_cast<V*>(smem);
  const int i0 = blockIdx.x * SPMM_THREADS;
  const int i = i0 + threadIdx.x;
  const int W = SPMM_THREADS + offs.hi - offs.lo;
  if constexpr (STAGE) {
    constexpr int G = K < 4 ? K : 4;  // columns requested together
    for (int t = threadIdx.x; t < W; t += SPMM_THREADS) {
      const int j = i0 + offs.lo + t;
      const bool in = (unsigned)j < (unsigned)n;
#pragma unroll
      for (int c0 = 0; c0 < K; c0 += G) {
        V v[G];
#pragma unroll
        for (int c = 0; c < G; ++c) v[c] = in ? __ldg(X + ((c0 + c) * ld + j)) : V(0);
#pragma unroll
        for (int c = 0; c < G; ++c) win[(c0 + c) * W + t] = v[c];
      }
    }
    __syncthreads();
  }
  // every row of the block has every neighbour inside [0, n): no tests
  const bool interior = i0 + offs.lo >= 0 && (long long)i0 + SPMM_THREADS + offs.hi <= n;
  if (i >= n) return;
  if (interior)
    spmm_row<L, V, K, B, false, STAGE, ACC>(data + i, X, Y, n, ld, offs, i, win, W);
  else
    spmm_row<L, V, K, B, true, STAGE, ACC>(data + i, X, Y, n, ld, offs, i, win, W);
}

template <typename L, typename V, int K, int B, bool ACC>
__global__ void __launch_bounds__(SPMM_THREADS)
spmm_dia_kernel(const L* __restrict__ data, const V* __restrict__ X, V* __restrict__ Y, int n,
                long long ld, const __grid_constant__ SpmmOffsets offs) {
  spmm_block<L, V, K, B, false, ACC>(data, X, Y, n, ld, offs);
}

// the staged form, held to SPMM_STAGE_MINB blocks per SM (64 registers):
// left to itself ptxas gives it 80 registers in fp64 K = 4 (3 blocks of 256
// rows per SM)
template <typename L, typename V, int K, int B>
__global__ void __launch_bounds__(SPMM_THREADS, SPMM_STAGE_MINB)
spmm_dia_kernel_stage(const L* __restrict__ data, const V* __restrict__ X, V* __restrict__ Y,
                      int n, long long ld, const __grid_constant__ SpmmOffsets offs) {
  spmm_block<L, V, K, B, true, false>(data, X, Y, n, ld, offs);
}

// The group plan of kernel 6: group g holds plan legs [begin[g], begin[g+1]);
// leg l has offset off[l] (ascending inside a group) and data row row[l].
// lo and hi are the least and greatest offset clamped to lo <= 0 <= hi (the
// interior test); width is the entries of one column's window, ACC_TILE plus
// the widest group's span.
struct AccPlan {
  int ngroups;
  int lo, hi, width;
  int begin[MAX_DIAGS + 1];
  int off[MAX_DIAGS];
  unsigned char row[MAX_DIAGS];
};

// one 4-byte asynchronous copy from global to shared memory (cp.async; it
// bypasses the registers), and the group and wait that close a stage
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's copy groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Stage group g's window X[c, i0 + lo_g .. i0 + ACC_TILE + hi_g) of all K
// columns into buf[c * width + s]; entries outside [0, n) are not copied
// (the legs that would read them are skipped).  The caller commits.
template <int K>
__device__ __forceinline__ void acc_stage(float* buf, const float* __restrict__ X, int n,
                                          long long ld, const AccPlan& plan, int g, int i0) {
  const int b = plan.begin[g], e = plan.begin[g + 1];
  const int lo = plan.off[b];
  const int w = ACC_TILE + plan.off[e - 1] - lo;
  for (int s = threadIdx.x; s < w; s += ACC_TILE) {
    const long long j = (long long)i0 + lo + s;
    if (j >= 0 && j < n) {
#pragma unroll
      for (int c = 0; c < K; ++c) cp_async4(buf + c * plan.width + s, X + (c * ld + j));
    }
  }
}

// coefficients of plan legs [k0, min(k0 + B, end)) of this thread's row, 0
// past end
template <typename L, int B>
__device__ __forceinline__ void acc_load(L (&d)[B], const L* __restrict__ rowp, int n,
                                         const AccPlan& plan, int k0, int end) {
#pragma unroll
  for (int b = 0; b < B; ++b)
    d[b] = k0 + b < end ? ld_leg(rowp + (size_t)plan.row[k0 + b] * n) : L(0.0f);
}

// One block of kernel 6: ACC_TILE rows, one thread each, K columns of y in
// registers.  The coefficient stream is pipelined in registers across the
// whole plan: batches of ACC_LEGS consecutive plan legs, which run across
// group boundaries, the next requested before this batch's FMAs, so the
// next group's first coefficients are in flight while this group's last are
// summed (and a short plan's are all requested at once).  A batch is summed
// in segments that end at group boundaries: there the partial is added into
// y and the next group opens.  The windows go through a ring of ACC_STAGES
// buffers: group g + ACC_STAGES - 1's is copied (cp.async) while group g is
// summed, so a plan of up to ACC_STAGES groups has every window in flight at
// once; opening a group is one wait and one barrier.  MASK (blocks near
// either end of [0, n)): a leg whose neighbour leaves [0, n) is not read and
// adds nothing.
template <typename L, int K, bool MASK>
__device__ __forceinline__ void acc_block(const L* __restrict__ data, const float* __restrict__ X,
                                          float* __restrict__ Y, int n, long long ld,
                                          const AccPlan& plan, float* win) {
  constexpr int B = ACC_LEGS, S = ACC_STAGES;
  // a batch inside one group skips the per-leg range test; at K = 8 that
  // second copy of the loop takes ptxas past 64 registers into spills and
  // ran no faster (scripts/dia_tuning.py), so K = 8 keeps the tested loop
  constexpr bool WHOLE = K < 8;
  const int t = threadIdx.x;
  const int i0 = blockIdx.x * ACC_TILE;
  const int i = i0 + t;
  const bool row_in = i < n;
  const int W = plan.width;
  const int G = plan.ngroups;
  const int nd = plan.begin[G];
  const L* rowp = data + (row_in ? i : 0);
  float y[K], part[K];
#pragma unroll
  for (int c = 0; c < K; ++c) y[c] = part[c] = 0.0f;
  L cur[B], nxt[B];
  acc_load(cur, rowp, n, plan, 0, nd);
  // one commit group per stage, empty past the last group, so that the wait
  // below always leaves exactly the newer stages in flight
#pragma unroll
  for (int p = 0; p < S - 1; ++p) {
    if (p < G) acc_stage<K>(win + p * K * W, X, n, ld, plan, p, i0);
    cp_async_commit();
  }
  int g = -1, gend = 0;  // the open group and its end
  const float* w = win;
  int s0 = 0;  // this row's window entry at offset 0
  for (int k0 = 0; k0 < nd; k0 += B) {
    if (k0 + B < nd) acc_load(nxt, rowp, n, plan, k0 + B, nd);
    const int bend = k0 + B < nd ? k0 + B : nd;
    for (int l = k0; l < bend;) {
      if (l == gend) {  // open group g + 1
        ++g;
        gend = plan.begin[g + 1];
        cp_async_wait<S - 2>();
        __syncthreads();  // group g's window is in; every thread is done with g - 1's buffer
        const int p = g + S - 1;
        if (p < G) acc_stage<K>(win + (p % S) * K * W, X, n, ld, plan, p, i0);
        cp_async_commit();
        w = win + (g % S) * K * W;
        s0 = t - plan.off[l];
      }
      const int seg = bend < gend ? bend : gend;  // this segment: legs [l, seg)
      // plan leg k0 + b into the partial
      auto leg = [&](int b) {
        const int off = plan.off[k0 + b];
        if (!MASK || (row_in && (unsigned)(i + off) < (unsigned)n)) {
          const float d = to_acc(cur[b]);
#pragma unroll
          for (int c = 0; c < K; ++c) part[c] = madd(d, w[c * W + s0 + off], part[c]);
        }
      };
      if (WHOLE && seg - l == B) {
#pragma unroll
        for (int b = 0; b < B; ++b) leg(b);
      } else {
#pragma unroll
        for (int b = 0; b < B; ++b)
          if (k0 + b >= l && k0 + b < seg) leg(b);
      }
      l = seg;
      if (l == gend) {  // group g is summed
#pragma unroll
        for (int c = 0; c < K; ++c) {
          y[c] += part[c];
          part[c] = 0.0f;
        }
      }
    }
#pragma unroll
    for (int b = 0; b < B; ++b) cur[b] = nxt[b];
  }
  if (row_in) {
#pragma unroll
    for (int c = 0; c < K; ++c) Y[c * ld + i] = y[c];
  }
}

template <typename L, int K>
__global__ void __launch_bounds__(ACC_TILE)
spmm_dia_acc_kernel(const L* __restrict__ data, const float* __restrict__ X,
                    float* __restrict__ Y, int n, long long ld,
                    const __grid_constant__ AccPlan plan) {
  extern __shared__ __align__(16) float acc_win[];  // min(G, ACC_STAGES) buffers of K * width
  // every row of the block has every neighbour inside [0, n): no tests
  const long long i0 = (long long)blockIdx.x * ACC_TILE;
  if (i0 + plan.lo >= 0 && i0 + ACC_TILE + plan.hi <= n)
    acc_block<L, K, false>(data, X, Y, n, ld, plan, acc_win);
  else
    acc_block<L, K, true>(data, X, Y, n, ld, plan, acc_win);
}

// checks every limit the kernel relies on; 0 or cudaErrorInvalidValue
static int fill_plan(AccPlan* p, int ndiags, int ngroups, const int* begin, const int* off,
                     const int* row) {
  if (ndiags < 1 || ndiags > MAX_DIAGS || ngroups < 1 || ngroups > ndiags)
    return (int)cudaErrorInvalidValue;
  if (begin[0] != 0 || begin[ngroups] != ndiags) return (int)cudaErrorInvalidValue;
  p->ngroups = ngroups;
  p->lo = p->hi = 0;
  int span = 0;
  for (int g = 0; g <= ngroups; ++g) p->begin[g] = begin[g];
  for (int g = 0; g < ngroups; ++g) {
    const int b = begin[g], e = begin[g + 1];
    if (e <= b || e - b > ACC_LMAX) return (int)cudaErrorInvalidValue;
    for (int l = b + 1; l < e; ++l)
      if (off[l] <= off[l - 1]) return (int)cudaErrorInvalidValue;
    if ((long long)off[e - 1] - off[b] > ACC_SPAN) return (int)cudaErrorInvalidValue;
    if (off[e - 1] - off[b] > span) span = off[e - 1] - off[b];
  }
  for (int l = 0; l < ndiags; ++l) {
    if (row[l] < 0 || row[l] >= ndiags) return (int)cudaErrorInvalidValue;
    p->off[l] = off[l];
    p->row[l] = (unsigned char)row[l];
    if (off[l] < p->lo) p->lo = off[l];
    if (off[l] > p->hi) p->hi = off[l];
  }
  p->width = ACC_TILE + span;
  return 0;
}

template <typename L, int K>
static int launch_acc_k(const L* d, const float* x, float* y, int n, long long ld,
                        const AccPlan& p, cudaStream_t st) {
  const int nbuf = p.ngroups < ACC_STAGES ? p.ngroups : ACC_STAGES;
  const size_t smem = (size_t)nbuf * K * p.width * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        spmm_dia_acc_kernel<L, K>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int nb = (n + ACC_TILE - 1) / ACC_TILE;
  spmm_dia_acc_kernel<L, K><<<nb, ACC_TILE, smem, st>>>(d, x, y, n, ld, p);
  return (int)cudaGetLastError();
}

template <typename L>
static int launch_spmm_acc(int k, const void* data, const void* X, void* Y, int n, long long ld,
                           const AccPlan& p, cudaStream_t st) {
  const L* d = (const L*)data;
  const float* x = (const float*)X;
  float* y = (float*)Y;
  switch (k) {
    case 1: return launch_acc_k<L, 1>(d, x, y, n, ld, p, st);
    case 2: return launch_acc_k<L, 2>(d, x, y, n, ld, p, st);
    case 4: return launch_acc_k<L, 4>(d, x, y, n, ld, p, st);
    case 8: return launch_acc_k<L, 8>(d, x, y, n, ld, p, st);
    default: return (int)cudaErrorInvalidValue;
  }
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
                       int accumulate, cudaStream_t st) {
  spmv_dia_kernel<L, V><<<blocks_of(n), THREADS, 0, st>>>((const L*)data, (const V*)x, (V*)y, n,
                                                          o, accumulate);
  return (int)cudaGetLastError();
}

template <typename L, typename V>
static int launch_spmv_dot(const void* data, const void* p, void* y, void* partial, void* dot,
                           int n, const Offsets& o, int accumulate, cudaStream_t st) {
  const int nb = blocks_of(n);
  spmv_dot_dia_kernel<L, V><<<nb, THREADS, 0, st>>>((const L*)data, (const V*)p, (V*)y,
                                                    (V*)partial, n, o, accumulate);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  sum_partials_kernel<V><<<1, THREADS, 0, st>>>((const V*)partial, nb, (V*)dot);
  return (int)cudaGetLastError();
}

// the batch: SPMM_LEGS for fp32 legs, up to four columns and a long leg
// list, else SPMM_LEGS_SHORT (more columns, a short list, and bf16 and fp64
// legs ran faster with it; scripts/dia_tuning.py)
template <typename L>
static int spmm_batch(int k, int nd) {
  return sizeof(L) == 4 && k <= 4 && nd > SPMM_LEGS ? SPMM_LEGS : SPMM_LEGS_SHORT;
}

// stage the X window (where the band spans at most SPMM_SPAN rows) when a
// leg reads at least SPMM_STAGE_BYTES = 32 bytes of X per row (fp32 K = 8,
// fp64 K >= 4) or eight times its coefficient's bytes (bf16 legs, K >= 4);
// fp32 legs with K <= 4 ran faster through L1 (scripts/dia_tuning.py)
template <typename L, typename V, int K>
constexpr bool spmm_stages() {
  return K * sizeof(V) >= SPMM_STAGE_BYTES || K * sizeof(V) >= 8 * sizeof(L);
}

template <typename L, typename V, int K, int B>
static int launch_spmm_kb(const L* d, const V* x, V* y, int n, long long ld, const SpmmOffsets& o,
                          cudaStream_t st) {
  const int nb = (n + SPMM_THREADS - 1) / SPMM_THREADS;
  if constexpr (spmm_stages<L, V, K>()) {
    if (o.hi - o.lo <= SPMM_SPAN) {
      const size_t smem = (size_t)K * (SPMM_THREADS + o.hi - o.lo) * sizeof(V);
      if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(spmm_dia_kernel_stage<L, V, K, B>,
                                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                   (int)smem);
        if (e != cudaSuccess) return (int)e;
      }
      spmm_dia_kernel_stage<L, V, K, B><<<nb, SPMM_THREADS, smem, st>>>(d, x, y, n, ld, o);
      return (int)cudaGetLastError();
    }
  }
  spmm_dia_kernel<L, V, K, B, false><<<nb, SPMM_THREADS, 0, st>>>(d, x, y, n, ld, o);
  return (int)cudaGetLastError();
}

// the batch (spmm_batch) picks the instantiation; only fp32 legs with up to
// four columns ever take SPMM_LEGS, so only those are built with it.  A
// chained launch after the first (accumulate) takes the ACC instantiation.
template <typename L, typename V, int K>
static int launch_spmm_k(int nd, const L* d, const V* x, V* y, int n, long long ld,
                         const SpmmOffsets& o, int accumulate, cudaStream_t st) {
  if (accumulate) {
    if constexpr (K <= 4) {
      const int nb = (n + SPMM_THREADS - 1) / SPMM_THREADS;
      spmm_dia_kernel<L, V, K, SPMM_LEGS_SHORT, true><<<nb, SPMM_THREADS, 0, st>>>(d, x, y, n, ld,
                                                                                    o);
      return (int)cudaGetLastError();
    }
    return (int)cudaErrorInvalidValue;  // a chained launch takes at most 4 columns
  }
  if constexpr (sizeof(L) == 4 && K <= 4) {
    if (spmm_batch<L>(K, nd) == SPMM_LEGS)
      return launch_spmm_kb<L, V, K, SPMM_LEGS>(d, x, y, n, ld, o, st);
  }
  return launch_spmm_kb<L, V, K, SPMM_LEGS_SHORT>(d, x, y, n, ld, o, st);
}

template <typename L, typename V>
static int launch_spmm(int k, const void* data, const void* X, void* Y, int n, long long ld,
                       const SpmmOffsets& o, int acc, cudaStream_t st) {
  const L* d = (const L*)data;
  const V* x = (const V*)X;
  V* y = (V*)Y;
  switch (k) {
    case 1: return launch_spmm_k<L, V, 1>(o.n, d, x, y, n, ld, o, acc, st);
    case 2: return launch_spmm_k<L, V, 2>(o.n, d, x, y, n, ld, o, acc, st);
    case 4: return launch_spmm_k<L, V, 4>(o.n, d, x, y, n, ld, o, acc, st);
    case 8: return launch_spmm_k<L, V, 8>(o.n, d, x, y, n, ld, o, acc, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" {

const char* cg_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// code: 0 fp32 legs / fp32 x, 1 bf16 legs / fp32 x, 2 fp64 legs / fp64 x;
// data: this launch's ndiags legs; accumulate: 1 to add them to the y an
// earlier group wrote (a chained launch), 0 to start from 0
int cg_spmv_dia(int code, const void* data, const void* x, void* y, int n, int ndiags,
                const int* offsets, int accumulate, void* stream) {
  Offsets o;
  int err = fill_offsets(&o, ndiags, offsets);
  if (err) return err;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (code) {
    case FP32: return launch_spmv<float, float>(data, x, y, n, o, accumulate, st);
    case BF16: return launch_spmv<__nv_bfloat16, float>(data, x, y, n, o, accumulate, st);
    case FP64: return launch_spmv<double, double>(data, x, y, n, o, accumulate, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// partial: ceil(n / 256) scratch values; dot: one value (p . A p);
// accumulate as cg_spmv_dia (the dot is of the whole y)
int cg_spmv_dot_dia(int code, const void* data, const void* p, void* y, void* partial, void* dot,
                    int n, int ndiags, const int* offsets, int accumulate, void* stream) {
  Offsets o;
  int err = fill_offsets(&o, ndiags, offsets);
  if (err) return err;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (code) {
    case FP32: return launch_spmv_dot<float, float>(data, p, y, partial, dot, n, o, accumulate, st);
    case BF16:
      return launch_spmv_dot<__nv_bfloat16, float>(data, p, y, partial, dot, n, o, accumulate, st);
    case FP64:
      return launch_spmv_dot<double, double>(data, p, y, partial, dot, n, o, accumulate, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// k in {1, 2, 4, 8} columns starting at X / Y, column stride ld; code and
// accumulate as cg_spmv_dia
int cg_spmm_dia(int code, int k, const void* data, const void* X, void* Y, int n, long long ld,
                int ndiags, const int* offsets, int accumulate, void* stream) {
  if (ndiags < 1 || ndiags > MAX_DIAGS || n < 1) return (int)cudaErrorInvalidValue;
  SpmmOffsets o = {};
  o.n = ndiags;
  for (int k2 = 0; k2 < ndiags; ++k2) {
    o.off[k2] = offsets[k2];
    if (offsets[k2] < o.lo) o.lo = offsets[k2];
    if (offsets[k2] > o.hi) o.hi = offsets[k2];
  }
  const cudaStream_t st = (cudaStream_t)stream;
  switch (code) {
    case FP32: return launch_spmm<float, float>(k, data, X, Y, n, ld, o, accumulate, st);
    case BF16: return launch_spmm<__nv_bfloat16, float>(k, data, X, Y, n, ld, o, accumulate, st);
    case FP64: return launch_spmm<double, double>(k, data, X, Y, n, ld, o, accumulate, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// kernel 6's rows per block and window buffers, as this library was built
int cg_spmm_dia_acc_tile() { return ACC_TILE; }
int cg_spmm_dia_acc_stages() { return ACC_STAGES; }

// kernel 6: k in {1, 2, 4, 8} columns of stride ld, the group plan of
// plan_dia_groups (begin: ngroups + 1 entries; off, row: ndiags); code 0 or 1
int cg_spmm_dia_acc(int code, int k, const void* data, const void* X, void* Y, int n,
                    long long ld, int ndiags, int ngroups, const int* begin, const int* off,
                    const int* row, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  AccPlan p;
  int err = fill_plan(&p, ndiags, ngroups, begin, off, row);
  if (err) return err;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (code) {
    case FP32: return launch_spmm_acc<float>(k, data, X, Y, n, ld, p, st);
    case BF16: return launch_spmm_acc<__nv_bfloat16>(k, data, X, Y, n, ld, p, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"

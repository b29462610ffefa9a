// Masked BCE-with-logits for Hopper: the loss's masked sum in one read-only
// pass, and its gradient in one elementwise pass.
//
// Replaces no TPU kernel: the JAX package leaves train/loss.py's
// bce_with_logits to XLA, which fuses the loss and its gradient into a few
// passes on its own. Eager PyTorch does not: the loss as torch ops and its
// autograd chain took about twenty passes over the (N, L) f32 logits a
// train step, ~16 ms of the 44 ms step at full chr1 (N 249,856, L 919).
//
//   num = sum_r m[r] sum_j [max(x, 0) - x z + log1p(exp(-|x|))]
//   dx  = g m[r] (sigmoid(x) - z),  g the cotangent of num
//
// x is the logits, z the targets (both f32, (rows, l), row-major), m the f32
// row mask (rows,), g a one-element f32 array in device memory (read by the
// kernel, so the host never waits on it).
//
// What bounds it on an H100 SXM: bytes. At full chr1 one (N, L) f32 tensor
// is 0.92 GB. The forward must read x and z once (1.84 GB, 0.55 ms at 3.35
// TB/s); the backward must read x and z and write dx (2.76 GB, 0.82 ms).
// The arithmetic, accurate expf and log1pf in f32 (~40 instructions an
// element), takes about half of the forward's bound on 132 SMs.
//
// What this design does about it:
// - Each element's value is the plain formula's, in its order of f32
//   operations (__fmul_rn and friends keep nvcc from contracting them into
//   FMAs); expf, log1pf and the division are the accurate ones.
// - The flat (rows * l) index space is walked in float4s by grid-stride
//   loops, with a scalar walk for l < 4 or a base pointer that is not 16-byte
//   aligned, and the last rows * l % 4 elements taken by block 0. l is odd
//   at 919, so a float4 can span two rows: each thread carries its row and
//   column and advances them by the stride's fixed rows and columns, with no
//   division in the loop.
// - The forward writes nothing of (N, L): each thread sums its elements (f32
//   within a float4, then float64), each block sums its threads in float64
//   into one partial, and a second one-block launch sums the partials in a
//   fixed order into num. The grid's size depends on the shape alone, so the
//   same input gives the same bits every time; there are no float atomics.
// - The backward computes sigmoid through exp(-|x|), so it never overflows,
//   and writes dx once; it saves nothing of its own between the passes.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARP = 32;
// The forward's grid cap. The kernels take 40 registers a thread, so 6
// blocks of 256 share an SM: the forward's 1,584 blocks (and partial sums)
// are two whole waves on 132 SMs (0.585 ms at full chr1, against 0.677 ms
// for 1,024 blocks, 1.3 waves). The backward sums nothing and is fastest
// with a thread a float4 (0.886 ms, against 0.925 ms for 4,096 blocks), so
// its grid has no cap.
constexpr int SUM_BLOCKS = 1584;

__device__ __forceinline__ float bce_term(float x, float z) {
  // max(x, 0) - x z + log1p(exp(-|x|)), rounded as the separate f32 ops are
  return __fadd_rn(__fsub_rn(fmaxf(x, 0.0f), __fmul_rn(x, z)), log1pf(expf(-fabsf(x))));
}

__device__ __forceinline__ float bce_grad(float x, float z, float gm) {
  // gm (sigmoid(x) - z), sigmoid as 1 / (1 + e) or e / (1 + e), e = exp(-|x|)
  const float e = expf(-fabsf(x));
  const float sig = __fdiv_rn(x >= 0.0f ? 1.0f : e, __fadd_rn(1.0f, e));
  return __fmul_rn(gm, __fsub_rn(sig, z));
}

// The row and column of a flat index, moved on by a fixed stride without a
// division: the stride's whole rows and remaining columns are found once.
struct Cursor {
  long long row;
  int col;
  long long drow;
  int dcol, l;
  __device__ Cursor(long long e, long long stride, int l)
      : row(e / l), col((int)(e % l)), drow(stride / l), dcol((int)(stride % l)), l(l) {}
  __device__ __forceinline__ void advance() {
    row += drow;
    col += dcol;
    if (col >= l) {
      col -= l;
      ++row;
    }
  }
};

// The block's sum, in thread 0.
__device__ double block_sum(double v) {
  __shared__ double warp_sums[THREADS / WARP];
  const int lane = threadIdx.x % WARP, warp = threadIdx.x / WARP;
#pragma unroll
  for (int o = WARP / 2; o > 0; o /= 2) v += __shfl_down_sync(0xffffffffu, v, o);
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < THREADS / WARP ? warp_sums[lane] : 0.0;
#pragma unroll
    for (int o = WARP / 2; o > 0; o /= 2) v += __shfl_down_sync(0xffffffffu, v, o);
  }
  return v;
}

// One partial sum a block: partial[blockIdx.x].
template <bool VEC4>
__global__ void __launch_bounds__(THREADS) bce_fused_sum_kernel(
    const float* __restrict__ x, const float* __restrict__ z, const float* __restrict__ m,
    long long n, int l, double* __restrict__ partial) {
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long threads = (long long)gridDim.x * THREADS;
  double acc = 0.0;
  if (VEC4) {
    const long long nv = n / 4;
    const float4* x4 = reinterpret_cast<const float4*>(x);
    const float4* z4 = reinterpret_cast<const float4*>(z);
    Cursor c(4 * t, 4 * threads, l);
    for (long long v = t; v < nv; v += threads, c.advance()) {
      const float4 xv = __ldg(x4 + v), zv = __ldg(z4 + v);
      // l >= 4: the float4's elements past the row's end are the next row's
      const float m0 = __ldg(m + c.row);
      const float m1 = c.col + 3 < l ? m0 : __ldg(m + c.row + 1);
      float s = __fmul_rn(bce_term(xv.x, zv.x), m0);
      s += __fmul_rn(bce_term(xv.y, zv.y), c.col + 1 < l ? m0 : m1);
      s += __fmul_rn(bce_term(xv.z, zv.z), c.col + 2 < l ? m0 : m1);
      s += __fmul_rn(bce_term(xv.w, zv.w), m1);
      acc += s;
    }
    const long long e = 4 * nv + threadIdx.x;  // the last n % 4 elements
    if (blockIdx.x == 0 && e < n) acc += __fmul_rn(bce_term(x[e], z[e]), __ldg(m + e / l));
  } else {
    Cursor c(t, threads, l);
    for (long long e = t; e < n; e += threads, c.advance())
      acc += __fmul_rn(bce_term(__ldg(x + e), __ldg(z + e)), __ldg(m + c.row));
  }
  acc = block_sum(acc);
  if (threadIdx.x == 0) partial[blockIdx.x] = acc;
}

// num = the partials' sum, in a fixed order, rounded once to f32.
__global__ void __launch_bounds__(THREADS) bce_fused_sum_final_kernel(
    const double* __restrict__ partial, int blocks, float* __restrict__ out) {
  double acc = 0.0;
  for (int i = threadIdx.x; i < blocks; i += THREADS) acc += partial[i];
  acc = block_sum(acc);
  if (threadIdx.x == 0) *out = (float)acc;
}

template <bool VEC4>
__global__ void __launch_bounds__(THREADS) bce_fused_grad_kernel(
    const float* __restrict__ x, const float* __restrict__ z, const float* __restrict__ m,
    const float* __restrict__ g, float* __restrict__ dx, long long n, int l) {
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long threads = (long long)gridDim.x * THREADS;
  const float gv = __ldg(g);
  if (VEC4) {
    const long long nv = n / 4;
    const float4* x4 = reinterpret_cast<const float4*>(x);
    const float4* z4 = reinterpret_cast<const float4*>(z);
    Cursor c(4 * t, 4 * threads, l);
    for (long long v = t; v < nv; v += threads, c.advance()) {
      const float4 xv = __ldg(x4 + v), zv = __ldg(z4 + v);
      const float g0 = __fmul_rn(gv, __ldg(m + c.row));
      const float g1 = c.col + 3 < l ? g0 : __fmul_rn(gv, __ldg(m + c.row + 1));
      float4 d;
      d.x = bce_grad(xv.x, zv.x, g0);
      d.y = bce_grad(xv.y, zv.y, c.col + 1 < l ? g0 : g1);
      d.z = bce_grad(xv.z, zv.z, c.col + 2 < l ? g0 : g1);
      d.w = bce_grad(xv.w, zv.w, g1);
      reinterpret_cast<float4*>(dx)[v] = d;
    }
    const long long e = 4 * nv + threadIdx.x;
    if (blockIdx.x == 0 && e < n) dx[e] = bce_grad(x[e], z[e], __fmul_rn(gv, __ldg(m + e / l)));
  } else {
    Cursor c(t, threads, l);
    for (long long e = t; e < n; e += threads, c.advance())
      dx[e] = bce_grad(__ldg(x + e), __ldg(z + e), __fmul_rn(gv, __ldg(m + c.row)));
  }
}

bool aligned16(const void* p) { return reinterpret_cast<unsigned long long>(p) % 16 == 0; }

// The walk a launch takes (float4s or scalars) and its number of blocks, a
// thread a float4 (or an element); l is 1 for an empty input, which no
// division may see as 0.
struct Plan {
  bool vec4;
  int blocks;
  long long n;
  int l;
};

Plan plan(bool aligned, long long rows, int l) {
  Plan p;
  p.n = rows * l;
  p.l = p.n == 0 ? 1 : l;
  p.vec4 = l >= 4 && aligned;
  const long long work = p.vec4 ? p.n / 4 : p.n;
  const long long blocks = (work + THREADS - 1) / THREADS;
  p.blocks = (int)(blocks < 1 ? 1 : blocks);
  return p;
}

}  // namespace

extern "C" {

// Doubles of the scratch `partial` that bce_sum_f32 takes.
int bce_sum_partials() { return SUM_BLOCKS; }

// *out = sum_r m[r] sum_j [max(x, 0) - x z + log1p(exp(-|x|))] over x, z
// (rows, l) f32 and m (rows,) f32; partial holds bce_sum_partials() doubles
// of scratch. Two launches. Returns cudaGetLastError() after them (0 on
// success).
int bce_sum_f32(const float* x, const float* z, const float* m, double* partial, float* out,
                long long rows, int l, void* stream) {
  if (rows < 0 || l < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Plan p = plan(aligned16(x) && aligned16(z), rows, l);
  if (p.blocks > SUM_BLOCKS) p.blocks = SUM_BLOCKS;
  if (p.vec4)
    bce_fused_sum_kernel<true><<<p.blocks, THREADS, 0, s>>>(x, z, m, p.n, p.l, partial);
  else
    bce_fused_sum_kernel<false><<<p.blocks, THREADS, 0, s>>>(x, z, m, p.n, p.l, partial);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bce_fused_sum_final_kernel<<<1, THREADS, 0, s>>>(partial, p.blocks, out);
  return (int)cudaGetLastError();
}

// dx (rows, l) = g[0] m[r] (sigmoid(x) - z). One launch. Returns
// cudaGetLastError() after it (0 on success).
int bce_sum_bwd_f32(const float* x, const float* z, const float* m, const float* g, float* dx,
                    long long rows, int l, void* stream) {
  if (rows < 0 || l < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Plan p = plan(aligned16(x) && aligned16(z) && aligned16(dx), rows, l);
  if (p.vec4)
    bce_fused_grad_kernel<true><<<p.blocks, THREADS, 0, s>>>(x, z, m, g, dx, p.n, p.l);
  else
    bce_fused_grad_kernel<false><<<p.blocks, THREADS, 0, s>>>(x, z, m, g, dx, p.n, p.l);
  return (int)cudaGetLastError();
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

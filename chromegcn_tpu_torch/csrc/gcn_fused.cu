// Fused gated-GCN layer, forward kernel for Hopper: z = tanh((A x) W + b),
// h = A x gathered over the edge form, then h W on tensor cores in 3xTF32,
// with the bias and tanh applied to each fragment of the product. (The
// backward kernel, B3, is gcn_fused_bwd.cu; both run gather_mma.cuh.)
//
// Replaces the TPU kernel chromegcn_tpu/ops/gcn_fused.py::_fused_fwd_call
// (B2, :85-203). The TPU kernel streams op.fwd's dense blocks against x into
// an f32 accumulator (A (x W) == (A x) W, so no prologue GEMM) and rewrites
// it in place with tanh(acc W + b) in its epilogue (:149-162). Here A is
// op.fwd's edge form (row_ptr, col, val, f32 or bf16); x, W, b and z are f32.
// bf16 operators take x rounded to bf16 in the gather; the product with W is
// 3xTF32 in both modes.
//
// What bounds it on an H100 SXM. At the chr1-scale bench graph (N 50,176,
// d 128, 348,678 nonzeros) one launch must read the edge list (~2.8 MB), the
// row pointers (0.2 MB), x (25.7 MB), W and b, and write z (25.7 MB):
// ~54 MB, ~16 us at 3.35 TB/s. Its operations are 2 nnz d for the gather
// (0.09 GFLOP, ~1.3 us of f32 FFMA) and 2 N d^2 for the GEMM (1.64 GFLOP,
// ~10 us at 3xTF32's 165 TFLOP/s), so bytes bound it. An FFMA GEMM alone
// (~25 us at 67 TFLOP/s) would take longer than that bound.
//
// What this design does about it:
// - The GEMM mixes all d columns of a row, so a CTA owns whole rows: R
//   consecutive rows (64 at d 128), gathered by its 8 warps into a padded
//   shared-memory tile of h (8 bytes read per nonzero, ascending column
//   order, no atomics), then multiplied by W from there. The (N, d) h never
//   goes to device memory; z is written once.
// - The GEMM runs on tensor cores (mma.sync.m16n8k8) in 3xTF32, with W staged
//   by cp.async in (32 k x 64 column) chunks at a row stride of 72 floats,
//   two buffers; the bias pair of each fragment is loaded when its columns
//   start, and z = tanhf(acc + b) is stored when their k loop ends.
// - At d 128 a CTA takes 52,224 bytes of shared memory (four would fit an
//   SM) and 79 registers a thread (ptxas, for R 64 and 32 in f32 and bf16;
//   72 for R 16; no spills), so registers hold it to three CTAs (24 warps)
//   an SM, which hide the gather's L2 latency. Four CTAs an SM (64
//   registers) measured no faster, nor did R 32 or 16 at d 128.
// - A row with no entries (padding included) gives z = tanh(b), as the
//   reference's zero-filled accumulator does.
//
// What holds it back: as in B3, the gather (memory latency) and the GEMM
// (MMA, a barrier per W chunk) run one after the other in every CTA, and the
// CTAs of a wave start together, so the two phases add up.

#include "gather_mma.cuh"

namespace {

using namespace gmma;

// z[r, n : n + 2] = tanh(acc + b[n : n + 2]); nothing stored during the gather
struct FwdEpilogue {
  const float* __restrict__ b;
  float* __restrict__ z;
  int d;
  __device__ __forceinline__ void gathered(int, int, float4) const {}
  __device__ __forceinline__ float2 load(int, int n) const {
    return __ldg(reinterpret_cast<const float2*>(b + n));
  }
  __device__ __forceinline__ void store(int r, int n, float2 bias, float a0, float a1) const {
    *reinterpret_cast<float2*>(z + (size_t)r * d + n) =
        make_float2(tanhf(a0 + bias.x), tanhf(a1 + bias.y));
  }
};

template <typename T, int R>
__global__ void __launch_bounds__(NT, 3) gcn_fused_kernel(
    const int* __restrict__ row_ptr, const int* __restrict__ col,
    const T* __restrict__ val, const float* __restrict__ x,
    const float* __restrict__ w, const float* __restrict__ b, float* __restrict__ z,
    int n_rows, int d) {
  FwdEpilogue epi{b, z, d};
  gather_mma<T, R, false>(row_ptr, col, val, x, w, n_rows, d, epi);
}

template <typename T>
int dispatch(const int* row_ptr, const int* col, const void* val, const float* x,
             const float* w, const float* b, float* z, int n_rows, int d, void* stream) {
  if (n_rows <= 0 || d <= 0 || d % 4 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* v = static_cast<const T*>(val);
  return (int)with_rows_per_cta(d, [&](auto rows) {
    constexpr int R = decltype(rows)::value;
    return launch_rows<R, false>(gcn_fused_kernel<T, R>, n_rows, d, s, row_ptr, col, v, x, w,
                                 b, z, n_rows, d);
  });
}

}  // namespace

extern "C" {

// z (n_rows, d) = tanh((A @ x) w + b) over op.fwd's edge form; x (n_cols, d),
// w (d, d), b (d,), d a multiple of 4; A's row i holds the entries
// [row_ptr[i], row_ptr[i+1]) of col / val, columns ascending. Returns
// cudaGetLastError() after the launch (0 on success).
int gcn_fused_fwd_f32(const int* row_ptr, const int* col, const void* val, const float* x,
                      const float* w, const float* b, float* z, int n_rows, int d,
                      void* stream) {
  return dispatch<float>(row_ptr, col, val, x, w, b, z, n_rows, d, stream);
}

int gcn_fused_fwd_bf16(const int* row_ptr, const int* col, const void* val, const float* x,
                       const float* w, const float* b, float* z, int n_rows, int d,
                       void* stream) {
  return dispatch<__nv_bfloat16>(row_ptr, col, val, x, w, b, z, n_rows, d, stream);
}

// Dynamic shared memory (bytes) of one launch at width d.
long long gcn_fused_smem_bytes(int d) { return (long long)smem_bytes<false>(d); }

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

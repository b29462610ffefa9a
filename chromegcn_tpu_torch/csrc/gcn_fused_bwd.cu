// Fused gated-GCN layer, backward kernel for Hopper: h = A^T ds gathered
// over the edge form, then dx = dx_dir + h W^T on tensor cores in 3xTF32.
// (The forward kernel, B2, is gcn_fused.cu; both run gather_mma.cuh.)
//
// Replaces the TPU kernel chromegcn_tpu/ops/gcn_fused.py::_fused_bwd_call
// (B3, :206-315). The TPU kernel streams op.bwd's dense blocks into an f32
// accumulator and runs dx = dx_dir + acc W^T in its epilogue (:260-267). It
// writes both h and dx. Here A^T is op.bwd's edge form (row_ptr, col, val,
// f32 or bf16); ds, dx_dir, W, h and dx are f32.
//
// What bounds it on an H100 SXM. At the chr1-scale bench graph (N 50,176,
// d 128) one launch must read the edge list (~2.8 MB), ds, dx_dir and W
// and write h and dx: ~106 MB, ~32 us at 3.35 TB/s. Its operations are
// 2 nnz d for the gather (~0.09 GFLOP) and 2 N d^2 for the epilogue GEMM
// (1.64 GFLOP, ~10 us at 3xTF32's 165 TFLOP/s), so bytes bound it, but an
// FFMA epilogue alone (~25 us at 67 TFLOP/s) would take most of that bound.
//
// What this design does about it (gather_mma.cuh):
// - One CTA owns R consecutive rows (64 at d 128). Its 8 warps gather those
//   rows of h with B1's row gather (8 bytes per nonzero, ascending column
//   order, no atomics), store each row of h once to device memory, and keep
//   it in a padded shared-memory tile. The (N, d) h is never read back. At
//   d 128 a CTA takes 52,224 bytes of shared memory, so three CTAs (24
//   warps) share an SM and hide the gather's L2 latency.
// - The epilogue GEMM runs on tensor cores in 3xTF32. W's rows are W^T's
//   columns, which is the layout mma's B operand wants, so W is staged as
//   (64 output columns x 32 k) chunks with cp.async, no transpose. Each
//   thread's dx_dir is loaded when its 64 output columns start, and is
//   added when their k loop ends. bf16 operators round ds to bf16 in the
//   gather.
// - A row with no entries (padding included) gives h = 0 and dx = dx_dir.
//
// What holds it back: the gather (memory latency) and the epilogue (MMA,
// barriers per W chunk) run one after the other in every CTA, and the CTAs
// of a wave start together, so the two phases add up instead of overlapping.

#include "gather_mma.cuh"

namespace {

using namespace gmma;

// h stored as it is gathered; dx[r, n : n + 2] = dx_dir[r, n : n + 2] + acc
struct BwdEpilogue {
  const float* __restrict__ dx_dir;
  float* __restrict__ h;
  float* __restrict__ dx;
  int d;
  __device__ __forceinline__ void gathered(int row, int c, float4 v) const {
    *reinterpret_cast<float4*>(h + (size_t)row * d + c) = v;
  }
  __device__ __forceinline__ float2 load(int r, int n) const {
    return __ldg(reinterpret_cast<const float2*>(dx_dir + (size_t)r * d + n));
  }
  __device__ __forceinline__ void store(int r, int n, float2 dd, float a0, float a1) const {
    *reinterpret_cast<float2*>(dx + (size_t)r * d + n) = make_float2(dd.x + a0, dd.y + a1);
  }
};

template <typename T, int R>
__global__ void __launch_bounds__(NT, 3) gcn_fused_bwd_kernel(
    const int* __restrict__ row_ptr, const int* __restrict__ col,
    const T* __restrict__ val, const float* __restrict__ ds,
    const float* __restrict__ dx_dir, const float* __restrict__ w,
    float* __restrict__ h, float* __restrict__ dx, int n_rows, int d) {
  BwdEpilogue epi{dx_dir, h, dx, d};
  gather_mma<T, R, true>(row_ptr, col, val, ds, w, n_rows, d, epi);
}

template <typename T>
int dispatch(const int* row_ptr, const int* col, const void* val, const float* ds,
             const float* dx_dir, const float* w, float* h, float* dx, int n_rows, int d,
             void* stream) {
  if (n_rows <= 0 || d <= 0 || d % 4 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* v = static_cast<const T*>(val);
  return (int)with_rows_per_cta(d, [&](auto rows) {
    constexpr int R = decltype(rows)::value;
    return launch_rows<R, true>(gcn_fused_bwd_kernel<T, R>, n_rows, d, s, row_ptr, col, v,
                                ds, dx_dir, w, h, dx, n_rows, d);
  });
}

}  // namespace

extern "C" {

// h = A^T ds over op.bwd's edge form, dx = dx_dir + h w^T; ds (n_cols, d),
// dx_dir, h, dx (n_rows, d), w (d, d), d a multiple of 4. Returns
// cudaGetLastError() after the launch (0 on success).
int gcn_fused_bwd_f32(const int* row_ptr, const int* col, const void* val,
                      const float* ds, const float* dx_dir, const float* w, float* h,
                      float* dx, int n_rows, int d, void* stream) {
  return dispatch<float>(row_ptr, col, val, ds, dx_dir, w, h, dx, n_rows, d, stream);
}

int gcn_fused_bwd_bf16(const int* row_ptr, const int* col, const void* val,
                       const float* ds, const float* dx_dir, const float* w, float* h,
                       float* dx, int n_rows, int d, void* stream) {
  return dispatch<__nv_bfloat16>(row_ptr, col, val, ds, dx_dir, w, h, dx, n_rows, d,
                                 stream);
}

// Dynamic shared memory (bytes) of one launch at width d.
long long gcn_fused_bwd_smem_bytes(int d) { return (long long)smem_bytes<true>(d); }

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

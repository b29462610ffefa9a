// Fused gated-GCN layer, forward kernel for Hopper: the block-sparse SpMM
// with the layer's GEMM in its epilogue. (The backward kernel, B3, is
// gcn_fused_bwd.cu.)
//
// Replaces the TPU kernel chromegcn_tpu/ops/gcn_fused.py::_fused_fwd_call
// (B2, :85-203): z = tanh((A @ x) W + b). The block stream runs over op.fwd
// against x into an f32 accumulator, and the epilogue computes
// tanh(acc @ W + b) in the kernel (:149-162). x, W, b and z are f32. f32
// tiles run FFMA throughout (the reference runs Precision.HIGHEST; plain
// TF32 would lose about three digits). bf16 tiles take x rounded to bf16 in
// the stream; the epilogue stays f32 in both modes.
//
// What bounds it on an H100 SXM. At the chr1-scale bench graph (N 50,176,
// d 128) the data needs the edge list (~2.8 MB), x (25.7 MB), W and z
// (25.7 MB): ~54 MB, ~16 us at 3.35 TB/s. Its operations are one
// multiply-add per nonzero and column plus the epilogue GEMM,
// 2 nnz d + 2 N d^2 ~ 1.7 GFLOP, ~26 us of f32: operations bound it. This
// kernel reads the live blocks instead (~69 MB in f32) and multiplies the
// zeros inside them too, and the epilogue GEMM runs on CUDA cores in FFMA.
//
// What this design does about it:
// - The epilogue needs whole rows: acc @ W mixes all d columns of a row. So
//   each CTA owns one row block (tile_r rows) and all d columns. It walks
//   the row block's tiles and strips once per 64-column slice
//   (bsr_stream.cuh) into a tile_r x d accumulator kept in shared memory,
//   then runs the epilogue from there with W staged in 64 x 64 chunks, and
//   writes each output row once. The (N, d) product A @ x never goes to
//   device memory.
// - The accumulator takes tile_r x (d + 4) floats of shared memory beside
//   the walk's staging buffers, so the tile heights and widths that fit
//   are those whose plan stays within 227 KB (gcn_fused_smem_bytes;
//   ops/gcn_fused.py:fused_fits mirrors it). At tile_r 128 that is d <= 192.
// - A row block with no live blocks (padding rows included) gets
//   z = tanh(b), as the reference's zero-filled accumulator gives.
// - One CTA per row block: no atomics, and each row's sums are taken in a
//   fixed order.

#include "bsr_stream.cuh"

namespace {

using namespace bsr;

constexpr int KC = 64;  // rows of W staged per epilogue chunk

__host__ __device__ constexpr int padded_width(int d) { return (d + DC - 1) / DC * DC; }

size_t smem_bytes(int tile_r, int d) {
  return sizeof(float) * ((size_t)tile_r * LDA + TC * DC + SR * TC +
                          (size_t)tile_r * (padded_width(d) + 4));
}

// z = tanh((A @ x) w + b) for one row block
template <typename T, int TILE_R>
__global__ void __launch_bounds__(NT) gcn_fused_kernel(
    const T* __restrict__ tiles, const int* __restrict__ tile_cb,
    const int* __restrict__ tile_ptr, const T* __restrict__ strips,
    const int* __restrict__ strip_rb, const int* __restrict__ strip_cb,
    const int* __restrict__ strip_ptr, const int* __restrict__ strip_order,
    const float* __restrict__ x, const float* __restrict__ w,
    const float* __restrict__ bias, float* __restrict__ out, int d) {
  constexpr int TM = TILE_R / 16;  // output rows per thread
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* Acc = smem + stream_smem_floats<TILE_R>();  // TILE_R x lda accumulator
  const int dp = padded_width(d);
  const int lda = dp + 4;
  const int rb = blockIdx.x;
  const size_t row0 = (size_t)rb * TILE_R;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;

  // ---- stream: Acc = (A @ x)[row block], one 64-column slice at a time ----
  for (int c0 = 0; c0 < dp; c0 += DC)
    stream_slice<T, TILE_R>(tiles, tile_cb, tile_ptr, strips, strip_rb, strip_cb,
                            strip_ptr, strip_order, x, d, rb, c0, smem, Acc + c0, lda);

  // ---- epilogue: out[rows, c0..c0+64) from Acc @ W, chunk by chunk ----
  float* Ws = smem;  // KC x DC chunk; the walk is done with its buffers
  for (int c0 = 0; c0 < dp; c0 += DC) {
    float acc[TM][4];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

    for (int k0 = 0; k0 < dp; k0 += KC) {
      __syncthreads();  // the previous chunk's compute is done with Ws
      for (int i = tid; i < KC * DC; i += NT) {  // Ws[kk][jj] = W[k0+kk][c0+jj]
        const int kk = i / DC, jj = i % DC;
        float v = 0.f;
        if (k0 + kk < d && c0 + jj < d) v = __ldg(w + (size_t)(k0 + kk) * d + c0 + jj);
        Ws[kk * DC + jj] = v;
      }
      __syncthreads();
#pragma unroll 2
      for (int k = 0; k < KC; k += 4) {
        float4 b[4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          b[kk] = *reinterpret_cast<const float4*>(Ws + (k + kk) * DC + tx * 4);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float4 a4 =
              *reinterpret_cast<const float4*>(Acc + (ty * TM + i) * lda + k0 + k);
          const float a[4] = {a4.x, a4.y, a4.z, a4.w};
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            acc[i][0] = fmaf(a[kk], b[kk].x, acc[i][0]);
            acc[i][1] = fmaf(a[kk], b[kk].y, acc[i][1]);
            acc[i][2] = fmaf(a[kk], b[kk].z, acc[i][2]);
            acc[i][3] = fmaf(a[kk], b[kk].w, acc[i][3]);
          }
        }
      }
    }

    const int c = c0 + tx * 4;
    if (c < d) {
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        float* o = out + (row0 + ty * TM + i) * d + c;
        const float4 bb = load4(bias + c);  // z = tanh(acc W + b)
        *reinterpret_cast<float4*>(o) =
            make_float4(tanhf(acc[i][0] + bb.x), tanhf(acc[i][1] + bb.y),
                        tanhf(acc[i][2] + bb.z), tanhf(acc[i][3] + bb.w));
      }
    }
  }
}

template <typename T, int TILE_R>
cudaError_t launch(const void* tiles, const int* tile_cb, const int* tile_ptr,
                   const void* strips, const int* strip_rb, const int* strip_cb,
                   const int* strip_ptr, const int* strip_order, const float* x,
                   const float* w, const float* b, float* out, int n_row_blocks, int d,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(TILE_R, d);
  // above 48 KB only after this call; a plan over the card's limit fails here
  cudaError_t err = cudaFuncSetAttribute(gcn_fused_kernel<T, TILE_R>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  gcn_fused_kernel<T, TILE_R><<<n_row_blocks, NT, smem, stream>>>(
      static_cast<const T*>(tiles), tile_cb, tile_ptr, static_cast<const T*>(strips),
      strip_rb, strip_cb, strip_ptr, strip_order, x, w, b, out, d);
  return cudaGetLastError();
}

template <typename T>
int dispatch(const void* tiles, const int* tile_cb, const int* tile_ptr,
             const void* strips, const int* strip_rb, const int* strip_cb,
             const int* strip_ptr, const int* strip_order, const float* x,
             const float* w, const float* b, float* out, int n_row_blocks, int tile_r,
             int d, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 0 || d % 4 != 0) return (int)cudaErrorInvalidValue;
#define FUSED_CASE(R)                                                               \
  case R:                                                                           \
    return (int)launch<T, R>(tiles, tile_cb, tile_ptr, strips, strip_rb, strip_cb,  \
                             strip_ptr, strip_order, x, w, b, out, n_row_blocks, d, \
                             s);
  switch (tile_r) {
    FUSED_CASE(32)
    FUSED_CASE(64)
    FUSED_CASE(128)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef FUSED_CASE
}

}  // namespace

extern "C" {

// Each entry returns cudaGetLastError() after the launch (0 on success).
// tile_ptr / strip_ptr hold n_row_blocks + 1 offsets over the live blocks;
// strip_order lists each row block's live strips grouped by column block.

// z = tanh((A @ x) w + b); x (n_cols, d), w (d, d), b (d,), z (n_rows, d).
int gcn_fused_fwd_f32(const void* tiles, const int* tile_cb, const int* tile_ptr,
                      const void* strips, const int* strip_rb, const int* strip_cb,
                      const int* strip_ptr, const int* strip_order, const float* x,
                      const float* w, const float* b, float* z, int n_row_blocks,
                      int tile_r, int d, void* stream) {
  return dispatch<float>(tiles, tile_cb, tile_ptr, strips, strip_rb, strip_cb,
                         strip_ptr, strip_order, x, w, b, z, n_row_blocks, tile_r, d,
                         stream);
}

int gcn_fused_fwd_bf16(const void* tiles, const int* tile_cb, const int* tile_ptr,
                       const void* strips, const int* strip_rb, const int* strip_cb,
                       const int* strip_ptr, const int* strip_order, const float* x,
                       const float* w, const float* b, float* z, int n_row_blocks,
                       int tile_r, int d, void* stream) {
  return dispatch<__nv_bfloat16>(tiles, tile_cb, tile_ptr, strips, strip_rb, strip_cb,
                                 strip_ptr, strip_order, x, w, b, z, n_row_blocks,
                                 tile_r, d, stream);
}

// Dynamic shared memory (bytes) of one launch at this tile height and width.
long long gcn_fused_smem_bytes(int tile_r, int d) {
  return (long long)smem_bytes(tile_r, d);
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

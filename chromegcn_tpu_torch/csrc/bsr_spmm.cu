// SpMM for Hopper: out = A @ x, one warp per output row, gathering over the
// edge form (CSR) of one BSROperator direction.
//
// Replaces the TPU kernel chromegcn_tpu/ops/spmm_pallas.py::_bsr_matmul
// (:289-406). A is one direction of a BSROperator: forward A, or A^T for the
// backward pass. The TPU kernel streams the operator's dense (tile_r x 128)
// tiles and (8 x 128) strips through the MXU, which multiplies 128 x 128
// blocks. This kernel reads the same nonzeros from their edge form
// (row_ptr, col, val), which the host builds from exactly the nonzeros of
// the live blocks. val is f32 or bf16; x and out are f32. bf16 entries take
// x rounded to bf16 and sum in f32, as the TPU kernel does (:344).
//
// What bounds it on an H100 SXM. At the chr1-scale bench graph
// (make_hic_edges(50_000, 250_000), N 50,176, d 128) the blocks hold 17.3 M
// elements for 348,678 nonzeros (2.3% dense tiles, 0.26% dense strips).
// What the data needs is 2 x 348,678 x 128 ~ 0.09 GFLOP (~1.3 us of f32 at
// 67 TFLOP/s) and ~54 MB: the edge list (8 bytes an entry), the row
// pointers, x read once and out written once (~16 us at 3.35 TB/s). So the
// product lies far below the card's ridge point, and the only lever is to
// move fewer bytes. Tensor cores are deliberately not used: on the blocks
// they would multiply ~50x more elements than the data holds, and on the
// edges there is no dense product for them to run.
//
// What this design does about it:
// - It reads 8 bytes per nonzero instead of ~50 stored block elements.
// - One warp per row, lanes over d in float4s (d 128 is one float4 a lane;
//   wider d takes a second float4, or a second column group of CTAs). A
//   width that is not a multiple of 4 leaves x's rows 8- or 4-byte aligned:
//   it takes float2s (d % 4 == 2) or scalars (odd d), up to 256 columns a
//   warp as the float4 path, where the reference kernel takes any d. A
//   row's (col, val) pairs arrive 32 at a time in one coalesced load and are
//   broadcast by shuffle; 4 neighbours' 512-byte x rows are in flight before
//   their FMAs (csr_gather.cuh).
// - A CTA takes 16 consecutive rows, its 8 warps on 8 neighbouring rows at a
//   time. Hi-C contacts sit near the diagonal (|i - j| has a median of 2 at
//   the bench graph), so neighbouring rows gather the same x rows, and L1
//   serves the repeats; x (25.7 MB) fits in the 50 MB L2.
// - Rows longer than 32 entries loop over batches, so hub rows of several
//   hundred entries need nothing special.
// - Each row is summed in ascending column order by one warp and written
//   once, with no atomics; an empty row, padding included, writes zeros.

#include "csr_gather.cuh"

namespace {

using namespace csr;

constexpr int WARPS = 8;          // warps per CTA, one row each at a time
constexpr int ROWS_PER_WARP = 2;  // a CTA covers WARPS * ROWS_PER_WARP consecutive rows
constexpr int ROWS_PER_CTA = WARPS * ROWS_PER_WARP;

template <typename T, int NCH, int VEC>
__global__ void __launch_bounds__(WARPS * WARP) bsr_spmm_kernel(
    const int* __restrict__ row_ptr, const int* __restrict__ col,
    const T* __restrict__ val, const float* __restrict__ x, float* __restrict__ out,
    int n_rows, int d) {
  using V = typename Vec<VEC>::type;
  constexpr int COLS = VEC * WARP;
  const int lane = threadIdx.x % WARP, warp = threadIdx.x / WARP;
  const int c0 = blockIdx.y * NCH * COLS;
  const int row0 = blockIdx.x * ROWS_PER_CTA;
#pragma unroll 1
  for (int i = 0; i < ROWS_PER_WARP; ++i) {
    const int row = row0 + i * WARPS + warp;
    if (row >= n_rows) return;  // uniform across the warp
    V acc[NCH];
    gather_row<T, NCH, VEC>(row_ptr, col, val, x, d, row, c0, lane, acc);
#pragma unroll
    for (int j = 0; j < NCH; ++j) {
      const int c = c0 + VEC * lane + COLS * j;
      if (c < d) *reinterpret_cast<V*>(out + (size_t)row * d + c) = acc[j];
    }
  }
}

template <typename T, int NCH, int VEC>
cudaError_t launch(const int* row_ptr, const int* col, const void* val, const float* x,
                   float* out, int n_rows, int d, cudaStream_t stream) {
  const dim3 grid((n_rows + ROWS_PER_CTA - 1) / ROWS_PER_CTA,
                  (d + NCH * VEC * WARP - 1) / (NCH * VEC * WARP));
  bsr_spmm_kernel<T, NCH, VEC><<<grid, WARPS * WARP, 0, stream>>>(
      row_ptr, col, static_cast<const T*>(val), x, out, n_rows, d);
  return cudaGetLastError();
}

// d up to 32 VEC: one vector a lane; wider: 256 columns a warp (two float4s,
// four float2s or eight scalars a lane), over column groups of CTAs
template <typename T, int VEC>
int launch_vec(const int* row_ptr, const int* col, const void* val, const float* x,
               float* out, int n_rows, int d, cudaStream_t s) {
  if (d <= VEC * WARP) return (int)launch<T, 1, VEC>(row_ptr, col, val, x, out, n_rows, d, s);
  return (int)launch<T, 8 / VEC, VEC>(row_ptr, col, val, x, out, n_rows, d, s);
}

template <typename T>
int dispatch(const int* row_ptr, const int* col, const void* val, const float* x,
             float* out, int n_rows, int d, void* stream) {
  if (n_rows <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the widest load a row of x stays aligned for: x itself is 16-byte aligned
  if (d % 4 == 0) return launch_vec<T, 4>(row_ptr, col, val, x, out, n_rows, d, s);
  if (d % 2 == 0) return launch_vec<T, 2>(row_ptr, col, val, x, out, n_rows, d, s);
  return launch_vec<T, 1>(row_ptr, col, val, x, out, n_rows, d, s);
}

}  // namespace

extern "C" {

// out (n_rows, d) = A @ x, x (n_cols, d) 16-byte aligned, any d >= 1; A's row i holds
// the entries [row_ptr[i], row_ptr[i+1]) of col / val, columns ascending.
// Returns cudaGetLastError() after the launch (0 on success).
int bsr_spmm_f32(const int* row_ptr, const int* col, const void* val, const float* x,
                 float* out, int n_rows, int d, void* stream) {
  return dispatch<float>(row_ptr, col, val, x, out, n_rows, d, stream);
}

int bsr_spmm_bf16(const int* row_ptr, const int* col, const void* val, const float* x,
                  float* out, int n_rows, int d, void* stream) {
  return dispatch<__nv_bfloat16>(row_ptr, col, val, x, out, n_rows, d, stream);
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

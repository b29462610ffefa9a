// Block-sparse SpMM for Hopper: out = A @ x over dense tiles + strips.
//
// Replaces the TPU kernel chromegcn_tpu/ops/spmm_pallas.py::_bsr_matmul
// (:289-406). A is one direction of a BSROperator (forward A, or A^T for the
// backward pass): nt dense (tile_r x 128) tiles, tile t adding
// tiles[t] @ x[cb*128 : +128] to out[rb*tile_r : +tile_r], and ns dense
// (8 x 128) strips for the straggler edges, strip s adding
// strips[s] @ x[cb*128 : +128] to out[rb8*8 : +8]. Tiles are f32 or bf16;
// x and out are f32. bf16 tiles take x rounded to bf16 and accumulate in
// f32, as the TPU kernel does (:344).
//
// What bounds it on an H100 SXM. At the chr1-scale bench graph
// (make_hic_edges(50_000, 250_000), N 50,176, d 128) one launch streams
// ~17.3 M block elements (~69 MB in f32) plus x and out (2 x 25.7 MB):
// ~121 MB, ~36 us at 3.35 TB/s. The product itself needs one multiply-add
// per edge and column, 2 x 348,678 x 128 ~ 0.09 GFLOP, ~1.3 us of f32 at
// 67 TFLOP/s: the least time is set by bytes. But this kernel computes
// the dense block products, zeros inside the tiles included: 2 x 17.3 M x
// 128 ~ 4.4 GFLOP, ~66 us of f32 FFMA. So the design, not the data, puts
// its floor near twice the byte bound: the block form trades extra
// multiply-adds for gather-free streaming. chip_smoke.py recomputes the
// bound from each run's blocks and their nonzeros. Tensor cores would lift
// the FFMA floor, but plain TF32 is not f32-faithful (the reference runs
// at Precision.HIGHEST); 3xTF32 or wgmma is later work.
//
// What this design does about it: one CTA per (output row block of tile_r
// rows, slice of DC=64 columns). The TPU grid ran in order and accumulated
// into a VMEM-resident output; here CTAs run in parallel, each owns its
// output rows outright and writes each once, so there are no atomics and
// the summation order is fixed from run to run. The walk over the row
// block's tiles and strips is bsr_stream.cuh's, shared with gcn_fused.cu.

#include "bsr_stream.cuh"

namespace {

using namespace bsr;

template <typename T, int TILE_R>
__global__ void __launch_bounds__(NT) bsr_spmm_kernel(
    const T* __restrict__ tiles, const int* __restrict__ tile_cb,
    const int* __restrict__ tile_ptr, const T* __restrict__ strips,
    const int* __restrict__ strip_rb, const int* __restrict__ strip_cb,
    const int* __restrict__ strip_ptr, const int* __restrict__ strip_order,
    const float* __restrict__ x, float* __restrict__ out, int d) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* Os = smem;  // TILE_R x DC accumulator, reuses the staged tile's space
  const int rb = blockIdx.x;
  const int c0 = blockIdx.y * DC;
  stream_slice<T, TILE_R>(tiles, tile_cb, tile_ptr, strips, strip_rb, strip_cb,
                          strip_ptr, strip_order, x, d, rb, c0, smem, Os, DC);

  // ---- write every row of the block once ----
  for (int i = threadIdx.x; i < TILE_R * DC / 4; i += NT) {
    const int r = i / (DC / 4), c = (i % (DC / 4)) * 4;
    if (c0 + c < d)
      *reinterpret_cast<float4*>(out + (size_t)(rb * TILE_R + r) * d + c0 + c) =
          *reinterpret_cast<const float4*>(Os + r * DC + c);
  }
}

template <typename T, int TILE_R>
cudaError_t launch(const void* tiles, const int* tile_cb, const int* tile_ptr,
                   const void* strips, const int* strip_rb, const int* strip_cb,
                   const int* strip_ptr, const int* strip_order, const float* x,
                   float* out, int n_row_blocks, int d, cudaStream_t stream) {
  const size_t smem = sizeof(float) * stream_smem_floats<TILE_R>();
  cudaError_t err = cudaFuncSetAttribute(
      bsr_spmm_kernel<T, TILE_R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(n_row_blocks, (d + DC - 1) / DC);
  bsr_spmm_kernel<T, TILE_R><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(tiles), tile_cb, tile_ptr, static_cast<const T*>(strips),
      strip_rb, strip_cb, strip_ptr, strip_order, x, out, d);
  return cudaGetLastError();
}

template <typename T>
int dispatch(const void* tiles, const int* tile_cb, const int* tile_ptr,
             const void* strips, const int* strip_rb, const int* strip_cb,
             const int* strip_ptr, const int* strip_order, const float* x,
             float* out, int n_row_blocks, int tile_r, int d, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define BSR_CASE(R)                                                              \
  case R:                                                                        \
    return (int)launch<T, R>(tiles, tile_cb, tile_ptr, strips, strip_rb, strip_cb, \
                             strip_ptr, strip_order, x, out, n_row_blocks, d, s);
  switch (tile_r) {
    BSR_CASE(32)
    BSR_CASE(64)
    BSR_CASE(128)
    BSR_CASE(256)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef BSR_CASE
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 on success). tile_ptr and
// strip_ptr hold n_row_blocks + 1 offsets; strip_order lists the live strips
// of each row block grouped by column block.
int bsr_spmm_f32(const void* tiles, const int* tile_cb, const int* tile_ptr,
                 const void* strips, const int* strip_rb, const int* strip_cb,
                 const int* strip_ptr, const int* strip_order, const float* x,
                 float* out, int n_row_blocks, int tile_r, int d, void* stream) {
  return dispatch<float>(tiles, tile_cb, tile_ptr, strips, strip_rb, strip_cb,
                         strip_ptr, strip_order, x, out, n_row_blocks, tile_r, d,
                         stream);
}

int bsr_spmm_bf16(const void* tiles, const int* tile_cb, const int* tile_ptr,
                  const void* strips, const int* strip_rb, const int* strip_cb,
                  const int* strip_ptr, const int* strip_order, const float* x,
                  float* out, int n_row_blocks, int tile_r, int d, void* stream) {
  return dispatch<__nv_bfloat16>(tiles, tile_cb, tile_ptr, strips, strip_rb,
                                 strip_cb, strip_ptr, strip_order, x, out,
                                 n_row_blocks, tile_r, d, stream);
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

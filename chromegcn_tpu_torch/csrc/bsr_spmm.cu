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
// What this design does about it:
// - One CTA per (output row block of tile_r rows, slice of DC=64 columns).
//   The TPU grid ran in order and accumulated into a VMEM-resident output;
//   here CTAs run in parallel, each owns its output rows outright and
//   writes each once, so there are no atomics and the summation order is
//   fixed from run to run. Rows with no blocks are written as zeros.
// - Tiles: the CTA walks its row block's tiles through row pointers built on
//   the host from the live count (padding tiles sit at block (0, 0) after
//   the live ones and are never visited). Tile and x block are staged in
//   shared memory and each thread keeps a (tile_r/16 x 4) register
//   accumulator, so every shared-memory load feeds several FFMAs.
// - Strips: after the tiles, the accumulator moves to shared memory and all
//   256 threads share each strip's 8 x 64 outputs. Strips come in an order
//   grouped by column block, so strips that share an x block load it once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <type_traits>

namespace {

constexpr int TC = 128;      // tile / strip column width (x block height)
constexpr int SR = 8;        // strip rows
constexpr int DC = 64;       // output columns per CTA
constexpr int NT = 256;      // threads per CTA (16 x 16)
constexpr int LDA = TC + 4;  // padded shared-memory row stride of a staged tile

__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const __nv_bfloat162* q = reinterpret_cast<const __nv_bfloat162*>(p);
  const float2 a = __bfloat1622float2(q[0]);
  const float2 b = __bfloat1622float2(q[1]);
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <typename T, int TILE_R>
__global__ void __launch_bounds__(NT) bsr_spmm_kernel(
    const T* __restrict__ tiles, const int* __restrict__ tile_cb,
    const int* __restrict__ tile_ptr, const T* __restrict__ strips,
    const int* __restrict__ strip_rb, const int* __restrict__ strip_cb,
    const int* __restrict__ strip_ptr, const int* __restrict__ strip_order,
    const float* __restrict__ x, float* __restrict__ out, int d) {
  constexpr int TM = TILE_R / 16;  // accumulator rows per thread
  constexpr bool kRoundX = std::is_same<T, __nv_bfloat16>::value;
  extern __shared__ float4 smem4[];
  float* As = reinterpret_cast<float*>(smem4);  // TILE_R x LDA staged tile
  float* Bs = As + TILE_R * LDA;                // TC x DC x block
  float* Ss = Bs + TC * DC;                     // SR x TC staged strip
  float* Os = As;  // TILE_R x DC accumulator, reuses As after the tile phase

  const int rb = blockIdx.x;
  const int c0 = blockIdx.y * DC;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;

  // x rows [cb*TC, +TC), columns [c0, c0+DC) -> Bs; columns past d read 0.
  auto load_x = [&](int cb) {
    for (int i = tid; i < TC * DC / 4; i += NT) {
      const int k = i / (DC / 4), c = (i % (DC / 4)) * 4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (c0 + c < d) v = load4(x + (size_t)(cb * TC + k) * d + c0 + c);
      if constexpr (kRoundX) {
        v.x = round_bf16(v.x); v.y = round_bf16(v.y);
        v.z = round_bf16(v.z); v.w = round_bf16(v.w);
      }
      *reinterpret_cast<float4*>(Bs + k * DC + c) = v;
    }
  };

  float acc[TM][4];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  // ---- tiles: acc[rows ty*TM.., cols tx*4..] += tile @ x block ----
  const int t_end = tile_ptr[rb + 1];
  for (int t = tile_ptr[rb]; t < t_end; ++t) {
    __syncthreads();  // the previous tile's compute is done with As / Bs
    const T* tp = tiles + (size_t)t * TILE_R * TC;
    for (int i = tid; i < TILE_R * TC / 4; i += NT) {
      const int r = i / (TC / 4), c = (i % (TC / 4)) * 4;
      *reinterpret_cast<float4*>(As + r * LDA + c) = load4(tp + r * TC + c);
    }
    load_x(tile_cb[t]);
    __syncthreads();
#pragma unroll 2
    for (int k = 0; k < TC; k += 4) {
      float4 b[4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        b[kk] = *reinterpret_cast<const float4*>(Bs + (k + kk) * DC + tx * 4);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float4 a4 = *reinterpret_cast<const float4*>(As + (ty * TM + i) * LDA + k);
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

  // ---- accumulator -> shared memory ----
  __syncthreads();  // all threads are done reading As
#pragma unroll
  for (int i = 0; i < TM; ++i)
    *reinterpret_cast<float4*>(Os + (ty * TM + i) * DC + tx * 4) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);

  // ---- strips: each thread owns 2 of the strip's 8 x 64 outputs ----
  const int sr = tid / 32, sc = tid % 32;
  int prev_cb = -1;
  const int q_end = strip_ptr[rb + 1];
  for (int q = strip_ptr[rb]; q < q_end; ++q) {
    const int s = strip_order[q];
    const int cb = strip_cb[s];
    __syncthreads();  // the previous strip is done with Bs / Ss; Os stores visible
    if (cb != prev_cb) {  // uniform across the CTA
      load_x(cb);
      prev_cb = cb;
    }
    {
      const int r = tid / (TC / 4), c = (tid % (TC / 4)) * 4;  // SR*TC/4 == NT
      *reinterpret_cast<float4*>(Ss + r * TC + c) =
          load4(strips + (size_t)s * SR * TC + r * TC + c);
    }
    __syncthreads();
    float o0 = 0.f, o1 = 0.f;
#pragma unroll 8
    for (int k = 0; k < TC; ++k) {
      const float a = Ss[sr * TC + k];
      o0 = fmaf(a, Bs[k * DC + sc], o0);
      o1 = fmaf(a, Bs[k * DC + sc + 32], o1);
    }
    const int lr = strip_rb[s] * SR - rb * TILE_R + sr;
    Os[lr * DC + sc] += o0;
    Os[lr * DC + sc + 32] += o1;
  }
  __syncthreads();

  // ---- write every row of the block once ----
  for (int i = tid; i < TILE_R * DC / 4; i += NT) {
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
  static_assert(SR * TC / 4 == NT, "one float4 of a strip per thread");
  static_assert(TILE_R % 16 == 0, "16 row groups of threads");
  const size_t smem = sizeof(float) * (TILE_R * LDA + TC * DC + SR * TC);
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

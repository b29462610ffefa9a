// The row gather over one direction's edge form (CSR), shared by the SpMM
// kernel (bsr_spmm.cu) and the fused backward kernel (gcn_fused_bwd.cu).
//
// One warp computes one output row, (A @ x)[row, c0 : c0 + 128 NCH]: lane l
// owns the float4s at columns c0 + 4 l + 128 j, j < NCH. The row's entries
// come in batches of up to 32 (col, val) pairs, one coalesced load with one
// pair per lane, and are broadcast with __shfl_sync. UNROLL neighbours' x
// rows are loaded (read-only path) before their FMAs, so the warp waits on
// L2 once per UNROLL entries rather than once per entry. Entries are summed
// in ascending column order, with no atomics: the result is the same from
// run to run. An empty row gives zeros.
//
// val is f32 or bf16, x is f32; bf16 entries take x rounded to bf16
// (round-to-nearest-even) and sum in f32, as the TPU kernels do.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <type_traits>

namespace csr {

constexpr int WARP = 32;
constexpr int LANE_COLS = 4 * WARP;  // columns one warp covers per float4 step
constexpr int UNROLL = 4;            // x rows in flight per warp
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// acc[j] = sum over the row's entries e of val[e] * x[col[e], c + 128 j : +4],
// c = c0 + 4 lane; a float4 at or past column d stays zero and is never
// loaded. d is a multiple of 4; every lane of the warp calls this with the
// same row.
template <typename T, int NCH>
__device__ __forceinline__ void gather_row(const int* __restrict__ row_ptr,
                                           const int* __restrict__ col,
                                           const T* __restrict__ val,
                                           const float* __restrict__ x, int d, int row,
                                           int c0, int lane, float4 (&acc)[NCH]) {
  constexpr bool kRoundX = std::is_same<T, __nv_bfloat16>::value;
  bool live[NCH];
#pragma unroll
  for (int j = 0; j < NCH; ++j) {
    acc[j] = make_float4(0.f, 0.f, 0.f, 0.f);
    live[j] = c0 + 4 * lane + LANE_COLS * j < d;
  }
  const float* xl = x + c0 + 4 * lane;
  const int end = __ldg(row_ptr + row + 1);
  for (int p = __ldg(row_ptr + row); p < end; p += WARP) {
    const int n = min(WARP, end - p);  // uniform across the warp
    int my_col = 0;
    float my_val = 0.f;
    if (lane < n) {
      my_col = __ldg(col + p + lane);
      my_val = to_float(val[p + lane]);
    }
    for (int k = 0; k < n; k += UNROLL) {
      float v[UNROLL];
      float4 xv[UNROLL][NCH];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        // lanes past n (and k + u past 31) hold no entry: v is masked below
        const int cu = __shfl_sync(FULL, my_col, (k + u) & (WARP - 1));
        v[u] = __shfl_sync(FULL, my_val, (k + u) & (WARP - 1));
#pragma unroll
        for (int j = 0; j < NCH; ++j) {
          xv[u][j] = make_float4(0.f, 0.f, 0.f, 0.f);
          if (k + u < n && live[j])
            xv[u][j] = __ldg(reinterpret_cast<const float4*>(xl + (size_t)cu * d +
                                                             LANE_COLS * j));
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (k + u < n) {  // uniform across the warp
#pragma unroll
          for (int j = 0; j < NCH; ++j) {
            float4 b = xv[u][j];
            if constexpr (kRoundX) {
              b.x = round_bf16(b.x); b.y = round_bf16(b.y);
              b.z = round_bf16(b.z); b.w = round_bf16(b.w);
            }
            acc[j].x = fmaf(v[u], b.x, acc[j].x);
            acc[j].y = fmaf(v[u], b.y, acc[j].y);
            acc[j].z = fmaf(v[u], b.z, acc[j].z);
            acc[j].w = fmaf(v[u], b.w, acc[j].w);
          }
        }
      }
    }
  }
}

}  // namespace csr

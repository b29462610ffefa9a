// The row gather over one direction's edge form (CSR), shared by the SpMM
// kernel (bsr_spmm.cu) and the fused backward kernel (gcn_fused_bwd.cu).
//
// One warp computes one output row, (A @ x)[row, c0 : c0 + 32 VEC NCH]: lane
// l owns the VEC-wide vectors at columns c0 + VEC l + 32 VEC j, j < NCH.
// VEC is 4 (float4) where d % 4 == 0, the only width the fused kernels take;
// the SpMM kernel also takes VEC 2 (float2) where d % 4 == 2 and VEC 1
// (scalars) where d is odd, since a row of x is then aligned to 8 or 4 bytes
// only. The row's entries come in batches of up to 32 (col, val) pairs, one
// coalesced load with one pair per lane, and are broadcast with __shfl_sync.
// UNROLL neighbours' x rows are loaded (read-only path) before their FMAs,
// so the warp waits on L2 once per UNROLL entries rather than once per
// entry. Entries are summed in ascending column order, with no atomics: the
// result is the same from run to run. An empty row gives zeros.
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

// The vector type of VEC floats, and what the gather does with one.
template <int VEC> struct Vec;
template <> struct Vec<4> { using type = float4; };
template <> struct Vec<2> { using type = float2; };
template <> struct Vec<1> { using type = float; };

__device__ __forceinline__ void set_zero(float4& a) { a = make_float4(0.f, 0.f, 0.f, 0.f); }
__device__ __forceinline__ void set_zero(float2& a) { a = make_float2(0.f, 0.f); }
__device__ __forceinline__ void set_zero(float& a) { a = 0.f; }

__device__ __forceinline__ void load_x(float4& a, const float* p) {
  a = __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ void load_x(float2& a, const float* p) {
  a = __ldg(reinterpret_cast<const float2*>(p));
}
__device__ __forceinline__ void load_x(float& a, const float* p) { a = __ldg(p); }

__device__ __forceinline__ void round_in_place(float4& b) {
  b.x = round_bf16(b.x); b.y = round_bf16(b.y);
  b.z = round_bf16(b.z); b.w = round_bf16(b.w);
}
__device__ __forceinline__ void round_in_place(float2& b) {
  b.x = round_bf16(b.x); b.y = round_bf16(b.y);
}
__device__ __forceinline__ void round_in_place(float& b) { b = round_bf16(b); }

__device__ __forceinline__ void fma_into(float v, const float4& b, float4& acc) {
  acc.x = fmaf(v, b.x, acc.x);
  acc.y = fmaf(v, b.y, acc.y);
  acc.z = fmaf(v, b.z, acc.z);
  acc.w = fmaf(v, b.w, acc.w);
}
__device__ __forceinline__ void fma_into(float v, const float2& b, float2& acc) {
  acc.x = fmaf(v, b.x, acc.x);
  acc.y = fmaf(v, b.y, acc.y);
}
__device__ __forceinline__ void fma_into(float v, const float& b, float& acc) {
  acc = fmaf(v, b, acc);
}

// acc[j] = sum over the row's entries e of val[e] * x[col[e], c + 32 VEC j : +VEC],
// c = c0 + VEC lane; a vector at or past column d stays zero and is never
// loaded. d is a multiple of VEC and x 16-byte aligned, so every load is
// aligned; every lane of the warp calls this with the same row.
template <typename T, int NCH, int VEC = 4>
__device__ __forceinline__ void gather_row(const int* __restrict__ row_ptr,
                                           const int* __restrict__ col,
                                           const T* __restrict__ val,
                                           const float* __restrict__ x, int d, int row,
                                           int c0, int lane,
                                           typename Vec<VEC>::type (&acc)[NCH]) {
  using V = typename Vec<VEC>::type;
  constexpr int COLS = VEC * WARP;  // columns the warp covers per vector step
  constexpr bool kRoundX = std::is_same<T, __nv_bfloat16>::value;
  bool live[NCH];
#pragma unroll
  for (int j = 0; j < NCH; ++j) {
    set_zero(acc[j]);
    live[j] = c0 + VEC * lane + COLS * j < d;
  }
  const float* xl = x + c0 + VEC * lane;
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
      V xv[UNROLL][NCH];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        // lanes past n (and k + u past 31) hold no entry: v is masked below
        const int cu = __shfl_sync(FULL, my_col, (k + u) & (WARP - 1));
        v[u] = __shfl_sync(FULL, my_val, (k + u) & (WARP - 1));
#pragma unroll
        for (int j = 0; j < NCH; ++j) {
          set_zero(xv[u][j]);
          if (k + u < n && live[j]) load_x(xv[u][j], xl + (size_t)cu * d + COLS * j);
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (k + u < n) {  // uniform across the warp
#pragma unroll
          for (int j = 0; j < NCH; ++j) {
            V b = xv[u][j];
            if constexpr (kRoundX) round_in_place(b);
            fma_into(v[u], b, acc[j]);
          }
        }
      }
    }
  }
}

}  // namespace csr

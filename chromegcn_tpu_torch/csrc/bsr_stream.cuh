// The block stream of the fused forward kernel (gcn_fused.cu): one CTA's
// walk over the live tiles and strips of one output row block, for one
// slice of DC columns.
//
// A is one direction of a BSROperator (forward A, or A^T for the backward
// pass): nt dense (TILE_R x 128) tiles, tile t adding
// tiles[t] @ x[cb*128 : +128] to rows [rb*TILE_R, +TILE_R), and ns dense
// (8 x 128) strips for the straggler edges, strip s adding
// strips[s] @ x[cb*128 : +128] to rows [rb8*8, +8). Tiles are f32 or bf16;
// x is f32. bf16 tiles take x rounded to bf16 (round-to-nearest-even) and
// accumulate in f32, as the TPU kernels do.
//
// The walk:
// - Tiles: the CTA walks its row block's tiles through row pointers built on
//   the host from the live count (padding tiles sit at block (0, 0) after
//   the live ones and are never visited). Tile and x block are staged in
//   shared memory and each thread keeps a (TILE_R/16 x 4) register
//   accumulator, so every shared-memory load feeds several FFMAs.
// - Strips: after the tiles, the accumulator moves to shared memory and all
//   256 threads share each strip's 8 x 64 outputs. Strips come in an order
//   grouped by column block, so strips that share an x block load it once.
// Rows with no blocks come out as zeros, and each row's sum is taken in a
// fixed order, with no atomics.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <type_traits>

namespace bsr {

constexpr int TC = 128;      // tile / strip column width (x block height)
constexpr int SR = 8;        // strip rows
constexpr int DC = 64;       // output columns per slice
constexpr int NT = 256;      // threads per CTA (16 x 16)
constexpr int LDA = TC + 4;  // padded shared-memory row stride of a staged tile

// Shared-memory floats the walk stages through: a tile, an x block, a strip.
template <int TILE_R>
__host__ __device__ constexpr int stream_smem_floats() {
  return TILE_R * LDA + TC * DC + SR * TC;
}

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

// Os[r * ldo + c] = (A @ x)[rb*TILE_R + r, c0 + c] for r < TILE_R, c < DC;
// columns past d come out as zeros. smem holds stream_smem_floats<TILE_R>()
// floats. Os may alias the start of smem (the staged tile), which the walk
// is done with before it writes Os. Ends with __syncthreads(): Os is then
// complete and visible to every thread, and smem is free again.
template <typename T, int TILE_R>
__device__ __forceinline__ void stream_slice(
    const T* __restrict__ tiles, const int* __restrict__ tile_cb,
    const int* __restrict__ tile_ptr, const T* __restrict__ strips,
    const int* __restrict__ strip_rb, const int* __restrict__ strip_cb,
    const int* __restrict__ strip_ptr, const int* __restrict__ strip_order,
    const float* __restrict__ x, int d, int rb, int c0, float* smem, float* Os,
    int ldo) {
  constexpr int TM = TILE_R / 16;  // accumulator rows per thread
  constexpr bool kRoundX = std::is_same<T, __nv_bfloat16>::value;
  static_assert(SR * TC / 4 == NT, "one float4 of a strip per thread");
  static_assert(TILE_R % 16 == 0, "16 row groups of threads");
  float* As = smem;              // TILE_R x LDA staged tile
  float* Bs = As + TILE_R * LDA;  // TC x DC x block
  float* Ss = Bs + TC * DC;       // SR x TC staged strip

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
  __syncthreads();  // all threads are done reading As (Os may alias it)
#pragma unroll
  for (int i = 0; i < TM; ++i)
    *reinterpret_cast<float4*>(Os + (ty * TM + i) * ldo + tx * 4) =
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
    Os[lr * ldo + sc] += o0;
    Os[lr * ldo + sc + 32] += o1;
  }
  __syncthreads();
}

}  // namespace bsr

// The gather-and-multiply core of the fused layer's kernels, shared by the
// forward kernel B2 (gcn_fused.cu: z = tanh((A x) W + b)) and the backward
// kernel B3 (gcn_fused_bwd.cu: dx = dx_dir + (A^T ds) W^T).
//
// One CTA owns R consecutive rows (R 64 up to d 256, then 32 up to d 640,
// then 16, so the plan fits every width the fused layer admits):
// - Its 8 warps gather those rows of h = A @ x with the row gather of
//   csr_gather.cuh (8 bytes per nonzero, ascending column order, no
//   atomics) into a padded shared-memory tile, R x (k_extent(d) + 4) floats,
//   zero-filled past d and past n_rows. An empty row gives zeros. The
//   caller's epilogue sees each gathered float4 (B3 writes h from there).
// - It then multiplies the tile by W (or W^T) on tensor cores:
//   mma.sync.m16n8k8 in TF32, each operand split as big = tf32(a),
//   small = tf32(a - big), and acc += small*big + big*small + big*big in f32
//   (3xTF32). The dropped small*small term is at most 2^-22 of a product,
//   so the product stays f32-faithful (the reference runs
//   Precision.HIGHEST; plain TF32 would keep ~3 digits). The split rounds as
//   cvt.rna.tf32.f32 does, in integer operations, which issue four times as
//   fast as the conversion.
// - W is staged in chunks of 64 output columns x 32 k with cp.async, two
//   buffers: the first chunk lands while the warps gather, and each next one
//   while the tensor cores work on the current one.
// - Each fragment's epilogue operand (B3: dx_dir; B2: the bias) is loaded
//   when its 64 output columns start, and the fragment is handed to the
//   epilogue when their k loop ends.
//
// The epilogue is a struct with three members, called for rows < n_rows and
// columns < d only:
//   void gathered(int row, int c, float4 h)  h[row, c : c + 4], during the gather
//   float2 load(int r, int n)                the operand for [r, n : n + 2]
//   void store(int r, int n, float2 pre, float a0, float a1)
//                                            the product's [r, n] and [r, n + 1]

#pragma once

#include <type_traits>

#include "csr_gather.cuh"

namespace gmma {

using namespace csr;

constexpr int NT = 256;  // threads per CTA: 8 warps
constexpr int NWARPS = NT / WARP;
constexpr int NC = 64;   // output columns per staged W chunk
constexpr int KC = 32;   // k per staged W chunk

// rows per CTA at width d
__host__ __device__ constexpr int rows_per_cta(int d) {
  return d <= 256 ? 64 : (d <= 640 ? 32 : 16);
}
// h's k extent in shared memory: d padded to whole W chunks, zero-filled
__host__ __device__ constexpr int k_extent(int d) { return (d + KC - 1) / KC * KC; }

// One staged chunk of W, B[k][n] for k in [k0, k0 + KC), n in [n0, n0 + NC).
// kTransW (B3, h W^T): B[k][n] = W[n][k], so W's rows are output columns,
// staged as NC rows of KC floats at stride KC + 4. Otherwise (B2, h W):
// B[k][n] = W[k][n], staged as KC rows of NC floats at stride NC + 8. Either
// stride puts the B fragment's loads of a warp on 32 distinct banks, and
// each cp.async copies 16 contiguous bytes of one row of W.
template <bool kTransW>
struct WChunk {
  static constexpr int ROWS = kTransW ? NC : KC;
  static constexpr int COLS = kTransW ? KC : NC;
  static constexpr int LD = kTransW ? KC + 4 : NC + 8;
  static constexpr int SIZE = ROWS * LD;
  // offset of B[k][n] in the chunk; linear in k and n
  static __host__ __device__ constexpr int at(int k, int n) {
    return kTransW ? n * LD + k : k * LD + n;
  }
};

// Dynamic shared memory of one CTA at width d: the tile of h and two W chunks
template <bool kTransW>
size_t smem_bytes(int d) {
  return sizeof(float) *
         ((size_t)rows_per_cta(d) * (k_extent(d) + 4) + 2 * WChunk<kTransW>::SIZE);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  // src_bytes 0 fills the 16 bytes with zeros and reads nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// a rounded to TF32 as cvt.rna.tf32.f32 rounds it (to nearest, ties away
// from zero; the 13 low bits zero), in two integer operations, which issue
// at four times the rate of a conversion
__device__ __forceinline__ unsigned tf32_rna(float a) {
  return (__float_as_uint(a) + 0x1000u) & 0xffffe000u;
}

// 3xTF32 operand split: big = tf32(a), small = tf32(a - big)
__device__ __forceinline__ void split_tf32(float a, unsigned& big, unsigned& small) {
  big = tf32_rna(a);
  small = tf32_rna(a - __uint_as_float(big));
}

// c += a b for one 16 x 8 x 8 TF32 tile (a row-major 16 x 8, b col-major 8 x 8)
__device__ __forceinline__ void mma_tf32(float (&c)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The CTA's rows [blockIdx.x R, + R): h = A @ x over the edge form
// (row_ptr, col, val), then h W (or h W^T) handed to epi fragment by
// fragment. x (n_cols, d) and w (d, d) are f32, d a multiple of 4.
template <typename T, int R, bool kTransW, typename Epilogue>
__device__ __forceinline__ void gather_mma(const int* __restrict__ row_ptr,
                                           const int* __restrict__ col,
                                           const T* __restrict__ val,
                                           const float* __restrict__ x,
                                           const float* __restrict__ w, int n_rows, int d,
                                           Epilogue& epi) {
  using Chunk = WChunk<kTransW>;
  constexpr int RG = R / 16;       // warps along rows: one 16-row mma tile each
  constexpr int CG = NWARPS / RG;  // warps along a chunk's 64 columns
  constexpr int WN = NC / CG;      // columns per warp per chunk
  constexpr int NT8 = WN / 8;      // 8-column mma tiles per warp
  static_assert(RG * CG == NWARPS && NT8 >= 1, "warp layout");
  extern __shared__ float4 smem4[];
  const int dk = k_extent(d), ldh = dk + 4;  // ldh / 4 is odd: conflict-free
  float* Hs = reinterpret_cast<float*>(smem4);  // R x ldh tile of h
  float* Ws = Hs + R * ldh;                     // two W chunks
  const int tid = threadIdx.x, lane = tid % WARP, warp = tid / WARP;
  const int row0 = blockIdx.x * R;
  const int n_k = dk / KC;
  const int n_chunks = n_k * ((d + NC - 1) / NC);

  // chunk q of B: output columns [n0, n0 + NC), k [k0, k0 + KC); zeros past d
  auto stage_w = [&](int q) {
    const int n0 = (q / n_k) * NC, k0 = (q % n_k) * KC;
    const int w_row0 = kTransW ? n0 : k0, w_col0 = kTransW ? k0 : n0;
    float* dst = Ws + (q & 1) * Chunk::SIZE;
    for (int i = tid; i < Chunk::ROWS * Chunk::COLS / 4; i += NT) {
      const int rr = i / (Chunk::COLS / 4), cc = (i % (Chunk::COLS / 4)) * 4;
      const bool in = w_row0 + rr < d && w_col0 + cc < d;
      cp_async16(dst + rr * Chunk::LD + cc,
                 in ? w + (size_t)(w_row0 + rr) * d + w_col0 + cc : w, in ? 16 : 0);
    }
    cp_async_commit();
  };
  stage_w(0);  // lands while the warps gather

  // ---- gather: h = A @ x for rows [row0, row0 + R) ----
  for (int i = warp; i < R; i += NWARPS) {
    const int row = row0 + i;
    float* hs = Hs + i * ldh;
    int c_zero = 0;  // the row's columns from here to dk are zero
    if (row < n_rows) {
      for (int c0 = 0; c0 < d; c0 += LANE_COLS) {
        float4 acc[1];
        gather_row<T, 1>(row_ptr, col, val, x, d, row, c0, lane, acc);
        const int c = c0 + 4 * lane;
        if (c < d) {
          epi.gathered(row, c, acc[0]);
          *reinterpret_cast<float4*>(hs + c) = acc[0];
        }
      }
      c_zero = d;
    }
    for (int c = c_zero + 4 * lane; c < dk; c += LANE_COLS)
      *reinterpret_cast<float4*>(hs + c) = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  // ---- the product, chunk by chunk, 3xTF32 ----
  const int rg = warp % RG, cg = warp / RG;
  const int g = lane / 4, t = lane % 4;  // mma fragment coordinates
  const float* Ha = Hs + (rg * 16 + g) * ldh + t;
  float acc[NT8][4];
  float2 pre[NT8][2];  // this thread's epilogue operands, loaded while the k loop runs
  for (int q = 0; q < n_chunks; ++q) {
    const int kq = q % n_k;
    const int n_base = (q / n_k) * NC + cg * WN + 2 * t;  // d is a multiple of 4, so
    if (kq == 0) {                                        // n < d means n + 1 < d too
#pragma unroll
      for (int j = 0; j < NT8; ++j) {
        acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int n = n_base + 8 * j, r = row0 + rg * 16 + g + 8 * half;
          pre[j][half] = n < d && r < n_rows ? epi.load(r, n) : make_float2(0.f, 0.f);
        }
      }
    }
    if (q + 1 < n_chunks) {
      stage_w(q + 1);  // its buffer was last read in iteration q - 1
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // chunk q, and (at q 0) every row of Hs, visible to all
    const float* Wb = Ws + (q & 1) * Chunk::SIZE + Chunk::at(t, cg * WN + g);
#pragma unroll
    for (int kk = 0; kk < KC; kk += 8) {
      const int k = kq * KC + kk;
      unsigned a_big[4], a_small[4];
      split_tf32(Ha[k], a_big[0], a_small[0]);
      split_tf32(Ha[8 * ldh + k], a_big[1], a_small[1]);
      split_tf32(Ha[k + 4], a_big[2], a_small[2]);
      split_tf32(Ha[8 * ldh + k + 4], a_big[3], a_small[3]);
#pragma unroll
      for (int j = 0; j < NT8; ++j) {
        unsigned b_big[2], b_small[2];
        split_tf32(Wb[Chunk::at(kk, 8 * j)], b_big[0], b_small[0]);
        split_tf32(Wb[Chunk::at(kk + 4, 8 * j)], b_big[1], b_small[1]);
        mma_tf32(acc[j], a_small, b_big);
        mma_tf32(acc[j], a_big, b_small);
        mma_tf32(acc[j], a_big, b_big);
      }
    }
    __syncthreads();  // every warp is done with buffer q & 1 before it is restaged

    if (kq == n_k - 1) {  // the chunk's columns are complete
#pragma unroll
      for (int j = 0; j < NT8; ++j) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int n = n_base + 8 * j, r = row0 + rg * 16 + g + 8 * half;
          if (n < d && r < n_rows)
            epi.store(r, n, pre[j][half], acc[j][2 * half], acc[j][2 * half + 1]);
        }
      }
    }
  }
}

// Runs kernel over ceil(n_rows / R) CTAs of NT threads, with the dynamic
// shared memory of its plan at width d. Returns cudaGetLastError().
template <int R, bool kTransW, typename Kernel, typename... Args>
cudaError_t launch_rows(Kernel* kernel, int n_rows, int d, cudaStream_t stream,
                        Args... args) {
  const size_t smem = smem_bytes<kTransW>(d);
  // above 48 KB only after this call; a plan over the card's limit fails here
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<(n_rows + R - 1) / R, NT, smem, stream>>>(args...);
  return cudaGetLastError();
}

// f(std::integral_constant<int, R>) with R = rows_per_cta(d)
template <typename F>
cudaError_t with_rows_per_cta(int d, F&& f) {
  switch (rows_per_cta(d)) {
    case 64:
      return f(std::integral_constant<int, 64>{});
    case 32:
      return f(std::integral_constant<int, 32>{});
    default:
      return f(std::integral_constant<int, 16>{});
  }
}

}  // namespace gmma

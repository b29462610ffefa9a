// Fused gated-GCN layer, backward kernel for Hopper: h = A^T ds gathered
// over the edge form, then dx = dx_dir + h W^T on tensor cores in 3xTF32.
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
// (1.64 GFLOP, ~25 us of f32 FFMA at 67 TFLOP/s), so bytes bound it, but
// an FFMA epilogue alone would take most of that bound.
//
// What this design does about it:
// - One CTA owns R consecutive rows (R 64 up to d 256, then 32, then 16, so
//   the plan fits every width the fused layer admits). Its 8 warps gather
//   those rows of h with B1's row gather (csr_gather.cuh: 8 bytes per
//   nonzero, ascending column order, no atomics), store each row of h once
//   to device memory, and keep it in a padded shared-memory tile. The (N, d)
//   h is never read back. At d 128 a CTA takes 52 KB of shared memory, so
//   three CTAs (24 warps) share an SM and hide the gather's L2 latency.
// - The epilogue runs on tensor cores: mma.sync.m16n8k8 in TF32, with each
//   operand split as big = tf32(a), small = tf32(a - big), and
//   acc += small*big + big*small + big*big in f32 (3xTF32). The dropped
//   small*small term is at most 2^-22 of a product, so dx stays f32-faithful
//   (the reference runs Precision.HIGHEST; plain TF32 would keep ~3 digits).
//   The split rounds as cvt.rna.tf32.f32 does, in integer operations, which
//   issue four times as fast as the conversion. bf16 operators round ds to
//   bf16 in the gather; the epilogue is 3xTF32 in both modes.
// - W^T is staged in (64 output columns x 32 k) chunks with cp.async, two
//   buffers: the first chunk loads during the gather, and each next chunk
//   while the tensor cores work on the current one. W's rows are W^T's
//   columns, which is the layout mma's B operand wants, so no transpose.
//   Each thread's dx_dir is loaded when its 64 output columns start, and is
//   added when their k loop ends.
// - A row with no entries (padding included) gives h = 0 and dx = dx_dir.
//
// What holds it back: the gather (memory latency) and the epilogue (MMA,
// barriers per W chunk) run one after the other in every CTA, and the CTAs
// of a wave start together, so the two phases add up instead of overlapping.

#include "csr_gather.cuh"

namespace {

using namespace csr;

constexpr int NT = 256;          // threads per CTA: 8 warps
constexpr int NWARPS = NT / WARP;
constexpr int NC = 64;           // output columns (rows of W) per staged chunk
constexpr int KC = 32;           // k (columns of W) per staged chunk
constexpr int LDW = KC + 4;      // chunk row stride: conflict-free B fragment loads
constexpr int W_CHUNK = NC * LDW;

// rows per CTA at width d; the tile of h takes R x (d_k + 4) floats
__host__ __device__ constexpr int rows_per_cta(int d) {
  return d <= 256 ? 64 : (d <= 640 ? 32 : 16);
}
// h's k extent in shared memory: d padded to whole W chunks, zero-filled
__host__ __device__ constexpr int k_extent(int d) { return (d + KC - 1) / KC * KC; }

size_t smem_bytes(int d) {
  return sizeof(float) * ((size_t)rows_per_cta(d) * (k_extent(d) + 4) + 2 * W_CHUNK);
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

template <typename T, int R>
__global__ void __launch_bounds__(NT, 3) gcn_fused_bwd_kernel(
    const int* __restrict__ row_ptr, const int* __restrict__ col,
    const T* __restrict__ val, const float* __restrict__ ds,
    const float* __restrict__ dx_dir, const float* __restrict__ w,
    float* __restrict__ h, float* __restrict__ dx, int n_rows, int d) {
  constexpr int RG = R / 16;     // warps along rows: one 16-row mma tile each
  constexpr int CG = NWARPS / RG;  // warps along a chunk's 64 columns
  constexpr int WN = NC / CG;    // columns per warp per chunk
  constexpr int NT8 = WN / 8;    // 8-column mma tiles per warp
  static_assert(RG * CG == NWARPS && NT8 >= 1, "warp layout");
  extern __shared__ float4 smem4[];
  const int dk = k_extent(d), ldh = dk + 4;  // ldh / 4 is odd: conflict-free
  float* Hs = reinterpret_cast<float*>(smem4);  // R x ldh tile of h
  float* Ws = Hs + R * ldh;                     // two W chunks, NC x LDW each
  const int tid = threadIdx.x, lane = tid % WARP, warp = tid / WARP;
  const int row0 = blockIdx.x * R;
  const int n_k = dk / KC;
  const int n_chunks = n_k * ((d + NC - 1) / NC);

  // chunk q of W: rows [n0, n0 + NC), columns [k0, k0 + KC); zeros past d
  auto stage_w = [&](int q) {
    const int n0 = (q / n_k) * NC, k0 = (q % n_k) * KC;
    float* dst = Ws + (q & 1) * W_CHUNK;
    for (int i = tid; i < NC * KC / 4; i += NT) {
      const int nn = i / (KC / 4), kk = (i % (KC / 4)) * 4;
      const bool in = n0 + nn < d && k0 + kk < d;
      cp_async16(dst + nn * LDW + kk, in ? w + (size_t)(n0 + nn) * d + k0 + kk : w,
                 in ? 16 : 0);
    }
    cp_async_commit();
  };
  stage_w(0);  // lands while the warps gather

  // ---- gather: h = A^T ds for rows [row0, row0 + R) ----
  for (int i = warp; i < R; i += NWARPS) {
    const int row = row0 + i;
    float* hs = Hs + i * ldh;
    int c_zero = 0;  // the row's columns from here to dk are zero
    if (row < n_rows) {
      for (int c0 = 0; c0 < d; c0 += LANE_COLS) {
        float4 acc[1];
        gather_row<T, 1>(row_ptr, col, val, ds, d, row, c0, lane, acc);
        const int c = c0 + 4 * lane;
        if (c < d) {
          *reinterpret_cast<float4*>(h + (size_t)row * d + c) = acc[0];
          *reinterpret_cast<float4*>(hs + c) = acc[0];
        }
      }
      c_zero = d;
    }
    for (int c = c_zero + 4 * lane; c < dk; c += LANE_COLS)
      *reinterpret_cast<float4*>(hs + c) = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  // ---- epilogue: dx = dx_dir + h W^T, chunk by chunk, 3xTF32 ----
  const int rg = warp % RG, cg = warp / RG;
  const int g = lane / 4, t = lane % 4;  // mma fragment coordinates
  const float* Ha = Hs + (rg * 16 + g) * ldh + t;
  float acc[NT8][4];
  float2 dd[NT8][2];  // this thread's dx_dir, loaded while the chunk's k loop runs
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
          dd[j][half] = n < d && r < n_rows
                            ? __ldg(reinterpret_cast<const float2*>(dx_dir + (size_t)r * d + n))
                            : make_float2(0.f, 0.f);
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
    const float* Wb = Ws + (q & 1) * W_CHUNK + (cg * WN + g) * LDW + t;
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
        split_tf32(Wb[j * 8 * LDW + kk], b_big[0], b_small[0]);
        split_tf32(Wb[j * 8 * LDW + kk + 4], b_big[1], b_small[1]);
        mma_tf32(acc[j], a_small, b_big);
        mma_tf32(acc[j], a_big, b_small);
        mma_tf32(acc[j], a_big, b_big);
      }
    }
    __syncthreads();  // every warp is done with buffer q & 1 before it is restaged

    if (kq == n_k - 1) {  // the chunk's columns are complete: dx = dx_dir + acc
#pragma unroll
      for (int j = 0; j < NT8; ++j) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int n = n_base + 8 * j, r = row0 + rg * 16 + g + 8 * half;
          if (n < d && r < n_rows)
            *reinterpret_cast<float2*>(dx + (size_t)r * d + n) =
                make_float2(dd[j][half].x + acc[j][2 * half],
                            dd[j][half].y + acc[j][2 * half + 1]);
        }
      }
    }
  }
}

template <typename T, int R>
cudaError_t launch(const int* row_ptr, const int* col, const void* val, const float* ds,
                   const float* dx_dir, const float* w, float* h, float* dx, int n_rows,
                   int d, cudaStream_t stream) {
  const size_t smem = smem_bytes(d);
  // above 48 KB only after this call; a plan over the card's limit fails here
  cudaError_t err = cudaFuncSetAttribute(gcn_fused_bwd_kernel<T, R>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  gcn_fused_bwd_kernel<T, R><<<(n_rows + R - 1) / R, NT, smem, stream>>>(
      row_ptr, col, static_cast<const T*>(val), ds, dx_dir, w, h, dx, n_rows, d);
  return cudaGetLastError();
}

template <typename T>
int dispatch(const int* row_ptr, const int* col, const void* val, const float* ds,
             const float* dx_dir, const float* w, float* h, float* dx, int n_rows, int d,
             void* stream) {
  if (n_rows <= 0 || d <= 0 || d % 4 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (rows_per_cta(d)) {
    case 64:
      return (int)launch<T, 64>(row_ptr, col, val, ds, dx_dir, w, h, dx, n_rows, d, s);
    case 32:
      return (int)launch<T, 32>(row_ptr, col, val, ds, dx_dir, w, h, dx, n_rows, d, s);
    default:
      return (int)launch<T, 16>(row_ptr, col, val, ds, dx_dir, w, h, dx, n_rows, d, s);
  }
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
long long gcn_fused_bwd_smem_bytes(int d) { return (long long)smem_bytes(d); }

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

// Kernel F: the tensor cores' sustained rate on operands in shared memory.
//
// Replaces the Pallas TPU probe tools/exp_r5_mosaic_dot.py:_kernel (reached
// through rate()'s pallas_call), a roofline probe of the TPU's matrix unit
// with no model function: per grid step it multiplies the step's slab x[g]
// ([R, W, K] = M rows of K) by each of `ndots` resident weight matrices
// w[i] ([K, N]), sums the products and stores only row 0 of R (W rows) so
// that the dots are not dead code. Here, for each step g:
//
//   out[g, r, n] = sum_i sum_k x[g, 0, r, k] w[i, k, n]      (r < W)
//
// in s32 (s8 operands, exact) or f32 (bf16 operands), while every row of M
// is multiplied: the probe's work is 2 G M K N ndots operations.
//
// What bounds it on the H100: operations, by design (the probe's M = 3,584,
// N = 128 and K ndots = 1,536 give 0.50 ms of int8 and 1.00 ms of bf16
// tensor-core time a pass against 0.10-0.77 ms of bytes). Design:
//   * warpgroup MMAs from shared-memory descriptors, both operands K-major
//     with the 128-byte swizzle: s8 wgmma.m64n128k32, bf16 wgmma.m64n64k16;
//   * the weights stay resident in shared memory for the whole launch,
//     loaded once per block by TMA (a box of 128 bytes of K x the block's N
//     rows per (dot, 128-byte K chunk)). At N 128 the s8 weights take
//     ndots K 128 = 196,608 bytes for every (K, ndots) of the probe, and
//     bf16 twice that, which does not fit in the 227 KB a block can have:
//     a bf16 block owns N 64 (a slice; two slices, each block with one),
//     and the two slices' blocks read the same x (the second read mostly
//     from L2, since blocks 2j and 2j + 1 walk the same units);
//   * persistent blocks (one an SM), each walking units of 128 rows of one
//     step (two M tiles of 64, one a consumer warpgroup). A producer warp
//     (one thread issues) streams the unit's x by TMA, one 16 KB box of 128
//     rows x 128 bytes of K a stage, through a ring of 2-4 stages, running
//     ahead across units; the consumers only wait, issue MMAs and release:
//     per stage ndots x 4 wgmmas a warpgroup, all into one accumulator;
//   * epilogue: each thread stores its own sums of rows < W straight from
//     registers (the other rows are discarded, as on the TPU).
// No split-K, no atomics: the sums of integers are exact, and bf16 sums of
// integers below 2^24 are exact in any order.
// K must be a multiple of 128 bytes (s8: 128 values, bf16: 64), M = R W a
// multiple of 128, N = 128, and the weights must fit beside two stages.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int CONSUMERS = 256;                 // 2 warpgroups, an M tile (64 rows) each
constexpr int THREADS = CONSUMERS + 32;        // + the producer warp
constexpr int N = 128;                         // the probe's output channels
constexpr int UNIT_ROWS = 128;                 // rows of x a unit (both M tiles)
constexpr int STAGE = UNIT_ROWS * 128;         // 128 rows x 128 bytes of K (16 KB)
constexpr int MAX_STAGES = 4;
constexpr int HEAD = 1024;                     // barriers (the tiles stay 1,024-byte aligned)

template <typename T> struct Traits;
template <> struct Traits<int8_t> {
  static constexpr int BN = 128, KV = 128;     // a block's N; K values in 128 bytes
  static constexpr int ACC = BN / 2;           // s32 sums a thread (m64n128)
  using Acc = int;
};
template <> struct Traits<__nv_bfloat16> {
  static constexpr int BN = 64, KV = 64;
  static constexpr int ACC = BN / 2;           // f32 sums a thread (m64n64)
  using Acc = float;
};

// d += A (64 x 32 s8) x B (32 x 128 s8), both from shared memory
__device__ __forceinline__ void wgmma_s8_n128(int* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]),
        "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]),
        "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]),
        "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]),
        "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]),
        "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]),
        "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]),
        "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// d += A (64 x 16 bf16) x B (16 x 64 bf16), both K-major in shared memory
__device__ __forceinline__ void wgmma_bf16_n64(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, "
      "0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void mma(int* d, uint64_t da, uint64_t db) { wgmma_s8_n128(d, da, db); }
__device__ __forceinline__ void mma(float* d, uint64_t da, uint64_t db) { wgmma_bf16_n64(d, da, db); }

template <int N_>
__device__ __forceinline__ void pin(int* d) {
#pragma unroll
  for (int i = 0; i < N_; ++i) asm volatile("" : "+r"(d[i])::"memory");
}
template <int N_>
__device__ __forceinline__ void pin(float* d) { sm90::pin<N_>(d); }

struct Params {
  int steps, m, w_out, ndots;
  int nk;              // 128-byte K chunks
  int stages;
  int units;           // (step, 128-row group) pairs
};

template <typename T>
__global__ void __launch_bounds__(THREADS, 1) mma_rate_kernel(
    const __grid_constant__ CUtensorMap xmap,    // x as [steps * M rows][K]
    const __grid_constant__ CUtensorMap wmap,    // w^T as [ndots * 128 rows (n)][K]
    typename Traits<T>::Acc* __restrict__ out,   // [steps][W][128]
    const Params p) {
  using TR = Traits<T>;
  using Acc = typename TR::Acc;
  constexpr int WT = TR::BN * 128;              // one (dot, K chunk) weight tile
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = sm90::smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;   // swizzled tiles: 1,024-byte aligned
  const uint32_t full0 = base, empty0 = base + 8 * MAX_STAGES, wbar = base + 16 * MAX_STAGES;
  const uint32_t s_w = base + HEAD;
  const uint32_t s_ring = s_w + p.ndots * p.nk * WT;
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int slices = N / TR::BN;
  const int slice = blockIdx.x % slices, first = blockIdx.x / slices;
  const int step = gridDim.x / slices;
  const int groups = p.m / UNIT_ROWS;            // units of one step

  if (t == 0) {
    for (int s = 0; s < MAX_STAGES; ++s) {
      sm90::mbar_init(full0 + 8 * s, 1);
      sm90::mbar_init(empty0 + 8 * s, CONSUMERS / 32);
    }
    sm90::mbar_init(wbar, 1);
    sm90::mbar_init_fence();
  }
  __syncthreads();

  if (warp == CONSUMERS / 32) {
    // the producer: the weights once, then every unit's x in K chunks
    if (lane == 0 && first < p.units) {
      sm90::mbar_expect_tx(wbar, p.ndots * p.nk * WT);
      for (int i = 0; i < p.ndots; ++i)
        for (int c = 0; c < p.nk; ++c)
          sm90::tma_load_2d(s_w + (i * p.nk + c) * WT, &wmap, c * TR::KV,
                            i * N + slice * TR::BN, wbar);
      int k = 0;
      for (int u = first; u < p.units; u += step) {
        const int row = (u / groups) * p.m + (u % groups) * UNIT_ROWS;
        for (int c = 0; c < p.nk; ++c, ++k) {
          const int s = k % p.stages;
          sm90::mbar_wait(empty0 + 8 * s, ((k / p.stages) & 1) ^ 1);
          sm90::mbar_expect_tx(full0 + 8 * s, STAGE);
          sm90::tma_load_2d(s_ring + s * STAGE, &xmap, c * TR::KV, row, full0 + 8 * s);
        }
      }
    }
    return;
  }

  // the consumers: warpgroup wg owns rows 64 wg .. 64 wg + 63 of each unit
  const int wg = warp >> 2, w = warp & 3, g = lane >> 2, q = lane & 3;
  if (first < p.units) sm90::mbar_wait(wbar, 0);
  Acc acc[TR::ACC];
  int k = 0;
#pragma unroll 1
  for (int u = first; u < p.units; u += step) {
#pragma unroll
    for (int j = 0; j < TR::ACC; ++j) acc[j] = 0;
    pin<TR::ACC>(acc);
#pragma unroll 1
    for (int c = 0; c < p.nk; ++c, ++k) {
      const int s = k % p.stages;
      sm90::mbar_wait(full0 + 8 * s, (k / p.stages) & 1);
      const uint32_t a0 = s_ring + s * STAGE + wg * 64 * 128;
      sm90::wgmma_fence();
#pragma unroll 1
      for (int i = 0; i < p.ndots; ++i) {
        const uint32_t b0 = s_w + (i * p.nk + c) * WT;
#pragma unroll
        for (int j = 0; j < 4; ++j)              // 32 bytes of K a step
          mma(acc, sm90::desc_sw128(a0 + 32 * j), sm90::desc_sw128(b0 + 32 * j));
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<1>();
      pin<TR::ACC>(acc);
      if (k > 0) {                               // stage k - 1's wgmmas are done
        __syncwarp();
        if (lane == 0) sm90::mbar_arrive(empty0 + 8 * ((k - 1) % p.stages));
      }
    }
    sm90::wgmma_wait<0>();
    pin<TR::ACC>(acc);
    // acc[4j + 2h + e]: unit row 64 wg + 16 w + g + 8 h, column 8 j + 2 q + e
    const int gstep = u / groups;
    const int row0 = (u % groups) * UNIT_ROWS + 64 * wg + 16 * w + g;
    if (row0 - g < p.w_out) {                    // warp-uniform: some row of the warp stored
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row0 + 8 * h;
        if (r >= p.w_out) continue;
        Acc* o = out + (static_cast<size_t>(gstep) * p.w_out + r) * N + slice * TR::BN + 2 * q;
#pragma unroll
        for (int j = 0; j < TR::BN / 8; ++j) {
          o[8 * j] = acc[4 * j + 2 * h];
          o[8 * j + 1] = acc[4 * j + 2 * h + 1];
        }
      }
    }
  }
  // the last stage of the block is released with the launch's end
}

template <typename T>
int launch(const void* x, const void* wt, void* out, int steps, int m, int w_out, int K,
           int ndots, cudaStream_t st) {
  using TR = Traits<T>;
  if (steps == 0) return static_cast<int>(cudaSuccess);
  if (K % TR::KV != 0 || m % UNIT_ROWS != 0 || w_out > m || ndots < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  int sms = 0, optin = 0;
  cudaError_t e = sm90::device_limits(&sms, &optin);
  if (e != cudaSuccess) return static_cast<int>(e);

  Params p;
  p.steps = steps, p.m = m, p.w_out = w_out, p.ndots = ndots;
  p.nk = K / TR::KV;
  const int wbytes = ndots * p.nk * TR::BN * 128;
  const int fixed = 1024 + HEAD + wbytes;       // + the 1,024-byte alignment
  const int per = optin > fixed ? (optin - fixed) / STAGE : 0;
  if (per < 2) return static_cast<int>(cudaErrorInvalidValue);   // weights too large
  p.stages = per < MAX_STAGES ? per : MAX_STAGES;
  const int smem = fixed + p.stages * STAGE;
  p.units = steps * (m / UNIT_ROWS);
  e = sm90::allow_smem<mma_rate_kernel<T>>(smem);
  if (e != cudaSuccess) return static_cast<int>(e);

  const CUtensorMapDataType type =
      sizeof(T) == 1 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const cuuint64_t row_bytes = static_cast<cuuint64_t>(K) * sizeof(T);
  CUtensorMap xmap, wmap;
  {
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(K),
                                static_cast<cuuint64_t>(steps) * static_cast<cuuint64_t>(m)};
    const cuuint32_t box[2] = {static_cast<cuuint32_t>(TR::KV), UNIT_ROWS};
    e = sm90::encode_tensor_map(&xmap, type, 2, x, dims, &row_bytes, box,
                                CU_TENSOR_MAP_SWIZZLE_128B);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  {
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(ndots) * N};
    const cuuint32_t box[2] = {static_cast<cuuint32_t>(TR::KV), static_cast<cuuint32_t>(TR::BN)};
    e = sm90::encode_tensor_map(&wmap, type, 2, wt, dims, &row_bytes, box,
                                CU_TENSOR_MAP_SWIZZLE_128B);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int slices = N / TR::BN;
  int per_slice = sms / slices;
  if (per_slice > p.units) per_slice = p.units;
  if (per_slice < 1) per_slice = 1;
  mma_rate_kernel<T><<<per_slice * slices, THREADS, smem, st>>>(
      xmap, wmap, static_cast<typename TR::Acc*>(out), p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" const char* vqa_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// mode 0: s8 x [steps * m][K] and w^T [ndots * 128][K] (ops/mma_rate.
// pack_mma_rate_weights), s32 out [steps][w_out][128]; mode 1: bf16, f32 out.
// x and w 16-byte aligned. Returns cudaGetLastError() after the launch.
extern "C" int mma_rate(const void* x, const void* wt, void* out, int steps, int m, int w_out,
                        int K, int ndots, int mode, void* stream) {
  if (reinterpret_cast<uintptr_t>(x) % 16 != 0 || reinterpret_cast<uintptr_t>(wt) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case 0: return launch<int8_t>(x, wt, out, steps, m, w_out, K, ndots, st);
    case 1: return launch<__nv_bfloat16>(x, wt, out, steps, m, w_out, K, ndots, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

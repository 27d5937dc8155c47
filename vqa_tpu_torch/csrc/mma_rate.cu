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
// tensor-core time a pass), with x streaming close to the memory's rate at
// K 512 (1.28 GB of s8 a pass: 2.6 TB/s at the int8 peak). The weights,
// ndots K N values (196,608 bytes of s8, twice that of bf16), would fill a
// block's shared memory and leave no room for a ring deep enough to cover
// TMA's latency at that rate. Design: split K across a thread-block cluster.
//   * A cluster of CL blocks (s8: 2, bf16: 4) takes each unit of 128 rows of
//     one step together; block (rank) r owns the r-th K share of every dot:
//     it keeps that share's weights resident for the launch, at N 128 in
//     both types (98,304 bytes a block at every (K, ndots) of the probe),
//     and streams only its share of each unit's x, so every x byte crosses
//     from device memory once;
//   * warpgroup MMAs from shared-memory descriptors, both operands K-major:
//     s8 wgmma.m64n128k32, bf16 wgmma.m64n128k16 (32 bytes of K a step).
//     A share is chunks of 128 bytes of K with the 128-byte swizzle, or,
//     where it is no multiple of 128 bytes, of 64 bytes with the 64-byte
//     swizzle (s8 K 128 and bf16 K 128: one chunk of 64 bytes);
//   * persistent clusters (as many as the card holds at once), each walking
//     units. A producer warp (one thread issues) loads the weights once and
//     streams the unit's x share by TMA, one box of 128 rows x a chunk a
//     stage, through a ring of up to 8 stages, running ahead across units;
//     the consumers (two warpgroups, an M tile of 64 rows each) only wait,
//     issue MMAs and release: per stage ndots x chunk / 32 wgmmas each, all
//     into one accumulator. Shared memory of a block: 1,024 bytes of
//     barriers, 98,304 of weights, the partial sums' receive slots (s8
//     32,768, bf16 49,152), then the ring: s8 6 stages of 16 KB (K 256,
//     512) or 8 of 8 KB (K 128); bf16 5 of 16 KB or 8 of 8 KB (+ 1,024 of
//     alignment: at most 232,448);
//   * the cluster adds its partial sums only where rows are stored (r < W:
//     the first two units of a step at W 224), warp by warp: warp (wg, w)
//     of each block holds the same 16 rows, and rank s finalizes columns
//     [128 s / CL, 128 (s + 1) / CL). Each lane writes the sums of the
//     other ranks' columns into their receive slots (distributed shared
//     memory, st.shared::cluster) and arrives on their mbarrier (release at
//     cluster scope); after its own has completed, it adds the CL partial
//     sums in rank order 0 .. CL - 1, tells the senders that their slots are
//     free, and stores its rows < W. Sums of integers are exact in s32, and
//     in f32 below 2^24, so the result does not depend on the split.
// K bytes must split into CL shares of a multiple of 64 bytes (s8 and bf16:
// K a multiple of 128 values), M = R W a multiple of 128, N = 128, and the
// weights must fit beside the receive slots and two stages.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int CONSUMERS = 256;                 // 2 warpgroups, an M tile (64 rows) each
constexpr int WARPS = CONSUMERS / 32;
constexpr int THREADS = CONSUMERS + 32;        // + the producer warp
constexpr int N = 128;                         // the probe's output channels
constexpr int UNIT_ROWS = 128;                 // rows of x a unit (both M tiles)
constexpr int MAX_STAGES = 8;
constexpr int HEAD = 1024;                     // barriers (the tiles stay 1,024-byte aligned)
constexpr int ACC = N / 2;                     // sums a thread (m64n128)

template <typename T> struct Traits;
template <> struct Traits<int8_t> {
  static constexpr int CL = 2;                 // blocks of a cluster: K shares
  using Acc = int;
};
template <> struct Traits<__nv_bfloat16> {
  static constexpr int CL = 4;
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

__device__ __forceinline__ void mma(int* d, uint64_t da, uint64_t db) { wgmma_s8_n128(d, da, db); }
__device__ __forceinline__ void mma(float* d, uint64_t da, uint64_t db) {
  sm90::wgmma_bf16_n128(d, da, db, 1);
}

template <int N_>
__device__ __forceinline__ void pin(int* d) {
#pragma unroll
  for (int i = 0; i < N_; ++i) asm volatile("" : "+r"(d[i])::"memory");
}
template <int N_>
__device__ __forceinline__ void pin(float* d) { sm90::pin<N_>(d); }

__device__ __forceinline__ uint32_t bits(int v) { return static_cast<uint32_t>(v); }
__device__ __forceinline__ uint32_t bits(float v) { return __float_as_uint(v); }
__device__ __forceinline__ void unbits(uint32_t b, int& v) { v = static_cast<int>(b); }
__device__ __forceinline__ void unbits(uint32_t b, float& v) { v = __uint_as_float(b); }

struct Params {
  int steps, m, w_out, ndots;
  int nk;              // K chunks of a share
  int share_k;         // K values of a share
  int stages;
  int units;           // (step, 128-row group) pairs
};

// CB: bytes of K a chunk (128: the 128-byte swizzle; 64: the 64-byte one)
template <typename T, int CB>
__global__ void __launch_bounds__(THREADS, 1) mma_rate_kernel(
    const __grid_constant__ CUtensorMap xmap,    // x as [steps * M rows][K]
    const __grid_constant__ CUtensorMap wmap,    // w^T as [ndots * 128 rows (n)][K]
    typename Traits<T>::Acc* __restrict__ out,   // [steps][W][128]
    const Params p) {
  using Acc = typename Traits<T>::Acc;
  constexpr int CL = Traits<T>::CL;
  constexpr int KV = CB / static_cast<int>(sizeof(T));   // K values a chunk
  constexpr int STAGE = UNIT_ROWS * CB;         // a chunk of 128 rows of x
  constexpr int WT = N * CB;                    // one (dot, chunk) weight tile
  constexpr int VALS = ACC / CL;                // sums a lane exchanges with a rank
  constexpr int JPR = N / 8 / CL;               // 8-column groups a rank finalizes
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = sm90::smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;   // swizzled tiles: 1,024-byte aligned
  unsigned char* const gbase = smem_raw + (base - raw);
  const uint32_t full0 = base, empty0 = base + 8 * MAX_STAGES, wbar = base + 16 * MAX_STAGES;
  const uint32_t xfull0 = wbar + 8, xfree0 = xfull0 + 8 * WARPS;   // a consumer warp's pair
  const uint32_t s_w = base + HEAD;
  const uint32_t s_recv = s_w + p.ndots * p.nk * WT;   // [CL - 1][WARPS][VALS][32 lanes]
  const uint32_t s_ring = s_recv + (CL - 1) * WARPS * VALS * 128;
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int rank = static_cast<int>(sm90::cluster_rank());
  const int first = blockIdx.x / CL, step = gridDim.x / CL;   // the cluster's units
  const int groups = p.m / UNIT_ROWS;            // units of one step
  const int k0 = rank * p.share_k;               // the block's K share

  if (t == 0) {
    for (int s = 0; s < MAX_STAGES; ++s) {
      sm90::mbar_init(full0 + 8 * s, 1);
      sm90::mbar_init(empty0 + 8 * s, CONSUMERS / 32);
    }
    sm90::mbar_init(wbar, 1);
    for (int w = 0; w < WARPS; ++w) {            // every lane of the other ranks' warp w
      sm90::mbar_init(xfull0 + 8 * w, (CL - 1) * 32);
      sm90::mbar_init(xfree0 + 8 * w, (CL - 1) * 32);
    }
    sm90::mbar_init_fence();
  }
  sm90::cluster_sync();                          // the barriers exist before any remote arrival

  if (warp == WARPS) {
    // the producer: the weights' share once, then every unit's x share in chunks
    if (lane == 0 && first < p.units) {
      sm90::mbar_expect_tx(wbar, p.ndots * p.nk * WT);
      for (int i = 0; i < p.ndots; ++i)
        for (int c = 0; c < p.nk; ++c)
          sm90::tma_load_2d(s_w + (i * p.nk + c) * WT, &wmap, k0 + c * KV, i * N, wbar);
      int k = 0;
      for (int u = first; u < p.units; u += step) {
        const int row = (u / groups) * p.m + (u % groups) * UNIT_ROWS;
        for (int c = 0; c < p.nk; ++c, ++k) {
          const int s = k % p.stages;
          sm90::mbar_wait(empty0 + 8 * s, ((k / p.stages) & 1) ^ 1);
          sm90::mbar_expect_tx(full0 + 8 * s, STAGE);
          sm90::tma_load_2d(s_ring + s * STAGE, &xmap, k0 + c * KV, row, full0 + 8 * s);
        }
      }
    }
  } else {
    // the consumers: warpgroup wg owns rows 64 wg .. 64 wg + 63 of each unit
    const int wg = warp >> 2, w = warp & 3, g = lane >> 2, q = lane & 3;
    if (first < p.units) sm90::mbar_wait(wbar, 0);
    Acc acc[ACC];
    int k = 0, nx = 0;                           // stages taken; exchanges made
#pragma unroll 1
    for (int u = first; u < p.units; u += step) {
#pragma unroll
      for (int j = 0; j < ACC; ++j) acc[j] = 0;
      pin<ACC>(acc);
#pragma unroll 1
      for (int c = 0; c < p.nk; ++c, ++k) {
        const int s = k % p.stages;
        sm90::mbar_wait(full0 + 8 * s, (k / p.stages) & 1);
        const uint32_t a0 = s_ring + s * STAGE + wg * 64 * CB;
        sm90::wgmma_fence();
#pragma unroll 1
        for (int i = 0; i < p.ndots; ++i) {
          const uint32_t b0 = s_w + (i * p.nk + c) * WT;
#pragma unroll
          for (int j = 0; j < CB / 32; ++j) {      // 32 bytes of K a step
            if constexpr (CB == 128)
              mma(acc, sm90::desc_sw128(a0 + 32 * j), sm90::desc_sw128(b0 + 32 * j));
            else
              mma(acc, sm90::desc_sw64(a0 + 32 * j), sm90::desc_sw64(b0 + 32 * j));
          }
        }
        sm90::wgmma_commit();
        sm90::wgmma_wait<1>();
        pin<ACC>(acc);
        if (c > 0) {                             // stage k - 1's wgmmas are done
          __syncwarp();
          if (lane == 0) sm90::mbar_arrive(empty0 + 8 * ((k - 1) % p.stages));
        }
      }
      sm90::wgmma_wait<0>();
      pin<ACC>(acc);
      __syncwarp();
      if (lane == 0) sm90::mbar_arrive(empty0 + 8 * ((k - 1) % p.stages));

      // acc[4j + 2h + e]: unit row 64 wg + 16 w + g + 8 h, column 8 j + 2 q + e;
      // rank s's columns are j in [s JPR, (s + 1) JPR): acc[s VALS + v]
      const int gstep = u / groups;
      const int row0 = (u % groups) * UNIT_ROWS + 64 * wg + 16 * w + g;
      if (row0 - g >= p.w_out) continue;         // warp-uniform: no row of the warp stored
      const uint32_t par = nx & 1;
      ++nx;
      sm90::mbar_wait_cluster(xfree0 + 8 * warp, par ^ 1);   // the ranks read our last sums
#pragma unroll
      for (int s = 0; s < CL; ++s) {
        if (s == rank) continue;
        const int slot = rank < s ? rank : rank - 1;         // our slot at rank s
        const uint32_t dst =
            sm90::cluster_map(s_recv + (slot * WARPS + warp) * VALS * 128 + lane * 4, s);
#pragma unroll
        for (int v = 0; v < VALS; ++v) sm90::cluster_store(dst + v * 128, bits(acc[s * VALS + v]));
        sm90::cluster_arrive(sm90::cluster_map(xfull0 + 8 * warp, s));
      }
      sm90::mbar_wait_cluster(xfull0 + 8 * warp, par);       // every rank's sums for us
#pragma unroll
      for (int s = 0; s < CL; ++s) {
        if (s != rank) continue;
        Acc sum[VALS];
#pragma unroll
        for (int v = 0; v < VALS; ++v) sum[v] = 0;
#pragma unroll
        for (int r = 0; r < CL; ++r) {           // in rank order
          if (r == s) {
#pragma unroll
            for (int v = 0; v < VALS; ++v) sum[v] += acc[s * VALS + v];
          } else {
            const unsigned char* src =
                gbase + (s_recv - base) + ((r < s ? r : r - 1) * WARPS + warp) * VALS * 128 +
                lane * 4;
#pragma unroll
            for (int v = 0; v < VALS; ++v) {
              Acc x;
              unbits(*reinterpret_cast<const uint32_t*>(src + v * 128), x);
              sum[v] += x;
            }
          }
        }
#pragma unroll
        for (int r = 0; r < CL; ++r)             // the slots may be written again
          if (r != s) sm90::cluster_arrive(sm90::cluster_map(xfree0 + 8 * warp, r));
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = row0 + 8 * h;
          if (r >= p.w_out) continue;
          Acc* o = out + (static_cast<size_t>(gstep) * p.w_out + r) * N + 2 * q;
#pragma unroll
          for (int jj = 0; jj < JPR; ++jj) {
            const int j = s * JPR + jj;
            o[8 * j] = sum[4 * jj + 2 * h];
            o[8 * j + 1] = sum[4 * jj + 2 * h + 1];
          }
        }
      }
    }
  }
  // no block leaves while another may still write to its shared memory
  sm90::cluster_sync();
}

template <typename T, int CB>
int launch_cb(const void* x, const void* wt, void* out, const Params& p0, int K,
              cudaStream_t st) {
  using Acc = typename Traits<T>::Acc;
  constexpr int CL = Traits<T>::CL;
  constexpr int VALS = ACC / CL;
  constexpr int STAGE = UNIT_ROWS * CB;
  auto kernel = mma_rate_kernel<T, CB>;
  int sms = 0, optin = 0;
  cudaError_t e = sm90::device_limits(&sms, &optin);
  if (e != cudaSuccess) return static_cast<int>(e);
  Params p = p0;
  p.nk = p.share_k * static_cast<int>(sizeof(T)) / CB;
  const int wbytes = p.ndots * p.nk * N * CB;
  const int fixed = 1024 + HEAD + wbytes + (CL - 1) * WARPS * VALS * 128;   // + the alignment
  const int per = optin > fixed ? (optin - fixed) / STAGE : 0;
  if (per < 2) return static_cast<int>(cudaErrorInvalidValue);   // weights too large
  p.stages = per < MAX_STAGES ? per : MAX_STAGES;
  const int smem = fixed + p.stages * STAGE;
  e = sm90::allow_smem<mma_rate_kernel<T, CB>>(smem);
  if (e != cudaSuccess) return static_cast<int>(e);

  const CUtensorMapDataType type =
      sizeof(T) == 1 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const CUtensorMapSwizzle swizzle =
      CB == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  const cuuint64_t row_bytes = static_cast<cuuint64_t>(K) * sizeof(T);
  const cuuint32_t box_k = CB / sizeof(T);
  CUtensorMap xmap, wmap;
  {
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(K),
                                static_cast<cuuint64_t>(p.steps) * static_cast<cuuint64_t>(p.m)};
    const cuuint32_t box[2] = {box_k, UNIT_ROWS};
    e = sm90::encode_tensor_map(&xmap, type, 2, x, dims, &row_bytes, box, swizzle);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  {
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(p.ndots) * N};
    const cuuint32_t box[2] = {box_k, N};
    e = sm90::encode_tensor_map(&wmap, type, 2, wt, dims, &row_bytes, box, swizzle);
    if (e != cudaSuccess) return static_cast<int>(e);
  }

  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // persistent clusters: as many as the card holds at once, at most one a unit
  int clusters = 0;
  cfg.gridDim = dim3((sms / CL) * CL);
  e = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (clusters < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  if (clusters > p.units) clusters = p.units;
  cfg.gridDim = dim3(clusters * CL);
  e = cudaLaunchKernelEx(&cfg, kernel, xmap, wmap, static_cast<Acc*>(out), p);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* x, const void* wt, void* out, int steps, int m, int w_out, int K,
           int ndots, cudaStream_t st) {
  constexpr int CL = Traits<T>::CL;
  if (steps == 0) return static_cast<int>(cudaSuccess);
  const int kb = K * static_cast<int>(sizeof(T));
  if (K < 1 || kb % (64 * CL) != 0 || m % UNIT_ROWS != 0 || w_out > m || ndots < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.steps = steps, p.m = m, p.w_out = w_out, p.ndots = ndots;
  p.share_k = K / CL;
  p.units = steps * (m / UNIT_ROWS);
  // shares of a multiple of 128 bytes: 128-byte chunks; else 64-byte ones
  return (kb / CL) % 128 == 0 ? launch_cb<T, 128>(x, wt, out, p, K, st)
                              : launch_cb<T, 64>(x, wt, out, p, K, st);
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

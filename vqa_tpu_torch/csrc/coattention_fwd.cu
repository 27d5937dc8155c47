// Kernel E: the parallel co-attention forward over the three question levels.
//
// Replaces the Pallas TPU kernel tools/retired/coattention_kernel.py:_kernel
// (reached through _coattention_pallas's pallas_call), the fused forward of
// vqa_tpu.models.coattention.coattention_xla. For each sample b and level:
//   C   = tanh(Q V^T)                       [L, S]
//   H_v = tanh(W_v V + C^T (W_q Q))         [S, D]  (W_v V + b_v shared by the levels)
//   H_q = tanh(W_q Q + C (W_v V))           [L, D]
//   a_v = softmax(H_v w_v), a_q = softmax(H_q w_q)   (f32, max-subtracted)
//   out_v = a_v^T V, out_q = a_q^T Q        [D], rounded to the input type.
// Arithmetic kept from the TPU kernel: every product of input-type operands
// is summed in f32, every intermediate after the two projections stays f32,
// and the score biases c_v and c_q are not applied: they cancel in the
// softmax (tools/retired/coattention_kernel.py:63-66).
//
// The TPU kernel keeps a block of 4 samples resident in VMEM. On the H100 a
// sample's V alone is 401 KB in f32 at S 196, D 512, over the 227 KB of
// shared memory a block can have, so the work is cut in three launches:
//   (i) the projections as one tiled GEMM launch over three problems: W_v V
//       + b_v [B*S, D], W_q Q + b_q [B*3L, D] and tanh(Q V^T) [3L, S] of
//       every sample (tanh in that problem's epilogue), into f32 scratch the
//       wrapper allocates (19 MB at b32, which the 50 MB L2 keeps). A block
//       owns a 128 x 128 output tile: two consumer warpgroups (M = 64 each)
//       on wgmma.m64n128 with both operands from shared memory, and a
//       producer warp that brings each 128-byte K slice of A and of B by one
//       TMA box each (128 rows, the 128-byte swizzle wgmma reads) into a
//       ring of 3 stages that complete on mbarriers. bf16: wgmma k16, f32
//       sums; f32: 3xTF32 at k8 (each stage split once, in place, into TF32
//       hi and lo; lo hi + hi lo + hi hi, small terms first);
//  (ii) one block per (D slice of 64 columns, level, sample): 768 blocks at
//       b32, D 512. Its slices of C^T (W_q Q) [S, 64] and C (W_v V) [L, 64]
//       are 3xTF32 products on the tensor cores (mma.sync.m16n8k8 TF32,
//       the operands split into hi and lo as their fragments are loaded, an
//       A fragment once for the n8 tiles it meets; the intermediates are f32
//       in both modes, as on the TPU), on operands staged by cp.async. Each
//       adds W_v V or W_q Q, applies tanh, takes the dot with its slice of
//       w_v or w_q and writes the slice's partial scores;
// (iii) one block per (level, sample, 32 columns of D): the partial scores
//       summed over the slices in slice order, both softmaxes, and the
//       pooled sums a_v^T V and a_q^T Q for its columns, by 8 groups of
//       rows whose partial sums are added in group order.
// What bounds it: at b32, S 196, L 23, D 512 it does 5.8 GFLOP and moves
// 9.7 MB (bf16), so operations: 4.9 G of them on input-type operands (the
// projections and Q V^T), 0.9 G on f32 intermediates (H_v, H_q). No atomics,
// every sum in a fixed order: deterministic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

// ---- (i) the projections: out[m, n] = sum_k A[m, k] B[n, k] (+ bias[n]) ----

constexpr int G_BM = 128, G_BN = 128;
constexpr int G_CONSUMERS = 256;               // 2 warpgroups
constexpr int G_THREADS = G_CONSUMERS + 32;    // + the producer warp
constexpr int G_STAGES = 3;
constexpr int G_TILE = G_BM * 128;             // 128 rows x 128 bytes of K (16 KB)
constexpr int G_KS = 4;                        // 32-byte k-steps a stage

template <typename T> struct GLayout {
  static constexpr bool F32 = sizeof(T) == 4;
  static constexpr int KV = 128 / static_cast<int>(sizeof(T));   // K values a stage
  // A then B (f32: their hi parts, split in place), then (f32) their lo parts
  static constexpr int STAGE = (F32 ? 4 : 2) * G_TILE;
  static constexpr int SMEM = 1024 + 1024 + G_STAGES * STAGE;   // + alignment, barriers
};

struct Gemm {
  int amap, bmap;       // tensor maps of A [rows][K] and B [rows][K]
  int a_stride, b_stride;   // rows between batches of A and of B
  const float* bias;    // [N] or null
  float* out;           // [batch][M][N]
  int m, n, batch, tanh_out;
  int first_tile;       // this problem's first block
};

struct Gemms {
  Gemm p[3];
  int k;                // K (values)
};

struct Maps {
  CUtensorMap m[4];     // V [B*S, D], Q [B*3L, D], W_v^T [D, D], W_q^T [D, D]
};

template <typename T>
__global__ void __launch_bounds__(G_THREADS, 1) coatt_gemm_kernel(
    const __grid_constant__ Maps maps, const Gemms gp) {
  using GL = GLayout<T>;
  constexpr bool F32 = GL::F32;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = sm90::smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;   // swizzled tiles: 1,024-byte aligned
  unsigned char* const gbase = smem_raw + (base - raw);
  const uint32_t full0 = base, empty0 = base + 8 * G_STAGES;
  const uint32_t s_ring = base + 1024;
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;

  int pi = 0;
  while (pi < 2 && static_cast<int>(blockIdx.x) >= gp.p[pi + 1].first_tile) ++pi;
  const Gemm& p = gp.p[pi];
  const int tiles_m = (p.m + G_BM - 1) / G_BM, tiles_n = (p.n + G_BN - 1) / G_BN;
  const int tile = blockIdx.x - p.first_tile;
  const int bz = tile / (tiles_m * tiles_n), rem = tile % (tiles_m * tiles_n);
  const int m0 = (rem / tiles_n) * G_BM, n0 = (rem % tiles_n) * G_BN;
  const int nk = (gp.k + GL::KV - 1) / GL::KV;

  if (t == 0) {
    for (int s = 0; s < G_STAGES; ++s) {
      sm90::mbar_init(full0 + 8 * s, 1);
      sm90::mbar_init(empty0 + 8 * s, G_CONSUMERS / 32);
    }
    sm90::mbar_init_fence();
  }
  __syncthreads();

  if (warp == G_CONSUMERS / 32) {
    if (lane == 0) {
      const CUtensorMap* am = &maps.m[p.amap];
      const CUtensorMap* bm = &maps.m[p.bmap];
      const int arow = bz * p.a_stride + m0, brow = bz * p.b_stride + n0;
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % G_STAGES;
        sm90::mbar_wait(empty0 + 8 * s, ((kt / G_STAGES) & 1) ^ 1);
        const uint32_t st = s_ring + s * GL::STAGE, bar = full0 + 8 * s;
        sm90::mbar_expect_tx(bar, 2 * G_TILE);
        sm90::tma_load_2d(st, am, kt * GL::KV, arow, bar);
        sm90::tma_load_2d(st + G_TILE, bm, kt * GL::KV, brow, bar);
      }
    }
    return;
  }

  const int wg = warp >> 2, w = warp & 3, g = lane >> 2, q = lane & 3;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  sm90::pin<64>(acc);
#pragma unroll 1
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % G_STAGES;
    sm90::mbar_wait(full0 + 8 * s, (kt / G_STAGES) & 1);
    const uint32_t st = s_ring + s * GL::STAGE;
    if (F32) {
      // split A and B in place into TF32 hi, their lo parts beside them
      // (swizzled as they are); the stage is the consumers' until released
      float4* hi = reinterpret_cast<float4*>(gbase + (st - base));
      float4* lo = hi + 2 * G_TILE / 16;
      for (int i = t; i < 2 * G_TILE / 16; i += G_CONSUMERS) {
        float4 l;
        hi[i] = sm90::split4(hi[i], l);
        lo[i] = l;
      }
      sm90::fence_async_shared();
      sm90::named_barrier(1, G_CONSUMERS);
    }
    sm90::wgmma_fence();
#pragma unroll
    for (int j = 0; j < G_KS; ++j) {         // 32 bytes of K a step
      const uint64_t da = sm90::desc_sw128(st + wg * 64 * 128 + 32 * j);
      const uint64_t db = sm90::desc_sw128(st + G_TILE + 32 * j);
      if constexpr (F32) {
        constexpr uint32_t LO = (2 * G_TILE) >> 4;   // the lo parts, in 16-byte units
        sm90::wgmma_tf32_n128(acc, da + LO, db, 1);    // lo_a hi_b
        sm90::wgmma_tf32_n128(acc, da, db + LO, 1);    // hi_a lo_b
        sm90::wgmma_tf32_n128(acc, da, db, 1);         // hi_a hi_b
      } else {
        sm90::wgmma_bf16_n128(acc, da, db, 1);
      }
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<1>();
    sm90::pin<64>(acc);
    if (kt > 0) {                              // stage kt - 1's wgmmas are done
      __syncwarp();
      if (lane == 0) sm90::mbar_arrive(empty0 + 8 * ((kt - 1) % G_STAGES));
    }
  }
  sm90::wgmma_wait<0>();
  sm90::pin<64>(acc);

  // Epilogue: the tile staged in the ring (every stage consumed), then
  // written a row at a time, 32 lanes on consecutive columns.
  // acc[4j + 2h + e]: row 64 wg + 16 w + g + 8 h, column 8 j + 2 q + e
  sm90::named_barrier(1, G_CONSUMERS);
  constexpr int TS = G_BN + 1;                 // staging row stride (floats)
  float* staged = reinterpret_cast<float*>(gbase + (s_ring - base));
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        staged[(64 * wg + 16 * w + g + 8 * h) * TS + 8 * j + 2 * q + e] = acc[4 * j + 2 * h + e];
  sm90::named_barrier(1, G_CONSUMERS);
  float* out = p.out + static_cast<size_t>(bz) * p.m * p.n;
  for (int r = warp; r < G_BM; r += G_CONSUMERS / 32) {
    const int m = m0 + r;
    if (m >= p.m) break;
#pragma unroll
    for (int c = lane; c < G_BN; c += 32) {
      const int n = n0 + c;
      if (n >= p.n) break;
      float v = staged[r * TS + c];
      if (p.bias) v = __fadd_rn(v, __ldg(p.bias + n));
      if (p.tanh_out) v = tanhf(v);
      out[static_cast<size_t>(m) * p.n + n] = v;
    }
  }
}

// ---- (ii) one block per (D slice, level, sample): partial scores ----

constexpr int A_THREADS = 256, A_WARPS = A_THREADS / 32;
constexpr int DS = 64;                         // D slice: 8 n8 tiles

__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(sm90::smem_addr(dst)), "l"(src) : "memory");
}

// 16 bytes global -> shared, or 16 zero bytes (src-size 0: nothing is read)
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(sm90::smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

// an A fragment split into TF32 hi and lo (once, for every n8 tile it meets)
__device__ __forceinline__ void split_frag(const float* a, uint32_t* ah, uint32_t* al) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float h, l;
    sm90::split(a[i], h, l);
    ah[i] = __float_as_uint(h);
    al[i] = __float_as_uint(l);
  }
}

// d += a b as 3xTF32: lo_a hi_b + hi_a lo_b + hi_a hi_b, small terms first
__device__ __forceinline__ void mma_3xtf32(float* d, const uint32_t* ah, const uint32_t* al,
                                           float b0, float b1) {
  float bh0, bl0, bh1, bl1;
  sm90::split(b0, bh0, bl0);
  sm90::split(b1, bh1, bl1);
  mma_tf32(d, al, __float_as_uint(bh0), __float_as_uint(bh1));
  mma_tf32(d, ah, __float_as_uint(bl0), __float_as_uint(bl1));
  mma_tf32(d, ah, __float_as_uint(bh0), __float_as_uint(bh1));
}

// vw [B, S, D], qw [B, 3L, D], ct = tanh(Q V^T) [B, 3L, S] (f32, from (i));
// wv, wq [D]; part [B, 3, slices, S + L]: the slice's scores of H_v, then H_q.
__global__ void __launch_bounds__(A_THREADS) coatt_slice_kernel(
    const float* __restrict__ vw, const float* __restrict__ qw, const float* __restrict__ ct,
    const float* __restrict__ wv, const float* __restrict__ wq, float* __restrict__ part,
    int S, int L, int D) {
  extern __shared__ float sm[];
  const int sl = blockIdx.x, lvl = blockIdx.y, b = blockIdx.z, slices = gridDim.x;
  const int d0 = sl * DS, nd = min(DS, D - d0), nt = nd / 8;   // D % 32 == 0: 4 or 8 tiles
  float* cs = sm;                              // [L][S] tanh(C), padded to 16 bytes
  float* vs = cs + (L * S + 3) / 4 * 4;        // [S][DS] the slice of W_v V + b_v
  float* qs = vs + S * DS;                     // [L][DS] the slice of W_q Q + b_q
  float* qpart = qs + L * DS;                  // [DS / 8][L] H_q's scores per n8 tile
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int g = lane >> 2, q = lane & 3;
  const size_t qrow0 = (static_cast<size_t>(b) * 3 + lvl) * L;   // first row of Q as [B*3L, D]

  // every copy is issued before any is waited for (cp.async): one L2
  // latency a block, not one a load; columns past the slice are zero
  if ((qrow0 * S) % 4 == 0 && (L * S) % 4 == 0) {       // 16-byte pieces (S % 4 == 0)
    for (int i = 4 * t; i < L * S; i += 4 * A_THREADS) cp_async16(cs + i, ct + qrow0 * S + i, true);
  } else {
    for (int i = t; i < L * S; i += A_THREADS) cp_async4(cs + i, ct + qrow0 * S + i);
  }
  for (int i = t; i < S * (DS / 4); i += A_THREADS) {
    const int r = i / (DS / 4), c = 4 * (i % (DS / 4));
    cp_async16(vs + r * DS + c, vw + (static_cast<size_t>(b) * S + r) * D + d0 + c, c < nd);
  }
  for (int i = t; i < L * (DS / 4); i += A_THREADS) {
    const int r = i / (DS / 4), c = 4 * (i % (DS / 4));
    cp_async16(qs + r * DS + c, qw + (qrow0 + r) * D + d0 + c, c < nd);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  float* const pout = part + ((static_cast<size_t>(b) * 3 + lvl) * slices + sl) * (S + L);

  // H_v rows s (M = S, N = the slice, K = L): A = C^T, B = W_q Q; a warp an
  // m16 tile of rows and every n8 tile of the slice
  for (int mt = warp; mt * 16 < S; mt += A_WARPS) {
    const int s0 = mt * 16;
    float acc[DS / 8][4];
#pragma unroll
    for (int j = 0; j < DS / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
    for (int l0 = 0; l0 < L; l0 += 8) {
      // A (m16 x k8): a0 (g, q), a1 (g + 8, q), a2 (g, q + 4), a3 (g + 8, q + 4)
      float a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int s = s0 + g + 8 * (i & 1), l = l0 + q + 4 * (i >> 1);
        a[i] = s < S && l < L ? cs[l * S + s] : 0.f;
      }
      uint32_t ah[4], al[4];
      split_frag(a, ah, al);
      const int l_lo = l0 + q, l_hi = l0 + q + 4;
#pragma unroll
      for (int j = 0; j < DS / 8; ++j) {
        if (j >= nt) break;
        const float b0 = l_lo < L ? qs[l_lo * DS + 8 * j + g] : 0.f;
        const float b1 = l_hi < L ? qs[l_hi * DS + 8 * j + g] : 0.f;
        mma_3xtf32(acc[j], ah, al, b0, b1);
      }
    }
    // acc[j][2h + e]: row s0 + g + 8h, column 8j + 2q + e
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int s = s0 + g + 8 * h;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < DS / 8; ++j) {
        if (j >= nt) break;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * j + 2 * q + e;
          const float hv = tanhf(__fadd_rn(s < S ? vs[s * DS + c] : 0.f, acc[j][2 * h + e]));
          sum = __fadd_rn(sum, __fmul_rn(hv, __ldg(wv + d0 + c)));
        }
      }
      sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, 1));
      sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, 2));
      if (q == 0 && s < S) pout[s] = sum;
    }
  }

  // H_q rows l (M = L, N = the slice, K = S): A = C, B = W_v V; a warp an
  // m16 tile and the n8 tiles jg and jg + 4 (one split of A for both), its
  // row sums staged per n8 tile
  const int mtq = (L + 15) / 16;
  for (int pr = warp; pr < mtq * 4; pr += A_WARPS) {
    const int l0 = (pr >> 2) * 16, jg = pr & 3;
    const bool two = jg + 4 < nt;
    float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    for (int k0 = 0; k0 < S; k0 += 8) {
      float a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int l = l0 + g + 8 * (i & 1), s = k0 + q + 4 * (i >> 1);
        a[i] = l < L && s < S ? cs[l * S + s] : 0.f;
      }
      uint32_t ah[4], al[4];
      split_frag(a, ah, al);
      const int s_lo = k0 + q, s_hi = k0 + q + 4;
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        if (x == 1 && !two) break;             // warp-uniform
        const int j = jg + 4 * x;
        const float b0 = s_lo < S ? vs[s_lo * DS + 8 * j + g] : 0.f;
        const float b1 = s_hi < S ? vs[s_hi * DS + 8 * j + g] : 0.f;
        mma_3xtf32(acc[x], ah, al, b0, b1);
      }
    }
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      if (x == 1 && !two) break;
      const int j = jg + 4 * x;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int l = l0 + g + 8 * h;
        float sum = 0.f;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * j + 2 * q + e;
          const float hq = tanhf(__fadd_rn(l < L ? qs[l * DS + c] : 0.f, acc[x][2 * h + e]));
          sum = __fadd_rn(sum, __fmul_rn(hq, __ldg(wq + d0 + c)));
        }
        sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, 1));
        sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, 2));
        if (q == 0 && l < L) qpart[j * L + l] = sum;
      }
    }
  }
  __syncthreads();
  for (int l = t; l < L; l += A_THREADS) {
    float sum = 0.f;
    for (int j = 0; j < nt; ++j) sum = __fadd_rn(sum, qpart[j * L + l]);
    pout[S + l] = sum;
  }
}

// ---- (iii) softmaxes and pooled sums ----

// a block: 32 columns of D x 8 groups of rows, each group's partial sums
// added in group order
constexpr int P_COLS = 32, P_GROUPS = 8, P_THREADS = P_COLS * P_GROUPS;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return __shfl_sync(0xffffffffu, v, 0);       // lane 0's order, on every lane
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ void softmax(float* x, int n, int lane) {
  float m = -__int_as_float(0x7f800000);     // -inf
  for (int i = lane; i < n; i += 32) m = fmaxf(m, x[i]);
  m = warp_max(m);
  float s = 0.f;
  for (int i = lane; i < n; i += 32) s = __fadd_rn(s, expf(__fsub_rn(x[i], m)));
  s = warp_sum(s);
  for (int i = lane; i < n; i += 32) x[i] = __fdiv_rn(expf(__fsub_rn(x[i], m)), s);
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// sum over r = r0, r0 + step, ... < n of a[r] x[r * D], one FMA chain
template <typename T>
__device__ __forceinline__ float pooled(const float* a, const T* x, int r0, int step, int n,
                                        int D) {
  float acc = 0.f;
  for (int r = r0; r < n; r += step) acc = __fmaf_rn(a[r], to_f32(x[static_cast<size_t>(r) * D]), acc);
  return acc;
}

// V [B, S, D], Q [B, 3, L, D] in T; part from (ii); out_v, out_q [B, 3, D] in T.
template <typename T>
__global__ void __launch_bounds__(P_THREADS) coatt_pool_kernel(
    const T* __restrict__ V, const T* __restrict__ Q, const float* __restrict__ part,
    T* __restrict__ out_v, T* __restrict__ out_q, int S, int L, int D, int slices) {
  extern __shared__ float sc[];                // [S] scores then a_v, [L] then a_q; partials
  float* pv = sc + S + L;                      // [P_GROUPS][P_COLS] partial sums of out_v
  float* pq = pv + P_GROUPS * P_COLS;          // and of out_q
  const int lvl = blockIdx.x, b = blockIdx.y;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int col = t % P_COLS, grp = t / P_COLS, d = blockIdx.z * P_COLS + col;
  const float* parts = part + (static_cast<size_t>(b) * 3 + lvl) * slices * (S + L);
  for (int i = t; i < S + L; i += P_THREADS) {
    float s = 0.f;
    for (int k = 0; k < slices; ++k) s = __fadd_rn(s, parts[k * (S + L) + i]);
    sc[i] = s;
  }
  __syncthreads();
  if (warp == 0) softmax(sc, S, lane);
  if (warp == 1) softmax(sc + S, L, lane);
  __syncthreads();
  const size_t qrow0 = (static_cast<size_t>(b) * 3 + lvl) * L;
  if (d < D) {
    pv[grp * P_COLS + col] = pooled(sc, V + static_cast<size_t>(b) * S * D + d, grp, P_GROUPS, S, D);
    pq[grp * P_COLS + col] = pooled(sc + S, Q + qrow0 * D + d, grp, P_GROUPS, L, D);
  }
  __syncthreads();
  if (grp == 0 && d < D) {
    float a = 0.f, c = 0.f;
    for (int k = 0; k < P_GROUPS; ++k) {
      a = __fadd_rn(a, pv[k * P_COLS + col]);
      c = __fadd_rn(c, pq[k * P_COLS + col]);
    }
    out_v[(static_cast<size_t>(b) * 3 + lvl) * D + d] = from_f32<T>(a);
    out_q[(static_cast<size_t>(b) * 3 + lvl) * D + d] = from_f32<T>(c);
  }
}

template <typename T>
int launch(const void* v, const void* q, const void* wvt, const void* bv, const void* wqt,
           const void* bq, const void* wv, const void* wq, float* vw, float* qw, float* ct,
           float* part, void* out_v, void* out_q, int B, int S, int L, int D, cudaStream_t st) {
  if (B == 0) return static_cast<int>(cudaSuccess);
  int sms = 0, optin = 0;
  cudaError_t e = sm90::device_limits(&sms, &optin);
  if (e != cudaSuccess) return static_cast<int>(e);

  // (i): W_v V + b_v, W_q Q + b_q, then tanh(Q V^T) per sample
  Maps maps;
  const CUtensorMapDataType type =
      sizeof(T) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  const void* bases[4] = {v, q, wvt, wqt};
  const int rows[4] = {B * S, B * 3 * L, D, D};
  for (int i = 0; i < 4; ++i) {
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(rows[i])};
    const cuuint64_t strides[1] = {static_cast<cuuint64_t>(D) * sizeof(T)};
    const cuuint32_t box[2] = {static_cast<cuuint32_t>(GLayout<T>::KV), G_BM};
    e = sm90::encode_tensor_map(&maps.m[i], type, 2, bases[i], dims, strides, box,
                                CU_TENSOR_MAP_SWIZZLE_128B);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  Gemms gp;
  gp.k = D;
  gp.p[0] = {0, 2, 0, 0, static_cast<const float*>(bv), vw, B * S, D, 1, 0, 0};
  gp.p[1] = {1, 3, 0, 0, static_cast<const float*>(bq), qw, B * 3 * L, D, 1, 0, 0};
  gp.p[2] = {1, 0, 3 * L, S, nullptr, ct, 3 * L, S, B, 1, 0};
  int tiles = 0;
  for (Gemm& p : gp.p) {
    p.first_tile = tiles;
    tiles += p.batch * ((p.m + G_BM - 1) / G_BM) * ((p.n + G_BN - 1) / G_BN);
  }
  constexpr int gsmem = GLayout<T>::SMEM;
  e = sm90::allow_smem<coatt_gemm_kernel<T>>(gsmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  coatt_gemm_kernel<T><<<tiles, G_THREADS, gsmem, st>>>(maps, gp);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);

  // (ii): the shared-memory size depends on S and L
  const int slices = (D + DS - 1) / DS;
  const int asmem = static_cast<int>(((static_cast<size_t>(L) * S + 3) / 4 * 4 + (S + L) * DS +
                                      (DS / 8) * L) * sizeof(float));
  if (asmem > optin) return static_cast<int>(cudaErrorInvalidValue);
  e = sm90::allow_smem<coatt_slice_kernel>(asmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  coatt_slice_kernel<<<dim3(slices, 3, B), A_THREADS, asmem, st>>>(
      vw, qw, ct, static_cast<const float*>(wv), static_cast<const float*>(wq), part, S, L, D);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);

  // (iii)
  const int psmem = (S + L + 2 * P_GROUPS * P_COLS) * static_cast<int>(sizeof(float));
  if (psmem > optin) return static_cast<int>(cudaErrorInvalidValue);
  e = sm90::allow_smem<coatt_pool_kernel<T>>(psmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  coatt_pool_kernel<T><<<dim3(3, B, (D + P_COLS - 1) / P_COLS), P_THREADS, psmem, st>>>(
      static_cast<const T*>(v), static_cast<const T*>(q), part, static_cast<T*>(out_v),
      static_cast<T*>(out_q), S, L, D, slices);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" const char* vqa_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// mode: 0 = f32 v, q, matrices and outputs; 1 = bf16. v [B, S, D], q [B, 3,
// L, D]; wvt, wqt: W_v^T, W_q^T [D_out][D_in] in v's type; bv, bq, wv, wq [D]
// f32; vw [B, S, D], qw [B, 3L, D], ct [B, 3L, S], part [B, 3, ceil(D / 64),
// S + L] f32 scratch; out_v, out_q [B, 3, D]. v, q and the matrices 16-byte
// aligned, D a multiple of 32. Returns cudaGetLastError() after the launches
// (0 = success).
extern "C" int coattention_fwd(const void* v, const void* q, const void* wvt, const void* bv,
                               const void* wqt, const void* bq, const void* wv, const void* wq,
                               void* vw, void* qw, void* ct, void* part, void* out_v,
                               void* out_q, int B, int S, int L, int D, int mode, void* stream) {
  const uintptr_t misaligned = (reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(q) |
                                reinterpret_cast<uintptr_t>(wvt) |
                                reinterpret_cast<uintptr_t>(wqt)) % 16;
  if (misaligned || D % 32 != 0 || S < 1 || L < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* f[4] = {static_cast<float*>(vw), static_cast<float*>(qw), static_cast<float*>(ct),
                 static_cast<float*>(part)};
  switch (mode) {
    case 0: return launch<float>(v, q, wvt, bv, wqt, bq, wv, wq, f[0], f[1], f[2], f[3], out_v,
                                 out_q, B, S, L, D, st);
    case 1: return launch<__nv_bfloat16>(v, q, wvt, bv, wqt, bq, wv, wq, f[0], f[1], f[2], f[3],
                                         out_v, out_q, B, S, L, D, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

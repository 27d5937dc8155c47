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
// shared memory a block can have, so the work is cut in two launches:
//   (i) the projections as one tiled GEMM launch over three problems: W_v V
//       + b_v [B*S, D], W_q Q + b_q [B*3L, D] and the affinities' pre-tanh
//       Q V^T [3L, S] of every sample, into f32 scratch the wrapper
//       allocates (12.8 MB at b32, which the 50 MB L2 keeps). A block is 8
//       warps over a 128 x 128 output tile (a warp 32 x 64, two m16 and eight
//       n8 tiles), K in chunks of 8 32-bit words (16 bf16 or 8 f32 values)
//       through a 3-stage cp.async ring, rows 12 words apart (conflict-free
//       fragment loads). bf16: mma.sync.m16n8k16 with f32 sums; f32: 3xTF32
//       (hi = rna_tf32(v), lo = rna_tf32(v - hi); lo hi + hi lo + hi hi on
//       mma.sync.m16n8k8);
//  (ii) one block per (level, sample): tanh(C) [L, S] in shared memory, then
//       D in chunks of 32: the chunk of W_v V [S, 32] and of W_q Q [L, 32]
//       are staged, each warp forms rows of H_v and H_q (a lane a column,
//       f32 FMAs on the CUDA cores), multiplies them by w_v / w_q and adds the
//       warp's sum to the row's score; then both softmaxes and the pooled
//       sums over V and Q.
// What bounds it: at b32, S 196, L 23, D 512 it does 5.8 GFLOP and moves
// 9.7 MB (bf16), so operations: 4.9 G of them on bf16 operands (the
// projections and Q V^T), 0.9 G on f32 intermediates (H_v, H_q). Phase (ii)
// runs those on the CUDA cores in 96 blocks, under one an SM: it is the
// slow part of this first version. No atomics: deterministic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---- (i) the projections: out[m, n] = sum_k A[m, k] B[n, k] (+ bias[n]) ----

constexpr int G_BM = 128, G_BN = 128;
constexpr int G_KW = 8;                        // 32-bit words of K per stage
constexpr int G_RS = G_KW + 4;                 // row stride (words)
constexpr int G_THREADS = 256;
constexpr int G_STAGES = 3;
constexpr int G_TILE_WORDS = G_BM * G_RS;      // one operand's tile

struct Gemm {
  const void* a;        // [batch][M][K]
  const void* b;        // [batch][N][K]
  const float* bias;    // [N] or null
  float* out;           // [batch][M][N]
  int m, n, batch;
  long long sa, sb, so; // batch strides (elements)
  int first_tile;       // this problem's first block
};

struct Gemms {
  Gemm p[3];
  int k;                // K (values)
};

__device__ __forceinline__ void cp16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t tf32_rna(uint32_t v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(__uint_as_float(v)));
  return r & 0xffffe000u;
}

__device__ __forceinline__ void split(uint32_t v, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(v);
  lo = tf32_rna(__float_as_uint(__fsub_rn(__uint_as_float(v), __uint_as_float(hi))));
}

template <typename T>
__global__ void __launch_bounds__(G_THREADS) gemm_kernel(Gemms gp) {
  __shared__ __align__(16) uint32_t smem[G_STAGES][2][G_TILE_WORDS];
  constexpr bool BF16 = sizeof(T) == 2;
  int pi = 0;
  while (pi < 2 && static_cast<int>(blockIdx.x) >= gp.p[pi + 1].first_tile) ++pi;
  const Gemm& p = gp.p[pi];
  const int tiles_m = (p.m + G_BM - 1) / G_BM, tiles_n = (p.n + G_BN - 1) / G_BN;
  const int tile = blockIdx.x - p.first_tile;
  const int bz = tile / (tiles_m * tiles_n), rem = tile % (tiles_m * tiles_n);
  const int m0 = (rem / tiles_n) * G_BM, n0 = (rem % tiles_n) * G_BN;
  const int kw = BF16 ? gp.k / 2 : gp.k;        // words of a row
  const int nch = (kw + G_KW - 1) / G_KW;
  const uint32_t* ag = static_cast<const uint32_t*>(p.a) + bz * p.sa / (BF16 ? 2 : 1);
  const uint32_t* bg = static_cast<const uint32_t*>(p.b) + bz * p.sb / (BF16 ? 2 : 1);
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int mw = warp & 3, nw = warp >> 2;      // 4 warps along M, 2 along N
  const uint32_t sbase = static_cast<uint32_t>(__cvta_generic_to_shared(&smem[0][0][0]));

  auto load_stage = [&](int stage, int ch) {
    for (int i = t; i < 2 * G_BM * 2; i += G_THREADS) {
      const int op = i / (G_BM * 2), row = (i >> 1) % G_BM, k = ch * G_KW + (i & 1) * 4;
      const int r = (op ? n0 : m0) + row;
      const bool ok = r < (op ? p.n : p.m) && k < kw;
      const uint32_t* base = op ? bg : ag;
      cp16(sbase + ((stage * 2 + op) * G_TILE_WORDS + row * G_RS + (i & 1) * 4) * 4,
           ok ? base + static_cast<size_t>(r) * kw + k : base, ok);
    }
  };

  float acc[2][8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < G_STAGES - 1; ++s) {
    if (s < nch) load_stage(s, s);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
#pragma unroll 1
  for (int ch = 0; ch < nch; ++ch) {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(G_STAGES - 2) : "memory");
    __syncthreads();
    if (ch + G_STAGES - 1 < nch) load_stage((ch + G_STAGES - 1) % G_STAGES, ch + G_STAGES - 1);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    const uint32_t* as = smem[ch % G_STAGES][0] + (mw * 32 + g) * G_RS + q;
    const uint32_t* bs = smem[ch % G_STAGES][1] + (nw * 64 + g) * G_RS + q;
    uint32_t a[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const uint32_t* pa = as + mt * 16 * G_RS;
      a[mt][0] = pa[0];
      a[mt][1] = pa[8 * G_RS];
      a[mt][2] = pa[4];
      a[mt][3] = pa[8 * G_RS + 4];
    }
    if (BF16) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const uint32_t b0 = bs[j * 8 * G_RS], b1 = bs[j * 8 * G_RS + 4];
        mma_bf16(acc[0][j], a[0], b0, b1);
        mma_bf16(acc[1][j], a[1], b0, b1);
      }
    } else {
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int r = 0; r < 4; ++r) split(a[mt][r], ah[mt][r], al[mt][r]);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        uint32_t bh0, bl0, bh1, bl1;
        split(bs[j * 8 * G_RS], bh0, bl0);
        split(bs[j * 8 * G_RS + 4], bh1, bl1);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {   // small terms first
          mma_tf32(acc[mt][j], al[mt], bh0, bh1);
          mma_tf32(acc[mt][j], ah[mt], bl0, bl1);
          mma_tf32(acc[mt][j], ah[mt], bh0, bh1);
        }
      }
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");

  // acc[mt][j][2 h + e]: row m0 + 32 mw + 16 mt + g + 8 h, column n0 + 64 nw + 8 j + 2 q + e
  float* out = p.out + bz * p.so;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + 32 * mw + 16 * mt + g + 8 * h;
      if (m >= p.m) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + 64 * nw + 8 * j + 2 * q + e;
          if (n < p.n)
            out[static_cast<size_t>(m) * p.n + n] =
                p.bias ? __fadd_rn(acc[mt][j][2 * h + e], __ldg(p.bias + n)) : acc[mt][j][2 * h + e];
        }
    }
}

// ---- (ii) one block per (level, sample) ----

constexpr int A_THREADS = 256, A_WARPS = A_THREADS / 32;
constexpr int DC = 32;                         // D chunk: a lane a column
constexpr int ROWS = 4;                        // rows a warp forms at once

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

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// rows [r0, r0 + ROWS) of tanh(base + A^T B) . w for one D chunk, a lane a
// column: acc_r = sum_k A[k][r0 + r] B[k][lane] (A rows lda apart), then
// score[r] += warp sum of tanh(base[r][lane] + acc_r) w
__device__ __forceinline__ void score_rows(const float* A, int lda, int nk, const float* B,
                                           const float* base, float w, float* score,
                                           int r0, int nrows, int lane) {
  float acc[ROWS] = {0.f, 0.f, 0.f, 0.f};
  for (int k = 0; k < nk; ++k) {
    const float bk = B[k * DC + lane];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) acc[r] = __fmaf_rn(A[k * lda + r0 + r], bk, acc[r]);
  }
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    if (r0 + r >= nrows) break;                // warp-uniform
    const float h = tanhf(__fadd_rn(base[(r0 + r) * DC + lane], acc[r]));
    const float s = warp_sum(__fmul_rn(h, w));
    if (lane == 0) score[r0 + r] = __fadd_rn(score[r0 + r], s);
  }
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

// V [B, S, D], Q [B, 3, L, D] in T; vw [B, S, D], qw [B, 3L, D], cpre [B, 3L, S]
// f32 from (i); wv, wq [D] f32; out_v, out_q [B, 3, D] in T.
template <typename T>
__global__ void __launch_bounds__(A_THREADS) coatt_kernel(
    const T* __restrict__ V, const T* __restrict__ Q, const float* __restrict__ vw,
    const float* __restrict__ qw, const float* __restrict__ cpre,
    const float* __restrict__ wv, const float* __restrict__ wq,
    T* __restrict__ out_v, T* __restrict__ out_q, int S, int L, int D) {
  extern __shared__ float sm[];
  // row reads of the form A[k * lda + r0 + r] may run up to ROWS - 1 past a
  // buffer's end: the next buffer follows, and nothing read there is used
  float* cs = sm;                              // [L][S] tanh(Q V^T)
  float* vwc = cs + L * S;                     // [S][DC] chunk of W_v V + b_v
  float* qwc = vwc + S * DC;                   // [L][DC] chunk of W_q Q + b_q
  float* sv = qwc + L * DC;                    // [S] scores, then a_v
  float* sq = sv + S;                          // [L] scores, then a_q
  const int lvl = blockIdx.x, b = blockIdx.y;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const size_t qrow0 = (static_cast<size_t>(b) * 3 + lvl) * L;   // first row of Q as [B*3L, D]

  const float* cp = cpre + (static_cast<size_t>(b) * 3 * L + lvl * L) * S;
  for (int i = t; i < L * S; i += A_THREADS) cs[i] = tanhf(cp[i]);
  for (int i = t; i < S + L; i += A_THREADS) sv[i] = 0.f;   // sv and sq

  for (int dc = 0; dc < D; dc += DC) {
    __syncthreads();                           // the last chunk's readers are done
    for (int i = t; i < S * DC; i += A_THREADS)
      vwc[i] = vw[(static_cast<size_t>(b) * S + i / DC) * D + dc + i % DC];
    for (int i = t; i < L * DC; i += A_THREADS)
      qwc[i] = qw[(qrow0 + i / DC) * D + dc + i % DC];
    __syncthreads();
    const float wvd = __ldg(wv + dc + lane), wqd = __ldg(wq + dc + lane);
    // H_v rows s: sum over l of C[l][s] (W_q Q)[l][d]
    for (int s0 = warp * ROWS; s0 < S; s0 += A_WARPS * ROWS)
      score_rows(cs, S, L, qwc, vwc, wvd, sv, s0, S, lane);
    // H_q rows l: sum over s of C[l][s] (W_v V)[s][d] (A = C^T: rows of C S apart)
    for (int l0 = warp * ROWS; l0 < L; l0 += A_WARPS * ROWS) {
      float acc[ROWS] = {0.f, 0.f, 0.f, 0.f};
      for (int s = 0; s < S; ++s) {
        const float bk = vwc[s * DC + lane];
#pragma unroll
        for (int r = 0; r < ROWS; ++r) acc[r] = __fmaf_rn(cs[(l0 + r) * S + s], bk, acc[r]);
      }
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        if (l0 + r >= L) break;
        const float h = tanhf(__fadd_rn(qwc[(l0 + r) * DC + lane], acc[r]));
        const float sc = warp_sum(__fmul_rn(h, wqd));
        if (lane == 0) sq[l0 + r] = __fadd_rn(sq[l0 + r], sc);
      }
    }
  }
  __syncthreads();
  if (warp == 0) softmax(sv, S, lane);
  if (warp == 1) softmax(sq, L, lane);
  __syncthreads();
  const size_t o = (static_cast<size_t>(b) * 3 + lvl) * D;
  for (int d = t; d < D; d += A_THREADS) {
    float a = 0.f, c = 0.f;
    for (int s = 0; s < S; ++s)
      a = __fmaf_rn(sv[s], to_f32(V[(static_cast<size_t>(b) * S + s) * D + d]), a);
    for (int l = 0; l < L; ++l) c = __fmaf_rn(sq[l], to_f32(Q[(qrow0 + l) * D + d]), c);
    out_v[o + d] = from_f32<T>(a);
    out_q[o + d] = from_f32<T>(c);
  }
}

template <typename T>
int launch(const void* v, const void* q, const void* wvt, const void* bv, const void* wqt,
           const void* bq, const void* wv, const void* wq, float* vw, float* qw, float* cpre,
           void* out_v, void* out_q, int B, int S, int L, int D, cudaStream_t st) {
  if (B == 0) return static_cast<int>(cudaSuccess);
  // (i): W_v V + b_v, W_q Q + b_q, then Q V^T per sample
  Gemms gp;
  gp.k = D;
  gp.p[0] = {v, wvt, static_cast<const float*>(bv), vw, B * S, D, 1, 0, 0, 0, 0};
  gp.p[1] = {q, wqt, static_cast<const float*>(bq), qw, B * 3 * L, D, 1, 0, 0, 0, 0};
  gp.p[2] = {q, v, nullptr, cpre, 3 * L, S, B, 3LL * L * D, 1LL * S * D, 3LL * L * S, 0};
  int tiles = 0;
  for (Gemm& p : gp.p) {
    p.first_tile = tiles;
    tiles += p.batch * ((p.m + G_BM - 1) / G_BM) * ((p.n + G_BN - 1) / G_BN);
  }
  gemm_kernel<T><<<tiles, G_THREADS, 0, st>>>(gp);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);

  // (ii): the shared-memory size depends on S and L; above 48 KB it needs the
  // function's attribute, raised per device as far as a launch asked
  const size_t smem = (static_cast<size_t>(L) * S + (S + L) * DC + S + L) * sizeof(float);
  constexpr int MAX_DEVICES = 64;
  static size_t attr[MAX_DEVICES] = {};
  int dev = 0;
  e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (smem > 48 * 1024 && (dev >= MAX_DEVICES || attr[dev] < smem)) {
    e = cudaFuncSetAttribute(coatt_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev < MAX_DEVICES) attr[dev] = smem;
  }
  coatt_kernel<T><<<dim3(3, B), A_THREADS, smem, st>>>(
      static_cast<const T*>(v), static_cast<const T*>(q), vw, qw, cpre,
      static_cast<const float*>(wv), static_cast<const float*>(wq), static_cast<T*>(out_v),
      static_cast<T*>(out_q), S, L, D);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" const char* vqa_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// mode: 0 = f32 v, q, matrices and outputs; 1 = bf16. v [B, S, D], q [B, 3,
// L, D]; wvt, wqt: W_v^T, W_q^T [D_out][D_in] in v's type; bv, bq, wv, wq [D]
// f32; vw [B, S, D], qw [B, 3L, D], cpre [B, 3L, S] f32 scratch; out_v, out_q
// [B, 3, D]. v, q and the matrices 16-byte aligned, D a multiple of 32.
// Returns cudaGetLastError() after the launches (0 = success).
extern "C" int coattention_fwd(const void* v, const void* q, const void* wvt, const void* bv,
                               const void* wqt, const void* bq, const void* wv, const void* wq,
                               void* vw, void* qw, void* cpre, void* out_v, void* out_q,
                               int B, int S, int L, int D, int mode, void* stream) {
  const uintptr_t misaligned = (reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(q) |
                                reinterpret_cast<uintptr_t>(wvt) |
                                reinterpret_cast<uintptr_t>(wqt)) % 16;
  if (misaligned || D % DC != 0 || S < 1 || L < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* f[3] = {static_cast<float*>(vw), static_cast<float*>(qw), static_cast<float*>(cpre)};
  switch (mode) {
    case 0: return launch<float>(v, q, wvt, bv, wqt, bq, wv, wq, f[0], f[1], f[2], out_v, out_q,
                                 B, S, L, D, st);
    case 1: return launch<__nv_bfloat16>(v, q, wvt, bv, wqt, bq, wv, wq, f[0], f[1], f[2],
                                         out_v, out_q, B, S, L, D, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

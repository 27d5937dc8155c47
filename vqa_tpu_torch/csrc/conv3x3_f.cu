// Kernel D: float NHWC conv3x3 (pad 1) + bias + ReLU + 2x2 maxpool, bf16 or f32.
//
// Replaces the float route (int8 off, the default) of the Pallas TPU kernel
// vqa_tpu/ops/conv_hpack.py:_kernel, reached through _conv_hpack's
// pallas_call. The TPU kernel packs H row pairs onto the 128 lanes
// (_pack_h_pairs, _pack_weights) so that every dot contracts full lanes and
// the pool's H half is a max of two lane halves; that is a TPU layout, and
// here the input stays plain NHWC.
//
// Arithmetic kept from the TPU kernel: weights rounded to x.dtype (the
// wrapper does it), products of x.dtype operands summed in f32, the 2x2 pool
// a max over the four pixels' f32 sums, then + bias (f32), ReLU and one
// rounding to x.dtype at the store. The tensor cores sum in another order
// than ops/conv_hpack.conv3x3_f_plain, so the kernel is held within
// conv3x3_f_bound, not to bit-equality.
//
// What bounds it on the H100: operations. At VGG conv1 (448² input, b32, x
// [32, 224, 224, 64] -> [32, 112, 112, 128]) it does 118 G multiply-adds:
// 0.239 ms at the bf16 tensor-core peak against 0.092 ms for its 308 MB; in
// f32 each product costs three TF32 MMAs (1.44 ms at the TF32 peak). Design:
//   * implicit GEMM with K = 9 taps x C: M = conv pixels, N = output
//     channels. A block is 16 warps (8 along M x 2 along N) and owns a tile of
//     8 conv rows x 32 conv columns (4 x 16 pooled pixels) x 128 channels;
//     a warp owns 8 pooled pixels of one pooled row (32 conv pixels, two
//     m16 tiles) x 64 channels (8 n8 tiles), 64 f32 sums a thread;
//   * the rows of a warp's m16 tiles are ordered so that the four conv
//     pixels of a pooled pixel meet in one thread: tile mt is conv row
//     2 pr + mt, its row g is column 2 (pc0 + g) and row g + 8 column
//     2 (pc0 + g) + 1, and a thread holds rows g and g + 8 of both tiles. The
//     pool is a max over four registers, before one bias add and one store;
//   * K runs in chunks of 8 32-bit words per pixel: 16 bf16 channels (one
//     m16n8k16 step) or 8 f32 channels (one m16n8k8 step), and the nine taps
//     of a chunk read the same input halo (10 x 34 pixels) from another
//     start. A chunk's halo and weights ([9 taps][128 channels][8 words])
//     come by cp.async, whose zero fill is the conv's padding, into a ring of
//     3 stages (chunk ch + 2 loads while chunk ch multiplies; 206,688 bytes
//     of shared memory, one block of 16 warps an SM). Halo pixels lie 10
//     words apart and weight rows 12: each lane's fragment loads hit 32
//     distinct banks;
//   * the fragments are 32-bit words in both types: A word q (+4) of a
//     pixel, B word q (+4) of an output channel's row, so one body serves
//     both. bf16: one mma.sync.m16n8k16 (f32 sums) a tap, k-step and tile.
//     f32 (3xTF32): each operand v splits into hi = rna_tf32(v) and lo =
//     rna_tf32(v - hi) as its fragment is loaded, and each product is
//     lo_x hi_w + hi_x lo_w + hi_x hi_w, three mma.sync.m16n8k8 TF32;
//   * no split-K, no atomics: deterministic.
// C and C_out must be multiples of 8; a block's channels past C_out are
// zero-filled and not stored. Odd H or W floor (VALID pool).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TH = 8, TW = 32;                 // conv tile (pre-pool)
constexpr int PH = TH / 2, PW = TW / 2;        // pooled tile
constexpr int HALO_H = TH + 2, HALO_W = TW + 2;
constexpr int NPIX = HALO_H * HALO_W;          // 340
constexpr int BN = 128;                        // output channels of a block
constexpr int KW = 8;                          // 32-bit words of K per chunk
constexpr int XS = KW + 2;                     // halo pixel stride (words)
constexpr int WS = KW + 4;                     // weight row stride (words, 16-byte rows)
constexpr int M_WARPS = 8, N_WARPS = 2;
constexpr int THREADS = 32 * M_WARPS * N_WARPS;
constexpr int STAGES = 3;
constexpr int X_WORDS = NPIX * XS;
constexpr int W_WORDS = 9 * BN * WS;
constexpr int STAGE_WORDS = X_WORDS + W_WORDS;
constexpr int SMEM_BYTES = STAGES * STAGE_WORDS * 4;
static_assert((X_WORDS * 4) % 16 == 0 && (STAGE_WORDS * 4) % 16 == 0,
              "weight rows must stay 16-byte aligned");

__device__ __forceinline__ void cp8(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 8 : 0) : "memory");
}

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

// f32 -> TF32, to nearest with ties away from zero, the 13 low bits zero
__device__ __forceinline__ uint32_t tf32_rna(uint32_t v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(__uint_as_float(v)));
  return r & 0xffffe000u;
}

__device__ __forceinline__ void split(uint32_t v, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(v);
  lo = tf32_rna(__float_as_uint(__fsub_rn(__uint_as_float(v), __uint_as_float(hi))));
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __halves2bfloat162(__float2bfloat16_rn(a),
                                                             __float2bfloat16_rn(b));
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// T: __nv_bfloat16 (one m16n8k16 a step) or float (3xTF32, m16n8k8).
// x [B, H, W, C], w [9][Cout][C] in T, bias [Cout] f32, out [B, H/2, W/2, Cout].
template <typename T>
__global__ void __launch_bounds__(THREADS, 1) conv3x3_f_kernel(
    const T* __restrict__ x, const T* __restrict__ w, const float* __restrict__ bias,
    T* __restrict__ out, int H, int W, int C, int Cout) {
  extern __shared__ __align__(16) uint32_t smem[];
  constexpr bool BF16 = sizeof(T) == 2;
  const int cw = BF16 ? C / 2 : C;               // words of a pixel / weight row
  const int nch = (cw + KW - 1) / KW;
  const int Ho = H / 2, Wo = W / 2;
  const int tiles_w = (Wo + PW - 1) / PW;
  const int ty0 = (blockIdx.x / tiles_w) * TH, tx0 = (blockIdx.x % tiles_w) * TW;
  const int n0 = blockIdx.y * BN, b = blockIdx.z;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int mw = warp % M_WARPS, nw = warp / M_WARPS;
  const int pr = mw >> 1, pc0 = (mw & 1) * 8;    // the warp's pooled row, first pooled column
  const uint32_t sbase = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const uint32_t* xg = reinterpret_cast<const uint32_t*>(x);
  const uint32_t* wg = reinterpret_cast<const uint32_t*>(w);

  // chunk ch -> stage: the halo's words [8 ch, 8 ch + 8) of each pixel as 4
  // 8-byte copies, the weights' as 2 16-byte copies a (tap, channel) row
  auto load_stage = [&](int stage, int ch) {
    const uint32_t xs = sbase + stage * STAGE_WORDS * 4, ws = xs + X_WORDS * 4;
    for (int i = t; i < NPIX * 4; i += THREADS) {
      const int pix = i >> 2, k = ch * KW + (i & 3) * 2;
      const int iy = ty0 - 1 + pix / HALO_W, ix = tx0 - 1 + pix % HALO_W;
      const bool ok = iy >= 0 && iy < H && ix >= 0 && ix < W && k < cw;
      const uint32_t* src = ok ? xg + ((static_cast<size_t>(b) * H + iy) * W + ix) * cw + k : xg;
      cp8(xs + (pix * XS + (i & 3) * 2) * 4, src, ok);
    }
    for (int i = t; i < 9 * BN * 2; i += THREADS) {
      const int row = i >> 1, tap = row / BN, n = row % BN, k = ch * KW + (i & 1) * 4;
      const bool ok = n0 + n < Cout && k < cw;
      const uint32_t* src = ok ? wg + (static_cast<size_t>(tap) * Cout + n0 + n) * cw + k : wg;
      cp16(ws + (row * WS + (i & 1) * 4) * 4, src, ok);
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
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nch) load_stage(s, s);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  // the halo pixel of this lane's A row g (dx = 0) at tap (0, 0), conv row 2 pr
  const int apix = 2 * pr * HALO_W + 2 * (pc0 + g);
  const int brow = nw * 64 + g;
#pragma unroll 1
  for (int ch = 0; ch < nch; ++ch) {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(STAGES - 2) : "memory");
    __syncthreads();          // chunk ch landed; every warp is done with chunk ch - 1
    if (ch + STAGES - 1 < nch) load_stage((ch + STAGES - 1) % STAGES, ch + STAGES - 1);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    const uint32_t* xs = smem + (ch % STAGES) * STAGE_WORDS;
    const uint32_t* ws = xs + X_WORDS;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int ky = tap / 3, kx = tap % 3;
      // a[mt]: rows g (dx 0) and g + 8 (dx 1) of conv row 2 pr + mt, words q and q + 4
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const uint32_t* p = xs + (apix + (mt + ky) * HALO_W + kx) * XS + q;
        a[mt][0] = p[0];
        a[mt][1] = p[XS];
        a[mt][2] = p[4];
        a[mt][3] = p[XS + 4];
      }
      const uint32_t* wrow = ws + (tap * BN + brow) * WS + q;
      if (BF16) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const uint32_t b0 = wrow[j * 8 * WS], b1 = wrow[j * 8 * WS + 4];
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
          split(wrow[j * 8 * WS], bh0, bl0);
          split(wrow[j * 8 * WS + 4], bh1, bl1);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {   // small terms first
            mma_tf32(acc[mt][j], al[mt], bh0, bh1);
            mma_tf32(acc[mt][j], ah[mt], bl0, bl1);
            mma_tf32(acc[mt][j], ah[mt], bh0, bh1);
          }
        }
      }
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");

  // acc[mt][j][2 dx + e]: conv pixel (2 pr + mt, 2 (pc0 + g) + dx), channel
  // n0 + 64 nw + 8 j + 2 q + e
  const int po = ty0 / 2 + pr, pw = tx0 / 2 + pc0 + g;
  if (po >= Ho || pw >= Wo) return;
  T* const dst = out + ((static_cast<size_t>(b) * Ho + po) * Wo + pw) * Cout;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int n = n0 + nw * 64 + 8 * j + 2 * q;
    if (n >= Cout) break;                        // Cout % 8 == 0: whole n8 tiles
    float y[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float m = fmaxf(fmaxf(acc[0][j][e], acc[0][j][2 + e]),
                            fmaxf(acc[1][j][e], acc[1][j][2 + e]));
      const float v = __fadd_rn(m, __ldg(bias + n + e));
      y[e] = v > 0.f ? v : 0.f;
    }
    store2(dst + n, y[0], y[1]);
  }
}

template <typename T>
int launch(const void* x, const void* w, const void* bias, void* out, int B, int H, int W,
           int C, int Cout, cudaStream_t st) {
  // the shared-memory limit is an attribute of the function on each device
  constexpr int MAX_DEVICES = 64;
  static bool attr_set[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= MAX_DEVICES || !attr_set[dev]) {
    e = cudaFuncSetAttribute(conv3x3_f_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_BYTES);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev < MAX_DEVICES) attr_set[dev] = true;
  }
  const int Ho = H / 2, Wo = W / 2;
  if (B == 0 || Ho == 0 || Wo == 0 || Cout == 0) return static_cast<int>(cudaSuccess);
  const dim3 grid(((Ho + PH - 1) / PH) * ((Wo + PW - 1) / PW), (Cout + BN - 1) / BN, B);
  conv3x3_f_kernel<T><<<grid, THREADS, SMEM_BYTES, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const float*>(bias),
      static_cast<T*>(out), H, W, C, Cout);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" const char* vqa_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// mode: 0 = f32 x, w and out; 1 = bf16. w: [9][Cout][C] (ops/conv_hpack.
// conv3x3_f_operands), bias [Cout] f32. x and w 16-byte aligned, C and Cout
// multiples of 8. Returns cudaGetLastError() after the launch (0 = success).
extern "C" int conv3x3_f(const void* x, const void* w, const void* bias, void* out,
                         int B, int H, int W, int C, int Cout, int mode, void* stream) {
  if (C % 8 != 0 || Cout % 8 != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(w) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case 0: return launch<float>(x, w, bias, out, B, H, W, C, Cout, st);
    case 1: return launch<__nv_bfloat16>(x, w, bias, out, B, H, W, C, Cout, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Kernel A: int8 VGG conv0 (3 -> 64) + dequant + bias + ReLU + 2x2 maxpool.
//
// Replaces two Pallas TPU kernels of the JAX package:
//   vqa_tpu/ops/conv_stage1.py:_kernel_i8            (plain epilogue, x.dtype out)
//   vqa_tpu/ops/conv_stem.py:_kernel_conv0_packed    (requant epilogue, int8 out)
// Both compute the same int32 sums: the TPU kernels rewrite the conv as a
// space-to-depth K=108 dot so the 128-deep MXU is fed; here an implicit GEMM
// over the four pool phases gives the same integers.
//
// What bounds it on the H100: bytes. Each pooled output channel costs 4
// phases x 27 int8 MACs, i.e. 108 MACs per 1-2 stored bytes, far below the
// card's int8 ridge. At the serving shape (b32 @ 448^2) the 19 MB int8 image
// is read once and 205 MB of bf16 (or 103 MB of int8) is written. An earlier
// version ran the 11.1 G MACs as __dp4a on the CUDA cores and was bound by
// their instruction rate (PERF.md §6), so the MACs now go to the int8 tensor
// cores, mma.sync.m16n8k32.s32.s8.s8 (enough: the MMAs take ~10% of the time
// the bytes need, so wgmma's larger tiles would buy nothing here). The
// instructions left, the pool's max and the epilogue's ~12 a value, now set
// the requant mode's time:
//   * GEMM: M = (pooled pixel, pool phase), N = 64 channels (8 n-tiles),
//     K = the 27 (tap, channel) pairs packed into 32 bytes, one k-step. Word
//     k < 8 of K is tap k's (c0, c1, c2) in its bytes 0-2; byte 3 of words
//     0-2 carries tap 8's channel k (of words 3-7: zero weight). So lane
//     (g, t) builds its A fragment from tap t and t + 4 of its pixels g and
//     g + 8, merging in tap 8 with one __byte_perm;
//   * a warp owns 16 consecutive pooled pixels of one pooled row and runs
//     one M tile per pool phase, so the four phase sums of a (pixel,
//     channel) land in the same thread's registers: the 2x2 pool is a
//     register max over four MMA results, in int32, before the epilogue
//     (exact: every epilogue step is non-decreasing because scale > 0);
//   * a tile is 16 pooled rows x 32 pooled pixels (each of a block's 8
//     warps four such units). Its 34 x 66 input pixels come from device
//     memory by cp.async, 16 bytes at a time from each contiguous NHWC row
//     segment (4-byte words at its unaligned ends), so each input byte is
//     read ~1.06 times, and are unpacked in shared memory into char4 words
//     (c0, c1, c2, 0), the padding halo zero. The row stride of 81 words (17
//     mod 32 banks) makes every A-fragment load conflict-free;
//   * blocks are persistent (as many as fit on the card at once) and walk
//     over the tiles: a tile's input is fetched while the block computes the
//     one before, so the loads' latency hides behind the MMAs and the
//     epilogue instead of stalling each block before its first MMA;
//   * the weights, in B-fragment order (ops/conv_stage1.pack_conv0_i8_weights,
//     2 KB), stay in each thread's registers for the whole block;
//   * each warp stages a unit's 16 x 64 outputs in shared memory (padded rows,
//     conflict-free) and writes them back as 16-byte stores, neighbouring
//     lanes on neighbouring addresses: the unit is one contiguous run of
//     the NHWC output. No atomics: deterministic.
//
// Epilogue, bit-for-bit the plain PyTorch version in ops/conv_stage1.py:
//   y = relu(__fadd_rn(__fmul_rn(float(max_acc), scale[o]), bias[o]))
//   MODE 0: store f32, MODE 1: store bf16 (round to nearest even),
//   MODE 2: store int8 clip(rint(__fdiv_rn(y, s1[o])), -127, 127), computed
//   through a reciprocal where that provably gives the same integer
//   (near_half below).
// The _rn intrinsics keep nvcc from contracting into an FMA; rint rounds half
// to even, as the JAX package's CPU fallbacks do. Int32 sums are exact in any
// order (|acc| <= 27 * 127^2 < 2^31).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int OC = 64;                      // output channels (VGG conv0)
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int UNIT = 16;                    // pooled pixels per warp unit (M tile rows)
constexpr int TPX = 2 * UNIT;               // pooled columns per tile
constexpr int TPR = 2 * WARPS;              // pooled rows per tile
constexpr int XR = 2 * TPR + 2;             // staged input rows (34)
constexpr int XC = 2 * TPX + 2;             // staged input columns (66)
constexpr int XS = 81;                      // xs row stride in words: 17 mod 32
constexpr int RAW_CHUNKS = 14;              // 16-byte chunks that cover a row segment
constexpr int RAW_W = 16 * RAW_CHUNKS;      // >= XC * 3 + 15
constexpr int RAW_BYTES = XR * RAW_W;                      // 7,616
constexpr int XS_BYTES = (XR * XS * 4 + 15) / 16 * 16;     // 11,024
static_assert(XS >= XC && XS % 32 == 17, "A-fragment loads must stay conflict-free");
static_assert(RAW_W >= XC * 3 + 15, "a row segment plus its misalignment must fit");

// Staging row stride (bytes) of one pooled pixel's 64 outputs: padded so that
// the epilogue's fragment stores and the 16-byte reads are conflict-free.
template <int MODE> struct Out;
template <> struct Out<0> { using T = float; static constexpr int RS = 288; };
template <> struct Out<1> { using T = __nv_bfloat16; static constexpr int RS = 144; };
template <> struct Out<2> { using T = int8_t; static constexpr int RS = 80; };

__device__ __forceinline__ void cp_async16(uint32_t dst, uintptr_t src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" :: "r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, uintptr_t src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" :: "r"(dst), "l"(src) : "memory");
}

// d = A (16 x 32 s8, row) x B (32 x 8 s8, col), int32, from zero.
__device__ __forceinline__ void mma_s8(int* d, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "r"(0));
}

// float(sum) * s + b, before the ReLU
__device__ __forceinline__ float affine(int a, float s, float b) {
  return __fadd_rn(__fmul_rn(__int2float_rn(a), s), b);
}

__device__ __forceinline__ float relu(float v) { return v > 0.f ? v : 0.f; }

__device__ __forceinline__ int clip_rint(float v) {
  return static_cast<int>(fminf(fmaxf(rintf(v), -127.f), 127.f));
}

// Kernel B's rule (csrc/conv3x3_i8.cu, where it is proved): with q = y * inv,
// inv = rn(1 / s), rint(q) == rint(__fdiv_rn(y, s)) unless q < 128.5 lies
// within 2^-14 of a half-integer, or inv is NaN (s outside [2^-120, 2^120]);
// for q >= 128.5 both give 127 after the clip. Kernel A flags a superset,
// every q within 2^-14 of a half-integer and every NaN, |q - rint(q)| >=u
// 0.5 - 2^-14, which costs one compare a value (it also sends q = inf and a
// few saturated values to the division, which gives the same integer).
__device__ __forceinline__ bool near_half(float q, float rq) {
  return !(fabsf(__fsub_rn(q, rq)) < 0.5f - 0x1p-14f);
}

// Whether any lane of the warp has a value with near_half: one setp per
// value, chained, and one vote (written in PTX: the same test in C++ kept a
// bool per value and cost ~8 instructions a value in SASS).
__device__ __forceinline__ bool warp_any_near_half(const float* d) {
  uint32_t any;
  asm("{\n\t.reg .pred p;\n\t"
      "setp.geu.f32 p, %1, 0f3EFFF800;\n\t"              // 0.5 - 2^-14
      "setp.geu.or.f32 p, %2, 0f3EFFF800, p;\n\t"
      "setp.geu.or.f32 p, %3, 0f3EFFF800, p;\n\t"
      "setp.geu.or.f32 p, %4, 0f3EFFF800, p;\n\t"
      "vote.sync.any.pred p, p, 0xffffffff;\n\t"
      "selp.u32 %0, 1, 0, p;\n\t}"
      : "=r"(any) : "f"(fabsf(d[0])), "f"(fabsf(d[1])), "f"(fabsf(d[2])), "f"(fabsf(d[3])));
  return any != 0;
}

__device__ __forceinline__ float reciprocal_or_nan(float s) {
  return (s >= 0x1p-120f && s <= 0x1p120f) ? __frcp_rn(s) : __int_as_float(0x7fc00000);
}

// Requant fits 3 blocks a SM in 80 registers; the float modes would spill
// there, so they take 2.
template <int MODE>
__global__ void __launch_bounds__(THREADS, MODE == 2 ? 3 : 2) conv0_s2d_i8_kernel(
    const int8_t* __restrict__ x,      // [B, H, W, 3] int8, 4-byte aligned
    const int* __restrict__ wf,        // [32 lanes][8 n-tiles][2] B fragments
    const float* __restrict__ scale,   // [64] dequant scale
    const float* __restrict__ bias,    // [64]
    const float* __restrict__ s1,      // [64] requant scale (MODE 2)
    void* __restrict__ out,            // [B, H/2, W/2, 64]
    int B, int H, int W) {
  constexpr int ES = sizeof(typename Out<MODE>::T);
  constexpr int RS = Out<MODE>::RS;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* const raw = smem;                           // [XR][RAW_W] bytes
  int* const xs = reinterpret_cast<int*>(smem + RAW_BYTES);  // [XR][XS] char4 words
  const uint32_t raw_s = static_cast<uint32_t>(__cvta_generic_to_shared(raw));

  const int Ho = H / 2, Wo = W / 2;
  const int tiles_x = (Wo + TPX - 1) / TPX, tiles_y = (Ho + TPR - 1) / TPR;
  const int ntiles = tiles_x * tiles_y * B;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;

  // A tile's image b, first pooled row and column, and the staged input's
  // origin (iy0, ix0) with its valid columns [c_lo, c_hi).
  struct Tile { int b, po0, pw0, iy0, ix0, c_lo, c_hi; };
  auto tile_at = [&](int i) {
    Tile tl;
    tl.pw0 = (i % tiles_x) * TPX;
    tl.po0 = (i / tiles_x % tiles_y) * TPR;
    tl.b = i / (tiles_x * tiles_y);
    tl.iy0 = 2 * tl.po0 - 1, tl.ix0 = 2 * tl.pw0 - 1;
    tl.c_lo = tl.ix0 < 0 ? 1 : 0, tl.c_hi = min(XC, W - tl.ix0);
    return tl;
  };
  auto segment = [&](const Tile& tl, int iy) {       // first valid byte of a row segment
    return reinterpret_cast<uintptr_t>(
        x + ((static_cast<size_t>(tl.b) * H + iy) * W + tl.ix0 + tl.c_lo) * 3);
  };
  // Fetch each input row segment of tile i into raw row r at its offset from
  // the 16-byte-aligned base: a chunk inside the segment as one 16-byte
  // cp.async, else the 4-byte words that hold its bytes. With x 4-byte
  // aligned and H, W even (x's size a multiple of 12), those words lie
  // inside x.
  auto fetch = [&](int i) {
    const Tile tl = tile_at(i);
    for (int j = t; j < XR * RAW_CHUNKS; j += THREADS) {
      const int r = j / RAW_CHUNKS, k = j % RAW_CHUNKS, iy = tl.iy0 + r;
      if (iy < 0 || iy >= H) continue;
      const uintptr_t lo = segment(tl, iy), hi = lo + (tl.c_hi - tl.c_lo) * 3;
      const uintptr_t a = (lo & ~static_cast<uintptr_t>(15)) + 16 * k;
      const uint32_t dst = raw_s + r * RAW_W + 16 * k;
      if (a >= lo && a + 16 <= hi) {
        cp_async16(dst, a);
      } else {
        for (int m = 0; m < 4; ++m)
          if (a + 4 * m + 4 > lo && a + 4 * m < hi) cp_async4(dst + 4 * m, a + 4 * m);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  // Per-thread constants: lane (g, tq) of the MMA fragments.
  const int g = lane >> 2, tq = lane & 3;
  uint32_t bf[16];                     // bf[2j + r]: n-tile j, K word tq + 4r
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int4 v = __ldg(reinterpret_cast<const int4*>(wf) + lane * 4 + i);
    bf[4 * i] = v.x, bf[4 * i + 1] = v.y, bf[4 * i + 2] = v.z, bf[4 * i + 3] = v.w;
  }
  // per channel pair (2p, 2p + 1): (scale, scale, bias, bias) and the
  // requant reciprocals, read by the epilogue from shared memory (as
  // registers they would cost 48 a thread, and a block per SM)
  float4* const prm = reinterpret_cast<float4*>(smem + RAW_BYTES + XS_BYTES + WARPS * UNIT * RS);
  float2* const rcp = reinterpret_cast<float2*>(prm + OC / 2);
  if (t < OC / 2) {
    prm[t] = make_float4(__ldg(scale + 2 * t), __ldg(scale + 2 * t + 1),
                         __ldg(bias + 2 * t), __ldg(bias + 2 * t + 1));
    if (MODE == 2)
      rcp[t] = make_float2(reciprocal_or_nan(__ldg(s1 + 2 * t)),
                           reciprocal_or_nan(__ldg(s1 + 2 * t + 1)));
  }
  // tap k = (k / 3, k % 3) of lane tq's A words: tap tq, tap tq + 4, tap 8
  const int off_lo = (tq / 3) * XS + tq % 3, off_hi = ((tq + 4) / 3) * XS + (tq + 4) % 3;
  const int off_8 = 2 * XS + 2;
  const uint32_t sel = 0x0210u | ((4u + tq) << 12);   // bytes 0-2 of tap tq, byte tq of tap 8
  unsigned char* const ws = smem + RAW_BYTES + XS_BYTES + warp * UNIT * RS;

  const int first = blockIdx.x, step = gridDim.x;
  if (first < ntiles) fetch(first);
#pragma unroll 1
  for (int i = first; i < ntiles; i += step) {
    const Tile tl = tile_at(i);
    // tile i's input has landed and every warp is done with the last tile
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    for (int j = t; j < XR * XC; j += THREADS) {     // unpack into char4 words
      const int r = j / XC, c = j % XC, iy = tl.iy0 + r;
      int v = 0;
      if (iy >= 0 && iy < H && c >= tl.c_lo && c < tl.c_hi) {
        const unsigned char* p = raw + r * RAW_W + (segment(tl, iy) & 15) + (c - tl.c_lo) * 3;
        v = p[0] | (p[1] << 8) | (p[2] << 16);
      }
      xs[r * XS + c] = v;
    }
    __syncthreads();
    if (i + step < ntiles) fetch(i + step);          // overlaps this tile's MMAs

    // The warp's units: pooled rows warp and warp + 8, column halves 0 and 1.
#pragma unroll 1
    for (int ui = 0; ui < 4; ++ui) {
      const int pr = warp + WARPS * (ui >> 1), po = tl.po0 + pr;
      const int pw = tl.pw0 + UNIT * (ui & 1);
      if (po >= Ho || pw >= Wo) continue;           // warp-uniform
      uint32_t a[4][4];                             // [phase (p, q)][fragment register]
#pragma unroll
      for (int ph = 0; ph < 4; ++ph) {
        const int* base = xs + (2 * pr + (ph >> 1)) * XS + 2 * (UNIT * (ui & 1) + g) + (ph & 1);
        a[ph][0] = __byte_perm(base[off_lo], base[off_8], sel);
        a[ph][1] = __byte_perm(base[off_lo + 16], base[off_8 + 16], sel);
        a[ph][2] = base[off_hi];
        a[ph][3] = base[off_hi + 16];
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        int d[4][4];
#pragma unroll
        for (int ph = 0; ph < 4; ++ph) mma_s8(d[ph], a[ph], bf[2 * j], bf[2 * j + 1]);
        // m[2h + e]: pixel g + 8h, channel c + e
        int m[4];
#pragma unroll
        for (int v = 0; v < 4; ++v) m[v] = max(max(d[0][v], d[1][v]), max(d[2][v], d[3][v]));
        const float4 pj = prm[4 * j + tq];          // channels c, c + 1
        float y[4];                                 // before the ReLU
#pragma unroll
        for (int v = 0; v < 4; ++v) y[v] = affine(m[v], v & 1 ? pj.y : pj.x, v & 1 ? pj.w : pj.z);
        const int c = 8 * j + 2 * tq;
        unsigned char* dst0 = ws + g * RS + c * ES;
        unsigned char* dst1 = dst0 + 8 * RS;
        if (MODE == 0) {
          *reinterpret_cast<float2*>(dst0) = make_float2(relu(y[0]), relu(y[1]));
          *reinterpret_cast<float2*>(dst1) = make_float2(relu(y[2]), relu(y[3]));
        } else if (MODE == 1) {
          *reinterpret_cast<__nv_bfloat162*>(dst0) = __floats2bfloat162_rn(relu(y[0]), relu(y[1]));
          *reinterpret_cast<__nv_bfloat162*>(dst1) = __floats2bfloat162_rn(relu(y[2]), relu(y[3]));
        } else {
          // The ReLU moves to the integer: with inv > 0, y <= 0 gives
          // q <= 0 and max(min(rint(q), 127), 0) = 0, which the ReLU'd y
          // gives too; NaN (inv) -> 0, then divided. The warp divides only
          // when one of its lanes needs it (a vote once per n-tile, as
          // kernel B's per 8 channels), so the division is skipped, not
          // predicated
          const float2 ij = rcp[4 * j + tq];
          int r[4];
          float q[4], dq[4];
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            q[v] = __fmul_rn(y[v], v & 1 ? ij.y : ij.x);
            const float rq = rintf(q[v]);
            dq[v] = __fsub_rn(q[v], rq);
            r[v] = __vimin_s32_relu(__float2int_rz(rq), 127);
          }
          if (warp_any_near_half(dq)) {
#pragma unroll
            for (int v = 0; v < 4; ++v)
              if (near_half(q[v], rintf(q[v])))
                r[v] = clip_rint(__fdiv_rn(relu(y[v]), __ldg(s1 + c + (v & 1))));
          }
          *reinterpret_cast<uint16_t*>(dst0) = static_cast<uint16_t>(__byte_perm(r[0], r[1], 0x40));
          *reinterpret_cast<uint16_t*>(dst1) = static_cast<uint16_t>(__byte_perm(r[2], r[3], 0x40));
        }
      }
      __syncwarp();
      // the unit's outputs are one contiguous run of the NHWC output; int8
      // lanes read 8 pixels' same chunk at a time (conflict-free at RS = 80)
      constexpr int CPP = OC * ES / 16;             // 16-byte chunks per pixel
      const int npx = min(UNIT, Wo - pw);
      unsigned char* gout = static_cast<unsigned char*>(out) +
          ((static_cast<size_t>(tl.b) * Ho + po) * Wo + pw) * (OC * ES);
#pragma unroll
      for (int it = 0; it < UNIT * CPP / 32; ++it) {
        const int k = CPP >= 8 ? (lane + 32 * it) % CPP : lane >> 3;
        const int px = CPP >= 8 ? (lane + 32 * it) / CPP : 8 * it + (lane & 7);
        if (px < npx)
          *reinterpret_cast<int4*>(gout + px * (OC * ES) + 16 * k) =
              *reinterpret_cast<const int4*>(ws + px * RS + 16 * k);
      }
      __syncwarp();
    }
  }
}

template <int MODE>
int launch(const int8_t* x, const int* w, const float* scale, const float* bias,
           const float* s1, void* out, int B, int H, int W, cudaStream_t st) {
  constexpr int SMEM = RAW_BYTES + XS_BYTES + WARPS * UNIT * Out<MODE>::RS + OC / 2 * 24;
  // per device: the shared-memory attribute (mode 0 needs > 48 KB) and the
  // number of blocks that fit on the card at once
  constexpr int MAX_DEVICES = 64;
  static int resident[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  int blocks = dev < MAX_DEVICES ? resident[dev] : 0;
  if (blocks == 0) {
    e = cudaFuncSetAttribute(conv0_s2d_i8_kernel<MODE>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    int sms = 0, per_sm = 0;
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, conv0_s2d_i8_kernel<MODE>,
                                                        THREADS, SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    blocks = sms * per_sm;
    if (blocks == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
    if (dev < MAX_DEVICES) resident[dev] = blocks;
  }
  const int ntiles = ((W / 2 + TPX - 1) / TPX) * ((H / 2 + TPR - 1) / TPR) * B;
  conv0_s2d_i8_kernel<MODE><<<ntiles < blocks ? ntiles : blocks, THREADS, SMEM, st>>>(
      x, w, scale, bias, s1, out, B, H, W);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" const char* vqa_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x: 4-byte aligned (the fetch's edge words must not cross x's ends; any
// other x is refused with cudaErrorMisalignedAddress); w: [32][8][2] int32
// B fragments (ops/conv_stage1.pack_conv0_i8_weights).
// mode: 0 = f32 out, 1 = bf16 out, 2 = int8 requant with s1.
// Returns cudaGetLastError() after the launch (0 = success).
extern "C" int conv0_s2d_i8(const void* x, const void* w, const void* scale,
                            const void* bias, const void* s1, void* out,
                            int B, int H, int W, int mode, void* stream) {
  if (reinterpret_cast<uintptr_t>(x) % 4 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* xp = static_cast<const int8_t*>(x);
  const int* wp = static_cast<const int*>(w);
  const float* sp = static_cast<const float*>(scale);
  const float* bp = static_cast<const float*>(bias);
  const float* s1p = static_cast<const float*>(s1);
  switch (mode) {
    case 0: return launch<0>(xp, wp, sp, bp, s1p, out, B, H, W, st);
    case 1: return launch<1>(xp, wp, sp, bp, s1p, out, B, H, W, st);
    case 2: return launch<2>(xp, wp, sp, bp, s1p, out, B, H, W, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

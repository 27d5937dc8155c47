// Kernel D: float NHWC conv3x3 (pad 1) + bias + ReLU (+ 2x2 maxpool), bf16 or f32.
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
//   * implicit GEMM with K = 9 taps x C on warpgroup MMAs from shared-memory
//     descriptors: bf16 wgmma.m64n128k16, f32 as 3xTF32 wgmma.m64n128k8. A K
//     step is 32 bytes of a pixel (16 bf16 or 8 f32 channels), kernel B's
//     int8 geometry (conv3x3_i8.cu): the input halo of a K chunk is stored as
//     two 16-byte K halves of [10][tile width + 2] pixels, so a tap's A
//     operand (an M = 64 tile of 8 x 8 conv pixels) is the same halo from
//     another start address (SBO = one halo row, LBO = one K half); no
//     im2col. A consumer warpgroup owns 16 conv columns x 8 rows as two M
//     tiles (128 f32 sums a thread: the producer warpgroup gives its
//     registers to the consumers with setmaxnreg, 40 and 232 a thread);
//   * the weights are the B operand, packed by the wrapper
//     (ops/conv_hpack.pack_conv3x3_f_weights) as [slice][chunk][hi, lo in
//     f32][tap][16][K half][8][16 bytes] for slices of 128 output channels.
//     Blocks are persistent (one an SM, from the device's SM count), each
//     with a fixed slice, walking spatial tiles. Where the slice fits in
//     shared memory beside the rings (bf16 VGG conv1: 147,456 bytes) it is
//     fetched once, by bulk copies, and stays resident, so the weights
//     cross L2 -> SMEM once a block instead of once a tile (0.92 GB of a
//     448² bf16 launch before); otherwise (f32: hi and lo of conv1 are
//     589,824 bytes) each chunk's slice streams through the ring with its
//     halo, 147,456 bytes a tile of 8 x 32 pixels;
//   * two schedules (plan() below). Resident weights: 2 streams, ping-pong:
//     each warpgroup walks its own tiles of 8 x 16 conv pixels through its
//     own ring, and their mainloops take turns on the tensor cores (an
//     mbarrier pair orders them), so one warpgroup's epilogue overlaps the
//     other's MMAs. Streamed weights: 1 stream, both warpgroups on one tile
//     of 8 x 32 pixels (the weight chunk serves 256 pixels);
//   * a producer warp (one thread of the producer warpgroup) keeps the rings
//     full: per (tile, chunk) two TMA loads of a 4-D tensor map over NHWC
//     (boxes of 16 bytes x (tile width + 2) x 10, whose zero fill outside
//     the image is the conv's padding) and, streamed, one bulk copy of the
//     chunk's weights, completing on the stage's mbarrier. The consumers
//     wait on it, multiply, and release the stage; the producer runs ahead
//     across tile boundaries, so a tile's epilogue overlaps the next tile's
//     loads;
//   * f32: the wrapper splits the weights into TF32 hi and lo once; the
//     consumers split each halo stage once (not once per tap) into hi and lo
//     halos, double-buffered, and take each product as lo_x hi_w + hi_x lo_w
//     + hi_x hi_w, three wgmmas, small terms first;
//   * epilogue: M rows 16 w + g and 16 w + g + 8 of warp w are tile rows 2 w
//     and 2 w + 1 at column g of the M tile, so the two rows of a pool window
//     meet in one thread and its two columns in lanes 4 apart (one shuffle);
//     then + bias (f32), ReLU, one rounding to x.dtype, staged in shared
//     memory and written with 16-byte coalesced stores;
//   * no split-K, no atomics: deterministic.
// C and C_out must be multiples of 8; a slice's channels past C_out have zero
// weights and are not stored, K chunks past C arrive as zeros. Odd H or W
// floor (VALID pool).
//
// Unpooled mode (POOL = false, a compile-time flag, so the pooled bodies
// compile as they did): the same mainloop, and an epilogue that stores
// every conv pixel, f32 sum + bias, ReLU and one rounding to x.dtype. It is
// the float route of the Pallas probe tools/exp_nhwc_tap.py:_kernel
// (int8=False), the unpooled conv1 that probe times; no model path runs it.
// Its tile writes 4 times the pooled bytes (32 KB of bf16 a stream's tile
// of 8 x 16 pixels): at b160 conv1 the launch reads 1.03 GB and writes 2.06
// GB (0.92 ms at 3.35 TB/s) against 1.20 ms of bf16 tensor-core time, so
// the stores must overlap the other stream's MMAs almost whole. Design:
//   * the stores go out by TMA: a 4-D tensor map over the output [B, H, W,
//     C_out] with boxes of 64 bytes of channels x 16 columns x 2 rows, the
//     pixels one warp's fragments hold; each warp stages and stores its own
//     boxes (lane 0 issues cp.async.bulk.tensor, one bulk group a box), so
//     the epilogue needs no barrier across warps; the box's part past H, W
//     or C_out is not written, so the ragged edge needs no mask;
//   * a warp's staging is two pieces used in turn: 64 bytes of channels (32
//     bf16 or 16 f32) of its 32 pixels, a pixel's 64 bytes a row, under the
//     64-byte swizzle (a row's 16-byte unit u at u ^ ((row >> 1) & 3), as
//     TMA reads it): the warp's fragment writes of 8 pixels x 16 bytes then
//     fall on 32 distinct banks. Before a piece is written again, lane 0
//     waits until the store of two pieces ago has read it
//     (cp.async.bulk.wait_group.read 1), so one piece's store drains while
//     the next is written, and the warp goes back to its mainloop without
//     waiting for its last stores;
//   * the unpooled kernels (conv3x3_f_kernel_unpooled, one a stream count)
//     know the halo's width at compile time, so the tap offsets of their
//     descriptors are immediates and not registers held across the
//     mainloop: with them the epilogue's state fits in the consumers' 232
//     registers without a spill (with the widths read from Params it
//     spilled);
//   * shared memory (bf16 VGG conv1, 2 streams, resident weights): 1,024
//     bytes of alignment and 1,024 of barriers, 2 x 16,384 of staging (two
//     2 KB pieces a warp), 147,456 of weights and 4 ring stages of 11,776
//     bytes (two streams' halos): 229,376 of the 232,448 a block can have.
//     In f32 the staging shares the split halos' region, so each warp waits
//     for its stores' reads before the next tile's split.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int TH = 8, TW = 32;                 // conv tile of a block (pre-pool)
constexpr int PH = TH / 2, PW = TW / 2;        // pooled
constexpr int HALO_H = TH + 2;
constexpr int CONSUMERS = 256;                 // 2 warpgroups
constexpr int THREADS = CONSUMERS + 128;       // + the producer warpgroup (one thread issues)
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;   // setmaxnreg: 128 x 40 + 256 x 232 <= 64 K
constexpr int MAX_STAGES = 8;                  // a stream's ring
// full[2][8], empty[2][8], the weights' barrier, the two order barriers
constexpr int BARRIER_BYTES = 512;

constexpr int BN = 128;                        // output channels of a block (its slice)
// unpooled: a staging piece, 64 bytes of channels of a warp's 2 x 16 pixels
constexpr int UPIECE = 2 * 16 * 64;

template <typename T> struct Traits;
template <> struct Traits<__nv_bfloat16> {
  static constexpr int CK = 16, PARTS = 1;     // K chunk; one wgmma a tap and M tile
};
template <> struct Traits<float> {
  static constexpr int CK = 8, PARTS = 2;      // hi and lo, three wgmmas
};

template <typename T> struct Layout {
  static constexpr int TAP_BYTES = BN * 32;
  static constexpr int W_CHUNK = 9 * TAP_BYTES * Traits<T>::PARTS;    // one chunk's slice
  static constexpr int RS = BN * static_cast<int>(sizeof(T)) + 16;    // staging row stride
  // unpooled: channels of a staging piece, 64 bytes of a pixel
  static constexpr int UCH = 64 / static_cast<int>(sizeof(T));
  static_assert(W_CHUNK % 128 == 0, "regions must stay 128-byte aligned");
};

// Shared memory: barriers; per stream a region (f32: its double-buffered hi
// and lo halos; both types: the epilogue's staging, after the split halos'
// last use); the resident weights; per stream a ring of stages (a halo in
// two K halves, and the chunk's weights where they stream).
struct Params {
  int H, W, C, Cout, Ho, Wo;
  int nch;             // K chunks
  int resident;        // the slice's weights stay in shared memory
  int streams;         // 1: both warpgroups on one tile 32 conv columns wide; 2: a tile
                       // 16 wide each, their mainloops in turn (ping-pong)
  int stages;          // ring depth of a stream
  int units;           // spatial tiles (of every image), per slice
  int tiles_w, tiles_img;
  int halo_w, half_bytes, stage_bytes, region;
};

__host__ __device__ constexpr int round128(int n) { return (n + 127) / 128 * 128; }

__device__ __forceinline__ void store2(unsigned char* p, float a, float b, __nv_bfloat16*) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __halves2bfloat162(__float2bfloat16_rn(a),
                                                             __float2bfloat16_rn(b));
}

__device__ __forceinline__ void store2(unsigned char* p, float a, float b, float*) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// The same, to a shared-memory address (32 bits: one register an address)
__device__ __forceinline__ void store2_shared(uint32_t addr, float a, float b, __nv_bfloat16*) {
  const __nv_bfloat162 v = __halves2bfloat162(__float2bfloat16_rn(a), __float2bfloat16_rn(b));
  asm volatile("st.shared.b32 [%0], %1;\n" :: "r"(addr), "r"(*reinterpret_cast<const uint32_t*>(&v))
               : "memory");
}

__device__ __forceinline__ void store2_shared(uint32_t addr, float a, float b, float*) {
  asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" :: "r"(addr), "f"(a), "f"(b) : "memory");
}

// The kernel's body, inlined into the pooled and the unpooled kernels below.
// S: the unpooled kernels' stream count (1 or 2), known at compile time, so
// that the halo's width and the tap offsets of the descriptors are
// constants; 0 (pooled): read from Params.
template <typename T, bool POOL, int S>
__device__ __forceinline__ void conv3x3_f_body(
    const CUtensorMap* xmap,                    // x [B, H, W, C] as (C, W, H, B)
    const unsigned char* __restrict__ wp,       // pack_conv3x3_f_weights
    const float* __restrict__ bias,             // [Cout]
    T* __restrict__ out,                        // pooled: [B, H/2, W/2, Cout]
    const Params p,
    const CUtensorMap* ymap) {                  // unpooled: out [B, H, W, Cout] as (Cout, W, H, B)
  using L = Layout<T>;
  constexpr int CK = Traits<T>::CK;
  constexpr bool F32 = Traits<T>::PARTS == 2;
  constexpr int ACC = BN / 2;                   // f32 sums a thread and M tile (m64nBN)
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = sm90::smem_addr(smem_raw);
  // unpooled: the staging pieces are swizzled, 1,024-byte aligned
  const uint32_t base = POOL ? (raw + 127) & ~127u : (raw + 1023) & ~1023u;
  unsigned char* const gbase = smem_raw + (base - raw);
  const uint32_t full0 = base, empty0 = base + 16 * MAX_STAGES;
  const uint32_t wbar = base + 32 * MAX_STAGES, order0 = wbar + 8;
  const uint32_t s_regions = base + (POOL ? BARRIER_BYTES : 1024);
  const int streams = S ? S : p.streams;
  const int halo_w = S ? TW / S + 2 : p.halo_w;
  const int half_bytes = S ? round128(HALO_H * (TW / S + 2) * 16) : p.half_bytes;
  const uint32_t s_w = s_regions + streams * p.region;
  const uint32_t s_ring = s_w + (p.resident ? p.nch * L::W_CHUNK : 0);
  const int halo_bytes = 2 * half_bytes;
  const int tw = TW / streams, pw = PW / streams;   // a stream's tile
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int slices = (p.Cout + BN - 1) / BN;
  const int slice = blockIdx.x % slices, first = blockIdx.x / slices;
  const int step = gridDim.x / slices;
  if (t == 0) {
    for (int s = 0; s < 2 * MAX_STAGES; ++s) {
      sm90::mbar_init(full0 + 8 * s, 1);
      sm90::mbar_init(empty0 + 8 * s, CONSUMERS / 32 / streams);
    }
    sm90::mbar_init(wbar, 1);
    sm90::mbar_init(order0, 4);                 // the 4 warps of a warpgroup
    sm90::mbar_init(order0 + 8, 4);
    sm90::mbar_init_fence();
  }
  __syncthreads();

  if (warp >= CONSUMERS / 32) {
    // the producer warpgroup: one thread issues every copy, for the block's
    // tiles in order, tile i into the ring of stream i % streams
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(PRODUCER_REGS));
    if (warp == CONSUMERS / 32 && lane == 0) {
      const unsigned char* wsl = wp + static_cast<size_t>(slice) * p.nch * L::W_CHUNK;
      if (p.resident && first < p.units) {
        sm90::mbar_expect_tx(wbar, p.nch * L::W_CHUNK);
        for (int ch = 0; ch < p.nch; ++ch)
          sm90::bulk_load(s_w + ch * L::W_CHUNK, wsl + static_cast<size_t>(ch) * L::W_CHUNK,
                          L::W_CHUNK, wbar);
      }
      int k0 = 0, k1 = 0;                      // the streams' chunk counts
      int i = 0;
      for (int u = first; u < p.units; u += step, ++i) {
        const int sn = streams == 2 ? (i & 1) : 0;
        const int b = u / p.tiles_img, r = u % p.tiles_img;
        const int iy = (r / p.tiles_w) * TH - 1, ix = (r % p.tiles_w) * tw - 1;
        for (int ch = 0; ch < p.nch; ++ch) {
          const int k = sn ? k1++ : k0++, s = k % p.stages;
          const uint32_t fb = full0 + 8 * (sn * MAX_STAGES + s);
          sm90::mbar_wait(empty0 + 8 * (sn * MAX_STAGES + s), ((k / p.stages) & 1) ^ 1);
          const uint32_t st = s_ring + (sn * p.stages + s) * p.stage_bytes;
          sm90::mbar_expect_tx(fb, 2 * HALO_H * halo_w * 16 + (p.resident ? 0 : L::W_CHUNK));
          sm90::tma_load_4d(st, xmap, ch * CK, ix, iy, b, fb);
          sm90::tma_load_4d(st + half_bytes, xmap, ch * CK + CK / 2, ix, iy, b, fb);
          if (!p.resident)
            sm90::bulk_load(st + halo_bytes, wsl + static_cast<size_t>(ch) * L::W_CHUNK,
                            L::W_CHUNK, fb);
        }
      }
    }
    return;
  }

  // the consumers: warpgroup wg, warp w within it, lane (g, q); stream sn,
  // whose tiles are the block's tiles sn, sn + streams, ...
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(CONSUMER_REGS));
  const int wg = warp >> 2, w = warp & 3, g = lane >> 2, q = lane & 3;
  const int sn = streams == 2 ? wg : 0;
  const int col0 = streams == 2 ? 0 : 16 * wg;        // the warpgroup's first column
  const int nts = CONSUMERS / streams, ts = t - sn * nts;   // the stream's threads
  const int bar_id = 1 + sn;
  const int n0 = slice * BN;
  // the stage holds only the raw halo (f32 with resident weights): the split
  // consumes it; otherwise the wgmmas read it, and it is released after them
  const bool split_releases = F32 && p.resident;
  const uint32_t s_region = s_regions + sn * p.region;
  unsigned char* const staging = gbase + (s_region - base);
  const int nb = first < p.units ? (p.units - first + step - 1) / step : 0;   // the block's tiles
  if (p.resident && nb > 0) sm90::mbar_wait(wbar, 0);
  float acc[2][ACC];                           // M tiles: columns col0 + 8 mt ..
  int k = 0;
  int ep = 0;                                  // unpooled: pieces the stream has stored
#pragma unroll 1
  for (int i = sn; i < nb; i += streams) {
    const int u = first + i * step;
#pragma unroll
    for (int j = 0; j < ACC; ++j) acc[0][j] = acc[1][j] = 0.f;
    sm90::pin<ACC>(acc[0]);
    sm90::pin<ACC>(acc[1]);
    // ping-pong: tile i's mainloop starts when tile i - 1's (the other
    // warpgroup's) has issued its last wgmmas
    if (streams == 2 && i > 0) sm90::mbar_wait(order0 + 8 * ((i - 1) & 1), ((i - 1) >> 1) & 1);
#pragma unroll 1
    for (int ch = 0; ch < p.nch; ++ch, ++k) {
      const int s = k % p.stages;
      const int slot = sn * MAX_STAGES + s;
      sm90::mbar_wait(full0 + 8 * slot, (k / p.stages) & 1);
      const uint32_t st = s_ring + (sn * p.stages + s) * p.stage_bytes;
      const uint32_t ws = p.resident ? s_w + ch * L::W_CHUNK : st + halo_bytes;
      uint32_t xs = st;                        // the A halo (f32: its hi part; lo follows)
      if (F32) {
        // the stream's wgmmas of chunk k - 2 are done (each warpgroup waited
        // for all but its last group after chunk k - 1): split buffer k & 1 is free
        sm90::named_barrier(bar_id, nts);
        xs = s_region + (k & 1) * 2 * halo_bytes;
        const float4* src = reinterpret_cast<const float4*>(gbase + (st - base));
        float4* hi = reinterpret_cast<float4*>(gbase + (xs - base));
        float4* lo = hi + halo_bytes / 16;
        for (int j = ts; j < halo_bytes / 16; j += nts) {
          float4 l;
          hi[j] = sm90::split4(src[j], l);
          lo[j] = l;
        }
        sm90::fence_async_shared();
        if (split_releases) {
          __syncwarp();
          if (lane == 0) sm90::mbar_arrive(empty0 + 8 * slot);
        }
        sm90::named_barrier(bar_id, nts);
      }
      const uint64_t da = sm90::desc(xs + col0 * 16, half_bytes, halo_w * 16);
      const uint64_t db = sm90::desc(ws, 128, 256);
      sm90::wgmma_fence();
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {      // descriptors count 16-byte units
        const uint64_t bw = db + tap * (L::TAP_BYTES >> 4);
        const int toff = (tap / 3) * halo_w + tap % 3;
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const uint64_t a = da + (toff + 8 * mt);
          if constexpr (F32) {
            sm90::wgmma_tf32_n128(acc[mt], a + (halo_bytes >> 4), bw, 1);         // lo_x hi_w
            sm90::wgmma_tf32_n128(acc[mt], a, bw + 9 * (L::TAP_BYTES >> 4), 1);   // hi_x lo_w
            sm90::wgmma_tf32_n128(acc[mt], a, bw, 1);                             // hi_x hi_w
          } else {
            sm90::wgmma_bf16_n128(acc[mt], a, bw, 1);
          }
        }
      }
      sm90::wgmma_commit();
      if (streams == 2 && ch == p.nch - 1 && i + 1 < nb) {
        __syncwarp();                          // the next tile's mainloop may start
        if (lane == 0) sm90::mbar_arrive(order0 + 8 * (i & 1));
      }
      sm90::wgmma_wait<1>();
      sm90::pin<ACC>(acc[0]);
      sm90::pin<ACC>(acc[1]);
      if (!split_releases && ch > 0) {         // chunk k - 1's wgmmas are done
        __syncwarp();
        if (lane == 0) sm90::mbar_arrive(empty0 + 8 * (sn * MAX_STAGES + (k - 1) % p.stages));
      }
    }
    sm90::wgmma_wait<0>();
    sm90::pin<ACC>(acc[0]);
    sm90::pin<ACC>(acc[1]);
    if (!split_releases) {
      __syncwarp();
      if (lane == 0) sm90::mbar_arrive(empty0 + 8 * (sn * MAX_STAGES + (k - 1) % p.stages));
    }

    if constexpr (!POOL) {
      // acc[mt][4j + 2hf + e]: conv pixel (row 2w + hf, column col0 + 8 mt +
      // g) of the tile, channel n0 + 8j + 2q + e. Each warp stores its own
      // 2 rows x 16 columns: per piece of UCH channels, its lane 0 waits
      // until the warp's store of two pieces ago has read that piece, the
      // warp writes its fragments there (row 16 hf + 8 mt + g of 64 bytes,
      // under the 64-byte swizzle), and lane 0 stores the piece's box by
      // TMA. In f32 the staging shares the split halos' region: a barrier
      // first, so that every wgmma of the tile has read them.
      if constexpr (F32) sm90::named_barrier(bar_id, nts);
      const int b = u / p.tiles_img, r = u % p.tiles_img;
      const int y0 = (r / p.tiles_w) * TH + 2 * w, x0 = (r % p.tiles_w) * tw + col0;
      const bool inside = y0 < p.Ho && x0 < p.Wo;   // warp-uniform: else all clipped
      constexpr int JC = L::UCH / 8;             // j steps a piece
      // under the 64-byte swizzle, byte cb of row r of a piece (512-byte
      // aligned) lies at 64 r + 16 ((cb / 16) ^ ((r >> 1) & 3)) + cb % 16. For
      // the lane's byte cb = (8 jj + 2 q) sizeof(T) of row 16 hf + 8 mt + g
      // that is (16 hf + 8 mt) 64 + ((64 g + cb % 16 + 16 key) ^ (16 (cb /
      // 16))), key = (g >> 1) & 3: one 32-bit shared address a piece, which
      // changes with ep, so that no address of the epilogue is computed
      // ahead and held across the mainloop
      const uint32_t lane_bytes = g * 64 + ((2 * q * sizeof(T)) & 15) + (((g >> 1) & 3) << 4);
      const uint32_t block = s_region + (warp - 4 * sn) * 2 * UPIECE;   // the warp's two pieces
#pragma unroll
      for (int ck = 0; ck < BN / L::UCH; ++ck, ++ep) {
        if (n0 + ck * L::UCH >= p.Cout) break;   // block-uniform
        const uint32_t piece = block + (ep & 1) * UPIECE;
        const uint32_t at = piece + lane_bytes;
        if (lane == 0) sm90::bulk_wait_read<1>();
        __syncwarp();
#pragma unroll
        for (int jj = 0; jj < JC; ++jj) {
          const int j = ck * JC + jj;
          if (n0 + 8 * j >= p.Cout) break;     // warp-uniform: Cout % 8 == 0
          const float b0 = __ldg(bias + n0 + 8 * j + 2 * q), b1 = __ldg(bias + n0 + 8 * j + 2 * q + 1);
          const uint32_t unit = ((8 * jj + 2 * q) * sizeof(T)) >> 4;   // the 16-byte unit of cb
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
              const float v0 = __fadd_rn(acc[mt][4 * j + 2 * hf], b0);
              const float v1 = __fadd_rn(acc[mt][4 * j + 2 * hf + 1], b1);
              store2_shared((at ^ (unit << 4)) + (16 * hf + 8 * mt) * 64,
                            v0 > 0.f ? v0 : 0.f, v1 > 0.f ? v1 : 0.f, static_cast<T*>(nullptr));
            }
        }
        sm90::fence_async_shared();
        __syncwarp();
        if (lane == 0) {
          if (inside) sm90::tma_store_4d(ymap, piece, n0 + ck * L::UCH, x0, y0, b);
          sm90::bulk_commit();
        }
      }
      if (F32 && lane == 0) sm90::bulk_wait_read<0>();   // the next split overwrites the staging
      continue;
    }

    // Epilogue. acc[mt][4j + 2hf + e]: M row 16w + g + 8hf = tile pixel
    // (2w + hf, col0 + 8 mt + g), channel n0 + 8j + 2q + e. The staging
    // is free: the stream's last stores have read it, and (f32) every
    // split of this tile is done (wait<0> above).
    sm90::named_barrier(bar_id, nts);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      if (n0 + 8 * j >= p.Cout) break;         // warp-uniform: Cout % 8 == 0
      const int c = 8 * j + 2 * q;
      const float b0 = __ldg(bias + n0 + c), b1 = __ldg(bias + n0 + c + 1);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        float y[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float m = fmaxf(acc[mt][4 * j + e], acc[mt][4 * j + 2 + e]);
          m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 4));
          const float v = __fadd_rn(m, e ? b1 : b0);
          y[e] = v > 0.f ? v : 0.f;
        }
        // pooled pixel (w, col0 / 2 + 4 mt + g / 2); both lanes of a pair
        // stage the same values
        store2(staging + (w * pw + col0 / 2 + 4 * mt + (g >> 1)) * L::RS + c * sizeof(T), y[0],
               y[1], static_cast<T*>(nullptr));
      }
    }
    sm90::named_barrier(bar_id, nts);
    const int b = u / p.tiles_img, r = u % p.tiles_img;
    const int po0 = (r / p.tiles_w) * PH, pw0 = (r % p.tiles_w) * pw;
    constexpr int CHUNKS = BN * static_cast<int>(sizeof(T)) / 16;   // 16-byte pieces a pixel
    constexpr int PER16 = 16 / static_cast<int>(sizeof(T));         // channels a piece
    for (int j = ts; j < PH * pw * CHUNKS; j += nts) {
      const int pix = j / CHUNKS, kk = j % CHUNKS;
      const int po = po0 + pix / pw, pc = pw0 + pix % pw, o = n0 + kk * PER16;
      if (po >= p.Ho || pc >= p.Wo || o >= p.Cout) continue;
      *reinterpret_cast<int4*>(out + ((static_cast<size_t>(b) * p.Ho + po) * p.Wo + pc) * p.Cout + o) =
          *reinterpret_cast<const int4*>(staging + pix * L::RS + kk * 16);
    }
  }
  if constexpr (!POOL) {
    if (lane == 0) sm90::bulk_wait_all();       // the staging outlives the stores
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 1) conv3x3_f_kernel(
    const __grid_constant__ CUtensorMap xmap, const unsigned char* __restrict__ wp,
    const float* __restrict__ bias, T* __restrict__ out, const Params p) {
  conv3x3_f_body<T, true, 0>(&xmap, wp, bias, out, p, nullptr);
}

template <typename T, int S>
__global__ void __launch_bounds__(THREADS, 1) conv3x3_f_kernel_unpooled(
    const __grid_constant__ CUtensorMap xmap, const unsigned char* __restrict__ wp,
    const float* __restrict__ bias, const Params p, const __grid_constant__ CUtensorMap ymap) {
  conv3x3_f_body<T, false, S>(&xmap, wp, bias, nullptr, p, &ymap);
}

// The shared memory of a schedule: 2 streams with resident weights where
// they fit, else 1 stream, resident or streaming the weights. Returns the
// bytes, 0 if the schedule does not fit in `optin`. Unpooled, each warp of
// a stream stages two swizzled 2 KB pieces (UPIECE), 1,024-byte aligned.
template <typename T>
int plan(Params& p, int streams, int resident, int optin, bool pool) {
  using L = Layout<T>;
  p.streams = streams;
  p.resident = resident;
  const int tw = TW / streams;
  p.halo_w = tw + 2;
  p.half_bytes = round128(HALO_H * p.halo_w * 16);
  const int halo_bytes = 2 * p.half_bytes;
  const int staging = pool ? PH * (PW / streams) * L::RS : (8 / streams) * 2 * UPIECE;
  const int split = Traits<T>::PARTS == 2 ? 2 * 2 * halo_bytes : 0;
  const int region = staging > split ? staging : split;
  p.region = pool ? round128(region) : (region + 1023) / 1024 * 1024;
  p.stage_bytes = halo_bytes + (resident ? 0 : L::W_CHUNK);
  const int head = pool ? 128 + BARRIER_BYTES : 1024 + 1024;   // alignment + barriers
  const int fixed = head + streams * p.region + (resident ? p.nch * L::W_CHUNK : 0);
  const int per = (optin - fixed) / (streams * p.stage_bytes);
  if (optin <= fixed || per < 2) return 0;
  p.stages = per < MAX_STAGES ? per : MAX_STAGES;
  return fixed + streams * p.stages * p.stage_bytes;
}

template <typename T, bool POOL>
int launch(const void* x, const void* w, const void* bias, void* out, int B, int H, int W,
           int C, int Cout, cudaStream_t st) {
  constexpr int CK = Traits<T>::CK;
  const int Ho = POOL ? H / 2 : H, Wo = POOL ? W / 2 : W;
  if (B == 0 || Ho == 0 || Wo == 0 || Cout == 0) return static_cast<int>(cudaSuccess);
  int sms = 0, optin = 0;
  cudaError_t e = sm90::device_limits(&sms, &optin);
  if (e != cudaSuccess) return static_cast<int>(e);

  Params p;
  p.H = H, p.W = W, p.C = C, p.Cout = Cout, p.Ho = Ho, p.Wo = Wo;
  p.nch = (C + CK - 1) / CK;
  int smem = plan<T>(p, 2, 1, optin, POOL);
  if (smem == 0) smem = plan<T>(p, 1, 1, optin, POOL);
  if (smem == 0) smem = plan<T>(p, 1, 0, optin, POOL);
  if (smem == 0) return static_cast<int>(cudaErrorInvalidValue);
  // a tile's outputs: PH x PW / streams pooled, TH x TW / streams unpooled
  const int oh = POOL ? PH : TH, ow = (POOL ? PW : TW) / p.streams;
  p.tiles_w = (Wo + ow - 1) / ow;
  p.tiles_img = ((Ho + oh - 1) / oh) * p.tiles_w;
  p.units = B * p.tiles_img;
  e = POOL ? sm90::allow_smem<conv3x3_f_kernel<T>>(smem)
      : p.streams == 2 ? sm90::allow_smem<conv3x3_f_kernel_unpooled<T, 2>>(smem)
                       : sm90::allow_smem<conv3x3_f_kernel_unpooled<T, 1>>(smem);
  if (e != cudaSuccess) return static_cast<int>(e);

  CUtensorMap xmap;
  const cuuint64_t es = sizeof(T);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(C), static_cast<cuuint64_t>(W),
                              static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {C * es, static_cast<cuuint64_t>(W) * C * es,
                                 static_cast<cuuint64_t>(H) * W * C * es};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(CK / 2), static_cast<cuuint32_t>(p.halo_w),
                             HALO_H, 1};
  e = sm90::encode_tensor_map(&xmap, sizeof(T) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                                    : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                              4, x, dims, strides, box);
  if (e != cudaSuccess) return static_cast<int>(e);
  // unpooled: the output as (C_out, W, H, B), boxes of a warp's staging piece
  CUtensorMap ymap = {};
  if (!POOL) {
    const cuuint64_t ydims[4] = {static_cast<cuuint64_t>(Cout), static_cast<cuuint64_t>(Wo),
                                 static_cast<cuuint64_t>(Ho), static_cast<cuuint64_t>(B)};
    const cuuint64_t ystrides[3] = {Cout * es, static_cast<cuuint64_t>(Wo) * Cout * es,
                                    static_cast<cuuint64_t>(Ho) * Wo * Cout * es};
    const cuuint32_t ybox[4] = {static_cast<cuuint32_t>(Layout<T>::UCH), 16, 2, 1};
    e = sm90::encode_tensor_map(&ymap, sizeof(T) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                                      : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                                4, out, ydims, ystrides, ybox, CU_TENSOR_MAP_SWIZZLE_64B);
    if (e != cudaSuccess) return static_cast<int>(e);
  }

  // persistent blocks, one an SM, a whole number of them per slice
  const int slices = (Cout + BN - 1) / BN;
  int per_slice = sms / slices;
  if (per_slice < 1) per_slice = 1;
  if (per_slice > p.units) per_slice = p.units;
  if (POOL)
    conv3x3_f_kernel<T><<<per_slice * slices, THREADS, smem, st>>>(
        xmap, static_cast<const unsigned char*>(w), static_cast<const float*>(bias),
        static_cast<T*>(out), p);
  else if (p.streams == 2)
    conv3x3_f_kernel_unpooled<T, 2><<<per_slice * slices, THREADS, smem, st>>>(
        xmap, static_cast<const unsigned char*>(w), static_cast<const float*>(bias), p, ymap);
  else
    conv3x3_f_kernel_unpooled<T, 1><<<per_slice * slices, THREADS, smem, st>>>(
        xmap, static_cast<const unsigned char*>(w), static_cast<const float*>(bias), p, ymap);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" const char* vqa_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// mode: 0 = f32 x and out; 1 = bf16. w: ops/conv_hpack.pack_conv3x3_f_weights
// (bf16, or f32 TF32 hi/lo), bias [Cout] f32. x and w 16-byte aligned, C and
// Cout multiples of 8, out 16-byte aligned. pool: 1 = 2x2 maxpool, 0 = every
// pixel stored.
// Returns cudaGetLastError() after the launch (0 = success).
extern "C" int conv3x3_f(const void* x, const void* w, const void* bias, void* out,
                         int B, int H, int W, int C, int Cout, int mode, int pool,
                         void* stream) {
  if (C % 8 != 0 || Cout % 8 != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(w) % 16 != 0 || reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (2 * mode + (pool ? 1 : 0)) {
    case 0: return launch<float, false>(x, w, bias, out, B, H, W, C, Cout, st);
    case 1: return launch<float, true>(x, w, bias, out, B, H, W, C, Cout, st);
    case 2: return launch<__nv_bfloat16, false>(x, w, bias, out, B, H, W, C, Cout, st);
    case 3: return launch<__nv_bfloat16, true>(x, w, bias, out, B, H, W, C, Cout, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

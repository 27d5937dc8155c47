// Native batched JPEG decode + resize for the input pipeline (the port's
// copy of vqa_tpu/native/jpeg_decoder.cpp; same code, same C ABI).
//
// One C++ thread pool decodes a whole batch with libjpeg's DCT-domain
// scaling (decode directly at 1/2, 1/4 or 1/8 scale, what PIL calls "draft
// mode") and bilinear-resizes into a caller-provided contiguous uint8
// [N, S, S, 3] buffer, ready for one host-to-device copy. No Python object
// is touched off the calling thread, so the caller releases the interpreter
// lock for the whole batch (ctypes does), not per image.
//
// C ABI (ctypes):
//   int vqa_decode_batch(const char** paths, int n, uint8_t* out,
//                        uint8_t* status, int host_size, int threads)
// returns the number of images decoded; per-image success goes to
// status[i] (1 ok / 0 failed); failed slots are zero-filled and the Python
// layer substitutes PIL or synthetic fallbacks.
//
// Built with g++ by vqa_tpu_torch/native/jpeg.py at first use.

#include <cstddef>
#include <cstdio>

#include <jpeglib.h>

#include <atomic>
#include <cstdint>
#include <cstring>
#include <csetjmp>
#include <cstdio>
#include <thread>
#include <vector>

namespace {

struct ErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void error_exit(j_common_ptr cinfo) {
  auto* err = reinterpret_cast<ErrorMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

// bilinear resize RGB uint8 (src HxW) -> dst SxS
void resize_bilinear(const uint8_t* src, int h, int w, uint8_t* dst, int s) {
  const float sy = static_cast<float>(h) / s;
  const float sx = static_cast<float>(w) / s;
  for (int y = 0; y < s; ++y) {
    float fy = (y + 0.5f) * sy - 0.5f;
    if (fy < 0) fy = 0;
    int y0 = static_cast<int>(fy);
    int y1 = y0 + 1 < h ? y0 + 1 : h - 1;
    float wy = fy - y0;
    for (int x = 0; x < s; ++x) {
      float fx = (x + 0.5f) * sx - 0.5f;
      if (fx < 0) fx = 0;
      int x0 = static_cast<int>(fx);
      int x1 = x0 + 1 < w ? x0 + 1 : w - 1;
      float wx = fx - x0;
      for (int c = 0; c < 3; ++c) {
        float v00 = src[(y0 * w + x0) * 3 + c];
        float v01 = src[(y0 * w + x1) * 3 + c];
        float v10 = src[(y1 * w + x0) * 3 + c];
        float v11 = src[(y1 * w + x1) * 3 + c];
        float top = v00 + (v01 - v00) * wx;
        float bot = v10 + (v11 - v10) * wx;
        dst[(y * s + x) * 3 + c] = static_cast<uint8_t>(top + (bot - top) * wy + 0.5f);
      }
    }
  }
}

// decode one JPEG at >= host_size using DCT scaling, then resize
bool decode_one(const char* path, uint8_t* out, int host_size) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;

  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  std::vector<uint8_t> pixels;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    std::fclose(f);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);

  // largest 1/1,1/2,1/4,1/8 scale that stays >= host_size (PIL draft mode)
  cinfo.scale_num = 1;
  cinfo.scale_denom = 1;
  for (int denom = 8; denom >= 1; denom >>= 1) {
    if (static_cast<int>(cinfo.image_width) / denom >= host_size &&
        static_cast<int>(cinfo.image_height) / denom >= host_size) {
      cinfo.scale_denom = denom;
      break;
    }
  }
  cinfo.out_color_space = JCS_RGB;
  cinfo.dct_method = JDCT_IFAST;
  jpeg_start_decompress(&cinfo);

  const int w = cinfo.output_width;
  const int h = cinfo.output_height;
  pixels.resize(static_cast<size_t>(w) * h * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = pixels.data() + static_cast<size_t>(cinfo.output_scanline) * w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  std::fclose(f);

  if (w == host_size && h == host_size) {
    std::memcpy(out, pixels.data(), static_cast<size_t>(host_size) * host_size * 3);
  } else {
    resize_bilinear(pixels.data(), h, w, out, host_size);
  }
  return true;
}

}  // namespace

extern "C" {

int vqa_decode_batch(const char** paths, int n, uint8_t* out, uint8_t* status,
                     int host_size, int threads) {
  if (threads < 1) threads = 1;
  std::atomic<int> next{0};
  std::atomic<int> ok{0};
  const size_t stride = static_cast<size_t>(host_size) * host_size * 3;

  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) return;
      uint8_t* dst = out + stride * i;
      if (decode_one(paths[i], dst, host_size)) {
        status[i] = 1;
        ok.fetch_add(1);
      } else {
        status[i] = 0;
        std::memset(dst, 0, stride);
      }
    }
  };

  std::vector<std::thread> pool;
  const int nthreads = threads < n ? threads : n;
  pool.reserve(nthreads);
  for (int t = 0; t < nthreads; ++t) pool.emplace_back(worker);
  for (auto& t : pool) t.join();
  return ok.load();
}

}  // extern "C"

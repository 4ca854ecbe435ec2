// yat_loader: native threaded JPEG loading of the PyTorch port: JPEG
// decode + letterbox on a std::thread pool, with no Python and no GIL in the
// loop (the reference's DataLoader workers run cv2 in processes, reference
// data/build.py:127). Built with libjpeg, it is the JAX package's
// csrc/yat_loader.cpp with one entry added: yat_loader_next_indexed names
// each delivered frame. Built with -DYAT_NVJPEG (for a machine without
// libjpeg), each worker thread decodes with nvJPEG on the GPU (hybrid
// backend: Huffman on the host, IDCT on the device) into Y, Cb and Cr
// planes, copied back to the host, where libjpeg's own back end (its
// triangle-filter chroma upsampling and fixed-point YCbCr -> RGB) makes the
// BGR image; the letterbox, the C interface and the outputs' layout are the
// same. nvJPEG's interleaved output replicates chroma instead, 9-13 grey
// levels on average from cv2's on seeded-noise JPEGs.
//
// Letterbox matches data/augment.py letterbox in geometry
// (r = min(s/h, s/w), round(w*r), pad split round(d-0.1)/round(d+0.1),
// value 114) with the cv2-convention bilinear resample (half-pixel centres);
// pixel values may differ from cv2's by a few grey levels (cv2 uses
// fixed-point taps and another IDCT): tests/test_torch_native.py holds it.
//
// Build (ops/native.py does it at first use, into csrc/build/):
//   g++ -O3 -shared -fPIC yat_loader.cpp -o libyat_loader.so -ljpeg
//   nvcc -O3 -shared -Xcompiler -fPIC -x cu -DYAT_NVJPEG yat_loader.cpp
//        -o libyat_loader_nvjpeg.so -lnvjpeg

#include <algorithm>
#include <atomic>
#include <cmath>
#include <condition_variable>
#include <csetjmp>
#include <cstddef>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#ifdef YAT_NVJPEG
#include <cuda_runtime.h>
#include <nvjpeg.h>
#else
#include <jpeglib.h>  // needs <cstdio>/<cstddef> first (C header)
#endif

namespace {

struct Image {
  std::vector<uint8_t> data;  // HWC BGR
  int h = 0, w = 0;
  bool ok = false;
};

// libjpeg's (libjpeg-turbo's) decoder back end for planes decoded
// elsewhere: "fancy" chroma upsampling (jdsample.c h2v1 / h2v2 / h1v2:
// 3/4 of the nearer and 1/4 of the farther sample, edges replicated) and
// the fixed-point YCbCr -> RGB of jdcolor.c. Fed libjpeg's own planes
// (raw_data_out), it gives libjpeg's RGB byte for byte.
[[maybe_unused]] void upsample(const uint8_t* in, size_t pitch, int dw, int dh, int hf, int vf,
                               std::vector<uint8_t>& out) {
  const int ow = dw * hf;
  out.resize(size_t(ow) * dh * vf);
  std::vector<int> sum(dw);
  for (int r = 0; r < dh; ++r) {
    const uint8_t* row = in + size_t(r) * pitch;
    for (int v = 0; v < vf; ++v) {
      uint8_t* o = out.data() + size_t(r * vf + v) * ow;
      const uint8_t* near =
          in + size_t(v == 0 ? std::max(r - 1, 0) : std::min(r + 1, dh - 1)) * pitch;
      if (hf == 2 && dw > 2) {
        if (vf == 2) {  // h2v2_fancy_upsample
          for (int c = 0; c < dw; ++c) sum[c] = row[c] * 3 + near[c];
          o[0] = uint8_t((sum[0] * 4 + 8) >> 4);
          o[1] = uint8_t((sum[0] * 3 + sum[1] + 7) >> 4);
          for (int c = 1; c < dw - 1; ++c) {
            o[2 * c] = uint8_t((sum[c] * 3 + sum[c - 1] + 8) >> 4);
            o[2 * c + 1] = uint8_t((sum[c] * 3 + sum[c + 1] + 7) >> 4);
          }
          o[2 * dw - 2] = uint8_t((sum[dw - 1] * 3 + sum[dw - 2] + 8) >> 4);
          o[2 * dw - 1] = uint8_t((sum[dw - 1] * 4 + 7) >> 4);
        } else {  // h2v1_fancy_upsample
          o[0] = row[0];
          o[1] = uint8_t((row[0] * 3 + row[1] + 2) >> 2);
          for (int c = 1; c < dw - 1; ++c) {
            o[2 * c] = uint8_t((row[c] * 3 + row[c - 1] + 1) >> 2);
            o[2 * c + 1] = uint8_t((row[c] * 3 + row[c + 1] + 2) >> 2);
          }
          o[2 * dw - 2] = uint8_t((row[dw - 1] * 3 + row[dw - 2] + 1) >> 2);
          o[2 * dw - 1] = row[dw - 1];
        }
      } else if (hf == 2) {  // h2v1_upsample / h2v2_upsample: replicate
        for (int c = 0; c < dw; ++c) o[2 * c] = o[2 * c + 1] = row[c];
      } else if (vf == 2) {  // h1v2_fancy_upsample
        const int bias = v == 0 ? 1 : 2;
        for (int c = 0; c < dw; ++c) o[c] = uint8_t((row[c] * 3 + near[c] + bias) >> 2);
      } else {
        std::memcpy(o, row, size_t(dw));
      }
    }
  }
}

// (w, h) Y over full-size Cb, Cr planes (row length cw) -> BGR, jdcolor.c's
// ycc_rgb_convert with its tables.
[[maybe_unused]] void ycc_to_bgr(const uint8_t* y, size_t ypitch, const uint8_t* cb,
                                 const uint8_t* cr, int cw, int w, int h, uint8_t* bgr) {
  auto fix = [](double x) { return int32_t(x * 65536.0 + 0.5); };
  static const struct Tables {
    int cr_r[256], cb_b[256];
    int32_t cr_g[256], cb_g[256];
  } t = [&] {
    Tables k{};
    for (int i = 0; i < 256; ++i) {
      const int32_t x = i - 128;
      k.cr_r[i] = int((fix(1.40200) * x + 32768) >> 16);
      k.cb_b[i] = int((fix(1.77200) * x + 32768) >> 16);
      k.cr_g[i] = -fix(0.71414) * x;
      k.cb_g[i] = -fix(0.34414) * x + 32768;
    }
    return k;
  }();
  auto clamp = [](int v) { return uint8_t(std::min(255, std::max(0, v))); };
  for (int r = 0; r < h; ++r) {
    for (int c = 0; c < w; ++c) {
      const int yy = y[size_t(r) * ypitch + c];
      const int u = cb[size_t(r) * cw + c], v = cr[size_t(r) * cw + c];
      uint8_t* o = bgr + (size_t(r) * w + c) * 3;
      o[2] = clamp(yy + t.cr_r[v]);
      o[1] = clamp(yy + int((t.cb_g[u] + t.cr_g[v]) >> 16));
      o[0] = clamp(yy + t.cb_b[u]);
    }
  }
}

#ifdef YAT_NVJPEG
// One decoder per thread: an nvJPEG state is not thread-safe, so each
// thread owns its handle, state, stream and device buffer.
struct NvDecoder {
  nvjpegHandle_t handle = nullptr;
  nvjpegJpegState_t state = nullptr;
  cudaStream_t stream = nullptr;
  unsigned char* dev = nullptr;
  size_t cap = 0;
  bool ok = false;

  NvDecoder() {
    ok = nvjpegCreateSimple(&handle) == NVJPEG_STATUS_SUCCESS &&
         nvjpegJpegStateCreate(handle, &state) == NVJPEG_STATUS_SUCCESS &&
         cudaStreamCreateWithFlags(&stream, cudaStreamNonBlocking) == cudaSuccess;
  }
  ~NvDecoder() {
    if (dev) cudaFree(dev);
    if (stream) cudaStreamDestroy(stream);
    if (state) nvjpegJpegStateDestroy(state);
    if (handle) nvjpegDestroy(handle);
  }

  bool reserve(size_t need) {
    if (need <= cap) return true;
    if (dev) cudaFree(dev);
    dev = nullptr;
    cap = 0;
    if (cudaMalloc(&dev, need) != cudaSuccess) return false;
    cap = need;
    return true;
  }
};

bool decode_jpeg(const char* path, Image& img) {
  thread_local NvDecoder nv;
  if (!nv.ok) return false;
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  std::vector<unsigned char> bytes;
  unsigned char buf[1 << 16];
  for (size_t n; (n = std::fread(buf, 1, sizeof(buf), f)) > 0;) bytes.insert(bytes.end(), buf, buf + n);
  std::fclose(f);
  int nc = 0, ws[NVJPEG_MAX_COMPONENT], hs[NVJPEG_MAX_COMPONENT];
  nvjpegChromaSubsampling_t ss;
  if (bytes.empty() ||
      nvjpegGetImageInfo(nv.handle, bytes.data(), bytes.size(), &nc, &ss, ws, hs) !=
          NVJPEG_STATUS_SUCCESS)
    return false;
  const int w = ws[0], h = hs[0];
  // chroma factors of the subsamplings libjpeg upsamples with its filters
  int hf = 0, vf = 0;
  if (nc == 3 && ss == NVJPEG_CSS_444) hf = 1, vf = 1;
  if (nc == 3 && ss == NVJPEG_CSS_422) hf = 2, vf = 1;
  if (nc == 3 && ss == NVJPEG_CSS_420) hf = 2, vf = 2;
  if (nc == 3 && ss == NVJPEG_CSS_440) hf = 1, vf = 2;
  const bool planar = hf && ws[1] * hf >= w && hs[1] * vf >= h;
  nvjpegImage_t out{};
  size_t need = size_t(w) * h * 3;
  nvjpegOutputFormat_t fmt = NVJPEG_OUTPUT_BGRI;
  if (nc == 1) {
    need = size_t(w) * h;
    fmt = NVJPEG_OUTPUT_Y;
    out.channel[0] = nullptr;
    out.pitch[0] = size_t(w);
  } else if (planar) {
    need = size_t(w) * h + 2 * size_t(ws[1]) * hs[1];
    fmt = NVJPEG_OUTPUT_YUV;
  } else {
    out.pitch[0] = size_t(w) * 3;
  }
  if (!nv.reserve(need)) return false;
  out.channel[0] = nv.dev;
  if (planar) {
    out.pitch[0] = size_t(w);
    for (int k = 1; k < 3; ++k) {
      out.channel[k] = nv.dev + size_t(w) * h + size_t(k - 1) * ws[1] * hs[1];
      out.pitch[k] = size_t(ws[1]);
    }
  }
  std::vector<uint8_t> host(need);
  if (nvjpegDecode(nv.handle, nv.state, bytes.data(), bytes.size(), fmt, &out, nv.stream) !=
          NVJPEG_STATUS_SUCCESS ||
      cudaMemcpyAsync(host.data(), nv.dev, need, cudaMemcpyDeviceToHost, nv.stream) !=
          cudaSuccess ||
      cudaStreamSynchronize(nv.stream) != cudaSuccess)
    return false;
  img.data.resize(size_t(w) * h * 3);
  if (nc == 1) {  // gray: libjpeg's gray_rgb_convert replicates
    for (size_t i = 0; i < size_t(w) * h; ++i)
      img.data[3 * i] = img.data[3 * i + 1] = img.data[3 * i + 2] = host[i];
  } else if (planar) {
    std::vector<uint8_t> cb, cr;
    const uint8_t* planes = host.data() + size_t(w) * h;
    upsample(planes, size_t(ws[1]), ws[1], hs[1], hf, vf, cb);
    upsample(planes + size_t(ws[1]) * hs[1], size_t(ws[1]), ws[1], hs[1], hf, vf, cr);
    ycc_to_bgr(host.data(), size_t(w), cb.data(), cr.data(), ws[1] * hf, w, h,
               img.data.data());
  } else {
    img.data = std::move(host);
  }
  img.h = h;
  img.w = w;
  img.ok = true;
  return true;
}
#else
bool decode_jpeg(const char* path, Image& img) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  jpeg_decompress_struct cinfo;
  jpeg_error_mgr jerr;
  cinfo.err = jpeg_std_error(&jerr);
  jerr.error_exit = [](j_common_ptr c) { longjmp(*(jmp_buf*)c->client_data, 1); };
  jmp_buf env;
  cinfo.client_data = &env;
  if (setjmp(env)) {
    jpeg_destroy_decompress(&cinfo);
    std::fclose(f);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  img.h = cinfo.output_height;
  img.w = cinfo.output_width;
  img.data.resize(size_t(img.h) * img.w * 3);
  std::vector<uint8_t> row(size_t(img.w) * 3);
  uint8_t* rp = row.data();
  for (int y = 0; y < img.h; ++y) {
    jpeg_read_scanlines(&cinfo, &rp, 1);
    uint8_t* dst = img.data.data() + size_t(y) * img.w * 3;
    for (int x = 0; x < img.w; ++x) {  // RGB -> BGR (cv2 convention)
      dst[3 * x + 0] = row[3 * x + 2];
      dst[3 * x + 1] = row[3 * x + 1];
      dst[3 * x + 2] = row[3 * x + 0];
    }
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  std::fclose(f);
  img.ok = true;
  return true;
}
#endif

// bilinear resize, cv2 half-pixel convention: src = (dst + 0.5) * scale - 0.5
void resize_bilinear(const uint8_t* src, int sh, int sw, uint8_t* dst, int dh,
                     int dw) {
  const float sy = float(sh) / dh, sx = float(sw) / dw;
  for (int y = 0; y < dh; ++y) {
    float fy = (y + 0.5f) * sy - 0.5f;
    int y0 = (int)std::floor(fy);
    float ly = fy - y0;
    int y0c = std::clamp(y0, 0, sh - 1), y1c = std::clamp(y0 + 1, 0, sh - 1);
    const uint8_t* r0 = src + size_t(y0c) * sw * 3;
    const uint8_t* r1 = src + size_t(y1c) * sw * 3;
    uint8_t* out = dst + size_t(y) * dw * 3;
    for (int x = 0; x < dw; ++x) {
      float fx = (x + 0.5f) * sx - 0.5f;
      int x0 = (int)std::floor(fx);
      float lx = fx - x0;
      int x0c = std::clamp(x0, 0, sw - 1), x1c = std::clamp(x0 + 1, 0, sw - 1);
      for (int ch = 0; ch < 3; ++ch) {
        float v = (1 - ly) * ((1 - lx) * r0[3 * x0c + ch] + lx * r0[3 * x1c + ch]) +
                  ly * ((1 - lx) * r1[3 * x0c + ch] + lx * r1[3 * x1c + ch]);
        out[3 * x + ch] = (uint8_t)std::lround(std::clamp(v, 0.0f, 255.0f));
      }
    }
  }
}

// letterbox into a square imgsz canvas (geometry = data/augment.py letterbox,
// scaleup=true, center=true, pad 114)
void letterbox(const Image& img, uint8_t* out, int imgsz, float* meta) {
  const float r = std::min(float(imgsz) / img.h, float(imgsz) / img.w);
  const int nw = (int)std::lround(img.w * r), nh = (int)std::lround(img.h * r);
  const float dw = (imgsz - nw) / 2.0f, dh = (imgsz - nh) / 2.0f;
  const int top = (int)std::lround(dh - 0.1f), left = (int)std::lround(dw - 0.1f);
  std::memset(out, 114, size_t(imgsz) * imgsz * 3);
  std::vector<uint8_t> resized(size_t(nh) * nw * 3);
  resize_bilinear(img.data.data(), img.h, img.w, resized.data(), nh, nw);
  for (int y = 0; y < nh; ++y) {
    std::memcpy(out + (size_t(top + y) * imgsz + left) * 3,
                resized.data() + size_t(y) * nw * 3, size_t(nw) * 3);
  }
  meta[0] = (float)img.h;
  meta[1] = (float)img.w;
  meta[2] = r;
  meta[3] = dw;
  meta[4] = dh;
}

struct Loader {
  std::vector<std::string> paths;
  int imgsz, batch;
  std::atomic<int> next_idx{0};
  std::vector<std::vector<uint8_t>> slots;     // letterboxed frames
  std::vector<std::vector<float>> metas;       // (5,) per frame
  std::vector<std::atomic<int>> done;          // 0 pending, 1 ok, -1 failed
  std::vector<std::thread> workers;
  std::mutex mu;
  std::condition_variable cv;
  int cursor = 0;  // next frame to hand out

  Loader(const char** p, int n, int s, int b, int threads)
      : paths(p, p + n), imgsz(s), batch(b), slots(n), metas(n), done(n) {
    for (auto& d : done) d.store(0);
    int nt = std::max(1, threads);
    for (int t = 0; t < nt; ++t)
      workers.emplace_back([this] { work(); });
  }

  void work() {
    for (;;) {
      int i = next_idx.fetch_add(1);
      if (i >= (int)paths.size()) return;
      Image img;
      int ok = decode_jpeg(paths[i].c_str(), img) ? 1 : -1;
      if (ok == 1) {
        slots[i].resize(size_t(imgsz) * imgsz * 3);
        metas[i].resize(5);
        letterbox(img, slots[i].data(), imgsz, metas[i].data());
      }
      {
        // Publish under the mutex: next() evaluates its wait predicate under
        // mu, so a store+notify outside the lock can land between the
        // predicate check and the block — a lost wakeup that hangs next()
        // forever if this was the last pending item.
        std::lock_guard<std::mutex> g(mu);
        done[i].store(ok);
      }
      cv.notify_all();
    }
  }

  int next(uint8_t* imgs, float* meta, int* idx) {
    int count = 0;
    while (cursor < (int)paths.size() && count < batch) {
      int i = cursor;
      std::unique_lock<std::mutex> lk(mu);
      cv.wait(lk, [&] { return done[i].load() != 0; });
      lk.unlock();
      if (done[i].load() == 1) {
        std::memcpy(imgs + size_t(count) * imgsz * imgsz * 3, slots[i].data(),
                    size_t(imgsz) * imgsz * 3);
        std::memcpy(meta + size_t(count) * 5, metas[i].data(), 5 * sizeof(float));
        if (idx) idx[count] = i;
        ++count;
      }
      slots[i].clear();
      slots[i].shrink_to_fit();
      ++cursor;
    }
    return count;
  }

  ~Loader() {
    for (auto& w : workers) w.join();
  }
};

}  // namespace

extern "C" {

// Decode + letterbox a single image. out (imgsz, imgsz, 3) uint8 BGR,
// meta (5,) float32 = (h0, w0, ratio, dw, dh). Returns 0 ok / -1 fail.
int yat_load_image(const char* path, int imgsz, uint8_t* out, float* meta) {
  Image img;
  if (!decode_jpeg(path, img)) return -1;
  letterbox(img, out, imgsz, meta);
  return 0;
}

void* yat_loader_create(const char** paths, int n, int imgsz, int batch,
                        int threads) {
  return new Loader(paths, n, imgsz, batch, threads);
}

// Fills imgs (batch, imgsz, imgsz, 3) and meta (batch, 5); returns the
// number of frames delivered (0 = exhausted). Unreadable files are skipped.
int yat_loader_next(void* handle, uint8_t* imgs, float* meta) {
  return ((Loader*)handle)->next(imgs, meta, nullptr);
}

// As yat_loader_next, and idx (batch,) int32 receives each delivered frame's
// index into the path list, so a caller can name the frames after a skip.
int yat_loader_next_indexed(void* handle, uint8_t* imgs, float* meta, int* idx) {
  return ((Loader*)handle)->next(imgs, meta, idx);
}

void yat_loader_destroy(void* handle) { delete (Loader*)handle; }

}  // extern "C"

// yat_ops: native host-side ops of the PyTorch port: greedy IoU NMS over
// detection buffers and letterbox (aspect-preserving resize + pad), with a
// plain C interface over contiguous float / uint8 buffers, loaded with ctypes
// by ops/native.py. The same code as the JAX package's csrc/yat_ops.cpp, so
// both give the same bytes under the same compiler.
//
// Build (ops/native.py does it at first use, into csrc/build/):
//   g++ -O3 -shared -fPIC yat_ops.cpp -o libyat_ops.so

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <vector>

extern "C" {

// Greedy NMS over class-offset boxes.
// boxes: (n,4) xyxy float32, scores: (n,) float32, cls: (n,) float32.
// keep_out: (n,) int32 output indices; returns number kept (<= max_det).
int yat_nms(const float* boxes, const float* scores, const float* cls, int n,
            float iou_thres, float conf_thres, int max_det, float max_wh,
            int agnostic, int* keep_out) {
  std::vector<int> order(n);
  std::iota(order.begin(), order.end(), 0);
  std::sort(order.begin(), order.end(),
            [&](int a, int b) { return scores[a] > scores[b]; });

  std::vector<float> bx(n * 4);
  for (int i = 0; i < n; ++i) {
    const float off = agnostic ? 0.0f : cls[i] * max_wh;
    bx[i * 4 + 0] = boxes[i * 4 + 0] + off;
    bx[i * 4 + 1] = boxes[i * 4 + 1] + off;
    bx[i * 4 + 2] = boxes[i * 4 + 2] + off;
    bx[i * 4 + 3] = boxes[i * 4 + 3] + off;
  }
  std::vector<char> suppressed(n, 0);
  int kept = 0;
  for (int oi = 0; oi < n && kept < max_det; ++oi) {
    const int i = order[oi];
    if (suppressed[i] || scores[i] <= conf_thres) continue;
    keep_out[kept++] = i;
    const float ax1 = bx[i * 4], ay1 = bx[i * 4 + 1], ax2 = bx[i * 4 + 2],
                ay2 = bx[i * 4 + 3];
    const float area_a = std::max(0.f, ax2 - ax1) * std::max(0.f, ay2 - ay1);
    for (int oj = oi + 1; oj < n; ++oj) {
      const int j = order[oj];
      if (suppressed[j]) continue;
      const float bx1 = bx[j * 4], by1 = bx[j * 4 + 1], bx2 = bx[j * 4 + 2],
                  by2 = bx[j * 4 + 3];
      const float iw = std::min(ax2, bx2) - std::max(ax1, bx1);
      const float ih = std::min(ay2, by2) - std::max(ay1, by1);
      if (iw <= 0 || ih <= 0) continue;
      const float inter = iw * ih;
      const float area_b = std::max(0.f, bx2 - bx1) * std::max(0.f, by2 - by1);
      const float iou = inter / (area_a + area_b - inter + 1e-7f);
      if (iou > iou_thres) suppressed[j] = 1;
    }
  }
  return kept;
}

// Letterbox: bilinear resize (h,w,3) uint8 -> (size,size,3) uint8 with
// gray-114 padding, aspect preserved. Returns via out buffer; writes the
// scale ratio and pads into meta[3] = {r, dw, dh}.
void yat_letterbox(const uint8_t* img, int h, int w, int size, int scaleup,
                   uint8_t* out, float* meta) {
  float r = std::min((float)size / h, (float)size / w);
  if (!scaleup) r = std::min(r, 1.0f);
  const int nw = (int)std::lround(w * r);
  const int nh = (int)std::lround(h * r);
  const float dw = (size - nw) / 2.0f;
  const float dh = (size - nh) / 2.0f;
  const int top = (int)std::lround(dh - 0.1);
  const int left = (int)std::lround(dw - 0.1);

  std::memset(out, 114, (size_t)size * size * 3);
  // bilinear resize into the padded window
  for (int y = 0; y < nh; ++y) {
    const float sy = ((y + 0.5f) / r) - 0.5f;
    const int y0 = std::max(0, std::min((int)std::floor(sy), h - 1));
    const int y1 = std::min(y0 + 1, h - 1);
    const float fy = std::max(0.0f, std::min(sy - y0, 1.0f));
    uint8_t* dst = out + ((size_t)(y + top) * size + left) * 3;
    for (int x = 0; x < nw; ++x) {
      const float sx = ((x + 0.5f) / r) - 0.5f;
      const int x0 = std::max(0, std::min((int)std::floor(sx), w - 1));
      const int x1 = std::min(x0 + 1, w - 1);
      const float fx = std::max(0.0f, std::min(sx - x0, 1.0f));
      for (int c = 0; c < 3; ++c) {
        const float v00 = img[((size_t)y0 * w + x0) * 3 + c];
        const float v01 = img[((size_t)y0 * w + x1) * 3 + c];
        const float v10 = img[((size_t)y1 * w + x0) * 3 + c];
        const float v11 = img[((size_t)y1 * w + x1) * 3 + c];
        const float v = v00 * (1 - fy) * (1 - fx) + v01 * (1 - fy) * fx +
                        v10 * fy * (1 - fx) + v11 * fy * fx;
        dst[x * 3 + c] = (uint8_t)std::lround(v);
      }
    }
  }
  meta[0] = r;
  meta[1] = dw;
  meta[2] = dh;
}

}  // extern "C"

// Greedy NMS suppression for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel yolo_ad_refine_tpu/ops/nms_pallas.py::_suppress_kernel
// and returns exactly the keep mask of ops/nms.py::_suppress: over K
// score-sorted, class-offset xyxy fp32 candidates, candidate i is kept iff it
// is still alive and its score > conf_thres; a kept i kills every later j
// with IoU > iou_thres, IoU = inter / (area_i + area_j - inter + 1e-7).
//
// The TPU kernel walks all K candidates with whole-K vector ops because the
// TPU has no dynamic lane indexing. Here the work splits in two launches
// (one pair per batch, the image as a grid dimension):
//   1. nms_mask_kernel: 64x64 tiles of the IoU matrix, one thread per row i,
//      each writing a 64-bit word whose bit jj says "i would kill
//      j = 64*tile + jj" (j > i only).
//   2. nms_reduce_kernel: one warp per image walks the candidates in order
//      with the removed-bitmask (K/64 words) in shared memory and ORs in
//      row i only when i is kept.
// The IoU is written with __f*_rn intrinsics in the reference's order and
// the file is compiled with -fmad=false, so it rounds like the separate
// fp32 ops of the JAX and PyTorch versions and the mask is bit-equal.
//
// What bounds it: phase 1 does ~K^2/2 IoUs (~2.1M at K = 2048, ~15 flops
// each) and writes K^2/8 bytes of masks; phase 2 is a serial walk of K
// steps per image whose cost is latency, not bandwidth. At K = 2048 either
// is microseconds of work for the card; the launch and the serial walk set
// the time.

#include <cuda_runtime.h>

namespace {

constexpr int TB = 64;

__device__ __forceinline__ float area_rn(float x1, float y1, float x2, float y2) {
  return __fmul_rn(fmaxf(__fsub_rn(x2, x1), 0.f), fmaxf(__fsub_rn(y2, y1), 0.f));
}

__global__ void __launch_bounds__(TB)
nms_mask_kernel(const float* __restrict__ boxes, int K, int nwords, float iou_thres,
                unsigned long long* __restrict__ mask) {
  const int b = blockIdx.z;
  const int rb = blockIdx.y;
  const int cb = blockIdx.x;
  const int i = rb * TB + threadIdx.x;
  const int j0 = cb * TB;
  const float* bb = boxes + (size_t)b * K * 4;

  __shared__ float sb[TB][4];
  __shared__ float sarea[TB];
  if (j0 + threadIdx.x < K) {
    const float* q = bb + (size_t)(j0 + threadIdx.x) * 4;
    sb[threadIdx.x][0] = q[0];
    sb[threadIdx.x][1] = q[1];
    sb[threadIdx.x][2] = q[2];
    sb[threadIdx.x][3] = q[3];
    sarea[threadIdx.x] = area_rn(q[0], q[1], q[2], q[3]);
  }
  __syncthreads();
  if (i >= K) return;

  unsigned long long bits = 0ull;
  if (cb >= rb) {  // tiles left of the diagonal hold only j < i
    const float x1 = bb[(size_t)i * 4 + 0];
    const float y1 = bb[(size_t)i * 4 + 1];
    const float x2 = bb[(size_t)i * 4 + 2];
    const float y2 = bb[(size_t)i * 4 + 3];
    const float ai = area_rn(x1, y1, x2, y2);
    const int jn = min(TB, K - j0);
    for (int jj = 0; jj < jn; ++jj) {
      if (j0 + jj <= i) continue;
      const float iw = fmaxf(__fsub_rn(fminf(x2, sb[jj][2]), fmaxf(x1, sb[jj][0])), 0.f);
      const float ih = fmaxf(__fsub_rn(fminf(y2, sb[jj][3]), fmaxf(y1, sb[jj][1])), 0.f);
      const float inter = __fmul_rn(iw, ih);
      const float den = __fadd_rn(__fsub_rn(__fadd_rn(ai, sarea[jj]), inter), 1e-7f);
      if (__fdiv_rn(inter, den) > iou_thres) bits |= 1ull << jj;
    }
  }
  mask[((size_t)b * K + i) * nwords + cb] = bits;
}

__global__ void nms_reduce_kernel(const unsigned long long* __restrict__ mask,
                                  const float* __restrict__ scores, int K, int nwords,
                                  float conf_thres, unsigned char* __restrict__ keep) {
  extern __shared__ unsigned long long removed[];
  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  for (int w = lane; w < nwords; w += 32) removed[w] = 0ull;
  __syncwarp();
  const unsigned long long* mb = mask + (size_t)b * K * nwords;
  const float* sc = scores + (size_t)b * K;
  for (int i = 0; i < K; ++i) {
    const int w = i / 64;
    const bool alive = !((removed[w] >> (i % 64)) & 1ull);
    const bool kept = alive && (sc[i] > conf_thres);
    __syncwarp();
    if (lane == 0) keep[(size_t)b * K + i] = kept ? 1 : 0;
    if (kept) {
      for (int ww = w + lane; ww < nwords; ww += 32) removed[ww] |= mb[(size_t)i * nwords + ww];
    }
    __syncwarp();
  }
}

}  // namespace

extern "C" {

// boxes (B, K, 4) fp32, scores (B, K) fp32, mask_ws (B, K, ceil(K/64)) uint64
// scratch, keep (B, K) bytes. Returns cudaGetLastError().
int nms_suppress(const void* boxes, const void* scores, void* mask_ws, void* keep, int B,
                 int K, float iou_thres, float conf_thres, void* stream) {
  if (B <= 0 || K <= 0) return 0;
  const int nwords = (K + TB - 1) / TB;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid1(nwords, nwords, B);
  nms_mask_kernel<<<grid1, TB, 0, s>>>(static_cast<const float*>(boxes), K, nwords, iou_thres,
                                        static_cast<unsigned long long*>(mask_ws));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  nms_reduce_kernel<<<B, 32, nwords * sizeof(unsigned long long), s>>>(
      static_cast<const unsigned long long*>(mask_ws), static_cast<const float*>(scores), K,
      nwords, conf_thres, static_cast<unsigned char*>(keep));
  return (int)cudaGetLastError();
}

const char* yat_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

// Greedy NMS suppression for NVIDIA Hopper (sm_90a): K4 (axis-aligned IoU)
// and K5 (rotated boxes, probiou).
//
// K4 replaces the TPU kernel yolo_ad_refine_tpu/ops/nms_pallas.py::_suppress_kernel
// and returns exactly the keep mask of ops/nms.py::_suppress: over K
// score-sorted, class-offset xyxy fp32 candidates, candidate i is kept iff it
// is still alive and its score > conf_thres; a kept i kills every later j
// with IoU > iou_thres, IoU = inter / (area_i + area_j - inter + 1e-7).
//
// K5 replaces ops/nms_pallas.py::_suppress_rotated_kernel, the same greedy
// loop over xywhr candidates (class-offset centres) with the overlap
// probiou, 1 - the Hellinger distance of the boxes' Gaussians
// (ops/iou.py:probiou). Its input is the (B, 6, K) planes [x, y, a, b, c,
// clip(a*b - c^2, 0)] that the wrapper computes with the same torch
// function as the plain version, as the TPU kernel's wrapper does.
//
// The TPU kernels walk all K candidates with whole-K vector ops, pulling the
// current candidate out with a one-hot reduction, because the TPU has no
// dynamic lane indexing. Here the work splits in two launches (one pair per
// batch, the image as a grid dimension):
//   1. nms_mask_kernel / nms_rotated_mask_kernel: 64x64 tiles of the
//      overlap matrix, one thread per row i, each writing a 64-bit word
//      whose bit jj says "i would kill j = 64*tile + jj" (j > i only).
//   2. nms_reduce_kernel / nms_rotated_reduce_kernel (one body, greedy_walk,
//      under a name per kernel so that a profile tells them apart): one warp
//      per image walks the candidates in order with the removed-bitmask
//      (K/64 words) in shared memory and ORs in row i only when i is kept.
// Both overlaps are written with __f*_rn intrinsics in the reference's
// order of operations and the file is compiled with -fmad=false, so they
// round like the separate fp32 ops of the JAX and PyTorch versions: K4's mask
// is bit-equal; K5's differs from the plain version only through logf and
// expf (CUDA's against torch's, last ulp), which can flip a pair whose
// probiou lies within a few ulp of iou_thres.
//
// What bounds them: phase 1 does ~K^2/2 overlaps (~2.1M at K = 2048 an
// image; K4 ~15 flops each, K5 ~40, counting each log, exp, sqrt and
// division as one operation, which understates the floor: each is several
// instructions on the card) and writes K^2/8 bytes of masks; phase 2 is a
// serial walk of K steps per image whose cost is latency, not bandwidth. At
// K = 2048 either is microseconds of work for the card; the launch and the
// serial walk set the time.

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

// probiou of candidate (x1, y1, a1, b1, c1, sq1) against (x, y, a, b, c, sq),
// operation by operation as ops/iou.py:probiou computes it from the same a, b,
// c (eps = 1e-7).
__device__ __forceinline__ float probiou_rn(float x1, float y1, float a1, float b1, float c1,
                                            float sq1, float x, float y, float a, float b,
                                            float c, float sq) {
  const float eps = 1e-7f;
  const float aa = __fadd_rn(a1, a), bb = __fadd_rn(b1, b), cc = __fadd_rn(c1, c);
  const float ab_sum = __fsub_rn(__fmul_rn(aa, bb), __fmul_rn(cc, cc));
  const float denom = __fadd_rn(ab_sum, eps);
  const float dy = __fsub_rn(y1, y), dx = __fsub_rn(x1, x);
  const float t1 = __fmul_rn(
      __fdiv_rn(__fadd_rn(__fmul_rn(aa, __fmul_rn(dy, dy)), __fmul_rn(bb, __fmul_rn(dx, dx))),
                denom),
      0.25f);
  const float t2 =
      __fmul_rn(__fdiv_rn(__fmul_rn(__fmul_rn(cc, __fsub_rn(x, x1)), dy), denom), 0.5f);
  const float root = __fadd_rn(__fmul_rn(4.f, __fsqrt_rn(__fmul_rn(sq1, sq))), eps);
  const float t3 = __fmul_rn(0.5f, logf(__fadd_rn(__fdiv_rn(ab_sum, root), eps)));
  const float bd = fminf(fmaxf(__fadd_rn(__fadd_rn(t1, t2), t3), eps), 100.f);
  return __fsub_rn(1.f, __fsqrt_rn(__fadd_rn(__fsub_rn(1.f, expf(-bd)), eps)));
}

__global__ void __launch_bounds__(TB)
nms_rotated_mask_kernel(const float* __restrict__ planes, int K, int nwords, float iou_thres,
                        unsigned long long* __restrict__ mask) {
  const int b = blockIdx.z;
  const int rb = blockIdx.y;
  const int cb = blockIdx.x;
  const int i = rb * TB + threadIdx.x;
  const int j0 = cb * TB;
  const float* pb = planes + (size_t)b * 6 * K;

  __shared__ float sp[6][TB];
  if (j0 + threadIdx.x < K) {
    for (int p = 0; p < 6; ++p) sp[p][threadIdx.x] = pb[(size_t)p * K + j0 + threadIdx.x];
  }
  __syncthreads();
  if (i >= K) return;

  unsigned long long bits = 0ull;
  if (cb >= rb) {  // tiles left of the diagonal hold only j < i
    float q[6];
    for (int p = 0; p < 6; ++p) q[p] = pb[(size_t)p * K + i];
    const int jn = min(TB, K - j0);
    for (int jj = 0; jj < jn; ++jj) {
      if (j0 + jj <= i) continue;
      const float iou = probiou_rn(q[0], q[1], q[2], q[3], q[4], q[5], sp[0][jj], sp[1][jj],
                                   sp[2][jj], sp[3][jj], sp[4][jj], sp[5][jj]);
      if (iou > iou_thres) bits |= 1ull << jj;
    }
  }
  mask[((size_t)b * K + i) * nwords + cb] = bits;
}

// Phase 2 for image blockIdx.x, one warp, removed: nwords words of shared memory.
__device__ __forceinline__ void greedy_walk(const unsigned long long* __restrict__ mask,
                                            const float* __restrict__ scores, int K, int nwords,
                                            float conf_thres, unsigned char* __restrict__ keep,
                                            unsigned long long* removed) {
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

__global__ void nms_reduce_kernel(const unsigned long long* __restrict__ mask,
                                  const float* __restrict__ scores, int K, int nwords,
                                  float conf_thres, unsigned char* __restrict__ keep) {
  extern __shared__ unsigned long long removed[];
  greedy_walk(mask, scores, K, nwords, conf_thres, keep, removed);
}

__global__ void nms_rotated_reduce_kernel(const unsigned long long* __restrict__ mask,
                                          const float* __restrict__ scores, int K, int nwords,
                                          float conf_thres, unsigned char* __restrict__ keep) {
  extern __shared__ unsigned long long removed[];
  greedy_walk(mask, scores, K, nwords, conf_thres, keep, removed);
}

using walk_fn = void (*)(const unsigned long long*, const float*, int, int, float,
                         unsigned char*);

// Phase 2 (walk) after a mask kernel has filled mask_ws. Returns cudaGetLastError().
int launch_reduce(walk_fn walk, const void* mask_ws, const void* scores, void* keep, int B,
                  int K, int nwords, float conf_thres, cudaStream_t s) {
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  walk<<<B, 32, nwords * sizeof(unsigned long long), s>>>(
      static_cast<const unsigned long long*>(mask_ws), static_cast<const float*>(scores), K,
      nwords, conf_thres, static_cast<unsigned char*>(keep));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K4. boxes (B, K, 4) fp32, scores (B, K) fp32, mask_ws (B, K, ceil(K/64))
// uint64 scratch, keep (B, K) bytes. Returns cudaGetLastError().
int nms_suppress(const void* boxes, const void* scores, void* mask_ws, void* keep, int B,
                 int K, float iou_thres, float conf_thres, void* stream) {
  if (B <= 0 || K <= 0) return 0;
  const int nwords = (K + TB - 1) / TB;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  nms_mask_kernel<<<dim3(nwords, nwords, B), TB, 0, s>>>(
      static_cast<const float*>(boxes), K, nwords, iou_thres,
      static_cast<unsigned long long*>(mask_ws));
  return launch_reduce(nms_reduce_kernel, mask_ws, scores, keep, B, K, nwords, conf_thres,
                       s);
}

// K5. planes (B, 6, K) fp32 [x, y, a, b, c, sq], the rest as K4.
int nms_rotated_suppress(const void* planes, const void* scores, void* mask_ws, void* keep,
                         int B, int K, float iou_thres, float conf_thres, void* stream) {
  if (B <= 0 || K <= 0) return 0;
  const int nwords = (K + TB - 1) / TB;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  nms_rotated_mask_kernel<<<dim3(nwords, nwords, B), TB, 0, s>>>(
      static_cast<const float*>(planes), K, nwords, iou_thres,
      static_cast<unsigned long long*>(mask_ws));
  return launch_reduce(nms_rotated_reduce_kernel, mask_ws, scores, keep, B, K, nwords,
                       conf_thres, s);
}

const char* yat_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

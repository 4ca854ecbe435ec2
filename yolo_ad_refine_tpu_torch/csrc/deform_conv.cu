// Modulated deformable convolution (DCNv2) forward for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel yolo_ad_refine_tpu/ops/deform_mxu2.py::_fwd_kernel
// (and computes the function of ops/deform.py::modulated_deform_conv2d):
// a 3x3, stride-1, pad-1 deformable conv. For every output pixel p and tap t
// the input is sampled bilinearly at (y + t/3 - 1 + dy, x + t%3 - 1 + dx),
// each corner that lies outside the map contributing zero (mmcv rule),
// scaled by the tap's mask, and contracted with the tap's (C x Cout) weight
// slice. Offsets are clipped to +-radius first when radius >= 0; radius < 0
// samples unbounded, as mmcv and ops/deform.py do.
//
// Layouts: x (B, H, W, C) and out (B, H, W, Cout) in the working type (fp32
// or bf16; a channels_last NCHW tensor is this NHWC buffer), offset
// (B, H, W, 18) as (dy, dx) pairs in row-major tap order and mask
// (B, H, W, 9) in fp32, weight (9, C, Cout) in the working type. All sums
// are fp32.
//
// The TPU kernel builds banded hat-weight matrices because the TPU has no
// per-lane gather; here each corner is a plain load. Design: a block owns
// 64 output pixels and 64 output channels. For each tap it tabulates the 4
// corner addresses and mask*bilinear weights of its pixels, gathers the
// masked samples of 64 input channels into shared memory (one coalesced
// 256-byte row per corner), stages the tap's 64x64 weight slice beside them
// and multiplies the two tiles into fp32 registers (4 pixels x 4 channels a
// thread). The contraction with the weight happens here, not after the
// kernel.
//
// What bounds it: per 640 image, over the three AYHead levels (80^2, 40^2,
// 20^2 = 8,400 px, C = Cout = 64) the work is ~0.62 GFLOP of contraction
// (2 * 9 * 64 * 64 per pixel) plus ~5k sampling flops per pixel, and the
// bytes that must move are ~5.2 MB in fp32 (x and out 2.15 MB each, offset
// and mask 0.9 MB). That is memory-bound against the tensor cores and
// compute-bound against the fp32 CUDA cores this simple kernel uses. Moving
// the contraction onto wgmma with TMA-fed tiles is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int KK = 9;    // taps
constexpr int TP = 64;   // output pixels per block
constexpr int TC = 64;   // input channels per shared-memory chunk
constexpr int TO = 64;   // output channels per block
constexpr int NT = 256;  // threads: 16 pixel groups x 16 channel groups

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(NT)
dcn_fwd_kernel(const T* __restrict__ x, const float* __restrict__ offset,
               const float* __restrict__ mask, const T* __restrict__ weight,
               T* __restrict__ out, int npix, int H, int W, int C, int Cout,
               float radius) {
  __shared__ float s_samp[TP][TC + 1];
  __shared__ __align__(16) float s_w[TC][TO];
  __shared__ int s_idx[TP][4];    // corner pixel index (b*H + y)*W + x, -1 outside
  __shared__ float s_cw[TP][4];   // mask * bilinear weight of the corner

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // output channels tx*4 .. tx*4+3
  const int ty = tid / 16;  // pixels ty*4 .. ty*4+3
  const int p0 = blockIdx.x * TP;
  const int o0 = blockIdx.y * TO;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int t = 0; t < KK; ++t) {
    if (tid < TP) {
      const int p = p0 + tid;
      int idx[4] = {-1, -1, -1, -1};
      float cw[4] = {0.f, 0.f, 0.f, 0.f};
      if (p < npix) {
        const int xw = p % W;
        const int r = p / W;
        const int yh = r % H;
        const int b = r / H;
        float dy = offset[(size_t)p * 18 + 2 * t];
        float dx = offset[(size_t)p * 18 + 2 * t + 1];
        if (radius >= 0.f) {
          dy = fminf(fmaxf(dy, -radius), radius);
          dx = fminf(fmaxf(dx, -radius), radius);
        }
        const float m = mask[(size_t)p * KK + t];
        const float cy = (float)(yh + t / 3 - 1) + dy;
        const float cx = (float)(xw + t % 3 - 1) + dx;
        // a sample at or beyond -1 / the far edge has no corner inside
        if (cy > -1.f && cy < (float)H && cx > -1.f && cx < (float)W) {
          const float fy = floorf(cy);
          const float fx = floorf(cx);
          const int y0 = (int)fy;
          const int x0 = (int)fx;
          const float ly = cy - fy;
          const float lx = cx - fx;
          const float wy[2] = {1.f - ly, ly};
          const float wx[2] = {1.f - lx, lx};
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int yy = y0 + (k >> 1);
            const int xx = x0 + (k & 1);
            if (yy >= 0 && yy < H && xx >= 0 && xx < W) {
              idx[k] = (b * H + yy) * W + xx;
              cw[k] = m * (wy[k >> 1] * wx[k & 1]);
            }
          }
        }
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        s_idx[tid][k] = idx[k];
        s_cw[tid][k] = cw[k];
      }
    }
    __syncthreads();

    for (int c0 = 0; c0 < C; c0 += TC) {
      // gather the masked samples: thread -> one channel, 16 pixels
      const int c = tid % TC;
      const int pr = tid / TC;
      for (int j = 0; j < TP / (NT / TC); ++j) {
        const int pp = pr + (NT / TC) * j;
        float v = 0.f;
        if (c0 + c < C) {
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int q = s_idx[pp][k];
            if (q >= 0) v += s_cw[pp][k] * to_f(x[(size_t)q * C + c0 + c]);
          }
        }
        s_samp[pp][c] = v;
      }
      // stage the tap's weight slice
      for (int i = tid; i < TC * TO; i += NT) {
        const int cc = i / TO;
        const int oo = i % TO;
        float w = 0.f;
        if (c0 + cc < C && o0 + oo < Cout)
          w = to_f(weight[((size_t)t * C + c0 + cc) * Cout + o0 + oo]);
        s_w[cc][oo] = w;
      }
      __syncthreads();
#pragma unroll 8
      for (int cc = 0; cc < TC; ++cc) {
        const float4 bw = *reinterpret_cast<const float4*>(&s_w[cc][tx * 4]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float a = s_samp[ty * 4 + i][cc];
          acc[i][0] = fmaf(a, bw.x, acc[i][0]);
          acc[i][1] = fmaf(a, bw.y, acc[i][1]);
          acc[i][2] = fmaf(a, bw.z, acc[i][2]);
          acc[i][3] = fmaf(a, bw.w, acc[i][3]);
        }
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p = p0 + ty * 4 + i;
    if (p >= npix) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int o = o0 + tx * 4 + j;
      if (o < Cout) out[(size_t)p * Cout + o] = from_f<T>(acc[i][j]);
    }
  }
}

}  // namespace

extern "C" {

// dtype: 0 = fp32, 1 = bf16 (x, weight and out). Returns cudaGetLastError().
int dcn_forward(const void* x, const void* offset, const void* mask, const void* weight,
                void* out, int B, int H, int W, int C, int Cout, float radius, int dtype,
                void* stream) {
  const int npix = B * H * W;
  const dim3 grid((npix + TP - 1) / TP, (Cout + TO - 1) / TO);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    dcn_fwd_kernel<float><<<grid, NT, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(offset),
        static_cast<const float*>(mask), static_cast<const float*>(weight),
        static_cast<float*>(out), npix, H, W, C, Cout, radius);
  } else if (dtype == 1) {
    dcn_fwd_kernel<__nv_bfloat16><<<grid, NT, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(offset),
        static_cast<const float*>(mask), static_cast<const __nv_bfloat16*>(weight),
        static_cast<__nv_bfloat16*>(out), npix, H, W, C, Cout, radius);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

const char* yat_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

// Modulated deformable convolution (DCNv2) forward and backward for NVIDIA
// Hopper (sm_90a). The backward kernel follows the forward below.
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

// ---------------------------------------------------------------------------
// Backward (K1 bwd). Replaces yolo_ad_refine_tpu/ops/deform_mxu2.py::_bwd_kernel
// and computes the gradient of the function above: dx, doffset, dmask and
// dweight for an incoming gradient g (B, H, W, Cout) in the working type.
//
// Per tap t, with sampled_t[p, c] = sum_k w_k x[corner_k, c] (bilinear weights
// w_k from floor-based corners, before the mask) and gs_t = g . W_t^T:
//   dmask[p, t]   = sum_c sampled_t[p, c] gs_t[p, c]
//   doffset[p, t] = m sum_c gs_t[p, c] sum_k (dw_k / d coord) x[corner_k, c]
//   dx[corner_k]  += m w_k gs_t[p, :]                       (fp64 atomics)
//   dW_t          += (m sampled_t)^T g                      (fp64 atomics)
// With radius < 0 (unbounded) the floor-based weights give, at an integer
// sample coordinate, the one-sided derivative that autodiff of ops/deform.py
// (and mmcv) gives. With radius >= 0 the derivative is the TPU kernel's
// hat derivative (deform_mxu2.py:71-76), which is 0 along an axis where the
// sample coordinate is integral, so that axis's doffset term is zeroed
// where its fraction is 0. A corner outside the map is zero, so its terms
// drop. With radius >= 0 the offsets are clipped first and doffset is also
// zeroed where |offset| >= radius, as deform_mxu2.py:483 does.
//
// Design: block (tile group, tap). The block stages its tap's weight slice
// W_t (C x Cout) in shared memory once and keeps its dW_t partial there; it
// walks 64-pixel tiles, and per tile loads g, forms gs = g . W_t^T, then each
// warp takes 8 pixels with its lanes over channels: it gathers the four
// corner rows, writes m * sampled to shared memory, scatters dx with atomics
// and reduces the four corner dot products over the warp into dmask and
// doffset. Last, dW_t += (m sampled)^T g from shared memory. At the end the
// block adds its dW_t partial into the global dW with atomics. dx and dW are
// summed in an order that changes from run to run, so both sums are kept in
// fp64 and rounded to fp32 once, by the wrapper: two runs then give the same
// fp32 gradient but where an fp64 sum lies within its own rounding of an fp32
// rounding boundary, where fp32 atomics would move the last bits of nearly
// every sum of several terms (and a train step's gradient with them).
//
// What bounds it: the per-tap products g . W_t^T and (m sampled)^T g are
// 4 C Cout flops per pixel and tap (~1.3 GFLOP per 640 image over the three
// levels at C = Cout = 64), run here on fp32 CUDA cores out of shared
// memory; the bytes (x, offset, mask, g read, dx, doffset, dmask written)
// are ~8.3 MB per image in fp32. Moving both products onto wgmma is later
// work.

constexpr int BWD_TILE_GROUPS = 64;  // tile groups per tap (grid.x upper bound)

template <typename T>
__global__ void __launch_bounds__(NT)
dcn_bwd_kernel(const T* __restrict__ x, const float* __restrict__ offset,
               const float* __restrict__ mask, const T* __restrict__ weight,
               const T* __restrict__ g, double* __restrict__ dx,
               float* __restrict__ doffset, float* __restrict__ dmask,
               double* __restrict__ dweight, int npix, int H, int W, int C, int Cout,
               float radius) {
  extern __shared__ float smem[];
  float* s_w = smem;                      // C x (Cout + 1), padded rows
  float* s_dw = s_w + C * (Cout + 1);     // C x Cout, this block's dW_t partial
  float* s_g = s_dw + C * Cout;           // TP x Cout
  float* s_gs = s_g + TP * Cout;          // TP x C
  float* s_ms = s_gs + TP * C;            // TP x C, mask * sampled

  const int t = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int ntiles = (npix + TP - 1) / TP;

  for (int i = tid; i < C * Cout; i += NT) {
    s_w[(i / Cout) * (Cout + 1) + i % Cout] = to_f(weight[(size_t)t * C * Cout + i]);
    s_dw[i] = 0.f;
  }

  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int p0 = tile * TP;
    __syncthreads();  // the previous tile's readers of s_g / s_ms are done
    for (int i = tid; i < TP * Cout; i += NT)
      s_g[i] = (p0 + i / Cout < npix) ? to_f(g[(size_t)p0 * Cout + i]) : 0.f;
    __syncthreads();

    // gs = g . W_t^T: thread -> (pixel, channel), consecutive channels per warp
    for (int i = tid; i < TP * C; i += NT) {
      const float* gr = s_g + (i / C) * Cout;
      const float* wr = s_w + (i % C) * (Cout + 1);
      float acc = 0.f;
      for (int o = 0; o < Cout; ++o) acc = fmaf(gr[o], wr[o], acc);
      s_gs[i] = acc;
    }
    __syncthreads();

    // a warp per pixel, lanes over channels
    for (int pi = warp; pi < TP; pi += NT / 32) {
      const int p = p0 + pi;
      if (p >= npix) {
        for (int c = lane; c < C; c += 32) s_ms[pi * C + c] = 0.f;
        continue;
      }
      const int xw = p % W;
      const int r = p / W;
      const int yh = r % H;
      const int b = r / H;
      float dy = offset[(size_t)p * 18 + 2 * t];
      float dxo = offset[(size_t)p * 18 + 2 * t + 1];
      float gate_y = 1.f, gate_x = 1.f;
      if (radius >= 0.f) {
        gate_y = fabsf(dy) < radius ? 1.f : 0.f;
        gate_x = fabsf(dxo) < radius ? 1.f : 0.f;
        dy = fminf(fmaxf(dy, -radius), radius);
        dxo = fminf(fmaxf(dxo, -radius), radius);
      }
      const float m = mask[(size_t)p * KK + t];
      const float cy = (float)(yh + t / 3 - 1) + dy;
      const float cx = (float)(xw + t % 3 - 1) + dxo;
      const float fy = floorf(cy);
      const float fx = floorf(cx);
      const float ly = cy - fy;
      const float lx = cx - fx;
      if (radius >= 0.f) {  // the hat derivative is 0 at an integral coordinate
        if (ly == 0.f) gate_y = 0.f;
        if (lx == 0.f) gate_x = 0.f;
      }
      // clamp before the int conversion: beyond [-2, H] both corners are outside
      const int y0 = (int)fminf(fmaxf(fy, -2.f), (float)H);
      const int x0 = (int)fminf(fmaxf(fx, -2.f), (float)W);
      const float wy[2] = {1.f - ly, ly};
      const float wx[2] = {1.f - lx, lx};
      int idx[4];
      float wk[4], dwy[4], dwx[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int ky = k >> 1, kx = k & 1;
        const int yy = y0 + ky, xx = x0 + kx;
        const bool in = yy >= 0 && yy < H && xx >= 0 && xx < W;
        idx[k] = in ? (b * H + yy) * W + xx : -1;
        wk[k] = in ? wy[ky] * wx[kx] : 0.f;
        dwy[k] = in ? (ky ? wx[kx] : -wx[kx]) : 0.f;
        dwx[k] = in ? (kx ? wy[ky] : -wy[ky]) : 0.f;
      }
      float a[4] = {0.f, 0.f, 0.f, 0.f};  // sum_c gs[c] x[corner_k, c]
      for (int c = lane; c < C; c += 32) {
        const float gsv = s_gs[pi * C + c];
        const float mg = m * gsv;
        float samp = 0.f;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (idx[k] < 0) continue;
          const size_t q = (size_t)idx[k] * C + c;
          const float xv = to_f(x[q]);
          samp = fmaf(wk[k], xv, samp);
          a[k] = fmaf(gsv, xv, a[k]);
          atomicAdd(dx + q, (double)(wk[k] * mg));
        }
        s_ms[pi * C + c] = m * samp;
      }
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int s = 16; s > 0; s >>= 1) a[k] += __shfl_xor_sync(0xffffffffu, a[k], s);
      if (lane == 0) {
        float dm = 0.f, doy = 0.f, dox = 0.f;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          dm = fmaf(wk[k], a[k], dm);
          doy = fmaf(dwy[k], a[k], doy);
          dox = fmaf(dwx[k], a[k], dox);
        }
        dmask[(size_t)p * KK + t] = dm;
        doffset[(size_t)p * 18 + 2 * t] = gate_y * m * doy;
        doffset[(size_t)p * 18 + 2 * t + 1] = gate_x * m * dox;
      }
    }
    __syncthreads();

    // dW_t += (m sampled)^T g: thread -> (channel, output channel) entries
    for (int i = tid; i < C * Cout; i += NT) {
      const int c = i / Cout;
      const int o = i % Cout;
      float acc = s_dw[i];
      for (int pp = 0; pp < TP; ++pp) acc = fmaf(s_ms[pp * C + c], s_g[pp * Cout + o], acc);
      s_dw[i] = acc;
    }
  }
  __syncthreads();
  for (int i = tid; i < C * Cout; i += NT)
    atomicAdd(dweight + (size_t)t * C * Cout + i, (double)s_dw[i]);
}

size_t bwd_smem_bytes(int C, int Cout) {
  return sizeof(float) * ((size_t)C * (Cout + 1) + (size_t)C * Cout + (size_t)TP * Cout +
                          2 * (size_t)TP * C);
}

template <typename T>
int launch_bwd(const void* x, const void* offset, const void* mask, const void* weight,
               const void* g, void* dx, void* doffset, void* dmask, void* dweight, int npix,
               int H, int W, int C, int Cout, float radius, cudaStream_t s) {
  const size_t smem = bwd_smem_bytes(C, Cout);
  cudaError_t err = cudaFuncSetAttribute(dcn_bwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int ntiles = (npix + TP - 1) / TP;
  const dim3 grid(ntiles < BWD_TILE_GROUPS ? ntiles : BWD_TILE_GROUPS, KK);
  dcn_bwd_kernel<T><<<grid, NT, smem, s>>>(
      static_cast<const T*>(x), static_cast<const float*>(offset),
      static_cast<const float*>(mask), static_cast<const T*>(weight), static_cast<const T*>(g),
      static_cast<double*>(dx), static_cast<float*>(doffset), static_cast<float*>(dmask),
      static_cast<double*>(dweight), npix, H, W, C, Cout, radius);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory (bytes) one backward block needs at these channel counts.
size_t dcn_backward_smem_bytes(int C, int Cout) { return bwd_smem_bytes(C, Cout); }

// dx (B, H, W, C) and dweight (9, C, Cout) are fp64 and must be zeroed by the
// caller (the kernel adds into them); doffset (B, H, W, 18) and dmask
// (B, H, W, 9) are fp32 and fully written. dtype: 0 = fp32, 1 = bf16 (x,
// weight and g). Returns cudaGetLastError().
int dcn_backward(const void* x, const void* offset, const void* mask, const void* weight,
                 const void* g, void* dx, void* doffset, void* dmask, void* dweight, int B,
                 int H, int W, int C, int Cout, float radius, int dtype, void* stream) {
  const int npix = B * H * W;
  if (npix == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_bwd<float>(x, offset, mask, weight, g, dx, doffset, dmask, dweight, npix, H,
                             W, C, Cout, radius, s);
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16>(x, offset, mask, weight, g, dx, doffset, dmask, dweight,
                                     npix, H, W, C, Cout, radius, s);
  return (int)cudaErrorInvalidValue;
}

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

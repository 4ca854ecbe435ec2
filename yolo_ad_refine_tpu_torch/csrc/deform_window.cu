// Bounded-radius modulated deformable convolution (DCNv2) for NVIDIA Hopper
// (sm_90a): the window form (K3) and the separable form (K2), forward and
// backward, four entry points with a __global__ kernel each:
//
//   dcn_window_forward     replaces ops/deform_pallas.py::_fwd_kernel  (K3 fwd)
//   dcn_window_backward    replaces ops/deform_pallas.py::_bwd_kernel  (K3 bwd)
//   dcn_separable_forward  replaces ops/deform_mxu.py::_fwd_kernel     (K2 fwd)
//   dcn_separable_backward replaces ops/deform_mxu.py::_bwd_kernel     (K2 bwd)
//
// (paths under yolo_ad_refine_tpu/). All four compute the 3x3, stride-1,
// pad-1 DCNv2 of ops/deform.py with the offsets clipped to +-radius first:
// for every output pixel p and tap t the input is sampled bilinearly at
// (y + t/3 - 1 + dy, x + t%3 - 1 + dx), zero outside the map, scaled by the
// tap's mask and contracted with the tap's (C x Cout) weight slice. The
// bilinear weights are the TPU kernels' hat(u) = max(0, 1 - |u|) and their
// derivative dhat(u) = -sign(u) on |u| < 1 (0 at an integral coordinate).
// The hat is nonzero at two positions per axis, floor(u) and floor(u) + 1,
// so only those are evaluated: the other window terms add exactly 0.
//
// The two forms differ only where they round, which the kernels keep:
// - window (K3): the coordinate of an axis is offset - k (k the integer
//   window shift, deform_pallas.py:90,98); in bf16 the modulated sample is
//   rounded to bf16 before the bf16 x bf16 contraction (:104), fp32 sums.
// - separable (K2): the x coordinate is ((offset + tx + s) + x) - j over the
//   padded columns j (deform_mxu.py:118) and the y coordinate
//   ((offset + y % 8) + r + 1) - d over the window rows d of an 8-row chunk
//   (:122, CH = 8); in bf16 the x weights are rounded to bf16 (:128), the
//   x pass and the y combine run in fp32, and the contraction is fp32 with
//   the bf16 weight (:143, :304).
// Both backwards are all fp32 (deform_pallas.py:294-342, deform_mxu.py:343-
// 394): x, g and W are taken to fp32, and the x weights are not rounded.
// doffset is zeroed where |offset| >= radius (the clip's VJP).
//
// Layouts: x (B, H, W, C) in the working type (fp32 or bf16), offset
// (B, H, W, 18) as (dy, dx) pairs in row-major tap order and mask
// (B, H, W, 9) in fp32, weight (9, C, Cout) in the working type, out and g
// (B, H, W, Cout) in the working type.
//
// Design. The clip bounds where a tile's samples can fall: a block owns an
// 8 x 8 tile of output pixels, and every sample of it lies in the window of
// the tile plus a halo of r + 2 (the TPU kernels' pad margin s). The block
// stages that window in shared memory with cp.async, in channel chunks whose
// width the wrapper sizes at launch from the radius (a wider radius leaves
// room for fewer channels), and samples from shared memory, not from global
// memory as K1 (deform_conv.cu) does. Forward: a block also owns 64 output
// channels; per chunk and tap it writes the masked samples of its pixels to
// shared memory beside the tap's weight slice and multiplies the two into
// fp32 registers (4 pixels x 4 channels a thread). Backward: a block owns one
// tap and one (C-chunk, Cout-chunk) pair of at most 128 x 128 (grid.z; a
// single pair up to 128 channels) and walks many tiles; per tile it forms
// its pair's part of gs = g . W_t^T in the kernel, accumulates per pixel the
// four corner dot products gs . x_corner over the window chunks (a warp per
// pixel, reduced by shuffles), scatters dx with fp64 atomics and keeps its
// dW_t chunk in shared memory, added into the fp64 dW with atomics at the
// end. doffset and dmask add each pair's partial into fp64 sums. dx, dW,
// doffset and dmask are rounded once, by the wrapper: with a single pair
// doffset and dmask take one add each and equal the fp32 sums exactly; with
// several (C or Cout above 128) they repeat from run to run like dx.
//
// What bounds it: the per-tap (C x Cout) products, 2 * 9 * C * Cout flops a
// pixel forward and twice that backward, run here on the fp32 CUDA cores,
// against ~0.6 kB (fp32, C = Cout = 64) that a pixel must move forward. The
// kernels are operation-bound on the fp32 cores; moving the products onto
// wgmma is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int KK = 9;        // taps
constexpr int TH = 8;        // output tile rows
constexpr int TW = 8;        // output tile columns
constexpr int TP = TH * TW;  // output pixels per tile
constexpr int TO = 64;       // output channels per forward block
constexpr int NT = 256;      // threads per block
constexpr int MXU_CH = 8;    // rows per chunk of deform_mxu.py (its CH)
constexpr int BWD_TILE_GROUPS = 64;  // backward blocks per tap (grid.x upper bound)
constexpr int BWD_CHUNK = 128;       // channels and out channels a backward block takes

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

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ float hat(float u) { return fmaxf(0.f, 1.f - fabsf(u)); }

__device__ __forceinline__ float dhat(float u) {
  return fabsf(u) < 1.f ? (u > 0.f ? -1.f : (u < 0.f ? 1.f : 0.f)) : 0.f;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// One pixel's sample of one tap: the window-local index of its top-left
// corner, that corner's map coordinates, the hat weights of its two rows and
// columns and their derivatives, the mask, and the clip gates.
struct Geo {
  int pos, y0, x0;
  float wy[2], wx[2], dwy[2], dwx[2];
  float m, gy, gx;
};

struct Tile {
  int b, y0, x0;
};

__device__ __forceinline__ Tile tile_of(int tile, int H, int W) {
  const int tx = (W + TW - 1) / TW;
  const int ty = (H + TH - 1) / TH;
  const int b = tile / (tx * ty);
  const int rem = tile % (tx * ty);
  return {b, (rem / tx) * TH, (rem % tx) * TW};
}

// The geometry of pixel (y, x) of image b at tap t. SEP: the separable
// form's coordinates (deform_mxu.py), else the window form's.
template <bool SEP>
__device__ Geo tap_geometry(const float* __restrict__ offset, const float* __restrict__ mask,
                            const Tile& tl, int y, int x, int t, int H, int W, int r) {
  const int s = r + 2;
  const int WW = TW + 2 * s;
  const size_t p = ((size_t)tl.b * H + y) * W + x;
  float oy = offset[p * 18 + 2 * t];
  float ox = offset[p * 18 + 2 * t + 1];
  const float rf = (float)r;
  Geo g;
  g.gy = fabsf(oy) < rf ? 1.f : 0.f;
  g.gx = fabsf(ox) < rf ? 1.f : 0.f;
  oy = fminf(fmaxf(oy, -rf), rf);
  ox = fminf(fmaxf(ox, -rf), rf);
  const int ty = t / 3 - 1;
  const int tx = t % 3 - 1;
  float uy[2], ux[2];
  if (SEP) {
    const int yl = y % MXU_CH;
    const float ay = __fadd_rn(__fadd_rn(oy, (float)yl), (float)(r + 1));
    const float ax = __fadd_rn(__fadd_rn(ox, (float)(tx + s)), (float)x);
    const float fy = floorf(ay);
    const float fx = floorf(ax);
    uy[0] = __fsub_rn(ay, fy);
    uy[1] = __fsub_rn(ay, fy + 1.f);
    ux[0] = __fsub_rn(ax, fx);
    ux[1] = __fsub_rn(ax, fx + 1.f);
    g.y0 = (y - yl) + ty + 1 + (int)fy - s;  // padded row (y - yl) + ty + 1 + d
    g.x0 = (int)fx - s;                      // padded column j
  } else {
    const float fy = floorf(oy);
    const float fx = floorf(ox);
    uy[0] = __fsub_rn(oy, fy);
    uy[1] = __fsub_rn(oy, fy + 1.f);
    ux[0] = __fsub_rn(ox, fx);
    ux[1] = __fsub_rn(ox, fx + 1.f);
    g.y0 = y + ty + (int)fy;
    g.x0 = x + tx + (int)fx;
  }
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    g.wy[k] = hat(uy[k]);
    g.wx[k] = hat(ux[k]);
    g.dwy[k] = dhat(uy[k]);
    g.dwx[k] = dhat(ux[k]);
  }
  g.pos = (g.y0 - (tl.y0 - s)) * WW + (g.x0 - (tl.x0 - s));
  g.m = mask[p * KK + t];
  return g;
}

// A pixel of the tile that lies outside the map samples nothing.
__device__ __forceinline__ Geo empty_geometry() {
  Geo g;
  g.pos = g.y0 = g.x0 = 0;
#pragma unroll
  for (int k = 0; k < 2; ++k) g.wy[k] = g.wx[k] = g.dwy[k] = g.dwx[k] = 0.f;
  g.m = g.gy = g.gx = 0.f;
  return g;
}

// Stage channels [c0, c0 + cc) of the tile's window (tile plus a halo of s,
// zero outside the map) into s_x as [position][channel]. vec16: the rows of
// x are 16-byte aligned and cc * sizeof(T) is a multiple of 16, so each
// 16-byte piece is one cp.async. Ends with a barrier.
template <typename T>
__device__ void stage_window(T* s_x, const T* __restrict__ x, const Tile& tl, int H, int W,
                             int C, int c0, int cc, int s, bool vec16) {
  const int WW = TW + 2 * s;
  const int npos = (TH + 2 * s) * WW;
  if (vec16) {
    constexpr int E = 16 / sizeof(T);
    const int pieces = cc / E;
    for (int i = threadIdx.x; i < npos * pieces; i += blockDim.x) {
      const int q = i / pieces;
      const int c = c0 + (i % pieces) * E;
      const int yy = tl.y0 - s + q / WW;
      const int xx = tl.x0 - s + q % WW;
      T* dst = s_x + (size_t)q * cc + (c - c0);
      if (yy >= 0 && yy < H && xx >= 0 && xx < W && c < C)
        cp_async16(dst, x + (((size_t)tl.b * H + yy) * W + xx) * C + c);
      else
        *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
    }
    cp_async_wait_all();
  } else {
    for (int i = threadIdx.x; i < npos * cc; i += blockDim.x) {
      const int q = i / cc;
      const int c = c0 + i % cc;
      const int yy = tl.y0 - s + q / WW;
      const int xx = tl.x0 - s + q % WW;
      s_x[i] = (yy >= 0 && yy < H && xx >= 0 && xx < W && c < C)
                   ? x[(((size_t)tl.b * H + yy) * W + xx) * C + c]
                   : from_f<T>(0.f);
    }
  }
  __syncthreads();
}

__host__ __device__ __forceinline__ size_t align16(size_t n) { return (n + 15) & ~(size_t)15; }

__host__ __device__ __forceinline__ size_t window_bytes(int r, int cc, int itemsize) {
  const int s = r + 2;
  return align16((size_t)(TH + 2 * s) * (TW + 2 * s) * cc * itemsize);
}

size_t fwd_smem(int r, int cc, int itemsize) {
  return window_bytes(r, cc, itemsize) + sizeof(float) * ((size_t)TP * (cc + 1) + (size_t)cc * TO) +
         sizeof(Geo) * TP;
}

size_t bwd_smem(int r, int C, int Cout, int cc, int itemsize) {
  C = C < BWD_CHUNK ? C : BWD_CHUNK;  // a block's chunk pair
  Cout = Cout < BWD_CHUNK ? Cout : BWD_CHUNK;
  return window_bytes(r, cc, itemsize) +
         sizeof(float) * ((size_t)C * (Cout + 1) + (size_t)C * Cout + (size_t)TP * Cout +
                          2 * (size_t)TP * cc + 4 * (size_t)TP) +
         sizeof(Geo) * TP;
}

// The bilinear sample of one channel from the window, in the plain
// versions' order: the x pass over the two rows, then the y combine.
template <typename T>
__device__ __forceinline__ float sample(const T* s_x, const Geo& g, float wx0, float wx1, int c,
                                        int cc, int WW, float* xv) {
  xv[0] = to_f(s_x[(size_t)g.pos * cc + c]);
  xv[1] = to_f(s_x[(size_t)(g.pos + 1) * cc + c]);
  xv[2] = to_f(s_x[(size_t)(g.pos + WW) * cc + c]);
  xv[3] = to_f(s_x[(size_t)(g.pos + WW + 1) * cc + c]);
  const float row0 = __fadd_rn(__fmul_rn(wx0, xv[0]), __fmul_rn(wx1, xv[1]));
  const float row1 = __fadd_rn(__fmul_rn(wx0, xv[2]), __fmul_rn(wx1, xv[3]));
  return __fadd_rn(__fmul_rn(g.wy[0], row0), __fmul_rn(g.wy[1], row1));
}

// ---------------------------------------------------------------------------
// Forward. grid (tiles, ceil(Cout / 64)), NT threads.

template <typename T, bool SEP>
__device__ __forceinline__ void fwd_body(unsigned char* smem, const T* __restrict__ x,
                                         const float* __restrict__ offset,
                                         const float* __restrict__ mask,
                                         const T* __restrict__ weight, T* __restrict__ out,
                                         int H, int W, int C, int Cout, int r, int cc, bool vec16) {
  const int s = r + 2;
  const int WW = TW + 2 * s;
  T* s_x = reinterpret_cast<T*>(smem);
  float* s_samp = reinterpret_cast<float*>(smem + window_bytes(r, cc, sizeof(T)));  // TP x (cc+1)
  float* s_w = s_samp + TP * (cc + 1);                                               // cc x TO
  Geo* s_geo = reinterpret_cast<Geo*>(s_w + cc * TO);                                // TP

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // output channels tx*4 .. tx*4+3
  const int ty = tid / 16;  // pixels ty*4 .. ty*4+3
  const Tile tl = tile_of(blockIdx.x, H, W);
  const int o0 = blockIdx.y * TO;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int c0 = 0; c0 < C; c0 += cc) {
    __syncthreads();  // the previous chunk's readers of s_x are done
    stage_window(s_x, x, tl, H, W, C, c0, cc, s, vec16);
    for (int t = 0; t < KK; ++t) {
      if (tid < TP) {
        const int y = tl.y0 + tid / TW;
        const int xx = tl.x0 + tid % TW;
        s_geo[tid] = (y < H && xx < W) ? tap_geometry<SEP>(offset, mask, tl, y, xx, t, H, W, r)
                                       : empty_geometry();
      }
      for (int i = tid; i < cc * TO; i += NT) {
        const int c = c0 + i / TO;
        const int o = o0 + i % TO;
        s_w[i] = (c < C && o < Cout) ? to_f(weight[((size_t)t * C + c) * Cout + o]) : 0.f;
      }
      __syncthreads();
      for (int i = tid; i < TP * cc; i += NT) {
        const int p = i / cc;
        const int c = i % cc;
        const Geo g = s_geo[p];
        float wx0 = g.wx[0], wx1 = g.wx[1];
        if (SEP && sizeof(T) == 2) {  // K2 rounds the x weights to the input type
          wx0 = round_bf16(wx0);
          wx1 = round_bf16(wx1);
        }
        float xv[4];
        float ms = __fmul_rn(sample(s_x, g, wx0, wx1, c, cc, WW, xv), g.m);
        if (!SEP && sizeof(T) == 2) ms = round_bf16(ms);  // K3 rounds the sample
        s_samp[p * (cc + 1) + c] = ms;
      }
      __syncthreads();
      for (int k = 0; k < cc; ++k) {
        const float4 bw = *reinterpret_cast<const float4*>(&s_w[k * TO + tx * 4]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float a = s_samp[(ty * 4 + i) * (cc + 1) + k];
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
    const int p = ty * 4 + i;
    const int y = tl.y0 + p / TW;
    const int xx = tl.x0 + p % TW;
    if (y >= H || xx >= W) continue;
    const size_t q = ((size_t)tl.b * H + y) * W + xx;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int o = o0 + tx * 4 + j;
      if (o < Cout) out[q * Cout + o] = from_f<T>(acc[i][j]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(NT)
dcn_window_forward_kernel(const T* __restrict__ x, const float* __restrict__ offset,
                          const float* __restrict__ mask, const T* __restrict__ weight,
                          T* __restrict__ out, int H, int W, int C, int Cout, int r, int cc,
                          int vec16) {
  extern __shared__ __align__(16) unsigned char smem[];
  fwd_body<T, false>(smem, x, offset, mask, weight, out, H, W, C, Cout, r, cc, vec16 != 0);
}

template <typename T>
__global__ void __launch_bounds__(NT)
dcn_separable_forward_kernel(const T* __restrict__ x, const float* __restrict__ offset,
                             const float* __restrict__ mask, const T* __restrict__ weight,
                             T* __restrict__ out, int H, int W, int C, int Cout, int r, int cc,
                             int vec16) {
  extern __shared__ __align__(16) unsigned char smem[];
  fwd_body<T, true>(smem, x, offset, mask, weight, out, H, W, C, Cout, r, cc, vec16 != 0);
}

// ---------------------------------------------------------------------------
// Backward. grid (tile groups, 9 taps, chunk pairs), NT threads. dx
// (B, H, W, C), dweight (9, C, Cout), doffset and dmask are fp64 sums the
// caller zeroes.

template <typename T, bool SEP>
__device__ __forceinline__ void bwd_body(unsigned char* smem, const T* __restrict__ x,
                                         const float* __restrict__ offset,
                                         const float* __restrict__ mask,
                                         const T* __restrict__ weight, const T* __restrict__ g,
                                         double* __restrict__ dx, double* __restrict__ doffset,
                                         double* __restrict__ dmask, double* __restrict__ dweight,
                                         int B, int H, int W, int C, int Cout, int r, int cc,
                                         bool vec16) {
  const int s = r + 2;
  const int WW = TW + 2 * s;
  // the block's channels cb0 .. cb0 + Cb - 1 and out channels ob0 .. ob0 + Ob - 1
  const int nob = (Cout + BWD_CHUNK - 1) / BWD_CHUNK;
  const int cb0 = (int)(blockIdx.z / nob) * BWD_CHUNK;
  const int ob0 = (int)(blockIdx.z % nob) * BWD_CHUNK;
  const int Cb = min(BWD_CHUNK, C - cb0);
  const int Ob = min(BWD_CHUNK, Cout - ob0);
  T* s_x = reinterpret_cast<T*>(smem);
  float* s_w = reinterpret_cast<float*>(smem + window_bytes(r, cc, sizeof(T)));  // Cb x (Ob+1)
  float* s_dw = s_w + Cb * (Ob + 1);    // Cb x Ob, this block's dW_t chunk
  float* s_g = s_dw + Cb * Ob;          // TP x Ob
  float* s_gs = s_g + TP * Ob;          // TP x cc, g . W_t^T of the chunk
  float* s_ms = s_gs + TP * cc;         // TP x cc, mask * sample
  float* s_cg = s_ms + TP * cc;         // TP x 4, gs . x_corner over the chunks so far
  Geo* s_geo = reinterpret_cast<Geo*>(s_cg + 4 * TP);

  const int t = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int ntiles = B * ((H + TH - 1) / TH) * ((W + TW - 1) / TW);

  for (int i = tid; i < Cb * Ob; i += NT) {
    s_w[(i / Ob) * (Ob + 1) + i % Ob] =
        to_f(weight[((size_t)t * C + cb0 + i / Ob) * Cout + ob0 + i % Ob]);
    s_dw[i] = 0.f;
  }

  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const Tile tl = tile_of(tile, H, W);
    __syncthreads();  // the previous tile's readers of s_g, s_geo and s_cg are done
    for (int i = tid; i < TP * Ob; i += NT) {
      const int p = i / Ob;
      const int y = tl.y0 + p / TW;
      const int xx = tl.x0 + p % TW;
      s_g[i] = (y < H && xx < W)
                   ? to_f(g[(((size_t)tl.b * H + y) * W + xx) * Cout + ob0 + i % Ob])
                   : 0.f;
    }
    if (tid < TP) {
      const int y = tl.y0 + tid / TW;
      const int xx = tl.x0 + tid % TW;
      s_geo[tid] = (y < H && xx < W) ? tap_geometry<SEP>(offset, mask, tl, y, xx, t, H, W, r)
                                     : empty_geometry();
#pragma unroll
      for (int k = 0; k < 4; ++k) s_cg[tid * 4 + k] = 0.f;
    }
    // window chunks of cc channels (a power of two of at most 64, so none
    // straddles two blocks' chunks)
    for (int c0 = cb0; c0 < cb0 + Cb; c0 += cc) {
      stage_window(s_x, x, tl, H, W, C, c0, cc, s, vec16);  // ends with a barrier
      // the block's part of gs = g . W_t^T for the chunk's channels
      for (int i = tid; i < TP * cc; i += NT) {
        const int c = c0 + i % cc;
        float acc = 0.f;
        if (c < C) {
          const float* gr = s_g + (i / cc) * Ob;
          const float* wr = s_w + (c - cb0) * (Ob + 1);
          for (int o = 0; o < Ob; ++o) acc = fmaf(gr[o], wr[o], acc);
        }
        s_gs[i] = acc;
      }
      __syncthreads();

      // a warp per pixel, lanes over the chunk's channels
      for (int pi = warp; pi < TP; pi += NT / 32) {
        const int y = tl.y0 + pi / TW;
        const int xx = tl.x0 + pi % TW;
        if (y >= H || xx >= W) {
          for (int c = lane; c < cc; c += 32) s_ms[pi * cc + c] = 0.f;
          continue;
        }
        const Geo gg = s_geo[pi];
        float cg[4] = {0.f, 0.f, 0.f, 0.f};
        for (int c = lane; c < cc; c += 32) {
          const float gsv = s_gs[pi * cc + c];
          float xv[4];
          const float samp = sample(s_x, gg, gg.wx[0], gg.wx[1], c, cc, WW, xv);
          s_ms[pi * cc + c] = samp * gg.m;
#pragma unroll
          for (int k = 0; k < 4; ++k) cg[k] = fmaf(gsv, xv[k], cg[k]);
          if (c0 + c >= C) continue;
          const float gsm = gsv * gg.m;
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int yy = gg.y0 + (k >> 1);
            const int xc = gg.x0 + (k & 1);
            const float wk = gg.wy[k >> 1] * gg.wx[k & 1];
            if (yy >= 0 && yy < H && xc >= 0 && xc < W && wk != 0.f)
              atomicAdd(dx + (((size_t)tl.b * H + yy) * W + xc) * C + c0 + c,
                        (double)(wk * gsm));
          }
        }
#pragma unroll
        for (int k = 0; k < 4; ++k)
#pragma unroll
          for (int sh = 16; sh > 0; sh >>= 1) cg[k] += __shfl_xor_sync(0xffffffffu, cg[k], sh);
        if (lane == 0)
#pragma unroll
          for (int k = 0; k < 4; ++k) s_cg[pi * 4 + k] += cg[k];
      }
      __syncthreads();

      // dW_t += (m sample)^T g for the chunk's channels
      for (int i = tid; i < cc * Ob; i += NT) {
        const int c = c0 + i / Ob;
        if (c >= C) continue;
        const int o = i % Ob;
        float acc = s_dw[(c - cb0) * Ob + o];
        for (int p = 0; p < TP; ++p) acc = fmaf(s_ms[p * cc + i / Ob], s_g[p * Ob + o], acc);
        s_dw[(c - cb0) * Ob + o] = acc;
      }
      __syncthreads();  // s_x, s_gs and s_ms are free for the next chunk
    }

    // dmask and doffset of the tile's pixels from the hat and its derivative
    if (tid < TP) {
      const int y = tl.y0 + tid / TW;
      const int xx = tl.x0 + tid % TW;
      if (y < H && xx < W) {
        const Geo gg = s_geo[tid];
        const float* cg = s_cg + tid * 4;  // index 2a + b: row a, column b
        float dm = 0.f, doy = 0.f, dox = 0.f;
        if (SEP) {  // deform_mxu.py: doffy over the x-passed rows, doffx via dWx per column
          for (int a = 0; a < 2; ++a) {
            const float u = gg.wx[0] * cg[2 * a] + gg.wx[1] * cg[2 * a + 1];
            doy += gg.dwy[a] * u;
            dm += gg.wy[a] * u;
          }
          for (int bx = 0; bx < 2; ++bx)
            dox += gg.dwx[bx] * (gg.wy[0] * cg[bx] + gg.wy[1] * cg[2 + bx]);
        } else {  // deform_pallas.py: both over the four window terms
          for (int k = 0; k < 4; ++k) {
            const int a = k >> 1, bx = k & 1;
            dm += gg.wy[a] * gg.wx[bx] * cg[k];
            doy += gg.dwy[a] * gg.wx[bx] * cg[k];
            dox += gg.wy[a] * gg.dwx[bx] * cg[k];
          }
        }
        const size_t p = ((size_t)tl.b * H + y) * W + xx;
        atomicAdd(dmask + p * KK + t, (double)dm);
        atomicAdd(doffset + p * 18 + 2 * t, (double)(gg.gy * (gg.m * doy)));
        atomicAdd(doffset + p * 18 + 2 * t + 1, (double)(gg.gx * (gg.m * dox)));
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < Cb * Ob; i += NT)
    atomicAdd(dweight + ((size_t)t * C + cb0 + i / Ob) * Cout + ob0 + i % Ob, (double)s_dw[i]);
}

template <typename T>
__global__ void __launch_bounds__(NT)
dcn_window_backward_kernel(const T* __restrict__ x, const float* __restrict__ offset,
                           const float* __restrict__ mask, const T* __restrict__ weight,
                           const T* __restrict__ g, double* __restrict__ dx,
                           double* __restrict__ doffset, double* __restrict__ dmask,
                           double* __restrict__ dweight, int B, int H, int W, int C, int Cout,
                           int r, int cc, int vec16) {
  extern __shared__ __align__(16) unsigned char smem[];
  bwd_body<T, false>(smem, x, offset, mask, weight, g, dx, doffset, dmask, dweight, B, H, W, C,
                     Cout, r, cc, vec16 != 0);
}

template <typename T>
__global__ void __launch_bounds__(NT)
dcn_separable_backward_kernel(const T* __restrict__ x, const float* __restrict__ offset,
                              const float* __restrict__ mask, const T* __restrict__ weight,
                              const T* __restrict__ g, double* __restrict__ dx,
                              double* __restrict__ doffset, double* __restrict__ dmask,
                              double* __restrict__ dweight, int B, int H, int W, int C, int Cout,
                              int r, int cc, int vec16) {
  extern __shared__ __align__(16) unsigned char smem[];
  bwd_body<T, true>(smem, x, offset, mask, weight, g, dx, doffset, dmask, dweight, B, H, W, C,
                    Cout, r, cc, vec16 != 0);
}

// ---------------------------------------------------------------------------
// Launchers.

template <typename T>
using FwdKernel = void (*)(const T*, const float*, const float*, const T*, T*, int, int, int, int,
                           int, int, int);

template <typename T>
int launch_fwd(FwdKernel<T> kernel, const void* x, const void* offset, const void* mask,
               const void* weight, void* out, int B, int H, int W, int C, int Cout, int r, int cc,
               int vec16, cudaStream_t st) {
  const size_t smem = fwd_smem(r, cc, sizeof(T));
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int ntiles = B * ((H + TH - 1) / TH) * ((W + TW - 1) / TW);
  const dim3 grid(ntiles, (Cout + TO - 1) / TO);
  kernel<<<grid, NT, smem, st>>>(static_cast<const T*>(x), static_cast<const float*>(offset),
                                 static_cast<const float*>(mask), static_cast<const T*>(weight),
                                 static_cast<T*>(out), H, W, C, Cout, r, cc, vec16);
  return (int)cudaGetLastError();
}

template <typename T>
using BwdKernel = void (*)(const T*, const float*, const float*, const T*, const T*, double*,
                           double*, double*, double*, int, int, int, int, int, int, int, int);

template <typename T>
int launch_bwd(BwdKernel<T> kernel, const void* x, const void* offset, const void* mask,
               const void* weight, const void* g, void* dx, void* doffset, void* dmask,
               void* dweight, int B, int H, int W, int C, int Cout, int r, int cc, int vec16,
               cudaStream_t st) {
  const size_t smem = bwd_smem(r, C, Cout, cc, sizeof(T));
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int ntiles = B * ((H + TH - 1) / TH) * ((W + TW - 1) / TW);
  const int pairs = ((C + BWD_CHUNK - 1) / BWD_CHUNK) * ((Cout + BWD_CHUNK - 1) / BWD_CHUNK);
  const dim3 grid(ntiles < BWD_TILE_GROUPS ? ntiles : BWD_TILE_GROUPS, KK, pairs);
  kernel<<<grid, NT, smem, st>>>(
      static_cast<const T*>(x), static_cast<const float*>(offset),
      static_cast<const float*>(mask), static_cast<const T*>(weight), static_cast<const T*>(g),
      static_cast<double*>(dx), static_cast<double*>(doffset), static_cast<double*>(dmask),
      static_cast<double*>(dweight), B, H, W, C, Cout, r, cc, vec16);
  return (int)cudaGetLastError();
}

using bf16 = __nv_bfloat16;

}  // namespace

extern "C" {

// Shared memory (bytes) one block needs: backward 0 = forward, 1 = backward;
// cc = channels per chunk; dtype 0 = fp32, 1 = bf16.
size_t dcn_window_smem_bytes(int backward, int radius, int C, int Cout, int cc, int dtype) {
  const int itemsize = dtype == 0 ? 4 : 2;
  return backward ? bwd_smem(radius, C, Cout, cc, itemsize) : fwd_smem(radius, cc, itemsize);
}

// Forward entries: out (B, H, W, Cout) in the working type. dtype: 0 = fp32,
// 1 = bf16 (x, weight and out). vec16: 16-byte cp.async staging (x's rows
// 16-byte aligned and cc * itemsize a multiple of 16). Return
// cudaGetLastError().
int dcn_window_forward(const void* x, const void* offset, const void* mask, const void* weight,
                       void* out, int B, int H, int W, int C, int Cout, int radius, int cc,
                       int vec16, int dtype, void* stream) {
  if (B * H * W == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_fwd<float>(dcn_window_forward_kernel<float>, x, offset, mask, weight, out, B, H,
                             W, C, Cout, radius, cc, vec16, st);
  if (dtype == 1)
    return launch_fwd<bf16>(dcn_window_forward_kernel<bf16>, x, offset, mask, weight, out, B, H,
                            W, C, Cout, radius, cc, vec16, st);
  return (int)cudaErrorInvalidValue;
}

int dcn_separable_forward(const void* x, const void* offset, const void* mask,
                          const void* weight, void* out, int B, int H, int W, int C, int Cout,
                          int radius, int cc, int vec16, int dtype, void* stream) {
  if (B * H * W == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_fwd<float>(dcn_separable_forward_kernel<float>, x, offset, mask, weight, out,
                             B, H, W, C, Cout, radius, cc, vec16, st);
  if (dtype == 1)
    return launch_fwd<bf16>(dcn_separable_forward_kernel<bf16>, x, offset, mask, weight, out, B,
                            H, W, C, Cout, radius, cc, vec16, st);
  return (int)cudaErrorInvalidValue;
}

// Backward entries: dx (B, H, W, C), dweight (9, C, Cout), doffset
// (B, H, W, 18) and dmask (B, H, W, 9) are fp64 and zeroed by the caller
// (the kernel adds into them). g (B, H, W, Cout) in the working type.
int dcn_window_backward(const void* x, const void* offset, const void* mask, const void* weight,
                        const void* g, void* dx, void* doffset, void* dmask, void* dweight, int B,
                        int H, int W, int C, int Cout, int radius, int cc, int vec16, int dtype,
                        void* stream) {
  if (B * H * W == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_bwd<float>(dcn_window_backward_kernel<float>, x, offset, mask, weight, g, dx,
                             doffset, dmask, dweight, B, H, W, C, Cout, radius, cc, vec16, st);
  if (dtype == 1)
    return launch_bwd<bf16>(dcn_window_backward_kernel<bf16>, x, offset, mask, weight, g, dx,
                            doffset, dmask, dweight, B, H, W, C, Cout, radius, cc, vec16, st);
  return (int)cudaErrorInvalidValue;
}

int dcn_separable_backward(const void* x, const void* offset, const void* mask,
                           const void* weight, const void* g, void* dx, void* doffset,
                           void* dmask, void* dweight, int B, int H, int W, int C, int Cout,
                           int radius, int cc, int vec16, int dtype, void* stream) {
  if (B * H * W == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_bwd<float>(dcn_separable_backward_kernel<float>, x, offset, mask, weight, g, dx,
                             doffset, dmask, dweight, B, H, W, C, Cout, radius, cc, vec16, st);
  if (dtype == 1)
    return launch_bwd<bf16>(dcn_separable_backward_kernel<bf16>, x, offset, mask, weight, g, dx,
                            doffset, dmask, dweight, B, H, W, C, Cout, radius, cc, vec16, st);
  return (int)cudaErrorInvalidValue;
}

const char* yat_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

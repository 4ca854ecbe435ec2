// Modulated deformable convolution (DCNv2) forward and backward for NVIDIA
// Hopper (sm_90a), with the per-tap products on the tensor cores. The
// backward kernel follows the forward below.
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
// (B, H, W, 9) in fp32. The forward takes the weight as ops/deform.py
// k1_fwd_weight lays it out: (9, Cout, Cpad), each tap's slice transposed
// and its input channels zero-padded to a multiple of KC. The backward
// takes it as (9, C, Cout). All sums are fp32.
//
// The TPU kernel builds banded hat-weight matrices because the TPU has no
// per-lane gather; here each corner is a plain load. Forward design: a block
// owns 64 output pixels and up to 64 output channels (more output channels
// take more blocks). All 256 threads first tabulate the 4 corner indices and
// mask * bilinear weights of its pixels for all 9 taps. It then walks
// (tap, 32-channel chunk) steps: the 16-byte corner loads of step s + 1 are
// issued into registers before the products of step s and combined (in
// fp32, rounded once) into the other of two sample buffers after them; the
// weight chunks come by cp.async through a 3-stage ring, two steps ahead;
// one barrier a step. TMA has no gather, and the corner rows are
// data-dependent. The products are mma.sync on the tensor cores with fp32
// accumulators held in registers across all steps: bf16 x bf16 (m16n8k16)
// with the sample rounded to bf16 once, as deform_mxu2.py:145-148 rounds its
// sampled tile; fp32 by 3xTF32 (m16n8k8: a_lo b_hi + a_hi b_lo into one
// accumulator, a_hi b_hi into another, x_lo = tf32(x - tf32(x))), which
// keeps fp32 accuracy (max |kernel - plain| 8.6e-6 at the flagship's
// shapes). mma.sync, not wgmma: a 64-pixel tile fed from registers keeps
// the gather simple; wgmma is the step for the fp32 products (below).
// Shared-memory rows are padded by 4 words so that every fragment load is
// free of bank conflicts.
//
// What bounds it: per 640 image, over the three AYHead levels (80^2, 40^2,
// 20^2 = 8,400 px, C = Cout = 64) the products are ~0.62 GFLOP (2 * 9 * 64 *
// 64 per pixel) and the bytes that must move ~5.2 MB in fp32 (x and out
// 2.15 MB each, offset and mask 0.9 MB): bound by the tensor cores' rate
// (0.14 ms at batch 32 by 3xTF32, 0.02 ms at batch 16 in bf16). On the card
// (H100 80GB HBM3, 700 W; engine/profile_dcn.py --tree-split, device time)
// it takes 0.98 ms fp32 at batch 32 and 0.31 ms bf16 at batch 16: without
// its corner reads 0.82 / 0.16 ms (in fp32 the 3xTF32 mma.sync products,
// three tf32 mma for each one), without its products 0.51 / 0.19 ms (the
// gather of 4 corner rows a sample from L2: 2.5 GB at batch 32 in fp32).
// -Xptxas -v (sm_90a, 16-byte loads): 126 registers fp32, 120 bf16, no
// spills; 64,512 / 44,032 bytes of shared memory at Cout = 64.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int KK = 9;     // taps
constexpr int NT = 256;   // threads: 8 warps
constexpr int TP = 64;    // output pixels per tile (4 mma row tiles of 16)
constexpr int KC = 32;    // input channels per forward step
constexpr int NMAX = 64;  // output channels per forward block
constexpr int NS = 3;     // stages of the forward's weight-chunk ring

// storage of one element: fp32, or the bits of a bf16
template <bool BF> struct Elt;
template <> struct Elt<false> {
  using S = float;
  static __device__ __forceinline__ float f(float v) { return v; }
  static __device__ __forceinline__ float from(float v) { return v; }
};
template <> struct Elt<true> {
  using S = unsigned short;
  static __device__ __forceinline__ float f(unsigned short v) {
    return __uint_as_float((unsigned)v << 16);
  }
  static __device__ __forceinline__ unsigned short from(float v) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
};

// VEC elements loaded or stored as one (16 bytes when VEC * sizeof(S) = 16)
template <typename S, int VEC>
struct alignas(sizeof(S) * VEC) Pack {
  S v[VEC];
};

__host__ __device__ constexpr int round_up(int v, int m) { return (v + m - 1) / m * m; }

// ---- tensor-core helpers ----------------------------------------------------

__device__ __forceinline__ uint32_t to_tf32(float f) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(f));
  return r;
}

// f = hi + lo to 22 bits: both halves as tf32 operands
__device__ __forceinline__ void split_tf32(float f, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(f);
  lo = to_tf32(f - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// a b by 3xTF32: a_hi b_hi into d, the two small terms into d2 (d itself,
// or a second accumulator so that the products form two dependency
// chains); a split (hi, lo) by the caller once for all the n-tiles it
// meets, b an fp32 fragment split here
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], float (&d2)[4],
                                           const uint32_t (&ah)[4], const uint32_t (&al)[4],
                                           float b0f, float b1f) {
  uint32_t bh[2], bl[2];
  split_tf32(b0f, bh[0], bl[0]);
  split_tf32(b1f, bh[1], bl[1]);
  mma_tf32(d2, al[0], al[1], al[2], al[3], bh[0], bh[1]);
  mma_tf32(d2, ah[0], ah[1], ah[2], ah[3], bl[0], bl[1]);
  mma_tf32(d, ah[0], ah[1], ah[2], ah[3], bh[0], bh[1]);
}

// the four fp32 a-fragment values, split
__device__ __forceinline__ void split4(float a0, float a1, float a2, float a3, uint32_t (&ah)[4],
                                       uint32_t (&al)[4]) {
  split_tf32(a0, ah[0], al[0]);
  split_tf32(a1, ah[1], al[1]);
  split_tf32(a2, ah[2], al[2]);
  split_tf32(a3, ah[3], al[3]);
}

__device__ __forceinline__ uint32_t pack2(unsigned short lo, unsigned short hi) {
  return (uint32_t)lo | ((uint32_t)hi << 16);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  const int n = valid ? 16 : 0;  // 0: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
// 8 or 4 bytes (zero-filled where !valid), through L1
template <int BYTES>
__device__ __forceinline__ void cp_async_small(void* smem, const void* gmem, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  const int n = valid ? BYTES : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s), "l"(gmem), "n"(BYTES),
               "r"(n));
}
template <int N>  // at most N of this thread's commit groups still in flight
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ---- forward ----------------------------------------------------------------

// 32-bit words of a forward shared-memory row (KC channels + 4 words of pad)
template <bool BF>
__host__ __device__ constexpr int fwd_row_words() {
  return KC * (BF ? 2 : 4) / 4 + 4;
}

size_t fwd_smem_bytes(int Cout, bool bf) {
  const int np = round_up(Cout < NMAX ? Cout : NMAX, 16);
  const int rw = bf ? fwd_row_words<true>() : fwd_row_words<false>();
  const size_t words = (size_t)NS * np * rw     // weight chunks
                       + (size_t)2 * TP * rw      // samples
                       + (size_t)KK * TP * 4 * 2; // corner tables
  return 4 * words;
}

// the 4 corners of pixel p at tap t: flat pixel index (-1 outside) and
// mask * bilinear weight
__device__ __forceinline__ void corners(const float* __restrict__ offset,
                                        const float* __restrict__ mask, int p, int t, int npix,
                                        int H, int W, float radius, int (&idx)[4],
                                        float (&cw)[4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    idx[k] = -1;
    cw[k] = 0.f;
  }
  if (p >= npix) return;
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
  if (!(cy > -1.f && cy < (float)H && cx > -1.f && cx < (float)W)) return;
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

// BF: bf16 (else fp32); VEC: channels a corner load takes (16 bytes), or 1
// where C or the pointer does not allow 16-byte loads
template <bool BF, int VEC>
__global__ void __launch_bounds__(NT, 2)
dcn_fwd_kernel(const typename Elt<BF>::S* __restrict__ x, const float* __restrict__ offset,
               const float* __restrict__ mask, const typename Elt<BF>::S* __restrict__ wt,
               typename Elt<BF>::S* __restrict__ out, int npix, int H, int W, int C, int Cout,
               int Cpad, float radius) {
  using S = typename Elt<BF>::S;
  using P = Pack<S, VEC>;
  constexpr int RW = fwd_row_words<BF>();   // words per shared row
  constexpr int EPW = BF ? 2 : 1;           // elements per 32-bit word
  constexpr int CV = 16 / sizeof(S);        // elements in 16 bytes
  constexpr int PR = KC / CV;               // 16-byte pieces in a row's KC channels
  constexpr int VPR = KC / VEC;             // corner loads per pixel and step
  constexpr int ITEMS = TP * VPR / NT;      // (pixel, load) items per thread
  constexpr int NTW = NMAX / 16;            // n-tiles of 8 a warp owns, at most
  static_assert(TP * VPR % NT == 0, "items must divide over the threads");

  const int np = round_up(min(Cout - (int)blockIdx.y * NMAX, NMAX), 16);
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* s_b = smem;                            // [NS][np][RW] weight, rows = out ch
  uint32_t* s_a = s_b + NS * np * RW;              // [2][TP][RW] modulated samples
  int* s_idx = reinterpret_cast<int*>(s_a + 2 * TP * RW);  // [KK][TP][4]
  float* s_cw = reinterpret_cast<float*>(s_idx + KK * TP * 4);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2, tg = lane & 3;
  const int p0 = blockIdx.x * TP;
  const int o0 = blockIdx.y * NMAX;
  const int m0 = (warp & 3) * 16;               // the warp's 16 pixels
  const int nb = (warp >> 2) * (np / 2);        // and its half of the out channels
  const int ntw = np / 16;                      // n-tiles of 8 in that half
  const int nkc = Cpad / KC;
  const int steps = KK * nkc;

  for (int i = tid; i < KK * TP; i += NT) {
    const int t = i / TP, pp = i % TP;
    int idx[4];
    float cw[4];
    corners(offset, mask, p0 + pp, t, npix, H, W, radius, idx, cw);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      s_idx[i * 4 + k] = idx[k];
      s_cw[i * 4 + k] = cw[k];
    }
  }

  // the weight chunk of step s (tap s / nkc, channels (s % nkc) * KC ..)
  // into ring stage s % NS by cp.async; one commit group a step, empty past
  // the last
  auto stage_w = [&](int s) {
    if (s < steps) {
      const int t = s / nkc, c0 = (s % nkc) * KC;
      uint32_t* b = s_b + (s % NS) * np * RW;
      for (int i = tid; i < np * PR; i += NT) {
        const int n = i / PR, pc = i % PR;
        const bool valid = o0 + n < Cout;
        const S* src = valid ? wt + ((size_t)t * Cout + o0 + n) * Cpad + c0 + pc * CV : wt;
        cp_async16(b + n * RW + pc * 4, src, valid);
      }
    }
    cp_async_commit();
  };
  P raw[ITEMS][4];
  auto issue = [&](int s) {  // the corner loads of step s, into registers
    const int t = s / nkc, c0 = (s % nkc) * KC;
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      const int it = tid + j * NT;
      const int pp = it / VPR;
      const int c = c0 + (it % VPR) * VEC;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int q = s_idx[(t * TP + pp) * 4 + k];
        if (q >= 0 && c < C) {
          raw[j][k] = *reinterpret_cast<const P*>(x + (size_t)q * C + c);
        } else {
#pragma unroll
          for (int e = 0; e < VEC; ++e) raw[j][k].v[e] = S(0);
        }
      }
    }
  };
  auto combine = [&](int s) {  // fp32 sum of the 4 corners, rounded once
    const int t = s / nkc;
    S* a = reinterpret_cast<S*>(s_a + (s & 1) * TP * RW);
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      const int it = tid + j * NT;
      const int pp = it / VPR;
      const int cl = (it % VPR) * VEC;
      float cw[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) cw[k] = s_cw[(t * TP + pp) * 4 + k];
      P o;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        float v = 0.f;
#pragma unroll
        for (int k = 0; k < 4; ++k) v = fmaf(cw[k], Elt<BF>::f(raw[j][k].v[e]), v);
        o.v[e] = Elt<BF>::from(v);
      }
      *reinterpret_cast<P*>(a + pp * RW * EPW + cl) = o;
    }
  };

  // fp32: the two small 3xTF32 terms go to acc2, so that a tile's three
  // products form two dependency chains instead of one
  float acc[NTW][4], acc2[NTW][4];
#pragma unroll
  for (int j = 0; j < NTW; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = acc2[j][i] = 0.f;

  for (int s = 0; s < NS - 1; ++s) stage_w(s);
  __syncthreads();  // corner tables
  issue(0);
  combine(0);
  cp_async_wait<NS - 2>();  // the weight of step 0
  __syncthreads();

  for (int s = 0; s < steps; ++s) {
    const bool next = s + 1 < steps;
    // stage (s - 1) % NS was last read by step s - 1's products, before the
    // barrier that ended it
    stage_w(s + NS - 1);
    if (next) issue(s + 1);  // in flight over the products of step s
    const uint32_t* a = s_a + (s & 1) * TP * RW;
    const uint32_t* b = s_b + (s % NS) * np * RW;
    if constexpr (BF) {
#pragma unroll
      for (int kw = 0; kw < KC / 2; kw += 8) {  // k16 = 8 words
        const uint32_t a0 = a[(m0 + g) * RW + kw + tg], a1 = a[(m0 + g + 8) * RW + kw + tg];
        const uint32_t a2 = a[(m0 + g) * RW + kw + tg + 4];
        const uint32_t a3 = a[(m0 + g + 8) * RW + kw + tg + 4];
#pragma unroll
        for (int j = 0; j < NTW; ++j) {
          if (j < ntw) {
            const int n = nb + j * 8 + g;
            mma_bf16(acc[j], a0, a1, a2, a3, b[n * RW + kw + tg], b[n * RW + kw + tg + 4]);
          }
        }
      }
    } else {
      const float* af = reinterpret_cast<const float*>(a);
      const float* bf = reinterpret_cast<const float*>(b);
#pragma unroll
      for (int k = 0; k < KC; k += 8) {
        uint32_t ah[4], al[4];
        split4(af[(m0 + g) * RW + k + tg], af[(m0 + g + 8) * RW + k + tg],
               af[(m0 + g) * RW + k + tg + 4], af[(m0 + g + 8) * RW + k + tg + 4], ah, al);
#pragma unroll
        for (int j = 0; j < NTW; ++j) {
          if (j < ntw) {
            const int n = (nb + j * 8 + g) * RW + k + tg;
            mma_3xtf32(acc[j], acc2[j], ah, al, bf[n], bf[n + 4]);
          }
        }
      }
    }
    if (next) combine(s + 1);  // samples buffer (s + 1) & 1, last read by step s - 1
    cp_async_wait<NS - 2>();   // the weight of step s + 1
    __syncthreads();
  }
  cp_async_wait<0>();  // no copy outlives the block

#pragma unroll
  for (int j = 0; j < NTW; ++j) {
    if (j >= ntw) continue;
    if constexpr (!BF) {
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][i] += acc2[j][i];
    }
    const int o = o0 + nb + j * 8 + 2 * tg;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = p0 + m0 + g + 8 * h;
      if (p >= npix) continue;
      if (o < Cout) out[(size_t)p * Cout + o] = Elt<BF>::from(acc[j][2 * h]);
      if (o + 1 < Cout) out[(size_t)p * Cout + o + 1] = Elt<BF>::from(acc[j][2 * h + 1]);
    }
  }
}

template <bool BF, int VEC>
int launch_fwd(const void* x, const void* offset, const void* mask, const void* wt, void* out,
               int npix, int H, int W, int C, int Cout, int Cpad, float radius, cudaStream_t s) {
  using S = typename Elt<BF>::S;
  const size_t smem = fwd_smem_bytes(Cout, BF);
  const dim3 grid((npix + TP - 1) / TP, (Cout + NMAX - 1) / NMAX);
  cudaError_t err = cudaFuncSetAttribute(dcn_fwd_kernel<BF, VEC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dcn_fwd_kernel<BF, VEC><<<grid, NT, smem, s>>>(
      static_cast<const S*>(x), static_cast<const float*>(offset),
      static_cast<const float*>(mask), static_cast<const S*>(wt), static_cast<S*>(out), npix, H,
      W, C, Cout, Cpad, radius);
  return (int)cudaGetLastError();
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
//   dW_t          += (m sampled_t)^T g                      (fp64, once a block)
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
// W_t (C x Cout) in shared memory once and walks 64-pixel tiles; the next
// tile's g, offsets and mask come by cp.async while it works on one. Per
// tile it forms gs = g . W_t^T on the tensor cores, then each group of
// lanes takes a pixel with its lanes over 16-byte channel vectors: it loads
// the four corner rows, writes m * sampled to shared memory and reduces the
// four corner dot products over the group into dmask and doffset; then
// scatters dx with fp64 atomics, lanes over consecutive channels so that an
// atomic instruction covers whole 32-byte sectors (a corner of weight 0
// adds nothing and is skipped). Last, dW_t += (m sampled)^T g on the tensor cores, into
// accumulators that stay in registers over all the block's tiles and are
// added into the global fp64 dW once. The products run as the TPU kernel's
// do (deform_mxu2.py:207-210,272-275): bf16 operands for bf16 inputs (m *
// sampled rounded to bf16), fp32 accumulation; fp32 by 3xTF32. dx and dW
// are summed in an order that changes from run to run, so both sums are
// kept in fp64 and rounded to fp32 once, by the wrapper: two runs then give
// the same fp32 gradient but where an fp64 sum lies within its own rounding
// of an fp32 rounding boundary.
//
// What bounds it: the per-tap products g . W_t^T and (m sampled)^T g are
// 4 C Cout flops per pixel and tap (~1.3 GFLOP per 640 image over the three
// levels at C = Cout = 64); the bytes (x, offset, mask, g read, dx, doffset,
// dmask written) are ~8.3 MB per image in fp32: bound by the tensor cores'
// rate (0.15 ms at batch 16 by 3xTF32, 0.05 ms in bf16). On the card (H100
// 80GB HBM3, 700 W; engine/profile_dcn.py --tree-split, device time, batch
// 16) it takes 1.81 ms fp32 and 1.38 ms bf16: the products alone 0.88 /
// 0.28 ms, the corner work with the dx scatter 1.33 / 1.31, without the
// scatter 0.67 / 0.46. The scatter is 4 C fp64 atomic adds a sample (310 M
// a backward over the three levels), at about the L2's atomic rate; with a
// block per tap a shared-memory window would merge only the few corners
// that one tap's neighbouring pixels share, so the cut left for later is a
// block over all 9 taps of a tile summing dx in a window, with dW in a
// second pass.
//
// Past 128 channels (the flagship's DCN at scales m, l and x: C = Cout = 256
// or 384) dW_t no longer fits in a block's registers. The kernel is then
// launched WIDE, with a third grid dimension over (C-chunk, Cout-chunk)
// pairs of at most 128 x 128: each block runs the body above on its chunk
// pair, on strided views of x, g and W. Every gradient is bilinear in the
// pair: gs = g . W_t^T is a sum over the Cout chunks, dmask and doffset sums
// over both, and dW_t's chunk is its own block's. So dx takes the partial
// gs of each Cout chunk (fp64 atomics, as always), doffset and dmask add
// their partials into fp64 buffers that the wrapper rounds once (so a wide
// fp32 backward repeats like the narrow one), and dW_t is whole. The price
// is the corner gather and the dx scatter repeated once per Cout chunk: at
// C = Cout = 384, 3 times; a later PR may split gs from dW_t to avoid it.
// -Xptxas -v (sm_90a, 16-byte loads, C, Cout <= 64): 128 registers fp32
// and bf16, no spills; 89,088 / 56,320 bytes of shared memory. Above 64
// channels the bf16 variant spills (255 registers, 280 bytes).

constexpr int BWD_TILE_GROUPS = 64;  // tile groups per tap (grid.x upper bound)
constexpr int BWD_CMAX = 128;        // C and Cout a block takes: dW_t in mma accumulators

// doffset and dmask: fp32, written once; or (WIDE) fp64 sums of the chunk
// pairs' partials
template <bool WIDE>
using GradOut = typename std::conditional<WIDE, double, float>::type;

struct BwdLayout {  // shared-memory rows of the backward, in 32-bit words
  int cpn, cok;     // C and Cout padded to 16 (mma n / k multiples)
  int rw_o;         // s_w and s_g rows: Cout values + 4 words
  int rw_c;         // s_ms rows: C values + 4 words
  int rw_s;         // s_gs rows (fp32): C values + 4 (two g tiles: prefetch)
  __host__ __device__ BwdLayout(int C, int Cout, bool bf) {
    cpn = round_up(C, 16);
    cok = round_up(Cout, 16);
    rw_o = cok * (bf ? 2 : 4) / 4 + 4;
    rw_c = cpn * (bf ? 2 : 4) / 4 + 4;
    rw_s = cpn + 4;
  }
  __host__ __device__ size_t words() const {
    return (size_t)cpn * rw_o + (size_t)2 * TP * rw_o + (size_t)TP * rw_s + (size_t)TP * rw_c +
           (size_t)2 * TP * 4;
  }
};

size_t bwd_smem_bytes(int C, int Cout, bool bf) { return 4 * BwdLayout(C, Cout, bf).words(); }

// copy rows x cols elements (row stride ld in global) into shared rows of
// rw words, zero beyond (rows_valid, cols_valid) up to (rows, cols_pad)
template <bool BF>
__device__ __forceinline__ void stage_rows(uint32_t* dst, int rw, const typename Elt<BF>::S* src,
                                           size_t ld, int rows, int rows_valid, int cols_pad,
                                           int cols_valid, bool vec16) {
  using S = typename Elt<BF>::S;
  constexpr int V = 16 / sizeof(S);
  if (vec16) {  // cols_valid a multiple of V, src 16-byte aligned
    const int vpr = cols_pad / V;
    for (int i = threadIdx.x; i < rows * vpr; i += NT) {
      const int r = i / vpr, c = (i % vpr) * V;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (r < rows_valid && c < cols_valid) v = *reinterpret_cast<const uint4*>(src + r * ld + c);
      *reinterpret_cast<uint4*>(dst + r * rw + c * (int)sizeof(S) / 4) = v;
    }
  } else {
    S* d = reinterpret_cast<S*>(dst);
    const int es = rw * 4 / (int)sizeof(S);
    for (int i = threadIdx.x; i < rows * cols_pad; i += NT) {
      const int r = i / cols_pad, c = i % cols_pad;
      d[r * es + c] = (r < rows_valid && c < cols_valid) ? src[r * ld + c] : S(0);
    }
  }
}

// BF: bf16 (else fp32); VEC: channels a corner load takes; BIG: C or Cout
// above 64 (8 n-tiles a warp in gs, a warp per 16 channels of dW over all
// out channels; else 4 n-tiles in gs, and 4 x 2 warps over dW). Registers
// are capped for 2 blocks an SM. WIDE: C or Cout above BWD_CMAX; blockIdx.z
// is the block's (C-chunk, Cout-chunk) pair (see above). C and Cout are
// the full widths, the row strides of x, g, W, dx and dW.
template <bool BF, int VEC, bool BIG, bool WIDE>
__global__ void __launch_bounds__(NT, BIG ? 1 : 2)
dcn_bwd_kernel(const typename Elt<BF>::S* __restrict__ x, const float* __restrict__ offset,
               const float* __restrict__ mask, const typename Elt<BF>::S* __restrict__ weight,
               const typename Elt<BF>::S* __restrict__ g, double* __restrict__ dx,
               GradOut<WIDE>* __restrict__ doffset, GradOut<WIDE>* __restrict__ dmask,
               double* __restrict__ dweight, int npix, int H, int W, int C, int Cout,
               float radius) {
  using S = typename Elt<BF>::S;
  using P = Pack<S, VEC>;
  constexpr int NTW = BIG ? 8 : 4;    // gs n-tiles a warp
  constexpr int WM = BIG ? 8 : 4;     // dW: warps along the channels (16 each)
  constexpr int MAXT = BIG ? 16 : 4;  // and (8-wide) out-channel tiles a warp
  constexpr int EPW = BF ? 2 : 1;
  // the block's channels c0 .. c0 + Cb - 1 and out channels o0 .. o0 + Ob - 1
  const int nob = WIDE ? (Cout + BWD_CMAX - 1) / BWD_CMAX : 1;
  const int c0 = WIDE ? (int)(blockIdx.z / nob) * BWD_CMAX : 0;
  const int o0 = WIDE ? (int)(blockIdx.z % nob) * BWD_CMAX : 0;
  const int Cb = WIDE ? min(BWD_CMAX, C - c0) : C;
  const int Ob = WIDE ? min(BWD_CMAX, Cout - o0) : Cout;
  const BwdLayout L(Cb, Ob, BF);
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* s_w = smem;                        // [cpn][rw_o]  W_t, zero-padded
  uint32_t* s_g2 = s_w + L.cpn * L.rw_o;       // [2][TP][rw_o] g tiles, zero-padded
  float* s_gs = reinterpret_cast<float*>(s_g2 + 2 * TP * L.rw_o);  // [TP][rw_s]
  uint32_t* s_ms = reinterpret_cast<uint32_t*>(s_gs + TP * L.rw_s);  // [TP][rw_c] m * sampled
  float* s_om = reinterpret_cast<float*>(s_ms + TP * L.rw_c);  // [2][TP][4] dy, dx, mask

  const int t = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gq = lane >> 2, tg = lane & 3;
  const int ntiles = (npix + TP - 1) / TP;
  const bool gvec = (Cout * (int)sizeof(S)) % 16 == 0 && (reinterpret_cast<uintptr_t>(g) & 15) == 0;
  const bool wvec =
      (Cout * (int)sizeof(S)) % 16 == 0 && (reinterpret_cast<uintptr_t>(weight) & 15) == 0;

  stage_rows<BF>(s_w, L.rw_o, weight + ((size_t)t * C + c0) * Cout + o0, Cout, L.cpn, Cb, L.cok,
                 Ob, wvec);

  // the g tile of pixels p0 .. p0 + TP - 1 into buffer buf: by cp.async
  // (zero-filled past npix and Cout) where rows allow 16-byte copies; and
  // the tap's offset and mask of those pixels
  auto stage_g = [&](int p0, int buf) {
    uint32_t* dst = s_g2 + buf * TP * L.rw_o;
    const int rows = min(TP, npix - p0);
    for (int r = tid; r < TP; r += NT) {
      float* om = s_om + (buf * TP + r) * 4;
      const bool valid = r < rows;
      cp_async_small<8>(om, valid ? offset + (size_t)(p0 + r) * 18 + 2 * t : offset, valid);
      cp_async_small<4>(om + 2, valid ? mask + (size_t)(p0 + r) * KK + t : mask, valid);
    }
    if (gvec) {
      constexpr int V = 16 / sizeof(S);
      const int vpr = L.cok / V;
      for (int i = tid; i < TP * vpr; i += NT) {
        const int r = i / vpr, c = (i % vpr) * V;
        const bool valid = r < rows && c < Ob;
        cp_async16(dst + r * L.rw_o + c / EPW, valid ? g + (size_t)(p0 + r) * Cout + o0 + c : g,
                   valid);
      }
    } else {
      stage_rows<BF>(dst, L.rw_o, g + (size_t)p0 * Cout + o0, Cout, TP, rows, L.cok, Ob, false);
    }
    cp_async_commit();
  };

  // gs: warp -> 16 pixels x half the (padded) channels
  const int gm0 = (warp & 3) * 16;
  const int gnb = (warp >> 2) * (L.cpn / 2);
  const int gntw = L.cpn / 16;
  // dW: warp -> 16 channels (cm) x its share of the out channels (dn0 ..,
  // dnt tiles of 8); the a fragment is loaded once for all of them
  const int cm = (warp % WM) * 16;
  const int dnt = L.cok / 8 / (8 / WM);
  const int dn0 = (warp / WM) * dnt * 8;
  float dw[MAXT][4];
#pragma unroll
  for (int j = 0; j < MAXT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) dw[j][i] = 0.f;

  // corner work: a group of G lanes (a power of two) per pixel
  const int nv = (Cb + VEC - 1) / VEC;
  int G = 1;
  while (G < nv && G < 32) G <<= 1;
  const int ppw = 32 / G;  // pixels a warp takes at once

  if (blockIdx.x < ntiles) stage_g(blockIdx.x * TP, 0);
  for (int tile = blockIdx.x, it = 0; tile < ntiles; tile += gridDim.x, ++it) {
    const int p0 = tile * TP;
    const uint32_t* s_g = s_g2 + (it & 1) * TP * L.rw_o;
    cp_async_wait<0>();
    __syncthreads();  // this tile's g is in; the previous tile's readers are done
    if (tile + gridDim.x < ntiles) stage_g(p0 + gridDim.x * TP, (it + 1) & 1);

    {  // gs = g . W_t^T on the tensor cores
      float acc[NTW][4];
#pragma unroll
      for (int j = 0; j < NTW; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
      if constexpr (BF) {
        for (int kw = 0; kw < L.cok / 2; kw += 8) {
          const uint32_t a0 = s_g[(gm0 + gq) * L.rw_o + kw + tg];
          const uint32_t a1 = s_g[(gm0 + gq + 8) * L.rw_o + kw + tg];
          const uint32_t a2 = s_g[(gm0 + gq) * L.rw_o + kw + tg + 4];
          const uint32_t a3 = s_g[(gm0 + gq + 8) * L.rw_o + kw + tg + 4];
#pragma unroll
          for (int j = 0; j < NTW; ++j) {
            if (j < gntw) {
              const int n = gnb + j * 8 + gq;
              mma_bf16(acc[j], a0, a1, a2, a3, s_w[n * L.rw_o + kw + tg],
                       s_w[n * L.rw_o + kw + tg + 4]);
            }
          }
        }
      } else {
        const float* gf = reinterpret_cast<const float*>(s_g);
        const float* wf = reinterpret_cast<const float*>(s_w);
        for (int k = 0; k < L.cok; k += 8) {
          uint32_t ah[4], al[4];
          split4(gf[(gm0 + gq) * L.rw_o + k + tg], gf[(gm0 + gq + 8) * L.rw_o + k + tg],
                 gf[(gm0 + gq) * L.rw_o + k + tg + 4], gf[(gm0 + gq + 8) * L.rw_o + k + tg + 4],
                 ah, al);
#pragma unroll
          for (int j = 0; j < NTW; ++j) {
            if (j < gntw) {
              const int n = gnb + j * 8 + gq;
              mma_3xtf32(acc[j], acc[j], ah, al, wf[n * L.rw_o + k + tg],
                         wf[n * L.rw_o + k + tg + 4]);
            }
          }
        }
      }
#pragma unroll
      for (int j = 0; j < NTW; ++j) {
        if (j >= gntw) continue;
        const int n = gnb + j * 8 + 2 * tg;
        *reinterpret_cast<float2*>(s_gs + (gm0 + gq) * L.rw_s + n) = make_float2(acc[j][0], acc[j][1]);
        *reinterpret_cast<float2*>(s_gs + (gm0 + gq + 8) * L.rw_s + n) =
            make_float2(acc[j][2], acc[j][3]);
      }
    }
    __syncthreads();

    // corner work: lanes over channel vectors, G lanes a pixel
    for (int pb = warp * ppw; pb < TP; pb += (NT / 32) * ppw) {
      const int pi = pb + lane / G;
      const int sub = lane % G;
      // a pixel past the end keeps its lanes in the shuffles below, with no
      // corner, and writes zeros
      const bool valid = p0 + pi < npix;
      const int p = valid ? p0 + pi : npix - 1;
      S* ms = reinterpret_cast<S*>(s_ms) + pi * L.rw_c * EPW;
      const int xw = p % W;
      const int r = p / W;
      const int yh = r % H;
      const int b = r / H;
      const float* om = s_om + ((it & 1) * TP + pi) * 4;
      float dy = om[0];
      float dxo = om[1];
      float gate_y = 1.f, gate_x = 1.f;
      if (radius >= 0.f) {
        gate_y = fabsf(dy) < radius ? 1.f : 0.f;
        gate_x = fabsf(dxo) < radius ? 1.f : 0.f;
        dy = fminf(fmaxf(dy, -radius), radius);
        dxo = fminf(fmaxf(dxo, -radius), radius);
      }
      const float m = om[2];
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
        const bool in = valid && yy >= 0 && yy < H && xx >= 0 && xx < W;
        idx[k] = in ? (b * H + yy) * W + xx : -1;
        wk[k] = in ? wy[ky] * wx[kx] : 0.f;
        dwy[k] = in ? (ky ? wx[kx] : -wx[kx]) : 0.f;
        dwx[k] = in ? (kx ? wy[ky] : -wy[ky]) : 0.f;
      }
      float a[4] = {0.f, 0.f, 0.f, 0.f};  // sum_c gs[c] x[corner_k, c]
      for (int v = sub; v < nv; v += G) {
        const int c = v * VEC;
        P xv[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (idx[k] >= 0) {
            xv[k] = *reinterpret_cast<const P*>(x + (size_t)idx[k] * C + c0 + c);
          } else {
#pragma unroll
            for (int e = 0; e < VEC; ++e) xv[k].v[e] = S(0);
          }
        }
        P o;
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const float gsv = s_gs[pi * L.rw_s + c + e];
          float samp = 0.f;
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const float xe = Elt<BF>::f(xv[k].v[e]);
            samp = fmaf(wk[k], xe, samp);
            a[k] = fmaf(gsv, xe, a[k]);
          }
          o.v[e] = Elt<BF>::from(m * samp);
        }
        *reinterpret_cast<P*>(ms + c) = o;
      }
      // the dx scatter, lanes over consecutive channels: one atomic
      // instruction covers G consecutive doubles of a corner row
      for (int c = sub; c < Cb; c += G) {
        const float mg = m * s_gs[pi * L.rw_s + c];
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (wk[k] != 0.f) atomicAdd(dx + (size_t)idx[k] * C + c0 + c, (double)(wk[k] * mg));
      }
      for (int c = Cb + sub; c < L.cpn; c += G) ms[c] = S(0);  // the mma's zero pad
#pragma unroll
      for (int k = 0; k < 4; ++k)
        for (int s = G / 2; s > 0; s >>= 1) a[k] += __shfl_xor_sync(0xffffffffu, a[k], s);
      if (sub == 0 && valid) {
        float dm = 0.f, doy = 0.f, dox = 0.f;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          dm = fmaf(wk[k], a[k], dm);
          doy = fmaf(dwy[k], a[k], doy);
          dox = fmaf(dwx[k], a[k], dox);
        }
        if constexpr (WIDE) {
          atomicAdd(dmask + (size_t)p * KK + t, (double)dm);
          atomicAdd(doffset + (size_t)p * 18 + 2 * t, (double)(gate_y * m * doy));
          atomicAdd(doffset + (size_t)p * 18 + 2 * t + 1, (double)(gate_x * m * dox));
        } else {
          dmask[(size_t)p * KK + t] = dm;
          doffset[(size_t)p * 18 + 2 * t] = gate_y * m * doy;
          doffset[(size_t)p * 18 + 2 * t + 1] = gate_x * m * dox;
        }
      }
    }
    __syncthreads();

    // dW_t += (m sampled)^T g on the tensor cores: M = channel, N = out
    // channel, K = pixel; both operands are read down their columns
    if (cm < L.cpn) {
      if constexpr (BF) {
        const unsigned short* ms = reinterpret_cast<const unsigned short*>(s_ms);
        const unsigned short* gg = reinterpret_cast<const unsigned short*>(s_g);
        const int ec = L.rw_c * 2, eo = L.rw_o * 2;  // row strides in elements
#pragma unroll
        for (int k = 0; k < TP; k += 16) {
          const int ka = k + 2 * tg;
          const uint32_t a0 = pack2(ms[ka * ec + cm + gq], ms[(ka + 1) * ec + cm + gq]);
          const uint32_t a1 = pack2(ms[ka * ec + cm + gq + 8], ms[(ka + 1) * ec + cm + gq + 8]);
          const uint32_t a2 = pack2(ms[(ka + 8) * ec + cm + gq], ms[(ka + 9) * ec + cm + gq]);
          const uint32_t a3 =
              pack2(ms[(ka + 8) * ec + cm + gq + 8], ms[(ka + 9) * ec + cm + gq + 8]);
#pragma unroll
          for (int j = 0; j < MAXT; ++j) {
            if (j < dnt) {
              const int on = dn0 + j * 8 + gq;
              mma_bf16(dw[j], a0, a1, a2, a3, pack2(gg[ka * eo + on], gg[(ka + 1) * eo + on]),
                       pack2(gg[(ka + 8) * eo + on], gg[(ka + 9) * eo + on]));
            }
          }
        }
      } else {
        const float* ms = reinterpret_cast<const float*>(s_ms);
        const float* gg = reinterpret_cast<const float*>(s_g);
#pragma unroll 2
        for (int k = 0; k < TP; k += 8) {
          const int ka = k + tg;
          uint32_t ah[4], al[4];
          split4(ms[ka * L.rw_c + cm + gq], ms[ka * L.rw_c + cm + gq + 8],
                 ms[(ka + 4) * L.rw_c + cm + gq], ms[(ka + 4) * L.rw_c + cm + gq + 8], ah, al);
#pragma unroll
          for (int j = 0; j < MAXT; ++j) {
            if (j < dnt) {
              const int on = dn0 + j * 8 + gq;
              mma_3xtf32(dw[j], dw[j], ah, al, gg[ka * L.rw_o + on], gg[(ka + 4) * L.rw_o + on]);
            }
          }
        }
      }
    }
  }
  cp_async_wait<0>();  // no copy outlives the block

  // this block's dW_t partial into the global fp64 dW, once
#pragma unroll
  for (int j = 0; j < MAXT; ++j) {
    if (j >= dnt || cm >= L.cpn) continue;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = cm + gq + 8 * (i >> 1), o = dn0 + j * 8 + 2 * tg + (i & 1);
      if (c < Cb && o < Ob)
        atomicAdd(dweight + ((size_t)t * C + c0 + c) * Cout + o0 + o, (double)dw[j][i]);
    }
  }
}

bool bwd_wide(int C, int Cout) { return C > BWD_CMAX || Cout > BWD_CMAX; }

size_t bwd_block_smem_bytes(int C, int Cout, bool bf) {  // a block's chunk pair
  return bwd_smem_bytes(C < BWD_CMAX ? C : BWD_CMAX, Cout < BWD_CMAX ? Cout : BWD_CMAX, bf);
}

template <bool BF, int VEC, bool BIG, bool WIDE>
int launch_bwd_kernel(const void* x, const void* offset, const void* mask, const void* weight,
                      const void* g, void* dx, void* doffset, void* dmask, void* dweight,
                      int npix, int H, int W, int C, int Cout, float radius, cudaStream_t s) {
  using S = typename Elt<BF>::S;
  using GO = GradOut<WIDE>;
  auto kernel = dcn_bwd_kernel<BF, VEC, BIG, WIDE>;
  const size_t smem = bwd_block_smem_bytes(C, Cout, BF);
  const int ntiles = (npix + TP - 1) / TP;
  const int pairs = ((C + BWD_CMAX - 1) / BWD_CMAX) * ((Cout + BWD_CMAX - 1) / BWD_CMAX);
  const dim3 grid(ntiles < BWD_TILE_GROUPS ? ntiles : BWD_TILE_GROUPS, KK, WIDE ? pairs : 1);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, NT, smem, s>>>(
      static_cast<const S*>(x), static_cast<const float*>(offset),
      static_cast<const float*>(mask), static_cast<const S*>(weight), static_cast<const S*>(g),
      static_cast<double*>(dx), static_cast<GO*>(doffset), static_cast<GO*>(dmask),
      static_cast<double*>(dweight), npix, H, W, C, Cout, radius);
  return (int)cudaGetLastError();
}

template <bool BF, int VEC>
int launch_bwd(const void* x, const void* offset, const void* mask, const void* weight,
               const void* g, void* dx, void* doffset, void* dmask, void* dweight, int npix,
               int H, int W, int C, int Cout, float radius, cudaStream_t s) {
  if (bwd_wide(C, Cout))
    return launch_bwd_kernel<BF, VEC, true, true>(x, offset, mask, weight, g, dx, doffset, dmask,
                                                  dweight, npix, H, W, C, Cout, radius, s);
  if (C <= 64 && Cout <= 64)
    return launch_bwd_kernel<BF, VEC, false, false>(x, offset, mask, weight, g, dx, doffset,
                                                    dmask, dweight, npix, H, W, C, Cout, radius,
                                                    s);
  return launch_bwd_kernel<BF, VEC, true, false>(x, offset, mask, weight, g, dx, doffset, dmask,
                                                 dweight, npix, H, W, C, Cout, radius, s);
}

// 16-byte corner loads where C and the pointer allow them
template <bool BF>
bool vec_ok(const void* x, int C) {
  constexpr int V = BF ? 8 : 4;
  return C % V == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
}

}  // namespace

extern "C" {

// Shared memory (bytes) one block needs: kernel 0 = forward, 1 = backward;
// dtype 0 = fp32, 1 = bf16. ops/deform.py computes the same and checks it.
size_t dcn_smem_bytes(int kernel, int C, int Cout, int dtype) {
  return kernel == 0 ? fwd_smem_bytes(Cout, dtype == 1) : bwd_block_smem_bytes(C, Cout, dtype == 1);
}

// dx (B, H, W, C) and dweight (9, C, Cout) are fp64 and must be zeroed by the
// caller (the kernel adds into them); doffset (B, H, W, 18) and dmask
// (B, H, W, 9) are fp32 and fully written where C and Cout are at most 128,
// else (dcn_backward_wide) fp64 sums the caller zeroes. dtype: 0 = fp32,
// 1 = bf16 (x, weight and g). Returns cudaGetLastError().
int dcn_backward(const void* x, const void* offset, const void* mask, const void* weight,
                 const void* g, void* dx, void* doffset, void* dmask, void* dweight, int B,
                 int H, int W, int C, int Cout, float radius, int dtype, void* stream) {
  const int npix = B * H * W;
  if (npix == 0) return 0;
  if (C < 1 || Cout < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return vec_ok<false>(x, C)
               ? launch_bwd<false, 4>(x, offset, mask, weight, g, dx, doffset, dmask, dweight,
                                      npix, H, W, C, Cout, radius, s)
               : launch_bwd<false, 1>(x, offset, mask, weight, g, dx, doffset, dmask, dweight,
                                      npix, H, W, C, Cout, radius, s);
  if (dtype == 1)
    return vec_ok<true>(x, C)
               ? launch_bwd<true, 8>(x, offset, mask, weight, g, dx, doffset, dmask, dweight,
                                     npix, H, W, C, Cout, radius, s)
               : launch_bwd<true, 1>(x, offset, mask, weight, g, dx, doffset, dmask, dweight,
                                     npix, H, W, C, Cout, radius, s);
  return (int)cudaErrorInvalidValue;
}

// wt is (9, Cout, Cpad): each tap's weight transposed, input channels
// zero-padded to Cpad, a multiple of 32. dtype: 0 = fp32, 1 = bf16 (x, wt
// and out). Returns cudaGetLastError().
int dcn_forward(const void* x, const void* offset, const void* mask, const void* wt, void* out,
                int B, int H, int W, int C, int Cout, int Cpad, float radius, int dtype,
                void* stream) {
  const int npix = B * H * W;
  if (npix == 0 || Cout == 0) return 0;
  if (Cpad % KC != 0 || Cpad < C || (reinterpret_cast<uintptr_t>(wt) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return vec_ok<false>(x, C)
               ? launch_fwd<false, 4>(x, offset, mask, wt, out, npix, H, W, C, Cout, Cpad,
                                      radius, s)
               : launch_fwd<false, 1>(x, offset, mask, wt, out, npix, H, W, C, Cout, Cpad,
                                      radius, s);
  if (dtype == 1)
    return vec_ok<true>(x, C)
               ? launch_fwd<true, 8>(x, offset, mask, wt, out, npix, H, W, C, Cout, Cpad,
                                     radius, s)
               : launch_fwd<true, 1>(x, offset, mask, wt, out, npix, H, W, C, Cout, Cpad,
                                     radius, s);
  return (int)cudaErrorInvalidValue;
}

// 1 where dcn_backward runs WIDE (C or Cout above 128: doffset and dmask
// are then fp64 sums), else 0
int dcn_backward_wide(int C, int Cout) { return bwd_wide(C, Cout) ? 1 : 0; }

const char* yat_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

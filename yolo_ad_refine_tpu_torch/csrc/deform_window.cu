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
// Design. The clip bounds where a tile's samples can fall: every sample of
// a tile of output pixels lies in the window of the tile plus a halo of
// r + 2 (the TPU kernels' pad margin s). A block stages that window in
// shared memory, in channel chunks whose width the wrapper sizes at launch
// from the radius (ops/deform_pallas.py window_fwd_launch: a wider radius
// leaves room for fewer channels), and samples from shared memory, not
// from global memory as K1 (deform_conv.cu) does.
//
// Forward (tensor cores). A block owns an 8 x 16 tile (512 threads, one
// block an SM by its registers) and NB = 64 or 128 output channels (128
// past 64 where 16-byte copies are allowed, so that a wide layer stages
// each window half as often). The 16-pixel-wide tile halves, per pixel,
// the weight that every block reads from L2 (the whole 9 x C x Cout slice
// of its NB channels) and cuts the halo's share of the window. The block
// first tabulates the geometry of all 9 taps of its 128 pixels (window
// position, the hat weights of the two rows and columns, the mask), then
// walks (chunk, tap) steps, chunk-major, with one barrier a step: the
// window chunk k + 1 is copied by cp.async (zero-filled outside the map
// and past C) into the other of two buffers while chunk k's nine taps
// compute, and waited for two steps before its first tap is sampled; the
// weight slice of step s + 2 is loaded into registers before the products
// of step s, and that of step s + 1 stored after them into the other of
// two weight tiles; the samples of step s + 1 are formed after the
// products of step s into the other of two sample tiles. The products are
// mma.sync on the tensor cores, fragments by ldmatrix from rows padded by
// 4 words (free of bank conflicts), fp32 accumulators in registers across
// all steps (16 warps: 8 along the pixels, a tile row each, x 2 along the
// output channels). Each form keeps its own products:
// - fp32 (K2, K3): 3xTF32 m16n8k8, a_hi b_hi + (a_lo b_hi + a_hi b_lo), with
//   x_hi = tf32(x), x_lo = tf32(x - x_hi) rounded as cvt.rna.tf32.f32
//   (split_tf32); the weight is split once, when its tile is stored, the
//   samples in registers;
// - K3 bf16: the modulated sample rounded to bf16, bf16 x bf16 m16n8k16;
// - K2 bf16: the sample stays fp32 and meets the bf16 weight, which is
//   exact in TF32, as a_hi w + a_lo w (2xTF32).
// The sample keeps the plain versions' order (x pass, then y combine,
// __fmul_rn / __fadd_rn, then the mask), so the kernel differs from them
// only in the products' rounding and order, and each output is summed in
// one fixed order (chunks, taps, then mma k-blocks): two runs are equal
// bit for bit, and so are the two block widths at one chunk width.
// Global mode: where even the narrowest double-buffered window chunk does
// not fit a block (from radius 29 or 30 in fp32, 30 or 31 in bf16),
// window_fwd_launch takes the same kernel without the window: the samples
// read their four corners from global memory (L2), as K1 does, with
// 64-channel blocks. Nothing else changes, so at one chunk width the
// outputs equal the window mode's bit for bit.
//
// Backward: a block owns one tap and one (C-chunk, Cout-chunk) pair of at
// most 128 x 128 (grid.z; a single pair up to 128 channels) and walks many
// 8 x 8 tiles; per tile it forms its pair's part of gs = g . W_t^T in the kernel,
// accumulates per pixel the four corner dot products gs . x_corner over the
// window chunks (a warp per pixel, reduced by shuffles), scatters dx with
// fp64 atomics and keeps its dW_t chunk in shared memory, added into the
// fp64 dW with atomics at the end. doffset and dmask add each pair's
// partial into fp64 sums. dx, dW, doffset and dmask are rounded once, by
// the wrapper: with a single pair doffset and dmask take one add each and
// equal the fp32 sums exactly; with several (C or Cout above 128) they
// repeat from run to run like dx.
//
// What bounds it: the per-tap (C x Cout) products, 2 * 9 * C * Cout flops a
// pixel forward and twice that backward, against ~0.6 kB (fp32, C = Cout =
// 64) that a pixel must move forward: operation-bound. The forward's
// products run on the tensor cores (3xTF32 in fp32: three TF32 products a
// product); the backward's still on the fp32 cores (later work).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int KK = 9;        // taps
constexpr int TH = 8;        // the backward's output tile rows
constexpr int TW = 8;        // and columns
constexpr int TP = TH * TW;  // output pixels per tile
constexpr int NT = 256;      // the backward's threads per block
constexpr int MXU_CH = 8;    // rows per chunk of deform_mxu.py (its CH)
// the forward's block: an 8 x 16 tile of output pixels, 16 warps
constexpr int FTH = 8;
constexpr int FTW = 16;
constexpr int FTP = FTH * FTW;
constexpr int FNT = 512;
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

// 16 bytes, zero-filled where !valid (gmem is then any mapped address)
__device__ __forceinline__ void cp_async16z(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

__device__ __forceinline__ void cp_async_wait0() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// x = hi + lo as TF32 operands, both rounded as cvt.rna.tf32.f32 rounds
// a finite value (to nearest, ties away from zero): hi by adding half a
// TF32 ulp to the magnitude's bits and clearing the 13 low bits; lo = x -
// hi is exact, and adding half an ulp to it suffices, because the tensor
// cores read only the top 19 bits of a TF32 operand. Integer operations:
// the conversion instruction costs twice as many, for inf and NaN checks
__device__ __forceinline__ void split_tf32(uint32_t x, uint32_t& hi, uint32_t& lo) {
  hi = (x + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(__uint_as_float(x) - __uint_as_float(hi)) + 0x1000u;
}

// four 8 x 16-byte matrices from shared memory: lanes 8i .. 8i + 7 give the
// row addresses of matrix i, and register i holds row lane / 4, 32-bit word
// lane % 4 of it (an mma fragment: TF32 words or bf16 pairs)
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// N elements loaded or stored as one
template <typename T, int N>
struct alignas(sizeof(T) * N) Vec {
  T v[N];
};

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

__device__ __forceinline__ Tile fwd_tile(int tile, int H, int W) {
  const int tx = (W + FTW - 1) / FTW;
  const int ty = (H + FTH - 1) / FTH;
  const int b = tile / (tx * ty);
  const int rem = tile % (tx * ty);
  return {b, (rem / tx) * FTH, (rem % tx) * FTW};
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

// The forward's shared memory, in 32-bit words: two window chunk buffers
// (none in the global mode), two sample tiles (A), two weight tiles (B;
// fp32 weights as hi and lo TF32 planes, rows = output channels) and the
// geometry of the 9 taps (6 words an entry; 7 in the global mode, whose
// corner is a map row and column). bf: bf16 inputs; sep: the separable form
// (K2), whose bf16 products are TF32 on fp32 samples; gl: the global mode.
// ops/deform_pallas.py window_fwd_smem computes the same.
struct FwdLayout {
  int ww, wh, npos, xw;  // window row length, rows, positions, words a position holds
  int ks, rw;        // k of a step (one chunk, at least one mma's), words of an A or B row
  int planes, nb;
  bool gl;
  __host__ __device__ FwdLayout(int r, int cc, int nb_, bool bf, bool sep, bool gl_) {
    const int s = r + 2;
    const bool f32 = !bf || sep;
    const int mk = f32 ? 8 : 16;  // k of one mma: m16n8k8 TF32, m16n8k16 bf16
    ww = FTW + 2 * s;
    wh = FTH + 2 * s;
    npos = wh * ww;
    xw = cc * (bf ? 2 : 4) / 4;
    ks = cc > mk ? cc : mk;
    rw = ks * (f32 ? 4 : 2) / 4 + 4;
    planes = bf ? 1 : 2;
    nb = nb_;
    gl = gl_;
  }
  __host__ __device__ size_t words() const {
    return (gl ? 0 : (size_t)2 * npos * xw) + (size_t)2 * FTP * rw +
           (size_t)2 * planes * nb * rw + (size_t)KK * FTP * (gl ? 7 : 6);
  }
};

size_t fwd_smem(int r, int cc, int nb, bool bf, bool sep, bool gl) {
  return 4 * FwdLayout(r, cc, nb, bf, sep, gl).words();
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
// Forward on the tensor cores (see the design note at the top). grid (tiles,
// ceil(Cout / NB)), FNT threads. wt is (9, Cout, Cpad) as ops/deform.py
// k1_fwd_weight lays it out, Cpad a multiple of cc; cc * sizeof(T) is 16 to
// 128 bytes. VEC: channels a window copy and a sample take (16 bytes; 1
// where C or x's pointer does not allow 16-byte copies). GL: the global
// mode, for a radius whose window does not fit (window_fwd_launch chooses
// it): nothing is staged, and the samples read their four corners from x in
// global memory (L2), zero outside the map, as K1 does; the rest is the
// window mode's, so the two give equal outputs. The cut copies of
// engine/profile_dcn.py (WINDOW_TREE_SPLITS) edit the lines marked "split:".

template <typename T, bool SEP, int VEC, int NB, bool GL>
__device__ __forceinline__ void fwd_body(const T* __restrict__ x, const float* __restrict__ offset,
                                         const float* __restrict__ mask,
                                         const T* __restrict__ wt, T* __restrict__ out, int H,
                                         int W, int C, int Cout, int Cpad, int r, int cc) {
  constexpr bool BF = sizeof(T) == 2;
  constexpr bool F32 = !BF || SEP;          // TF32 products: samples and weights in fp32
  constexpr int PLANES = BF ? 1 : 2;        // fp32 weights: hi and lo planes
  constexpr int NTW = NB / 16;              // n-tiles of 8 a warp owns, at most
  constexpr int E16 = 16 / (int)sizeof(T);  // elements in 16 bytes
  constexpr int WP = NB / 64;               // 16-byte weight pieces a thread carries
  using P = Vec<T, VEC>;
  const FwdLayout L(r, cc, NB, BF, SEP, GL);
  // its own name: the backward's extern shared array has another type
  extern __shared__ __align__(16) uint32_t fwd_smem_words[];
  uint32_t* s_x = fwd_smem_words;                         // [2][npos][xw] window chunks
  uint32_t* s_a = s_x + (GL ? 0 : 2 * L.npos * L.xw);     // [2][FTP][rw] samples
  uint32_t* s_b = s_a + 2 * FTP * L.rw;                    // [2][PLANES][NB][rw] weights
  float4* s_gw = reinterpret_cast<float4*>(s_b + 2 * PLANES * NB * L.rw);  // [KK][FTP] wx, wy
  // [KK][FTP] the top-left corner: its window position, or (GL) its map
  // row and column as an int2
  int* s_gp = reinterpret_cast<int*>(s_gw + KK * FTP);
  float* s_gm = reinterpret_cast<float*>(s_gp + (GL ? 2 : 1) * KK * FTP);  // [KK][FTP] mask

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2, tg = lane & 3;
  const Tile tl = fwd_tile(blockIdx.x, H, W);
  const int o0 = blockIdx.y * NB;
  const int np = (min(Cout - o0, NB) + 15) / 16 * 16;  // the block's output channels, padded
  const int m0 = (warp & 7) * 16;                       // the warp's 16 pixels (a tile row)
  const int nb0 = (warp >> 3) * (np / 2);               // and its half of the output channels
  const int ntw = np / 16;                              // n-tiles of 8 in that half
  const int nchunks = (C + cc - 1) / cc;
  const int steps = KK * nchunks;
  const int s = r + 2;

  // window chunk kc (channels kc * cc ..) into buffer kc & 1, zero outside
  // the map and past C: cp.async, one commit group; or plain loads and
  // stores (VEC 1), seen by all after the next barrier. GL: nothing
  const int lg_cc = 31 - __clz(cc);  // cc, ks and a row's pieces are powers of two
  auto stage = [&](int kc) {
    if constexpr (GL) return;
    T* dst = reinterpret_cast<T*>(s_x + (kc & 1) * L.npos * L.xw);
    const int c0 = kc * cc;
    constexpr int E = VEC > 1 ? E16 : 1;  // elements a copy takes
    const int lg_pieces = lg_cc - (E == 8 ? 3 : E == 4 ? 2 : 0);  // copies a position
    // a warp a window row (wh rows of ww), lanes along it
    for (int wy = warp; wy < L.wh; wy += FNT / 32) {
      const int yy = tl.y0 - s + wy;
      for (int j = lane; j < L.ww << lg_pieces; j += 32) {
        const int xx = tl.x0 - s + (j >> lg_pieces);
        const int c = c0 + (j & ((1 << lg_pieces) - 1)) * E;
        const bool valid = yy >= 0 && yy < H && xx >= 0 && xx < W && c < C;
        const T* src = x + (((size_t)tl.b * H + yy) * W + xx) * C + c;
        T* d = dst + (size_t)(wy * L.ww + (j >> lg_pieces)) * cc + (c - c0);
        if constexpr (VEC > 1)
          cp_async16z(d, valid ? src : x, valid);
        else
          *d = valid ? *src : from_f<T>(0.f);
      }
    }
    if constexpr (VEC > 1) cp_async_commit();
  };

  // the weight of step st (tap st % 9, channels (st / 9) * cc ..): 16-byte
  // pieces of its NB rows into registers w (zero past Cout and past the
  // chunk) two steps ahead, then into weight tile buf
  const int lg_ppr = 31 - __clz(L.ks * (int)sizeof(T) / 16);  // pieces of a row
  auto load_w = [&](int st, uint4(&w)[WP]) {
    const int t = st % KK, c0 = (st / KK) * cc;
#pragma unroll
    for (int j = 0; j < WP; ++j) {
      const int i = tid + j * FNT;
      const int n = i >> lg_ppr, k = (i & ((1 << lg_ppr) - 1)) * E16;
      w[j] = make_uint4(0u, 0u, 0u, 0u);
      if (n < NB && o0 + n < Cout && k < cc)
        w[j] = __ldg(reinterpret_cast<const uint4*>(wt + ((size_t)t * Cout + o0 + n) * Cpad +
                                                    c0 + k));
    }
  };
  auto store_w = [&](const uint4(&w)[WP], int buf) {
#pragma unroll
    for (int j = 0; j < WP; ++j) {
      const int i = tid + j * FNT;
      const int n = i >> lg_ppr, k = (i & ((1 << lg_ppr) - 1)) * E16;  // k in elements
      if (n >= NB) continue;
      uint32_t* row = s_b + ((size_t)buf * PLANES * NB + n) * L.rw;
      const uint4 v = w[j];
      if constexpr (!BF) {  // 4 fp32: split once, hi and lo planes
        const uint32_t w[4] = {v.x, v.y, v.z, v.w};
        uint32_t hi[4], lo[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) split_tf32(w[e], hi[e], lo[e]);
        *reinterpret_cast<uint4*>(row + k) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
        *reinterpret_cast<uint4*>(row + NB * L.rw + k) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
      } else if constexpr (SEP) {  // 8 bf16 as fp32, exact in TF32
        *reinterpret_cast<uint4*>(row + k) =
            make_uint4(v.x << 16, v.x & 0xffff0000u, v.y << 16, v.y & 0xffff0000u);
        *reinterpret_cast<uint4*>(row + k + 4) =
            make_uint4(v.z << 16, v.z & 0xffff0000u, v.w << 16, v.w & 0xffff0000u);
      } else {  // 8 bf16 as they are
        *reinterpret_cast<uint4*>(row + k / 2) = v;
      }
    }
  };

  // GL: VEC channels from ch of map position (yy, xx), zero outside the
  // map and past C (VEC > 1 divides C)
  auto corner = [&](int yy, int xx, int ch) {
    P v;
    if (yy >= 0 && yy < H && xx >= 0 && xx < W && ch < C) {
      v = *reinterpret_cast<const P*>(x + (((size_t)tl.b * H + yy) * W + xx) * C + ch);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) v.v[e] = from_f<T>(0.f);
    }
    return v;
  };

  // the modulated samples of step st into sample tile buf, in the plain
  // versions' order; K3 rounds them to bf16 for its bf16 products
  auto sample = [&](int st, int buf) {
    const int t = st % KK;
    const T* win = reinterpret_cast<const T*>(s_x + ((st / KK) & 1) * L.npos * L.xw);
    constexpr int LG_VEC = VEC == 8 ? 3 : VEC == 4 ? 2 : 0;
    const int lg_pieces = lg_cc - LG_VEC;
    for (int i = tid; i < FTP << lg_pieces; i += FNT) {
      const int p = i >> lg_pieces, c = (i & ((1 << lg_pieces) - 1)) * VEC;
      const float4 gw = s_gw[t * FTP + p];
      const float m = s_gm[t * FTP + p];
      P v0, v1, v2, v3;
      if constexpr (GL) {
        const int2 yx = reinterpret_cast<const int2*>(s_gp)[t * FTP + p];
        const int ch = (st / KK) * cc + c;
        v0 = corner(yx.x, yx.y, ch);
        v1 = corner(yx.x, yx.y + 1, ch);
        v2 = corner(yx.x + 1, yx.y, ch);
        v3 = corner(yx.x + 1, yx.y + 1, ch);
      } else {
        const T* q = win + (size_t)s_gp[t * FTP + p] * cc + c;
        v0 = *reinterpret_cast<const P*>(q);
        v1 = *reinterpret_cast<const P*>(q + cc);
        v2 = *reinterpret_cast<const P*>(q + (size_t)L.ww * cc);
        v3 = *reinterpret_cast<const P*>(q + (size_t)(L.ww + 1) * cc);
      }
      float ms[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float row0 =
            __fadd_rn(__fmul_rn(gw.x, to_f(v0.v[e])), __fmul_rn(gw.y, to_f(v1.v[e])));
        const float row1 =
            __fadd_rn(__fmul_rn(gw.x, to_f(v2.v[e])), __fmul_rn(gw.y, to_f(v3.v[e])));
        ms[e] = __fmul_rn(__fadd_rn(__fmul_rn(gw.z, row0), __fmul_rn(gw.w, row1)), m);
      }
      uint32_t* row = s_a + ((size_t)buf * FTP + p) * L.rw;
      if constexpr (F32) {
        float* a = reinterpret_cast<float*>(row) + c;
        if constexpr (VEC % 4 == 0) {
#pragma unroll
          for (int e = 0; e < VEC; e += 4)
            *reinterpret_cast<float4*>(a + e) = make_float4(ms[e], ms[e + 1], ms[e + 2], ms[e + 3]);
        } else {
#pragma unroll
          for (int e = 0; e < VEC; ++e) a[e] = ms[e];
        }
      } else {
        Vec<__nv_bfloat16, VEC> o;
#pragma unroll
        for (int e = 0; e < VEC; ++e) o.v[e] = __float2bfloat16(ms[e]);
        *reinterpret_cast<Vec<__nv_bfloat16, VEC>*>(reinterpret_cast<__nv_bfloat16*>(row) + c) = o;
      }
    }
  };

  // fp32 accumulators; the small 3xTF32 / 2xTF32 terms go to acc2, so that
  // a tile's products form two dependency chains
  float acc[NTW][4], acc2[F32 ? NTW : 1][4];
#pragma unroll
  for (int j = 0; j < NTW; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = acc2[F32 ? j : 0][i] = 0.f;

  // ldmatrix row addresses (bytes) of this lane: A rows m0 + lane % 8 (+8
  // for lanes 8-15 and 24-31), words +4 for lanes 16-31; B rows nb0 + lane
  // % 8 (+8 for lanes 16-31), words +4 for lanes 8-15 and 24-31
  const uint32_t a_lane = static_cast<uint32_t>(__cvta_generic_to_shared(s_a)) +
                          4u * ((m0 + (lane & 7) + ((lane >> 3) & 1) * 8) * L.rw + (lane >> 4) * 4);
  const uint32_t b_lane =
      static_cast<uint32_t>(__cvta_generic_to_shared(s_b)) +
      4u * ((nb0 + (lane & 7) + (lane >> 4) * 8) * L.rw + ((lane >> 3) & 1) * 4);
  const int kwords = F32 ? L.ks : L.ks / 2;  // 32-bit words of k in a row
  auto products = [&](int buf) {
    const uint32_t a_buf = a_lane + 4u * buf * FTP * L.rw;
    const uint32_t b_buf = b_lane + 4u * buf * PLANES * NB * L.rw;
    for (int kw = 0; kw < kwords; kw += 8) {  // 8 words: k8 in TF32, k16 in bf16
      uint32_t a[4];
      ldsm_x4(a, a_buf + 4u * kw);
      if constexpr (F32) {
        uint32_t ah[4], al[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) split_tf32(a[q], ah[q], al[q]);
#pragma unroll
        for (int jp = 0; jp < NTW / 2; ++jp) {
          if (2 * jp < ntw) {
            uint32_t bh[4], bl[4];
            ldsm_x4(bh, b_buf + 4u * (jp * 16 * L.rw + kw));
            if constexpr (!BF) ldsm_x4(bl, b_buf + 4u * ((NB + jp * 16) * L.rw + kw));
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              if (2 * jp + h < ntw) {  // split: products
                mma_tf32(acc2[2 * jp + h], al, bh[2 * h], bh[2 * h + 1]);
                if constexpr (!BF) mma_tf32(acc2[2 * jp + h], ah, bl[2 * h], bl[2 * h + 1]);
                mma_tf32(acc[2 * jp + h], ah, bh[2 * h], bh[2 * h + 1]);
              }
            }
          }
        }
      } else {
#pragma unroll
        for (int jp = 0; jp < NTW / 2; ++jp) {
          if (2 * jp < ntw) {
            uint32_t b[4];
            ldsm_x4(b, b_buf + 4u * (jp * 16 * L.rw + kw));
#pragma unroll
            for (int h = 0; h < 2; ++h)
              if (2 * jp + h < ntw)  // split: products
                mma_bf16(acc[2 * jp + h], a, b[2 * h], b[2 * h + 1]);
          }
        }
      }
    }
  };

  stage(0);
  for (int i = tid; i < 2 * FTP * L.rw; i += FNT) s_a[i] = 0u;  // k past the chunk stays 0
  for (int i = tid; i < KK * FTP; i += FNT) {
    const int t = i / FTP, p = i % FTP;
    const int y = tl.y0 + p / FTW;
    const int xx = tl.x0 + p % FTW;
    const Geo gg = (y < H && xx < W) ? tap_geometry<SEP>(offset, mask, tl, y, xx, t, H, W, r)
                                     : empty_geometry();
    float wx0 = gg.wx[0], wx1 = gg.wx[1];
    if (SEP && BF) {  // K2 rounds the x weights to the input type
      wx0 = round_bf16(wx0);
      wx1 = round_bf16(wx1);
    }
    s_gw[i] = make_float4(wx0, wx1, gg.wy[0], gg.wy[1]);
    // the top-left corner in this block's window (tap_geometry's pos is the
    // backward's, of an 8 x 8 tile); GL: in the map, and for a pixel past
    // the map one whose four corners lie outside it
    if constexpr (GL)
      reinterpret_cast<int2*>(s_gp)[i] = (y < H && xx < W) ? make_int2(gg.y0, gg.x0)
                                                             : make_int2(-2, -2);
    else
      s_gp[i] = (y < H && xx < W) ? (gg.y0 - (tl.y0 - s)) * L.ww + (gg.x0 - (tl.x0 - s)) : 0;
    s_gm[i] = gg.m;
  }
  // two register sets for the weights: step st loads W(st + 2) into one and
  // stores W(st + 1) from the other (loaded a step earlier), so that a load
  // has a whole step to arrive; the loop takes two steps a turn so that
  // each set is named, not indexed
  uint4 wa[WP], wb[WP];
  load_w(0, wa);
  if constexpr (VEC > 1) cp_async_wait0();
  __syncthreads();  // window chunk 0, the geometry, the zeroed sample tiles
  sample(0, 0);  // split: sampling
  store_w(wa, 0);
  if (steps > 1) load_w(1, wb);
  __syncthreads();

  auto step = [&](int st, uint4(&ld)[WP], const uint4(&sto)[WP]) {
    const int t = st % KK, kc = st / KK;
    // buffer (kc + 1) & 1 was last read by the samples of step kc * 9 - 1,
    // formed before the barrier that ended step kc * 9 - 2
    if (t == 0 && kc + 1 < nchunks) stage(kc + 1);
    if (st + 2 < steps) load_w(st + 2, ld);
    products(st & 1);
    if (st + 1 < steps) {
      sample(st + 1, (st + 1) & 1);  // split: sampling
      store_w(sto, (st + 1) & 1);
    }
    // chunk kc + 1 is first sampled in the step after next
    if constexpr (VEC > 1)
      if (t == KK - 2 && kc + 1 < nchunks) cp_async_wait0();
    __syncthreads();
  };
  for (int st = 0; st < steps; st += 2) {
    step(st, wa, wb);
    if (st + 1 < steps) step(st + 1, wb, wa);
  }

#pragma unroll
  for (int j = 0; j < NTW; ++j) {
    if (j >= ntw) continue;
    if constexpr (F32) {
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][i] += acc2[j][i];
    }
    const int o = o0 + nb0 + j * 8 + 2 * tg;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = m0 + g + 8 * h;
      const int y = tl.y0 + p / FTW;
      const int xx = tl.x0 + p % FTW;
      if (y >= H || xx >= W) continue;
      const size_t q = ((size_t)tl.b * H + y) * W + xx;
      if (o < Cout) out[q * Cout + o] = from_f<T>(acc[j][2 * h]);
      if (o + 1 < Cout) out[q * Cout + o + 1] = from_f<T>(acc[j][2 * h + 1]);
    }
  }
}

template <typename T, int VEC, int NB, bool GL>
__global__ void __launch_bounds__(FNT, 1)
dcn_window_forward_kernel(const T* __restrict__ x, const float* __restrict__ offset,
                          const float* __restrict__ mask, const T* __restrict__ wt,
                          T* __restrict__ out, int H, int W, int C, int Cout, int Cpad, int r,
                          int cc) {
  fwd_body<T, false, VEC, NB, GL>(x, offset, mask, wt, out, H, W, C, Cout, Cpad, r, cc);
}

template <typename T, int VEC, int NB, bool GL>
__global__ void __launch_bounds__(FNT, 1)
dcn_separable_forward_kernel(const T* __restrict__ x, const float* __restrict__ offset,
                             const float* __restrict__ mask, const T* __restrict__ wt,
                             T* __restrict__ out, int H, int W, int C, int Cout, int Cpad, int r,
                             int cc) {
  fwd_body<T, true, VEC, NB, GL>(x, offset, mask, wt, out, H, W, C, Cout, Cpad, r, cc);
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

template <typename T, bool SEP, int VEC, int NB, bool GL>
int launch_fwd(const void* x, const void* offset, const void* mask, const void* wt, void* out,
               int B, int H, int W, int C, int Cout, int Cpad, int r, int cc, cudaStream_t st) {
  void (*kernel)(const T*, const float*, const float*, const T*, T*, int, int, int, int, int, int,
                 int) = SEP ? dcn_separable_forward_kernel<T, VEC, NB, GL>
                            : dcn_window_forward_kernel<T, VEC, NB, GL>;
  const size_t smem = fwd_smem(r, cc, NB, sizeof(T) == 2, SEP, GL);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int ntiles = B * ((H + FTH - 1) / FTH) * ((W + FTW - 1) / FTW);
  const dim3 grid(ntiles, (Cout + NB - 1) / NB);
  kernel<<<grid, FNT, smem, st>>>(static_cast<const T*>(x), static_cast<const float*>(offset),
                                 static_cast<const float*>(mask), static_cast<const T*>(wt),
                                 static_cast<T*>(out), H, W, C, Cout, Cpad, r, cc);
  return (int)cudaGetLastError();
}

// the forward's checks and its choice of instantiation: NB 128 only with
// 16-byte copies (wide layers are aligned) and in the window mode
template <typename T, bool SEP>
int dispatch_fwd(const void* x, const void* offset, const void* mask, const void* wt, void* out,
                 int B, int H, int W, int C, int Cout, int Cpad, int r, int cc, int nb, int vec16,
                 int gl, cudaStream_t st) {
  const int bytes = cc * (int)sizeof(T);
  if (B * H * W == 0 || Cout == 0) return 0;
  if (C < 1 || r < 0 || cc < 1 || (cc & (cc - 1)) != 0 || bytes < 16 || bytes > 128 ||
      Cpad % cc != 0 || Cpad < C || (reinterpret_cast<uintptr_t>(wt) & 15) != 0 ||
      (nb != 64 && nb != 128) || (nb == 128 && (!vec16 || gl)))
    return (int)cudaErrorInvalidValue;
  constexpr int V = 16 / sizeof(T);
  if (gl)
    return vec16 ? launch_fwd<T, SEP, V, 64, true>(x, offset, mask, wt, out, B, H, W, C, Cout,
                                                    Cpad, r, cc, st)
                 : launch_fwd<T, SEP, 1, 64, true>(x, offset, mask, wt, out, B, H, W, C, Cout,
                                                    Cpad, r, cc, st);
  if (!vec16)
    return launch_fwd<T, SEP, 1, 64, false>(x, offset, mask, wt, out, B, H, W, C, Cout, Cpad, r,
                                            cc, st);
  if (nb == 64)  // split: nb
    return launch_fwd<T, SEP, V, 64, false>(x, offset, mask, wt, out, B, H, W, C, Cout, Cpad, r,
                                            cc, st);
  return launch_fwd<T, SEP, V, 128, false>(x, offset, mask, wt, out, B, H, W, C, Cout, Cpad, r,
                                           cc, st);
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

// Shared memory (bytes) of one forward block: cc = channels per chunk, nb =
// output channels per block (64 or 128), dtype 0 = fp32, 1 = bf16;
// separable 1 = K2, 0 = K3; global 1 = the global mode. ops/deform_pallas.py
// window_fwd_smem computes the same.
size_t dcn_window_fwd_smem_bytes(int radius, int cc, int nb, int dtype, int separable,
                                 int global) {
  return fwd_smem(radius, cc, nb, dtype == 1, separable != 0, global != 0);
}

// Shared memory (bytes) of one backward block; cc = channels per chunk.
size_t dcn_window_bwd_smem_bytes(int radius, int C, int Cout, int cc, int dtype) {
  return bwd_smem(radius, C, Cout, cc, dtype == 0 ? 4 : 2);
}

// Forward entries: wt (9, Cout, Cpad) in the working type as
// ops/deform.py k1_fwd_weight lays it out (Cpad a multiple of cc), out
// (B, H, W, Cout). dtype: 0 = fp32, 1 = bf16 (x, wt and out). cc, nb,
// vec16 (16-byte window copies: x's rows 16-byte aligned) and global (the
// global mode) as window_fwd_launch chooses them. Return
// cudaGetLastError(), or cudaErrorInvalidValue for arguments the kernel
// does not take.
int dcn_window_forward(const void* x, const void* offset, const void* mask, const void* wt,
                       void* out, int B, int H, int W, int C, int Cout, int Cpad, int radius,
                       int cc, int nb, int vec16, int global, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_fwd<float, false>(x, offset, mask, wt, out, B, H, W, C, Cout, Cpad, radius, cc,
                                      nb, vec16, global, st);
  if (dtype == 1)
    return dispatch_fwd<bf16, false>(x, offset, mask, wt, out, B, H, W, C, Cout, Cpad, radius, cc,
                                     nb, vec16, global, st);
  return (int)cudaErrorInvalidValue;
}

int dcn_separable_forward(const void* x, const void* offset, const void* mask, const void* wt,
                          void* out, int B, int H, int W, int C, int Cout, int Cpad, int radius,
                          int cc, int nb, int vec16, int global, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_fwd<float, true>(x, offset, mask, wt, out, B, H, W, C, Cout, Cpad, radius, cc,
                                     nb, vec16, global, st);
  if (dtype == 1)
    return dispatch_fwd<bf16, true>(x, offset, mask, wt, out, B, H, W, C, Cout, Cpad, radius, cc,
                                    nb, vec16, global, st);
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

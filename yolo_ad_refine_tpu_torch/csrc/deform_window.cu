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
// Backward (tensor cores). A block owns BCC = 16 channels and BNO = 64
// output channels (grid.y, grid.z: the channel and output-channel chunks)
// and walks a group of 8 x 16 tiles (grid.x, 512 threads), all 9 taps a
// tile. Per tile it stages the tile's g (128 pixels x its 64 output
// channels) and its 16-channel window chunk, tabulates the 9 taps'
// geometry, and lists for each window position the (tap, pixel, corner)
// samples that reach it with a nonzero weight (counts, a prefix sum,
// placement by shared int atomics); then per tap, with one barrier a tap:
// - gs = g . W_t^T (128 x 16, k = the 64 output channels) on mma.sync, the
//   weight slice of the next tap loaded into registers meanwhile;
// - each thread samples its 2 pixels x 2 channels from the window in the
//   plain versions' order (x pass, y combine, __fmul_rn / __fadd_rn), writes
//   m * sample for the dW product and m * gs for dx, and sums gs . x_corner
//   over its channels (the four corner dot products, reduced across the
//   quad by shuffles in a fixed order);
// - after the barrier, dW_t += (m * sample)^T . g (16 x 64, k = the 128
//   pixels) on mma.sync into registers that hold dW for all 9 taps across
//   the block's tiles, and doffset and dmask of the tap from the corner
//   dot products and the hat's derivative.
// After the ninth tap each (window position, channel) sums its list's
// terms w_k * (m * gs) in fp64 and adds the sum into the fp64 dx once (only
// the halo overlaps a neighbour tile's), and the next tile's window chunk
// is copied in by cp.async meanwhile. Summing by position instead of
// adding each term at its four corners takes no shared atomics on fp64
// (a compare-and-swap loop each): the TPU kernel too sums a dx strip in
// VMEM and writes it once per (tap, row). The products: fp32 by 3xTF32 as
// the forward's; with bf16 inputs the function stays fp32: gs is one TF32
// product (g and W are bf16 values, exact in TF32), dW_t is 2xTF32 (the fp32
// sample split into two TF32 parts against g, exact), and the sample is
// never rounded to bf16. The sums: each gradient is summed in fp32 in a
// fixed order within a block, or (dx) in fp64 in the varying order of a
// position's list, and added into fp64 in global memory with atomics, so
// only fp64 additions change order between runs, and the wrapper's
// rounding to fp32 repeats bit for bit but where an fp64 sum lies within
// its own rounding of an fp32 boundary. Wider layers take more chunks: the
// sampling and dx repeat for each 64 output channels. Global mode: where
// the window mode's block does not fit (from radius 4 in fp32, 8 in bf16;
// the wrapper's window_bwd_launch chooses it), the same kernel reads the
// corners from x in global memory (L2) and adds each dx term there by an
// fp64 atomic.
//
// What bounds it: the per-tap (C x Cout) products, 2 * 9 * C * Cout flops a
// pixel forward and twice that backward, against ~0.6 kB (fp32, C = Cout =
// 64) that a pixel must move forward: operation-bound, on the tensor cores
// (3xTF32 in fp32: three TF32 products a product). Beside the products the
// backward sums 4 * 9 * C dx terms a pixel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int KK = 9;        // taps
constexpr int MXU_CH = 8;    // rows per chunk of deform_mxu.py (its CH)
// the forward's and the backward's block: an 8 x 16 tile of output pixels,
// 16 warps
constexpr int FTH = 8;
constexpr int FTW = 16;
constexpr int FTP = FTH * FTW;
constexpr int FNT = 512;
constexpr int BCC = 16;            // channels a backward block takes (two n-tiles of 8)
constexpr int BNO = 64;            // output channels a backward block takes
constexpr int GROW = BNO + 8;      // words of a g or weight row (8 mod 32: no bank conflicts)
constexpr int MROW = BCC + 8;      // words of a sample row (24 = -8 mod 32)

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

// One pixel's sample of one tap: its top-left corner's map coordinates,
// the hat weights of its two rows and columns and their derivatives, the
// mask, and the clip gates.
struct Geo {
  int y0, x0;
  float wy[2], wx[2], dwy[2], dwx[2];
  float m, gy, gx;
};

struct Tile {
  int b, y0, x0;
};

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
  g.m = mask[p * KK + t];
  return g;
}

// A pixel of the tile that lies outside the map samples nothing.
__device__ __forceinline__ Geo empty_geometry() {
  Geo g;
  g.y0 = g.x0 = 0;
#pragma unroll
  for (int k = 0; k < 2; ++k) g.wy[k] = g.wx[k] = g.dwy[k] = g.dwx[k] = 0.f;
  g.m = g.gy = g.gx = 0.f;
  return g;
}

__host__ __device__ __forceinline__ size_t align16(size_t n) { return (n + 15) & ~(size_t)15; }

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

// The backward's shared memory, in bytes from its start: in the window
// mode the x window chunk, m * gs of the 9 taps' samples (fp32, the dx
// terms' factor), and the window positions' lists of the (tap, pixel,
// corner) samples that reach them (starts, counts, the 16-bit entries);
// then two weight tiles (rows = channels), the g tile, two sample tiles,
// two corner-dot tiles (one per channel half) and the geometry of the 9
// taps (7 words an entry; 8 in the global mode, whose corner is a map row
// and column). ops/deform_pallas.py window_bwd_smem computes the same.
struct BwdLayout {
  int ww, wh, npos;
  size_t gsm, bstart, bcnt, blist, w, g, ms, cg, gw, gp, gm, gd, bytes;
  __host__ __device__ BwdLayout(int r, int itemsize, bool gl) {
    const int s = r + 2;
    ww = FTW + 2 * s;
    wh = FTH + 2 * s;
    npos = ww * wh;
    gsm = gl ? 0 : align16((size_t)npos * BCC * itemsize);
    bstart = gsm + (gl ? 0 : 4 * (size_t)KK * FTP * BCC);
    bcnt = bstart + (gl ? 0 : align16(4 * ((size_t)npos + 1)));
    blist = bcnt + (gl ? 0 : align16(4 * (size_t)npos));
    w = blist + (gl ? 0 : 2 * (size_t)KK * FTP * 4);
    g = w + 4 * (size_t)2 * BCC * GROW;
    ms = g + 4 * (size_t)FTP * GROW;
    cg = ms + 4 * (size_t)2 * FTP * MROW;
    gw = cg + 4 * (size_t)2 * 2 * FTP * 4;
    gp = gw + 16 * (size_t)KK * FTP;
    gm = gp + 4 * (size_t)KK * FTP * (gl ? 2 : 1);
    gd = gm + 4 * (size_t)KK * FTP;
    bytes = gd + 4 * (size_t)KK * FTP;
  }
};

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
    // the top-left corner in this block's window; GL: in the map, and for
    // a pixel past the map one whose four corners lie outside it
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
// Backward on the tensor cores (see the design note at the top). grid (tile
// groups, ceil(C / BCC), ceil(Cout / BNO)), FNT threads. weight is
// (9, C, Cout) in the working type; dx (B, H, W, C), dweight (9, C, Cout),
// doffset and dmask are fp64 sums the caller zeroes. vec16: x and g allow
// 16-byte loads (C and Cout times the item size multiples of 16, both
// pointers 16-byte aligned). GL: the global mode, for a radius whose window
// does not fit (window_bwd_launch chooses it): no window, the corners read
// from x in global memory and dx added there, the rest as the window mode.
// The cut copies of engine/profile_dcn.py (WINDOW_TREE_SPLITS) edit the
// lines marked "split:".

// The flags of one (pixel, tap) entry that the doffset and dmask step reads:
// the hat derivatives of the two rows and the two columns (2 bits each: 1
// for +1, 2 for -1) and the clip gates of y and x.
__device__ __forceinline__ int geo_flags(const Geo& g) {
  auto code = [](float d) { return d > 0.f ? 1 : (d < 0.f ? 2 : 0); };
  return code(g.dwy[0]) | code(g.dwy[1]) << 2 | code(g.dwx[0]) << 4 | code(g.dwx[1]) << 6 |
         (g.gy != 0.f) << 8 | (g.gx != 0.f) << 9;
}

__device__ __forceinline__ float flag_sign(int f, int shift) {
  const int c = (f >> shift) & 3;
  return c == 1 ? 1.f : (c == 2 ? -1.f : 0.f);
}

__device__ __forceinline__ uint32_t fbits(float v) { return __float_as_uint(v); }

template <typename T, bool SEP, bool GL>
__device__ __forceinline__ void bwd_body(const T* __restrict__ x, const float* __restrict__ offset,
                                         const float* __restrict__ mask,
                                         const T* __restrict__ weight, const T* __restrict__ g,
                                         double* __restrict__ dx, double* __restrict__ doffset,
                                         double* __restrict__ dmask, double* __restrict__ dweight,
                                         int B, int H, int W, int C, int Cout, int r, bool vec16) {
  constexpr bool BF = sizeof(T) == 2;
  const BwdLayout L(r, sizeof(T), GL);
  extern __shared__ __align__(16) unsigned char bwd_smem_bytes[];
  T* s_x = reinterpret_cast<T*>(bwd_smem_bytes);                     // [npos][BCC] x window
  float* s_gsm = reinterpret_cast<float*>(bwd_smem_bytes + L.gsm);   // [KK][FTP][BCC] m * gs
  int* s_bstart = reinterpret_cast<int*>(bwd_smem_bytes + L.bstart); // [npos + 1] list starts
  int* s_bcnt = reinterpret_cast<int*>(bwd_smem_bytes + L.bcnt);     // [npos] counts, cursors
  unsigned short* s_blist =
      reinterpret_cast<unsigned short*>(bwd_smem_bytes + L.blist);   // (t * FTP + p) * 4 + k
  float* s_w = reinterpret_cast<float*>(bwd_smem_bytes + L.w);       // [2][BCC][GROW] W_t rows
  float* s_g = reinterpret_cast<float*>(bwd_smem_bytes + L.g);       // [FTP][GROW] g of the tile
  float* s_ms = reinterpret_cast<float*>(bwd_smem_bytes + L.ms);     // [2][FTP][MROW] m sample
  float* s_cg = reinterpret_cast<float*>(bwd_smem_bytes + L.cg);     // [2][2][FTP][4] corner dots
  float4* s_gw = reinterpret_cast<float4*>(bwd_smem_bytes + L.gw);   // [KK][FTP] wx0 wx1 wy0 wy1
  int* s_gp = reinterpret_cast<int*>(bwd_smem_bytes + L.gp);         // [KK][FTP] corner (int2: GL)
  float* s_gm = reinterpret_cast<float*>(bwd_smem_bytes + L.gm);     // [KK][FTP] mask
  int* s_gd = reinterpret_cast<int*>(bwd_smem_bytes + L.gd);         // [KK][FTP] geo_flags

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tg = lane & 3;
  const int c0 = blockIdx.y * BCC, o0 = blockIdx.z * BNO;
  const int no = min(BNO, Cout - o0);
  const int kgs = (no + 7) & ~7;  // k of the gs product: the block's out channels, padded to 8
  const int s = r + 2;
  const int ntiles = B * ((H + FTH - 1) / FTH) * ((W + FTW - 1) / FTW);
  // gs: the warp's 16 pixels (a tile row) x 8 channels; ch: this thread's two
  const int am0 = (warp & 7) * 16, an0 = (warp >> 3) * 8;
  const int ch = an0 + 2 * tg;
  // dW_t: the warp's 8 output channels x half of the tile's pixels
  const int dn0 = (warp & 7) * 8, dk0 = (warp >> 3) * (FTP / 2);
  const bool dlive = dn0 < no;

  // the window chunk of tile tl into s_x, zero outside the map and past C:
  // cp.async (one commit group) or plain loads and stores
  auto stage = [&](const Tile& tl) {
    if constexpr (GL) return;
    if (vec16) {
      constexpr int E = 16 / (int)sizeof(T);  // elements a copy takes
      constexpr int PP = BCC / E;             // copies a position
      for (int i = tid; i < L.npos * PP; i += FNT) {
        const int q = i / PP, c = c0 + (i % PP) * E;
        const int yy = tl.y0 - s + q / L.ww, xx = tl.x0 - s + q % L.ww;
        const bool valid = yy >= 0 && yy < H && xx >= 0 && xx < W && c < C;
        const T* src = x + (((size_t)tl.b * H + yy) * W + xx) * C + c;
        cp_async16z(s_x + (size_t)q * BCC + (c - c0), valid ? src : x, valid);
      }
      cp_async_commit();
    } else {
      for (int i = tid; i < L.npos * BCC; i += FNT) {
        const int q = i / BCC, c = c0 + i % BCC;
        const int yy = tl.y0 - s + q / L.ww, xx = tl.x0 - s + q % L.ww;
        const bool valid = yy >= 0 && yy < H && xx >= 0 && xx < W && c < C;
        s_x[i] = valid ? x[(((size_t)tl.b * H + yy) * W + xx) * C + c] : from_f<T>(0.f);
      }
    }
  };

  // per window position q, the list of the samples (tap t, pixel p, corner
  // k) whose corner k lands on q with a nonzero weight: counted while the
  // geometry is tabulated, starts by a prefix sum (one warp), then placed
  // (shared int atomics: the order within a list varies from run to run)
  auto corner_pos = [&](int q, int k) { return q + (k >> 1) * L.ww + (k & 1); };
  auto wk_of = [](const float4& gw, int k) {  // w_k = wy[k >> 1] * wx[k & 1]
    return __fmul_rn(k < 2 ? gw.z : gw.w, (k & 1) ? gw.y : gw.x);
  };
  auto scan = [&]() {
    if (warp != 0) return;
    const int per = (L.npos + 31) / 32, q0 = lane * per;
    int sum = 0;
    for (int i = 0; i < per; ++i)
      if (q0 + i < L.npos) sum += s_bcnt[q0 + i];
    int incl = sum;
#pragma unroll
    for (int sh = 1; sh < 32; sh <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, sh);
      if (lane >= sh) incl += v;
    }
    int run = incl - sum;
    for (int i = 0; i < per; ++i) {
      if (q0 + i >= L.npos) break;
      const int n = s_bcnt[q0 + i];
      s_bstart[q0 + i] = s_bcnt[q0 + i] = run;
      run += n;
    }
    if (lane == 31) s_bstart[L.npos] = incl;
  };
  auto place = [&]() {
    for (int i = tid; i < KK * FTP; i += FNT) {
      const float4 gw = s_gw[i];
      const int q = s_gp[i];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (wk_of(gw, k) != 0.f)
          s_blist[atomicAdd(s_bcnt + corner_pos(q, k), 1)] = (unsigned short)(i * 4 + k);
    }
  };

  // dx of the tile's window: per position and channel the fp64 sum of its
  // list's terms w_k * (m * gs), added into the fp64 dx (the values past
  // the map or C dropped); a thread takes 4 channels of a position, so that
  // each list entry feeds 4 independent sums. The counts back to zero for
  // the next tile
  auto gather = [&](const Tile& tl) {
    for (int i = tid; i < L.npos * (BCC / 4); i += FNT) {
      const int q = i / (BCC / 4), c = (i % (BCC / 4)) * 4;
      double acc[4] = {0.0, 0.0, 0.0, 0.0};
#pragma unroll 2
      for (int e = s_bstart[q], e1 = s_bstart[q + 1]; e < e1; ++e) {  // split: gather
        const int id = s_blist[e];
        const float wk = wk_of(s_gw[id >> 2], id & 3);
        const float4 v = *reinterpret_cast<const float4*>(s_gsm + (id >> 2) * BCC + c);
        acc[0] += (double)__fmul_rn(wk, v.x);
        acc[1] += (double)__fmul_rn(wk, v.y);
        acc[2] += (double)__fmul_rn(wk, v.z);
        acc[3] += (double)__fmul_rn(wk, v.w);
      }
      if (c == 0) s_bcnt[q] = 0;
      const int yy = tl.y0 - s + q / L.ww, xx = tl.x0 - s + q % L.ww;
      if (yy < 0 || yy >= H || xx < 0 || xx >= W) continue;
      double* d = dx + (((size_t)tl.b * H + yy) * W + xx) * C + c0 + c;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (acc[j] == 0.0) continue;  // split: gather zeros
        if (c0 + c + j < C) atomicAdd(d + j, acc[j]);  // split: store
      }
    }
  };

  // two elements of row c of W_t^T (the block's 16 x 64 slice of tap t):
  // loaded a tap ahead into registers, stored into weight tile buf
  auto load_w = [&](int t, float (&w)[2]) {
    const int c = c0 + (tid >> 5), o = (tid & 31) * 2;
#pragma unroll
    for (int e = 0; e < 2; ++e)
      w[e] = (c < C && o + e < no) ? to_f(weight[((size_t)t * C + c) * Cout + o0 + o + e]) : 0.f;
  };
  auto store_w = [&](const float (&w)[2], int buf) {
    *reinterpret_cast<float2*>(s_w + (buf * BCC + (tid >> 5)) * GROW + (tid & 31) * 2) =
        make_float2(w[0], w[1]);
  };

  // 16 output channels of one pixel of the tile's g, as fp32
  auto load_g = [&](const Tile& tl, float (&v)[16]) {
    const int p = tid >> 2, ob = (tid & 3) * 16;
    const int y = tl.y0 + p / FTW, xx = tl.x0 + p % FTW;
    const bool in = y < H && xx < W;
    const T* src = g + (((size_t)tl.b * H + y) * W + xx) * Cout + o0 + ob;
    if (vec16) {
      constexpr int E = 16 / (int)sizeof(T);
#pragma unroll
      for (int j = 0; j < 16; j += E) {
        uint4 u = make_uint4(0u, 0u, 0u, 0u);
        if (in && ob + j < no) u = __ldg(reinterpret_cast<const uint4*>(src + j));
        const uint32_t w4[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if constexpr (BF) {
            v[j + 2 * e] = __uint_as_float(w4[e] << 16);
            v[j + 2 * e + 1] = __uint_as_float(w4[e] & 0xffff0000u);
          } else {
            v[j + e] = __uint_as_float(w4[e]);
          }
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < 16; ++j) v[j] = (in && ob + j < no) ? to_f(src[j]) : 0.f;
    }
  };
  auto store_g = [&](const float (&v)[16]) {
    float* row = s_g + (tid >> 2) * GROW + (tid & 3) * 16;
#pragma unroll
    for (int j = 0; j < 16; j += 4)
      *reinterpret_cast<float4*>(row + j) = make_float4(v[j], v[j + 1], v[j + 2], v[j + 3]);
  };

  // the 9 taps' geometry of the tile's 128 pixels
  auto geometry = [&](const Tile& tl) {
    for (int i = tid; i < KK * FTP; i += FNT) {
      const int t = i / FTP, p = i % FTP;
      const int y = tl.y0 + p / FTW, xx = tl.x0 + p % FTW;
      const bool in = y < H && xx < W;
      const Geo gg = in ? tap_geometry<SEP>(offset, mask, tl, y, xx, t, H, W, r)
                        : empty_geometry();
      s_gw[i] = make_float4(gg.wx[0], gg.wx[1], gg.wy[0], gg.wy[1]);
      if constexpr (GL)
        reinterpret_cast<int2*>(s_gp)[i] = in ? make_int2(gg.y0, gg.x0) : make_int2(-2, -2);
      else
        s_gp[i] = in ? (gg.y0 - (tl.y0 - s)) * L.ww + (gg.x0 - (tl.x0 - s)) : 0;
      s_gm[i] = gg.m;
      s_gd[i] = geo_flags(gg);
      if constexpr (!GL) {  // count the samples that reach each window position
        const float4 gw = s_gw[i];
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (wk_of(gw, k) != 0.f) atomicAdd(s_bcnt + corner_pos(s_gp[i], k), 1);
      }
    }
  };

  // channels ch, ch + 1 of the chunk at a corner: window position q, or
  // (GL) map row yy, column xx (zero outside the map and past C)
  auto corner_w = [&](int q) -> float2 {
    if constexpr (BF)
      return __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(s_x + (size_t)q * BCC + ch));
    else
      return *reinterpret_cast<const float2*>(s_x + (size_t)q * BCC + ch);
  };
  auto corner_g = [&](int b, int yy, int xx) -> float2 {
    float2 v = make_float2(0.f, 0.f);
    if (yy >= 0 && yy < H && xx >= 0 && xx < W) {
      const T* q = x + (((size_t)b * H + yy) * W + xx) * C + c0 + ch;
      if (c0 + ch < C) v.x = to_f(q[0]);
      if (c0 + ch + 1 < C) v.y = to_f(q[1]);
    }
    return v;
  };

  float dw[KK][4];  // dW_t of the warp's (16 channels x 8 out channels) over the block's tiles
#pragma unroll
  for (int t = 0; t < KK; ++t)
#pragma unroll
    for (int i = 0; i < 4; ++i) dw[t][i] = 0.f;

  if constexpr (!GL) {
    for (int i = tid; i < L.npos; i += FNT) s_bcnt[i] = 0;
    if ((int)blockIdx.x < ntiles) stage(fwd_tile(blockIdx.x, H, W));
    __syncthreads();  // the zeroed counts
  }
  {
    float w0[2];
    load_w(0, w0);
    store_w(w0, 0);
  }

  int par = 0;  // the weight, sample and corner-dot buffer of the tile's tap 0
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const Tile tl = fwd_tile(tile, H, W);
    const bool last_tile = tile + (int)gridDim.x >= ntiles;
    {
      float gv[16];
      load_g(tl, gv);
      geometry(tl);
      store_g(gv);
    }
    if constexpr (!GL)
      if (vec16) cp_async_wait0();
    __syncthreads();  // window chunk, g, geometry and the counts, W_0
    if constexpr (!GL) {
      scan();
      __syncthreads();
      place();  // read after the ninth tap's barrier
    }

#pragma unroll
    for (int t = 0; t < KK; ++t) {
      const int buf = (par + t) & 1;
      float wn[2];
      const bool more = t + 1 < KK || !last_tile;
      if (more) load_w((t + 1) % KK, wn);

      // gs = g . W_t^T: rows am0 + gq (+8), columns ch, ch + 1. k runs over
      // the out channels in an order of its own (logical k tg and tg + 4 at
      // 2 tg and 2 tg + 1), the same for both operands, so that each
      // fragment is one 8-byte load
      float acc[4] = {0.f, 0.f, 0.f, 0.f}, acc2[4] = {0.f, 0.f, 0.f, 0.f};
      {
        const float* ga = s_g + (am0 + gq) * GROW + 2 * tg;
        const float* wb = s_w + (buf * BCC + an0 + gq) * GROW + 2 * tg;
        for (int k = 0; k < kgs; k += 8) {  // split: products
          const float2 a01 = *reinterpret_cast<const float2*>(ga + k);
          const float2 a23 = *reinterpret_cast<const float2*>(ga + 8 * GROW + k);
          const float2 bb = *reinterpret_cast<const float2*>(wb + k);
          const uint32_t a[4] = {fbits(a01.x), fbits(a23.x), fbits(a01.y), fbits(a23.y)};
          if constexpr (BF) {  // bf16 values: exact in TF32
            mma_tf32(acc, a, fbits(bb.x), fbits(bb.y));
          } else {
            uint32_t ah[4], al[4], bh0, bl0, bh1, bl1;
#pragma unroll
            for (int q = 0; q < 4; ++q) split_tf32(a[q], ah[q], al[q]);
            split_tf32(fbits(bb.x), bh0, bl0);
            split_tf32(fbits(bb.y), bh1, bl1);
            mma_tf32(acc2, al, bh0, bh1);
            mma_tf32(acc2, ah, bl0, bl1);
            mma_tf32(acc, ah, bh0, bh1);
          }
        }
      }

      // sampling, corner dots and the dx terms for pixels am0 + gq + 8 h
      float cg[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // split: sampling
        const int p = am0 + gq + 8 * h;
        const int e0 = t * FTP + p;
        const float4 gw = s_gw[e0];
        const float m = s_gm[e0];
        float2 v[4];
        int q = 0, yy = 0, xx = 0;
        if constexpr (GL) {
          const int2 yx = reinterpret_cast<const int2*>(s_gp)[e0];
          yy = yx.x, xx = yx.y;
          v[0] = corner_g(tl.b, yy, xx);
          v[1] = corner_g(tl.b, yy, xx + 1);
          v[2] = corner_g(tl.b, yy + 1, xx);
          v[3] = corner_g(tl.b, yy + 1, xx + 1);
        } else {
          q = s_gp[e0];
          v[0] = corner_w(q);
          v[1] = corner_w(q + 1);
          v[2] = corner_w(q + L.ww);
          v[3] = corner_w(q + L.ww + 1);
        }
        const float gs[2] = {acc[2 * h] + acc2[2 * h], acc[2 * h + 1] + acc2[2 * h + 1]};
        const float vx[4][2] = {{v[0].x, v[0].y}, {v[1].x, v[1].y}, {v[2].x, v[2].y},
                                {v[3].x, v[3].y}};
        float ms[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float row0 = __fadd_rn(__fmul_rn(gw.x, vx[0][e]), __fmul_rn(gw.y, vx[1][e]));
          const float row1 = __fadd_rn(__fmul_rn(gw.x, vx[2][e]), __fmul_rn(gw.y, vx[3][e]));
          ms[e] = __fmul_rn(__fadd_rn(__fmul_rn(gw.z, row0), __fmul_rn(gw.w, row1)), m);
        }
        *reinterpret_cast<float2*>(s_ms + (buf * FTP + p) * MROW + ch) = make_float2(ms[0], ms[1]);
#pragma unroll
        for (int k = 0; k < 4; ++k) cg[4 * h + k] = fmaf(gs[1], vx[k][1], gs[0] * vx[k][0]);
        const float gsm[2] = {__fmul_rn(gs[0], m), __fmul_rn(gs[1], m)};
        if constexpr (GL) {  // dx: each term added into the fp64 dx
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const float wk = wk_of(gw, k);
            const int cy = yy + (k >> 1), cx = xx + (k & 1);
            if (wk == 0.f || cy < 0 || cy >= H || cx < 0 || cx >= W) continue;
#pragma unroll
            for (int e = 0; e < 2; ++e)
              if (c0 + ch + e < C)
                atomicAdd(dx + (((size_t)tl.b * H + cy) * W + cx) * C + c0 + ch + e,
                          (double)__fmul_rn(wk, gsm[e]));
          }
        } else {  // dx: the factor m * gs, summed per window position after the ninth tap
          *reinterpret_cast<float2*>(s_gsm + (size_t)e0 * BCC + ch) = make_float2(gsm[0], gsm[1]);
        }
      }
      // the quad's corner dots, reduced in a fixed order: lane tg keeps
      // pixel am0 + gq + 8 (tg >> 1), corners 2 (tg & 1) and 2 (tg & 1) + 1
      {
        const int hb = tg >> 1, kb = tg & 1;
        float r1[4], r2[2];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float other = __shfl_xor_sync(0xffffffffu, hb ? cg[i] : cg[4 + i], 2);
          r1[i] = (hb ? cg[4 + i] : cg[i]) + other;
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float other = __shfl_xor_sync(0xffffffffu, kb ? r1[i] : r1[2 + i], 1);
          r2[i] = (kb ? r1[2 + i] : r1[i]) + other;
        }
        *reinterpret_cast<float2*>(
            s_cg + ((buf * 2 + (warp >> 3)) * FTP + am0 + gq + 8 * hb) * 4 + 2 * kb) =
            make_float2(r2[0], r2[1]);
      }
      if (more) store_w(wn, buf ^ 1);
      __syncthreads();  // the tap's samples, corner dots and dx; the next tap's weight

      // dW_t += (m sample)^T g: rows (channels) gq, gq + 8, columns (out
      // channels) dn0 + 2 tg, + 1, k over the warp's 64 pixels
      if (dlive) {  // split: products
        const float* ma = s_ms + (buf * FTP + dk0 + tg) * MROW + gq;
        const float* gb = s_g + (dk0 + tg) * GROW + dn0 + gq;
#pragma unroll 4
        for (int k = 0; k < FTP / 2; k += 8) {
          const uint32_t a[4] = {fbits(ma[k * MROW]), fbits(ma[k * MROW + 8]),
                                 fbits(ma[(k + 4) * MROW]), fbits(ma[(k + 4) * MROW + 8])};
          const uint32_t b0 = fbits(gb[k * GROW]), b1 = fbits(gb[(k + 4) * GROW]);
          uint32_t ah[4], al[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) split_tf32(a[i], ah[i], al[i]);
          if constexpr (BF) {  // g exact in TF32: 2xTF32
            mma_tf32(dw[t], al, b0, b1);
            mma_tf32(dw[t], ah, b0, b1);
          } else {
            uint32_t bh0, bl0, bh1, bl1;
            split_tf32(b0, bh0, bl0);
            split_tf32(b1, bh1, bl1);
            mma_tf32(dw[t], al, bh0, bh1);
            mma_tf32(dw[t], ah, bl0, bl1);
            mma_tf32(dw[t], ah, bh0, bh1);
          }
        }
      }

      // dmask and doffset of the tap from the corner dots (index 2a + b:
      // row a, column b) and the hat's derivative: a lane in four, so that
      // every warp takes 8 pixels
      if ((tid & 3) == 0) {
        const int p = tid >> 2;
        const int y = tl.y0 + p / FTW, xx = tl.x0 + p % FTW;
        if (y < H && xx < W) {
          const int e0 = t * FTP + p;
          const float4 gw = s_gw[e0];
          const float m = s_gm[e0];
          const int f = s_gd[e0];
          const float wx[2] = {gw.x, gw.y}, wy[2] = {gw.z, gw.w};
          const float dwy[2] = {flag_sign(f, 0), flag_sign(f, 2)};
          const float dwx[2] = {flag_sign(f, 4), flag_sign(f, 6)};
          const float* cp0 = s_cg + ((buf * 2) * FTP + p) * 4;
          const float* cp1 = s_cg + ((buf * 2 + 1) * FTP + p) * 4;
          float cgv[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) cgv[k] = cp0[k] + cp1[k];
          float dm = 0.f, doy = 0.f, dox = 0.f;
          if (SEP) {  // deform_mxu.py: doffy over the x-passed rows, doffx via dWx per column
#pragma unroll
            for (int a = 0; a < 2; ++a) {
              const float u = wx[0] * cgv[2 * a] + wx[1] * cgv[2 * a + 1];
              doy += dwy[a] * u;
              dm += wy[a] * u;
            }
#pragma unroll
            for (int bx = 0; bx < 2; ++bx) dox += dwx[bx] * (wy[0] * cgv[bx] + wy[1] * cgv[2 + bx]);
          } else {  // deform_pallas.py: both over the four window terms
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              const int a = k >> 1, bx = k & 1;
              dm += wy[a] * wx[bx] * cgv[k];
              doy += dwy[a] * wx[bx] * cgv[k];
              dox += wy[a] * dwx[bx] * cgv[k];
            }
          }
          const size_t pg = ((size_t)tl.b * H + y) * W + xx;
          const float ody = (f >> 8 & 1) ? m * doy : 0.f;
          const float odx = (f >> 9 & 1) ? m * dox : 0.f;
          if (dm != 0.f) atomicAdd(dmask + pg * KK + t, (double)dm);
          if (ody != 0.f) atomicAdd(doffset + pg * 18 + 2 * t, (double)ody);
          if (odx != 0.f) atomicAdd(doffset + pg * 18 + 2 * t + 1, (double)odx);
        }
      }
    }
    par ^= 1;  // 9 taps: the next tile's tap 0 takes the other buffers

    if constexpr (!GL) {
      // every sample of the tile was taken before the last barrier
      if (!last_tile) stage(fwd_tile(tile + gridDim.x, H, W));
      gather(tl);
    }
    __syncthreads();  // g, the geometry, the lists and m * gs are free for the next tile
  }

  // dW: the two pixel halves added in a fixed order, then into the fp64 sums
  float* s_fold = s_g;  // 36 values x 256 threads: FTP * GROW words
  if (warp >= 8 && dlive)
#pragma unroll
    for (int t = 0; t < KK; ++t)
#pragma unroll
      for (int i = 0; i < 4; ++i) s_fold[(t * 4 + i) * 256 + (tid - 256)] = dw[t][i];
  __syncthreads();
  if (warp < 8 && dlive) {
#pragma unroll
    for (int t = 0; t < KK; ++t)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = c0 + gq + 8 * (i >> 1), o = dn0 + 2 * tg + (i & 1);
        const float v = dw[t][i] + s_fold[(t * 4 + i) * 256 + tid];
        if (c < C && o < no) atomicAdd(dweight + ((size_t)t * C + c) * Cout + o0 + o, (double)v);
      }
  }
}

template <typename T, bool GL>
__global__ void __launch_bounds__(FNT, 1)
dcn_window_backward_kernel(const T* __restrict__ x, const float* __restrict__ offset,
                           const float* __restrict__ mask, const T* __restrict__ weight,
                           const T* __restrict__ g, double* __restrict__ dx,
                           double* __restrict__ doffset, double* __restrict__ dmask,
                           double* __restrict__ dweight, int B, int H, int W, int C, int Cout,
                           int r, int vec16) {
  bwd_body<T, false, GL>(x, offset, mask, weight, g, dx, doffset, dmask, dweight, B, H, W, C,
                         Cout, r, vec16 != 0);
}

template <typename T, bool GL>
__global__ void __launch_bounds__(FNT, 1)
dcn_separable_backward_kernel(const T* __restrict__ x, const float* __restrict__ offset,
                              const float* __restrict__ mask, const T* __restrict__ weight,
                              const T* __restrict__ g, double* __restrict__ dx,
                              double* __restrict__ doffset, double* __restrict__ dmask,
                              double* __restrict__ dweight, int B, int H, int W, int C, int Cout,
                              int r, int vec16) {
  bwd_body<T, true, GL>(x, offset, mask, weight, g, dx, doffset, dmask, dweight, B, H, W, C,
                        Cout, r, vec16 != 0);
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

template <typename T, bool SEP, bool GL>
int launch_bwd(const void* x, const void* offset, const void* mask, const void* weight,
               const void* g, void* dx, void* doffset, void* dmask, void* dweight, int B, int H,
               int W, int C, int Cout, int r, int groups, int vec16, cudaStream_t st) {
  void (*kernel)(const T*, const float*, const float*, const T*, const T*, double*, double*,
                 double*, double*, int, int, int, int, int, int, int) =
      SEP ? dcn_separable_backward_kernel<T, GL> : dcn_window_backward_kernel<T, GL>;
  const size_t smem = BwdLayout(r, sizeof(T), GL).bytes;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int ntiles = B * ((H + FTH - 1) / FTH) * ((W + FTW - 1) / FTW);
  const dim3 grid(groups < ntiles ? groups : ntiles, (C + BCC - 1) / BCC, (Cout + BNO - 1) / BNO);
  kernel<<<grid, FNT, smem, st>>>(
      static_cast<const T*>(x), static_cast<const float*>(offset),
      static_cast<const float*>(mask), static_cast<const T*>(weight), static_cast<const T*>(g),
      static_cast<double*>(dx), static_cast<double*>(doffset), static_cast<double*>(dmask),
      static_cast<double*>(dweight), B, H, W, C, Cout, r, vec16);
  return (int)cudaGetLastError();
}

// the backward's checks and its choice of instantiation
template <typename T, bool SEP>
int dispatch_bwd(const void* x, const void* offset, const void* mask, const void* weight,
                 const void* g, void* dx, void* doffset, void* dmask, void* dweight, int B, int H,
                 int W, int C, int Cout, int r, int groups, int vec16, int gl, cudaStream_t st) {
  if (B * H * W == 0) return 0;
  const bool aligned = (reinterpret_cast<uintptr_t>(x) & 15) == 0 &&
                       (reinterpret_cast<uintptr_t>(g) & 15) == 0 &&
                       (C * sizeof(T)) % 16 == 0 && (Cout * sizeof(T)) % 16 == 0;
  if (C < 1 || Cout < 1 || r < 0 || groups < 1 || (gl != 0 && gl != 1) || (vec16 && !aligned))
    return (int)cudaErrorInvalidValue;
  return gl ? launch_bwd<T, SEP, true>(x, offset, mask, weight, g, dx, doffset, dmask, dweight, B,
                                       H, W, C, Cout, r, groups, vec16, st)
            : launch_bwd<T, SEP, false>(x, offset, mask, weight, g, dx, doffset, dmask, dweight,
                                        B, H, W, C, Cout, r, groups, vec16, st);
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

// Shared memory (bytes) of one backward block: dtype 0 = fp32, 1 = bf16;
// global 1 = the global mode. ops/deform_pallas.py window_bwd_smem computes
// the same.
size_t dcn_window_bwd_smem_bytes(int radius, int dtype, int global) {
  return BwdLayout(radius, dtype == 1 ? 2 : 4, global != 0).bytes;
}

// The backward block's fixed shape, as ops/deform_pallas.py
// window_bwd_launch takes it: which 0 = channels a block, 1 = output
// channels a block, 2 = threads, 3 = tile rows, 4 = tile columns; -1 else.
int dcn_window_bwd_shape(int which) {
  const int shape[5] = {BCC, BNO, FNT, FTH, FTW};
  return which >= 0 && which < 5 ? shape[which] : -1;
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

// Backward entries: weight (9, C, Cout) and g (B, H, W, Cout) in the
// working type; dx (B, H, W, C), dweight (9, C, Cout), doffset (B, H, W, 18)
// and dmask (B, H, W, 9) are fp64 and zeroed by the caller (the kernel adds
// into them). groups (tile groups, grid.x), vec16 (16-byte loads of x and
// g) and global (the global mode) as window_bwd_launch chooses them;
// dtype 0 = fp32, 1 = bf16. Return cudaGetLastError(), or
// cudaErrorInvalidValue for arguments the kernel does not take.
int dcn_window_backward(const void* x, const void* offset, const void* mask, const void* weight,
                        const void* g, void* dx, void* doffset, void* dmask, void* dweight, int B,
                        int H, int W, int C, int Cout, int radius, int groups, int vec16,
                        int global, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_bwd<float, false>(x, offset, mask, weight, g, dx, doffset, dmask, dweight, B,
                                      H, W, C, Cout, radius, groups, vec16, global, st);
  if (dtype == 1)
    return dispatch_bwd<bf16, false>(x, offset, mask, weight, g, dx, doffset, dmask, dweight, B,
                                     H, W, C, Cout, radius, groups, vec16, global, st);
  return (int)cudaErrorInvalidValue;
}

int dcn_separable_backward(const void* x, const void* offset, const void* mask,
                           const void* weight, const void* g, void* dx, void* doffset,
                           void* dmask, void* dweight, int B, int H, int W, int C, int Cout,
                           int radius, int groups, int vec16, int global, int dtype,
                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_bwd<float, true>(x, offset, mask, weight, g, dx, doffset, dmask, dweight, B,
                                     H, W, C, Cout, radius, groups, vec16, global, st);
  if (dtype == 1)
    return dispatch_bwd<bf16, true>(x, offset, mask, weight, g, dx, doffset, dmask, dweight, B,
                                    H, W, C, Cout, radius, groups, vec16, global, st);
  return (int)cudaErrorInvalidValue;
}

const char* yat_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

// Greedy NMS suppression for NVIDIA Hopper (sm_90a): K4 (axis-aligned IoU)
// and K5 (rotated boxes, probiou).
//
// K4 replaces the TPU kernel yolo_ad_refine_tpu/ops/nms_pallas.py::_suppress_kernel
// and returns exactly the keep mask of ops/nms.py::_suppress: over K
// class-offset xyxy fp32 candidates, taken in index order, candidate i is
// kept iff it is still alive and its score > conf_thres; a kept i kills every
// later j with IoU > iou_thres, IoU = inter / (area_i + area_j - inter + 1e-7).
// Neither kernel assumes the scores are sorted: a score only says whether a
// candidate is valid.
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
// dynamic lane indexing. Here the work splits in two launches:
//   1. nms_mask_kernel / nms_rotated_mask_kernel: the overlap bits of 64x64
//      tiles, one 64-bit word per row i and tile, whose bit jj says "i would
//      kill j = 64*tile + jj" (j > i only). Only the tiles the walk reads are
//      launched, the upper triangle cb >= rb, nwords*(nwords+1)/2 an image,
//      four a block of 256 threads (one row a thread). A row whose score is at
//      or under conf_thres is never kept, so the walk never reads it: it is
//      neither computed nor written, and a block whose rows are all such exits
//      at once. A row computes all 64 columns and masks j <= i and j >= K
//      afterwards.
//   2. nms_reduce_kernel / nms_rotated_reduce_kernel (one body, greedy_walk,
//      under a name per kernel so that a profile tells them apart): one block
//      of 512 threads an image walks the candidates a 64-bit word at a time,
//      K/64 dependent rounds in place of K, one barrier a round. Warp 0
//      resolves word t in registers: lane l holds candidates l and l + 32
//      (their diagonal mask words, their words of columns t + 1 and t + 2 and
//      their scores, loaded two rounds ahead into one of two register sets).
//      The word's kept set is the one set of candidates that no member kills
//      (kills run forward only, so it is what the greedy order keeps). Warp 0
//      starts from all candidates and repeats kept = candidates - the OR of
//      the kept lanes' diagonal words until kept no longer changes: after
//      pass p the first p candidates are final, so it ends, and it takes the
//      longest chain of kills within the word plus one passes (two for a
//      cluster of boxes, one where nothing kills). The kept lanes' words of
//      columns t + 1 and
//      t + 2, ORed across the warp, are what word t removes from the next two
//      words. Warps 1-15 OR the kept rows' words into words t + 3 on: they
//      issue the loads (L2, coalesced along a row, a few rows a warp) in the
//      round after word t and OR them into the removed bitmask in the one
//      after that, so the loads' latency overlaps a barrier and warp 0's
//      next word, and the words land before warp 0 reads them.
// Both overlaps are written with __f*_rn intrinsics in the reference's
// order of operations and the file is compiled with -fmad=false, so they
// round like the separate fp32 ops of the JAX and PyTorch versions: K4's mask
// is bit-equal; K5's differs from the plain version only through logf and
// expf (CUDA's against torch's, last ulp), which can flip a pair whose
// probiou lies within a few ulp of iou_thres.
//
// What bounds them: phase 1 does up to K^2/2 overlaps of valid rows (~2.1M at
// K = 2048 an image; K4 ~15 flops each, its division skipped where the boxes
// do not intersect, K5 ~40, counting each log, exp, sqrt and division as one
// operation, which understates the floor: each is several instructions on the
// card) and writes up to K^2/16 bytes of masks; phase 2 is K/64 rounds an
// image whose cost is latency (a barrier, warp 0's word and the other warps'
// L2 round trip, overlapped), not bandwidth. The launch arithmetic is
// ops/nms.py:nms_launch, which nms_launch_plan below repeats.

#include <climits>
#include <cuda_runtime.h>

namespace {

using u64 = unsigned long long;

constexpr int TB = 64;                          // candidates a mask word covers
constexpr int MASK_THREADS = 256;               // mask block: MASK_TILES tiles, a row a thread
constexpr int MASK_TILES = MASK_THREADS / TB;
constexpr int WALK_THREADS = 512;               // walk block: warp 0 resolves, the rest OR
constexpr int WALK_WARPS = WALK_THREADS / 32;
constexpr int OR_ROWS = (TB + WALK_WARPS - 2) / (WALK_WARPS - 1);  // kept rows a warp 1-15 ORs
constexpr int WALK_FIXED_SMEM = 2 * 8 + 2 * TB;  // kept word and kept list, two rounds
constexpr int SMEM_DEFAULT = 48 * 1024;         // a block's shared memory without opting in
constexpr int GRID_Y_MAX = 65535;
constexpr unsigned FULL = 0xffffffffu;

struct Plan {
  long long nwords, tiles, mask_blocks_x, walk_smem;
};

// The launch of one call, as ops/nms.py:nms_launch computes it. Returns 0, or
// cudaErrorInvalidValue / cudaErrorInvalidConfiguration for a shape that
// cannot launch.
int make_plan(int B, int K, Plan* p) {
  if (B <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  p->nwords = (K + TB - 1) / TB;
  p->tiles = p->nwords * (p->nwords + 1) / 2;
  p->mask_blocks_x = (p->tiles + MASK_TILES - 1) / MASK_TILES;
  p->walk_smem = 8 * p->nwords + WALK_FIXED_SMEM;
  if (B > GRID_Y_MAX || p->walk_smem > SMEM_DEFAULT || p->mask_blocks_x > INT_MAX)
    return (int)cudaErrorInvalidConfiguration;
  return 0;
}

// Tile `idx` of an image's upper triangle, counted from the last tile row up:
// row rr = nwords - 1 - rb holds the rr + 1 tiles cb = rb .. nwords - 1.
__device__ __forceinline__ void tile_of(long long idx, int nwords, int& rb, int& cb) {
  long long r = (long long)((sqrt(8.0 * (double)idx + 1.0) - 1.0) * 0.5);
  while (r * (r + 1) / 2 > idx) --r;
  while ((r + 1) * (r + 2) / 2 <= idx) ++r;
  rb = nwords - 1 - (int)r;
  cb = rb + (int)(idx - r * (r + 1) / 2);
}

// Bits of row r of tile (rb, cb) that the walk may read: j > i, j < K.
__device__ __forceinline__ u64 tile_bits(u64 bits, int r, int rb, int cb, int K) {
  if (cb == rb) bits &= r == TB - 1 ? 0ull : ~0ull << (r + 1);
  const int jn = K - cb * TB;
  if (jn < TB) bits &= (1ull << jn) - 1;
  return bits;
}

__device__ __forceinline__ float area_rn(float x1, float y1, float x2, float y2) {
  return __fmul_rn(fmaxf(__fsub_rn(x2, x1), 0.f), fmaxf(__fsub_rn(y2, y1), 0.f));
}

// Block layout of both mask kernels: thread = 4 * row + tile, so that the
// four tiles of a block, mostly neighbours in one tile row, write each row's
// four words side by side. Padded shared rows keep the four tiles' columns
// in distinct banks.
__global__ void __launch_bounds__(MASK_THREADS)
nms_mask_kernel(const float* __restrict__ boxes, const float* __restrict__ scores, int K,
                int nwords, long long ntiles, float iou_thres, float conf_thres,
                u64* __restrict__ mask) {
  const int b = blockIdx.y;
  const int g = threadIdx.x % MASK_TILES;
  const int r = threadIdx.x / MASK_TILES;
  const long long tile = (long long)blockIdx.x * MASK_TILES + g;
  const bool live = tile < ntiles;
  int rb = 0, cb = 0;
  if (live) tile_of(tile, nwords, rb, cb);
  const int i = rb * TB + r;
  const bool row_ok = live && i < K && scores[(size_t)b * K + i] > conf_thres;
  if (!__syncthreads_or(row_ok)) return;

  __shared__ float4 sbox[MASK_TILES][TB + 1];
  __shared__ float sarea[MASK_TILES][TB + 1];
  const float* bb = boxes + (size_t)b * K * 4;
  if (live) {
    const int j = cb * TB + r;
    float4 q = make_float4(0.f, 0.f, 0.f, 0.f);
    if (j < K) q = make_float4(bb[(size_t)j * 4], bb[(size_t)j * 4 + 1], bb[(size_t)j * 4 + 2],
                               bb[(size_t)j * 4 + 3]);
    sbox[g][r] = q;
    sarea[g][r] = area_rn(q.x, q.y, q.z, q.w);
  }
  __syncthreads();
  if (!row_ok) return;

  const float x1 = bb[(size_t)i * 4 + 0];
  const float y1 = bb[(size_t)i * 4 + 1];
  const float x2 = bb[(size_t)i * 4 + 2];
  const float y2 = bb[(size_t)i * 4 + 3];
  const float ai = area_rn(x1, y1, x2, y2);
  // unrolled whole, so that each column's bit is a constant: a compare and
  // a predicated OR a pair
  u64 bits = 0ull;
#pragma unroll
  for (int jj = 0; jj < TB; ++jj) {
    const float4 q = sbox[g][jj];
    const float iw = fmaxf(__fsub_rn(fminf(x2, q.z), fmaxf(x1, q.x)), 0.f);
    const float ih = fmaxf(__fsub_rn(fminf(y2, q.w), fmaxf(y1, q.y)), 0.f);
    const float inter = __fmul_rn(iw, ih);
    // inter == 0 gives IoU +-0 whatever the (positive) denominator, so the
    // division runs only for boxes that intersect
    float iou = 0.f;
    if (inter != 0.f) {
      const float den = __fadd_rn(__fsub_rn(__fadd_rn(ai, sarea[g][jj]), inter), 1e-7f);
      iou = __fdiv_rn(inter, den);
    }
    bits |= (u64)(iou > iou_thres) << jj;
  }
  mask[((size_t)b * K + i) * nwords + cb] = tile_bits(bits, r, rb, cb, K);
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

__global__ void __launch_bounds__(MASK_THREADS)
nms_rotated_mask_kernel(const float* __restrict__ planes, const float* __restrict__ scores,
                        int K, int nwords, long long ntiles, float iou_thres, float conf_thres,
                        u64* __restrict__ mask) {
  const int b = blockIdx.y;
  const int g = threadIdx.x % MASK_TILES;
  const int r = threadIdx.x / MASK_TILES;
  const long long tile = (long long)blockIdx.x * MASK_TILES + g;
  const bool live = tile < ntiles;
  int rb = 0, cb = 0;
  if (live) tile_of(tile, nwords, rb, cb);
  const int i = rb * TB + r;
  const bool row_ok = live && i < K && scores[(size_t)b * K + i] > conf_thres;
  if (!__syncthreads_or(row_ok)) return;

  __shared__ float4 sxyab[MASK_TILES][TB + 1];  // x, y, a, b
  __shared__ float2 scsq[MASK_TILES][TB + 1];   // c, sq
  const float* pb = planes + (size_t)b * 6 * K;
  if (live) {
    const int j = cb * TB + r;
    float p[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (j < K) {
      for (int k = 0; k < 6; ++k) p[k] = pb[(size_t)k * K + j];
    }
    sxyab[g][r] = make_float4(p[0], p[1], p[2], p[3]);
    scsq[g][r] = make_float2(p[4], p[5]);
  }
  __syncthreads();
  if (!row_ok) return;

  float q[6];
  for (int k = 0; k < 6; ++k) q[k] = pb[(size_t)k * K + i];
  u64 bits = 0ull;
#pragma unroll 4
  for (int jj = 0; jj < TB; ++jj) {
    const float4 u = sxyab[g][jj];
    const float2 v = scsq[g][jj];
    const float iou = probiou_rn(q[0], q[1], q[2], q[3], q[4], q[5], u.x, u.y, u.z, u.w, v.x, v.y);
    bits |= (u64)(iou > iou_thres) << jj;
  }
  mask[((size_t)b * K + i) * nwords + cb] = tile_bits(bits, r, rb, cb, K);
}

// Warp 0's data of one word t, lane l: candidates 64t + l and 64t + l + 32,
// their diagonal words (column t), their words of columns t + 1 and t + 2
// and their scores.
struct WordLanes {
  u64 d[2], o1[2], o2[2];
  float s[2];
};

// Phase 2 for image blockIdx.x: smem holds removed (nwords words), then the
// kept word and kept list of two rounds. See the note at the top of the file.
struct Walk {
  const u64* mb;
  const float* sc;
  unsigned char* kb;
  u64* removed;
  u64* kept_word;
  unsigned char* kept_list;
  int K, nwords, lane, warp;
  float conf_thres;
  u64 a0, a1;   // warp 0: what the last two words remove from the next two
  u64 v[OR_ROWS];  // warps 1-15: the loaded words of a round's ORs
  int pend_w;      // warps 1-15: the word they go into, or -1

  __device__ __forceinline__ void fetch(WordLanes& x, int t) const {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = t * TB + lane + 32 * h;
      if (j < K) {
        const u64* row = mb + (size_t)j * nwords;
        x.d[h] = row[t];
        if (t + 1 < nwords) x.o1[h] = row[t + 1];
        if (t + 2 < nwords) x.o2[h] = row[t + 2];
        x.s[h] = sc[j];
      }
    }
  }

  // OR of the kept lanes' words `o`, across warp 0
  __device__ __forceinline__ u64 kept_or(bool kept0, bool kept1, const u64 (&o)[2]) const {
    const u64 w = (kept0 ? o[0] : 0ull) | (kept1 ? o[1] : 0ull);
    return (u64)__reduce_or_sync(FULL, (unsigned)(w >> 32)) << 32 |
           __reduce_or_sync(FULL, (unsigned)w);
  }

  // Round t, before its barrier. Warp 0 resolves word t from `x`, fetched
  // two rounds before, and fetches word t + 2 into it. Warps 1-15 OR into
  // removed the words they loaded in round t - 1 (word t - 2's kept rows) and
  // issue the loads of word t - 1's kept rows, words t + 2 on, which land
  // during the barrier and warp 0's next word.
  __device__ __forceinline__ void round(int t, WordLanes& x) {
    const int buf = t & 1;
    if (warp == 0) {
      const WordLanes c = x;
      if (t + 2 < nwords) fetch(x, t + 2);
      // removed[t] holds words t - 3 and before: their ORs ended by the last barrier
      const u64 rem = removed[t] | a0;
      const int j0 = t * TB + lane, j1 = j0 + 32;
      const u64 valid = (u64)__ballot_sync(FULL, j0 < K && c.s[0] > conf_thres) |
                        (u64)__ballot_sync(FULL, j1 < K && c.s[1] > conf_thres) << 32;
      // kept: the candidates that no kept candidate kills, by passes from
      // all of them until it holds (see the note at the top of the file)
      const u64 cand = valid & ~rem;
      u64 kept = cand;
      if (cand) {
        for (;;) {
          const u64 next = cand & ~kept_or((kept >> lane) & 1ull, (kept >> (lane + 32)) & 1ull,
                                           c.d);
          if (next == kept) break;
          kept = next;
        }
      }
      const bool kept0 = (kept >> lane) & 1ull, kept1 = (kept >> (lane + 32)) & 1ull;
      if (j0 < K) kb[j0] = kept0;
      if (j1 < K) kb[j1] = kept1;
      if (kept0) kept_list[buf * TB + __popcll(kept & ((1ull << lane) - 1))] = lane;
      if (kept1) kept_list[buf * TB + __popcll(kept & ((1ull << (lane + 32)) - 1))] = lane + 32;
      if (lane == 0) kept_word[buf] = kept;
      a0 = a1 | kept_or(kept0, kept1, c.o1);
      a1 = kept_or(kept0, kept1, c.o2);
      return;
    }
    if (pend_w >= 0) {
      u64 acc = 0ull;
#pragma unroll
      for (int r = 0; r < OR_ROWS; ++r) acc |= v[r];
      if (acc) atomicOr(removed + pend_w, acc);
      pend_w = -1;
    }
    if (t == 0) return;
    // word u = t - 1, published at the last barrier; warp 1 + q takes its
    // kept rows q, q + 15, ..., its lanes words u + 3 + lane, + 32, ...
    const int u = t - 1;
    const int nk = __popcll(kept_word[u & 1]);
    const unsigned char* kl = kept_list + (u & 1) * TB;
    const int w = u + 3 + lane;
    if (nk == 0 || w >= nwords) return;
#pragma unroll
    for (int r = 0; r < OR_ROWS; ++r) {
      const int k = warp - 1 + (WALK_WARPS - 1) * r;
      v[r] = k < nk ? mb[(size_t)(u * TB + kl[k]) * nwords + w] : 0ull;
    }
    pend_w = w;
    // words past the first 32 (more than 35 words a row) are ORed at once
    for (int w2 = w + 32; w2 < nwords; w2 += 32) {
      u64 acc = 0ull;
      for (int k = warp - 1; k < nk; k += WALK_WARPS - 1)
        acc |= mb[(size_t)(u * TB + kl[k]) * nwords + w2];
      if (acc) atomicOr(removed + w2, acc);
    }
  }
};

__device__ __forceinline__ void greedy_walk(const u64* __restrict__ mask,
                                            const float* __restrict__ scores, int K, int nwords,
                                            float conf_thres, unsigned char* __restrict__ keep,
                                            u64* smem) {
  const int b = blockIdx.x;
  Walk wk{mask + (size_t)b * K * nwords, scores + (size_t)b * K, keep + (size_t)b * K,
          smem, smem + nwords, reinterpret_cast<unsigned char*>(smem + nwords + 2),
          K, nwords, (int)threadIdx.x & 31, (int)threadIdx.x >> 5, conf_thres, 0ull, 0ull,
          {}, -1};
  for (int w = threadIdx.x; w < nwords; w += WALK_THREADS) wk.removed[w] = 0ull;
  // two lane sets, for even and odd words, so that a fetch has two rounds
  WordLanes even{{0ull, 0ull}, {0ull, 0ull}, {0ull, 0ull}, {0.f, 0.f}}, odd = even;
  if (wk.warp == 0) {
    wk.fetch(even, 0);
    if (nwords > 1) wk.fetch(odd, 1);
  }
  __syncthreads();
  for (int t = 0; t < nwords; t += 2) {
    wk.round(t, even);
    __syncthreads();
    if (t + 1 < nwords) {
      wk.round(t + 1, odd);
      __syncthreads();
    }
  }
}

__global__ void __launch_bounds__(WALK_THREADS)
nms_reduce_kernel(const u64* __restrict__ mask, const float* __restrict__ scores, int K,
                  int nwords, float conf_thres, unsigned char* __restrict__ keep) {
  extern __shared__ u64 walk_smem[];
  greedy_walk(mask, scores, K, nwords, conf_thres, keep, walk_smem);
}

__global__ void __launch_bounds__(WALK_THREADS)
nms_rotated_reduce_kernel(const u64* __restrict__ mask, const float* __restrict__ scores,
                          int K, int nwords, float conf_thres,
                          unsigned char* __restrict__ keep) {
  extern __shared__ u64 walk_smem[];
  greedy_walk(mask, scores, K, nwords, conf_thres, keep, walk_smem);
}

using mask_fn = void (*)(const float*, const float*, int, int, long long, float, float, u64*);
using walk_fn = void (*)(const u64*, const float*, int, int, float, unsigned char*);

// Both phases on stream s. Returns the plan's error or cudaGetLastError().
int launch(mask_fn mask_kernel, walk_fn walk, const void* data, const void* scores,
           void* mask_ws, void* keep, int B, int K, float iou_thres, float conf_thres,
           void* stream) {
  if (B <= 0 || K <= 0) return 0;
  Plan p;
  const int bad = make_plan(B, K, &p);
  if (bad) return bad;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scores);
  u64* mask = static_cast<u64*>(mask_ws);
  mask_kernel<<<dim3((unsigned)p.mask_blocks_x, B), MASK_THREADS, 0, s>>>(
      static_cast<const float*>(data), sc, K, (int)p.nwords, p.tiles, iou_thres, conf_thres,
      mask);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  walk<<<B, WALK_THREADS, (size_t)p.walk_smem, s>>>(mask, sc, K, (int)p.nwords, conf_thres,
                                                    static_cast<unsigned char*>(keep));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K4. boxes (B, K, 4) fp32, scores (B, K) fp32, mask_ws (B, K, ceil(K/64))
// uint64 scratch, keep (B, K) bytes. Returns a cudaError_t (0 on success).
int nms_suppress(const void* boxes, const void* scores, void* mask_ws, void* keep, int B,
                 int K, float iou_thres, float conf_thres, void* stream) {
  return launch(nms_mask_kernel, nms_reduce_kernel, boxes, scores, mask_ws, keep, B, K,
                iou_thres, conf_thres, stream);
}

// K5. planes (B, 6, K) fp32 [x, y, a, b, c, sq], the rest as K4.
int nms_rotated_suppress(const void* planes, const void* scores, void* mask_ws, void* keep,
                         int B, int K, float iou_thres, float conf_thres, void* stream) {
  return launch(nms_rotated_mask_kernel, nms_rotated_reduce_kernel, planes, scores, mask_ws,
                keep, B, K, iou_thres, conf_thres, stream);
}

// The launch of a (B, K) call, for ops/nms.py:nms_launch to be held against:
// out = [nwords, tiles an image, mask blocks, mask threads, walk blocks, walk
// threads, walk shared bytes]. Returns the plan's cudaError_t.
int nms_launch_plan(int B, int K, long long* out) {
  Plan p;
  const int bad = make_plan(B, K, &p);
  if (bad) return bad;
  const long long v[7] = {p.nwords, p.tiles, p.mask_blocks_x * B, MASK_THREADS, B,
                          WALK_THREADS, p.walk_smem};
  for (int k = 0; k < 7; ++k) out[k] = v[k];
  return 0;
}

const char* yat_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

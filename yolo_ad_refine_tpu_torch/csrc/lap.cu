// Batched linear sum assignment (the Hungarian matcher of RT-DETR) for
// NVIDIA Hopper (sm_90a).
//
// Counterpart of yolo_ad_refine_tpu/ops/lap.py (_lsa_single, :29-119), which
// runs the matcher on the device inside the jitted train step: it is no
// Pallas kernel there, but the plain alternative, scipy on the host, costs a
// host round trip and up to m^2 scans per cost matrix, B x 7 matrices a step.
//
// For each (M, N) cost matrix (rows GT slots, columns queries, M <= N) and
// its row mask, it solves the rectangular assignment problem over the valid
// rows by the shortest augmenting path with dual potentials (the algorithm
// of scipy's linear_sum_assignment, and of the JAX function), row by row in
// row order. A padded row has a constant cost, so the valid rows' optimum is
// the same whether or not it is solved; the padded rows then take the
// lowest columns no valid row took, in row order. Ties in the Dijkstra scan
// go first to an unassigned column, then to the lowest index, as in JAX.
// Every value is computed in fp32 by the same operations, in the same
// order, as the plain version (ops/lap.py linear_sum_assignment_plain), so
// the two agree bit for bit. Non-finite costs count as 0 (jnp.nan_to_num).
//
// Design: one thread block per matrix (image x level), 256 threads. The
// columns are spread over the threads; the column state (potentials v, the
// shortest path costs, the path, the column's row, the scanned flags) and the
// row state (potentials u, each row's column, the visited flags) live in
// shared memory; each scan reads one cost row from global memory, coalesced,
// and finds the next column by a block reduction over the key (path cost,
// assigned, index). The dual update runs over the threads; the augmentation
// along the stored path is serial (it is at most M steps). What bounds it is
// the chain of dependent scans, each a pass over N columns and a reduction:
// a latency chain, not bytes or arithmetic.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;
constexpr int NW = NT / 32;
constexpr float INF = 1e30f;

struct Key {
  float val;
  int taken;  // 1 where the column is assigned: a free column wins a tie
  int j;
};

__device__ __forceinline__ bool better(const Key& a, const Key& b) {
  if (a.val != b.val) return a.val < b.val;
  if (a.taken != b.taken) return a.taken < b.taken;
  return a.j < b.j;
}

__device__ __forceinline__ Key shfl_key(const Key& k, int delta) {
  Key o;
  o.val = __shfl_down_sync(0xffffffffu, k.val, delta);
  o.taken = __shfl_down_sync(0xffffffffu, k.taken, delta);
  o.j = __shfl_down_sync(0xffffffffu, k.j, delta);
  return o;
}

__global__ void __launch_bounds__(NT)
lap_kernel(const float* __restrict__ cost, const uint8_t* __restrict__ row_mask,
           int* __restrict__ col4row_out, int* __restrict__ scans_out, int M, int N) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* v = reinterpret_cast<float*>(smem);
  float* spc = v + N;
  int* path = reinterpret_cast<int*>(spc + N);
  int* row4col = path + N;
  float* u = reinterpret_cast<float*>(row4col + N);
  int* col4row = reinterpret_cast<int*>(u + M);
  uint8_t* remaining = reinterpret_cast<uint8_t*>(col4row + M);
  uint8_t* sr = remaining + N;

  __shared__ Key red[NW];
  __shared__ float s_min_val;
  __shared__ int s_i, s_sink, s_done;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long b = blockIdx.x;
  const float* C = cost + b * (long long)M * N;
  const uint8_t* valid = row_mask + b * (long long)M;

  for (int j = tid; j < N; j += NT) {
    v[j] = 0.f;
    spc[j] = INF;
    path[j] = 0;
    row4col[j] = -1;
    remaining[j] = 1;
  }
  for (int r = tid; r < M; r += NT) {
    u[r] = 0.f;
    col4row[r] = -1;
    sr[r] = 0;
  }
  int scans = 0;
  __syncthreads();

  for (int cur = 0; cur < M; ++cur) {
    if (!valid[cur]) continue;
    if (tid == 0) {
      s_i = cur;
      s_min_val = 0.f;
      s_done = 0;
    }
    __syncthreads();
    // Dijkstra for the shortest augmenting path from row cur
    while (true) {
      const int i = s_i;
      const float min_val = s_min_val;
      const float ui = u[i];
      const float* Ci = C + (long long)i * N;
      Key best{INF, 1, 0x7fffffff};
      bool any = false;
      for (int j = tid; j < N; j += NT) {
        if (!remaining[j]) continue;
        float c = Ci[j];
        if (!isfinite(c)) c = 0.f;
        const float r = ((min_val + c) - ui) - v[j];
        if (r < spc[j]) {
          spc[j] = r;
          path[j] = i;
        }
        const Key k{spc[j], row4col[j] != -1, j};
        if (!any || better(k, best)) best = k;
        any = true;
      }
      for (int d = 16; d > 0; d >>= 1) {
        const Key o = shfl_key(best, d);
        if (better(o, best)) best = o;
      }
      if (lane == 0) red[warp] = best;
      __syncthreads();
      if (tid == 0) {
        Key k = red[0];
        for (int w = 1; w < NW; ++w)
          if (better(red[w], k)) k = red[w];
        sr[i] = 1;
        remaining[k.j] = 0;
        s_min_val = k.val;
        if (row4col[k.j] == -1) {
          s_sink = k.j;
          s_done = 1;
        } else {
          s_i = row4col[k.j];
        }
      }
      ++scans;
      __syncthreads();
      if (s_done) break;
    }
    // dual updates, with col4row as it was before the augmentation
    const float min_val = s_min_val;
    for (int r = tid; r < M; r += NT)
      if (sr[r] && r != cur) u[r] = u[r] + (min_val - spc[col4row[r]]);
    if (tid == 0) u[cur] = u[cur] + min_val;
    for (int j = tid; j < N; j += NT)
      if (!remaining[j]) v[j] = v[j] + (spc[j] - min_val);
    __syncthreads();
    if (tid == 0) {  // augment along the stored path
      int j = s_sink;
      while (true) {
        const int i = path[j];
        row4col[j] = i;
        const int nxt = col4row[i];
        col4row[i] = j;
        if (i == cur) break;
        j = nxt;
      }
    }
    for (int j = tid; j < N; j += NT) {
      spc[j] = INF;
      remaining[j] = 1;
    }
    for (int r = tid; r < M; r += NT) sr[r] = 0;
    __syncthreads();
  }
  if (tid == 0) {  // padded rows: the lowest columns left, in row order
    int c = 0;
    for (int r = 0; r < M; ++r) {
      if (valid[r]) continue;
      while (row4col[c] != -1) ++c;
      col4row[r] = c++;
    }
    if (scans_out != nullptr) scans_out[b] = scans;
  }
  __syncthreads();
  for (int r = tid; r < M; r += NT) col4row_out[b * M + r] = col4row[r];
}

}  // namespace

extern "C" {

// The dynamic shared memory of a block for (M, N).
long long lap_smem_bytes(int M, int N) {
  return 16LL * N + 8LL * M + N + M;
}

// cost (B, M, N) float32, row_mask (B, M) uint8 (nonzero: valid), col4row
// (B, M) int32 out, scans (B,) int32 out (the Dijkstra scans each matrix
// took) or null; all contiguous on the device. M <= N. Returns
// cudaGetLastError().
int lap_solve(const float* cost, const uint8_t* row_mask, int* col4row, int* scans, int B,
              int M, int N, void* stream) {
  if (B == 0 || M == 0) return 0;
  if (M > N || N <= 0) return (int)cudaErrorInvalidValue;
  const long long smem = lap_smem_bytes(M, N);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        lap_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  lap_kernel<<<B, NT, (size_t)smem, static_cast<cudaStream_t>(stream)>>>(cost, row_mask, col4row,
                                                                          scans, M, N);
  return (int)cudaGetLastError();
}

const char* yat_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

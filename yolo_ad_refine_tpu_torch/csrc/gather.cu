// Row gather with a zero fill for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel `kernel` of benchmarks/bench_dcn.py::probe_pallas_gather
// (:103, pallas_call at :108), which asks whether Mosaic can gather rows of a
// VMEM-resident (H*W, C) array at dynamic per-row indices, the pattern of a
// deformable conv's tap samples. Per batch element b it computes
//
//   out[b, i, :] = x[b, j, :],  j = idx[b, i] (+ N where idx[b, i] is in [-N, -1])
//
// for x (B, N, C) and idx (B, M) int32, and a row of zeros where idx[b, i]
// < -N or >= N: the semantics of jnp.take(x, idx, axis=0, fill_value=0),
// the probe's body, under jax.vmap. The copy is bitwise, so one kernel
// serves every element type: the wrapper passes the row length in bytes.
//
// What bounds it: nothing but bytes. Each output row is one input row, so
// the card must read x and idx once and write out once; at the probe's
// shapes (B = 32, the AYHead levels 80^2, 40^2, 20^2, C = 64, M = 9 N) that
// is ~354 MB in bf16, 0.106 ms at 3.35 TB/s, nearly all of it the output.
// Design: threads over (row, 16-byte piece), neighbouring threads on
// neighbouring pieces of a row (and rows of neighbouring indices after
// them), so that the stores, which carry 88 % of the bytes, are whole
// 32-byte sectors; each thread reads its row's index (a broadcast within the
// row's threads) and issues one 16-byte load and one 16-byte store. Where the
// row length or a pointer does not allow 16-byte pieces, 8, 4 or 2 bytes.
// The random rows are read from L2 or HBM as they come: x (34 MB in bf16 at
// B = 32) fits the 50 MB L2, so its rows are mostly read from there.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;         // threads per block
constexpr int BLOCKS_MAX = 4224;  // grid-stride cap: 32 blocks of 256 threads per SM

// V: the piece a thread copies; I: the flat index type (32 bits where the
// pieces fit, else 64)
template <typename V, typename I>
__global__ void __launch_bounds__(NT)
gather_rows_kernel(const V* __restrict__ x, const int* __restrict__ idx, V* __restrict__ out,
                   I rows, int N, int M, int vpr) {
  const I total = rows * (I)vpr;
  for (I i = (I)blockIdx.x * NT + threadIdx.x; i < total; i += (I)gridDim.x * NT) {
    const I row = i / (I)vpr;  // b * M + m
    const int piece = (int)(i - row * (I)vpr);
    const I b = row / (I)M;
    int j = idx[row];
    if (j < 0) j += N;  // [-N, -1] wraps; below -N stays negative: zeros
    V v{};
    if (j >= 0 && j < N) v = x[(b * (I)N + (I)j) * (I)vpr + piece];
    out[i] = v;
  }
}

template <typename V>
int launch(const void* x, const int* idx, void* out, int B, int N, int M, long long row_bytes,
           cudaStream_t s) {
  const int vpr = (int)(row_bytes / (long long)sizeof(V));
  const long long rows = (long long)B * M;
  const long long total = rows * vpr;
  const long long want = (total + NT - 1) / NT;
  const int blocks = (int)(want < BLOCKS_MAX ? want : BLOCKS_MAX);
  if (total < (1LL << 31) && (long long)B * N * vpr < (1LL << 31)) {
    gather_rows_kernel<V, unsigned><<<blocks, NT, 0, s>>>(
        static_cast<const V*>(x), idx, static_cast<V*>(out), (unsigned)rows, N, M, vpr);
  } else {
    gather_rows_kernel<V, unsigned long long><<<blocks, NT, 0, s>>>(
        static_cast<const V*>(x), idx, static_cast<V*>(out), (unsigned long long)rows, N, M,
        vpr);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x (B, N, C) and out (B, M, C), rows of row_bytes = C * itemsize bytes
// each, contiguous; idx (B, M) int32. Returns cudaGetLastError().
int gather_rows(const void* x, const int* idx, void* out, int B, int N, int M, long long row_bytes,
                void* stream) {
  if ((long long)B * M == 0 || row_bytes == 0) return 0;
  if (N < 0 || row_bytes % 2 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uintptr_t align = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out);
  if (row_bytes % 16 == 0 && align % 16 == 0)
    return launch<uint4>(x, idx, out, B, N, M, row_bytes, s);
  if (row_bytes % 8 == 0 && align % 8 == 0)
    return launch<uint2>(x, idx, out, B, N, M, row_bytes, s);
  if (row_bytes % 4 == 0 && align % 4 == 0)
    return launch<unsigned>(x, idx, out, B, N, M, row_bytes, s);
  return launch<unsigned short>(x, idx, out, B, N, M, row_bytes, s);
}

const char* yat_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

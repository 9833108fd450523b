// next_use: next(t), the index of the next request of the same object, or T
// when the object never recurs. Belady and cost-Belady read it.
//
// Replaces: src/repro/kernels/next_use.py, next_use_pallas (body _kernel),
// the Pallas TPU kernel that walks the trace backwards one block per
// sequential grid step against a last-seen table kept in VMEM scratch.
//
// What bounds it on an H100: neither bytes (8*T: each id read once, each
// result written once) nor operations, but the chain of dependences through
// the last-seen table: request t needs the table as the requests after t
// left it. The walk is therefore sequential, and its floor on this card is
// the latency of one table read and write per chunk, not the 8*T bytes.
//
// Design: the TPU's sequential grid becomes a loop inside one block. One
// warp walks the trace from the back, 32 requests (one per lane) at a time.
// Inside a chunk, __match_any_sync on the ids finds each lane's group of
// equal ids; a lane whose group has a higher lane takes the nearest such
// lane's position, and the highest lane of each group reads the table. After
// a __syncwarp the lowest lane of each group writes its position into the
// table, which is then what the next (earlier) chunk reads. The table lives
// in shared memory when 4*N bytes fit under the opt-in limit, else in a
// global scratch buffer that the wrapper allocates; the whole block fills it
// with T first.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;

__global__ void __launch_bounds__(kThreads)
next_use_kernel(const int* __restrict__ ids, int* __restrict__ out,
                int* __restrict__ global_table, int T, int n,
                int table_in_shared) {
  extern __shared__ int shared_table[];
  int* table = table_in_shared ? shared_table : global_table;
  for (int j = threadIdx.x; j < n; j += kThreads) table[j] = T;
  __syncthreads();
  if (threadIdx.x >= 32) return;

  const int lane = threadIdx.x;
  const unsigned below = (1u << lane) - 1u;   // lanes < lane
  const unsigned above = ~below & ~(1u << lane);  // lanes > lane
  const int chunks = (T + 31) / 32;
  // Lanes past the end of a ragged last chunk share id -1, which no request
  // has, so they never pair with a real request. Every earlier chunk is
  // full, and its ids are loaded one chunk ahead of their use.
  int next_id = (chunks - 1) * 32 + lane < T ? ids[(chunks - 1) * 32 + lane]
                                             : -1;
  for (int c = chunks - 1; c >= 0; --c) {
    const int t = c * 32 + lane;
    const bool valid = t < T;
    const int id = next_id;
    if (c > 0) next_id = ids[t - 32];
    const unsigned peers = __match_any_sync(0xffffffffu, id);
    const unsigned later = peers & above;
    int nxt = 0;
    if (later)
      nxt = c * 32 + __ffs(later) - 1;
    else if (valid)
      nxt = table[id];
    __syncwarp();
    if (valid && (peers & below) == 0) table[id] = t;
    if (valid) out[t] = nxt;
    __syncwarp();
  }
}

}  // namespace

// Largest table, in int32 entries, that fits in one block's shared memory.
extern "C" int next_use_max_shared_entries() {
  int device = 0;
  int optin = 0;
  if (cudaGetDevice(&device) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return 0;
  return optin / (int)sizeof(int);
}

// ids: (T,) int32 in [0, n); out: (T,) int32. global_table: n int32 of
// scratch, read only when the table does not fit in shared memory
// (table_in_shared == 0). Returns the CUDA error of the launch, 0 on success.
extern "C" int next_use_launch(const void* ids, void* out, void* global_table,
                               int T, int n, int table_in_shared,
                               void* stream) {
  size_t smem = table_in_shared ? (size_t)n * sizeof(int) : 0;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        next_use_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  next_use_kernel<<<1, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const int*>(ids), static_cast<int*>(out),
      static_cast<int*>(global_table), T, n, table_in_shared);
  return (int)cudaGetLastError();
}

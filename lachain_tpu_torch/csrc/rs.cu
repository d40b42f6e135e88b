// Reed-Solomon matrix product over GF(2^8) and GF(2^16) for Hopper
// (sm_90a): the port of the JAX package's jitted GF matmul
// (lachain_tpu/ops/rs_batch.py _device_jit._mm :233-257 and
// _matmul_device :260-305, plain XLA, not Pallas).
//
//   lt_rs_matmul8   <- _mm over GF(2^8)  (poly 0x11D), uint8 symbols
//   lt_rs_matmul16  <- _mm over GF(2^16) (poly 0x1100B), uint16 symbols
//
// What it computes. C = A * B over GF(2^bits): for each inner index j
// where both a[r, j] and b[j, c] are nonzero, exp[log a + log b] is XORed
// into c[r, c]. This is GF.matmul's sum (rs_batch.py:79-101), bit for bit.
//
// One launch per batch call and field, over all of the call's groups.
// The XLA program ran one product per (k, n) or (k, erasure pattern)
// group, its columns padded to a power of two for the mesh. Here a launch
// takes G groups: group g multiplies its own A_g (rows_g x k_g, symbols,
// row-major, its own device buffer) into its contiguous run of columns of
// B (K x C, K >= every k_g; rows past k_g of a group's columns are not
// read) and writes those columns of C (R x C, R >= every rows_g; rows
// past rows_g are written 0). The wrapper packs the groups as int64 rows
// [A's address, rows_g, k_g, end of its columns]. The columns are exactly
// the batch's, with no padding.
//
// Work. A thread owns one column c and a tile of RT rows: it finds c's
// group by a binary search over the column ends, then walks j < k_g,
// reading b[j, c] once (consecutive threads, consecutive columns:
// coalesced) and its log once, and XORs one exp lookup into each of its
// RT accumulators. a[r, j] is the same for every thread of a warp whose
// columns share a group, so its loads and log lookups are broadcasts.
//
// Tables. GF(2^8): exp (255 entries) and log (256) as bytes in static
// shared memory, loaded by every block. GF(2^16): exp has 65,535 uint16
// entries (128 KB), log 65,536; together they exceed a block's 227 KB of
// shared memory. exp, the lookup made once per product term, goes into
// dynamic shared memory; log, looked up once per b entry and broadcast
// for a's entries, is read through the read-only path from global memory
// (L1 / L2). Both fields keep exp at `order` entries and reduce the
// exponent sum by one conditional subtraction, so the 128 KB table fits;
// GF(2^16) blocks are 1024 threads, one block per SM, on a grid of at
// most one block per SM that strides over the work, so each SM loads the
// table once.
//
// Bound. Bytes: B read once and C written once, symbols x symbol size,
// over HBM's rate. Lookups: one exp lookup per product term with both
// factors nonzero, over the shared-memory lookup rate (one a lane a clock
// on every SM). At the era's shapes the lookups bound it. The design does
// nothing yet about shared-memory bank conflicts of the random exp
// lookups (split-nibble tables with prmt, several columns a thread: later
// work).
//
// Each extern "C" entry launches on the caller's stream and returns
// cudaGetLastError(); the Python wrapper raises when it is non-zero.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int RT = 8;              // rows a thread accumulates
constexpr int BLOCK8 = 256;        // GF(2^8) threads per block
constexpr int BLOCK16 = 1024;      // GF(2^16): one block per SM
constexpr int BLOCKS_PER_SM8 = 8;  // GF(2^8) grid cap: 2048 threads an SM
constexpr int ORDER8 = 255;
constexpr int ORDER16 = 65535;

// first group whose column end lies past c (the groups' columns are
// contiguous and in order; an empty group is skipped)
__device__ __forceinline__ int group_of(const long long* groups, int G,
                                        int c) {
  int lo = 0, hi = G - 1;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(&groups[4 * mid + 3]) > c) {
      hi = mid;
    } else {
      lo = mid + 1;
    }
  }
  return lo;
}

// log through shared memory (GF(2^8)) or the read-only path (GF(2^16))
template <bool LOG_SHARED, typename Sym>
__device__ __forceinline__ uint32_t log_of(const Sym* log, uint32_t s) {
  if constexpr (LOG_SHARED) {
    return log[s];
  } else {
    return __ldg(&log[s]);
  }
}

template <typename Sym, int ORDER, bool LOG_SHARED>
__device__ __forceinline__ void matmul_body(
    const Sym* exp_s, const Sym* log, const long long* groups, int G,
    const Sym* __restrict__ b, int C, Sym* __restrict__ out, int R,
    long long items) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long w = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       w < items; w += stride) {
    const int c = (int)(w % C);
    const int r0 = (int)(w / C) * RT;
    const int g = group_of(groups, G, c);
    const Sym* a = reinterpret_cast<const Sym*>(__ldg(&groups[4 * g]));
    const int rows = (int)__ldg(&groups[4 * g + 1]);
    const int k = (int)__ldg(&groups[4 * g + 2]);
    const int live = rows - r0;  // rows of this tile inside the group
    uint32_t acc[RT];
#pragma unroll
    for (int i = 0; i < RT; ++i) acc[i] = 0;
    for (int j = 0; j < k; ++j) {
      const uint32_t s = b[(size_t)j * C + c];
      if (s == 0) continue;
      const uint32_t lb = log_of<LOG_SHARED>(log, s);
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        if (i < live) {
          const uint32_t av = __ldg(&a[(size_t)(r0 + i) * k + j]);
          if (av != 0) {
            uint32_t e = log_of<LOG_SHARED>(log, av) + lb;
            e -= e >= (uint32_t)ORDER ? (uint32_t)ORDER : 0u;
            acc[i] ^= exp_s[e];
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      if (r0 + i < R) out[(size_t)(r0 + i) * C + c] = (Sym)acc[i];
    }
  }
}

__global__ void __launch_bounds__(BLOCK8)
    rs_matmul8_kernel(const uint8_t* __restrict__ exp,
                      const uint8_t* __restrict__ log,
                      const long long* __restrict__ groups, int G,
                      const uint8_t* __restrict__ b, int C,
                      uint8_t* __restrict__ out, int R, long long items) {
  __shared__ uint8_t exp_s[ORDER8];
  __shared__ uint8_t log_s[ORDER8 + 1];
  for (int i = threadIdx.x; i <= ORDER8; i += blockDim.x) {
    log_s[i] = log[i];
    if (i < ORDER8) exp_s[i] = exp[i];
  }
  __syncthreads();
  matmul_body<uint8_t, ORDER8, true>(exp_s, log_s, groups, G, b, C, out, R,
                                     items);
}

__global__ void __launch_bounds__(BLOCK16)
    rs_matmul16_kernel(const uint16_t* __restrict__ exp,
                       const uint16_t* __restrict__ log,
                       const long long* __restrict__ groups, int G,
                       const uint16_t* __restrict__ b, int C,
                       uint16_t* __restrict__ out, int R, long long items) {
  extern __shared__ uint16_t exp16_s[];
  for (int i = threadIdx.x; i < ORDER16; i += blockDim.x) exp16_s[i] = exp[i];
  __syncthreads();
  matmul_body<uint16_t, ORDER16, false>(exp16_s, log, groups, G, b, C, out,
                                        R, items);
}

constexpr size_t SMEM16 = ORDER16 * sizeof(uint16_t);

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess) {
      sms = 0;
      return 1;
    }
  }
  return sms;
}

long long work_items(int C, int R) {
  return (long long)C * ((R + RT - 1) / RT);
}

int grid_for(long long items, int block, int cap) {
  const long long blocks = (items + block - 1) / block;
  return (int)(blocks < cap ? blocks : cap);
}

}  // namespace

extern "C" {

// exp: `order` symbols (exp[i] = 2^i), log: order + 1 symbols; groups: G
// int64 rows [A's device address, rows_g, k_g, end of its columns]; b:
// (K, C) symbols; out: (R, C) symbols.
int lt_rs_matmul8(const void* exp, const void* log, const void* groups, int G,
                  const void* b, int C, void* out, int R, void* stream) {
  const long long items = work_items(C, R);
  if (G > 0 && items > 0) {
    rs_matmul8_kernel<<<grid_for(items, BLOCK8, sm_count() * BLOCKS_PER_SM8),
                        BLOCK8, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)exp, (const uint8_t*)log, (const long long*)groups, G,
        (const uint8_t*)b, C, (uint8_t*)out, R, items);
  }
  return (int)cudaGetLastError();
}

int lt_rs_matmul16(const void* exp, const void* log, const void* groups,
                   int G, const void* b, int C, void* out, int R,
                   void* stream) {
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        rs_matmul16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)SMEM16);
    if (err != cudaSuccess) return (int)err;
    smem_set = true;
  }
  const long long items = work_items(C, R);
  if (G > 0 && items > 0) {
    rs_matmul16_kernel<<<grid_for(items, BLOCK16, sm_count()), BLOCK16,
                         SMEM16, (cudaStream_t)stream>>>(
        (const uint16_t*)exp, (const uint16_t*)log, (const long long*)groups,
        G, (const uint16_t*)b, C, (uint16_t*)out, R, items);
  }
  return (int)cudaGetLastError();
}

// Registers per thread, local (spill) bytes, threads per lane and threads
// per block of kernel `which` (0 rs_matmul8, 1 rs_matmul16), for the chip
// report.
int lt_rs_kernel_attrs(int which, int* regs, int* local_bytes,
                       int* threads_per_lane, int* block) {
  const void* fns[2] = {(const void*)rs_matmul8_kernel,
                        (const void*)rs_matmul16_kernel};
  if (which < 0 || which > 1) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, fns[which]);
  if (err != cudaSuccess) return (int)err;
  *regs = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  *threads_per_lane = 1;
  *block = which == 0 ? BLOCK8 : BLOCK16;
  return 0;
}

}  // extern "C"

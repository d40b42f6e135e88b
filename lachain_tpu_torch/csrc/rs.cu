// Reed-Solomon matrix product over GF(2^8) and GF(2^16) for Hopper
// (sm_90a): the port of the JAX package's jitted GF matmul
// (lachain_tpu/ops/rs_batch.py _device_jit._mm :233-257 and
// _matmul_device :260-305, plain XLA, not Pallas).
//
//   lt_rs_matmul8   <- _mm over GF(2^8)  (poly 0x11D), uint8 symbols
//   lt_rs_matmul16  <- _mm over GF(2^16) (poly 0x1100B), uint16 symbols
//
// What it computes. C = A * B over GF(2^bits), GF.matmul's sum
// (rs_batch.py:79-101) bit for bit. One launch per batch call and field,
// over all of the call's groups: group g multiplies its own A_g (rows_g x
// k_g) into its contiguous run of columns [col_begin, col_end) of B (K x C,
// K >= every k_g; rows past k_g of a group's columns are not read) and
// writes those columns of C (R x C, R >= every rows_g; rows past rows_g
// are written 0). The columns are exactly the caller's, with no padding.
// The kernels never see A itself, only a form of it made once per cached
// matrix on the host (ops/rs_ref.py):
//   GF(2^8): per coefficient c, two 16-entry tables c * x and c * (x << 4)
//     (32 bytes). The product by c is linear over GF(2), so c * b =
//     lo[b & 15] ^ hi[b >> 4]: no log or exp lookup, no test for zero (a
//     zero coefficient's tables are zeros). This is the split-table form
//     of Intel ISA-L's ec_init_tables / gf_vect_mul and GF-Complete's
//     "SPLIT 8 4".
//   GF(2^16): log(A), 0xFFFF at a zero coefficient (the device log table
//     maps 0 to 0xFFFF as well).
//
// Work. The wrapper (ops/rs_batch.py group_rows) cuts each group into
// items, tiles of rtile rows x ctile column units inside the group (a
// unit is a 32-bit word of 4 columns in GF(2^8), a column in GF(2^16)),
// numbered so that a group's items are adjacent, and packs one int64 row
// per group: [A's form, rows_g, k_g, col_begin, col_end, first item]. A
// persistent grid walks the items. A block finds an item's group (GF(2^8):
// each thread checks one group's item range, one round of loads;
// GF(2^16): a binary search), stages the item's part of A's form, kd j
// at a time, in
// shared memory (kept while the block's next item has the same group and
// row tile), and its threads take the tile's units, RB rows of one unit
// each.
//   GF(2^8) (rs_matmul8_kernel, 256-thread blocks, several an SM): the
//     block also stages B's words of the tile (one round of coalesced
//     loads: a thread's 22 j no longer wait on each other's loads). Per j
//     a thread builds the two nibble selectors and masks of its word once
//     (prmt's copy and sign modes); per row it reads the coefficient's 32
//     bytes as two broadcast 16-byte shared loads and selects all four
//     products with 4 prmt and 3 lop3 (two 8-entry halves a nibble, a
//     select on the nibble's top bit). It stores the 4 output bytes as
//     one word, or byte by byte where the word is not all its group's or
//     its address in C is not 4-byte aligned; a word of B at an address
//     that is not 4-byte aligned is read as two aligned words and a prmt.
//     The flush's groups lie as they come (131 columns each at N=64), so
//     a word at a group's edge is shared with its neighbour. On an H100
//     the N=64 decode ran 1.5% faster this way than on 4-column
//     boundaries, the encode (C = 131) 3.7% slower (scan_sweep.py).
//   GF(2^16) (rs_matmul16_kernel, 1024 threads, one block an SM): the
//     128 KB exp table goes into shared memory by cp.async once a launch,
//     overlapping the first item's staging; the block stages log(A) and,
//     one log lookup a symbol, log(B). A term is one broadcast read of log
//     a, an add and one conditional subtraction of 65,535 (an unsigned
//     min), one exp lookup and an XOR under the two logs' masks.
//
// Tiles (ops/rs_batch.py tiles_for, per call): rtile the call's rows up to
// 64 (GF(2^8): its tables in <= 64 KB) or 128 (GF(2^16)); ctile the column
// units that cut the call into about one item an SM, at most a block's
// threads' worth of units; kd all of k up to 32 (GF(2^8)) or 96. RB, the
// rows a thread, is a build constant (LT_RS8_ROWS = 4, LT_RS16_ROWS = 1):
// scan_sweep.py times the other values in one call (its table is in
// PERF.md). Fewer rows a thread means more threads on these small shapes,
// which are latency-bound: on an H100 GF(2^16) at 1 row beat 2 and 4 at
// every flush shape; GF(2^8) at 2 rows spilled to local memory, and at 8
// lost at N=64's shapes while winning only at the 10,000-transaction
// block's.
//
// Bound. Bytes: B read once and C written once over HBM's rate. Work: the
// terms whose two factors are both nonzero, over one term a lane a clock
// on every SM (chip_smoke.py); the GF(2^8) design's integer work (7
// instructions a word of 4 products a row, 12 a word's selectors a row
// block) on 64 INT32 lanes an SM comes to about the same time. At the
// flush's shapes neither bounds it: a launch is a few items' latency
// (launch, the group's row, a stage, k dependent shared loads) on a
// mostly idle card.
//
// Each extern "C" entry launches on the caller's stream and returns
// cudaGetLastError(); the Python wrapper raises when it is non-zero.

#include <cstdint>
#include <cuda_runtime.h>

#ifndef LT_RS8_ROWS
#define LT_RS8_ROWS 4
#endif
#ifndef LT_RS16_ROWS
#define LT_RS16_ROWS 1
#endif

namespace {

constexpr int RB8 = LT_RS8_ROWS;    // GF(2^8): rows a thread, 4 columns each
constexpr int RB16 = LT_RS16_ROWS;  // GF(2^16): rows a thread, one column
constexpr int BLOCK8 = 256;
constexpr int BLOCK16 = 1024;
constexpr int KD8 = 32;    // GF(2^8): j a stage holds at most
constexpr int RT8 = 64;    // GF(2^8): rows a tile holds at most
constexpr int CT8 = 256;   // GF(2^8): words a tile holds at most
constexpr int KD16 = 96;   // GF(2^16): j a stage holds at most
constexpr int RT16 = 128;  // GF(2^16): rows a tile holds at most
constexpr int CT16 = 256;  // GF(2^16): columns a tile holds at most
constexpr uint32_t ORDER16 = 65535;
constexpr uint32_t NO_LOG = 0xFFFF;  // log(A) and log(B) at a zero symbol
constexpr int EXP16_BYTES = 65536 * 2;  // 65,535 powers and a 0
constexpr int ROW = 6;  // int64 words of a group row

static_assert(RB8 >= 1 && RB8 <= 16 && RB16 >= 1 && RB16 <= 16, "rows a thread");

__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b, uint32_t s) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(s));
  return d;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

// One item of a launch, decoded from its group's row.
struct Item {
  const void* a;  // the group's form of A
  int k;          // the group's k
  int r0;         // first row of the tile
  int nrows;      // rows of the tile inside C (rows past rows_g are zeros)
  int live;       // rows of the tile inside the group
  int u0;         // first column unit of the tile (word or column of C)
  int nu;         // column units of the tile
  int cb, ce;     // the group's columns
  int g;          // the group
};

// The item's group, the one whose items [first, next group's first) hold
// it, found by every thread checking one group in parallel (one round of
// loads for G <= blockDim; the holder writes it to *slot): GF(2^8)'s way.
__device__ __forceinline__ int find_group_parallel(const long long* __restrict__ groups,
                                                   int G, long long items,
                                                   long long item, int* slot) {
  if (G == 1) return 0;  // uniform: no search, no barrier
  __syncthreads();  // every thread has read the last item's group
  for (int t = threadIdx.x; t < G; t += blockDim.x) {
    const long long lo = __ldg(&groups[ROW * t + 5]);
    const long long hi = t + 1 < G ? __ldg(&groups[ROW * (t + 1) + 5]) : items;
    if (lo <= item && item < hi) *slot = t;
  }
  __syncthreads();
  return *slot;
}

// The same by a binary search in every thread: GF(2^16)'s way. Its kernel
// ran 10-15% faster so on an H100 (no barrier in its item loop), while
// GF(2^8)'s spilled to local memory (scan_sweep.py beside the other).
__device__ __forceinline__ int find_group_search(const long long* __restrict__ groups,
                                                 int G, long long item) {
  int lo = 0, hi = G - 1;  // the last group whose first item is <= item
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (__ldg(&groups[ROW * mid + 5]) <= item) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  return lo;
}

// Item `item` of group g. The group's column units are [first, end)
// (words spanned in GF(2^8), columns in GF(2^16)); its items are
// ceil(R / rtile) row tiles x ceil((end - first) / ctile) column tiles,
// column tiles fastest.
template <bool WORDS>
__device__ __forceinline__ Item decode_item(const long long* __restrict__ groups,
                                            int g, long long item, int R,
                                            int rtile, int ctile) {
  Item it;
  it.g = g;
  const long long* row = groups + ROW * g;
  it.a = reinterpret_cast<const void*>(__ldg(&row[0]));
  const int rows_g = (int)__ldg(&row[1]);
  it.k = (int)__ldg(&row[2]);
  it.cb = (int)__ldg(&row[3]);
  it.ce = (int)__ldg(&row[4]);
  const int first = WORDS ? it.cb >> 2 : it.cb;
  const int end = WORDS ? (it.ce + 3) >> 2 : it.ce;
  const int ctiles = (end - first + ctile - 1) / ctile;
  const int local = (int)(item - __ldg(&row[5]));
  const int rt = local / ctiles, ct = local - rt * ctiles;
  it.r0 = rt * rtile;
  it.nrows = min(rtile, R - it.r0);
  it.live = max(0, min(it.nrows, rows_g - it.r0));
  it.u0 = first + ct * ctile;
  it.nu = min(ctile, end - it.u0);
  return it;
}

// ---------------------------------------------------------------------------
// GF(2^8)
// ---------------------------------------------------------------------------

// The 4 bytes at p (columns c..c+3 of a row of B), of which bytes [lo, hi)
// are needed: one aligned word, or two and a prmt when p's address is not
// 4-aligned (B may be a view at any byte); only words holding a needed
// byte are read.
__device__ __forceinline__ uint32_t load_word(const uint8_t* p8, int lo, int hi) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(p8);
  const int s = (int)(addr & 3);
  const uint32_t* p = reinterpret_cast<const uint32_t*>(addr - s);
  const uint32_t w0 = s + lo < 4 ? __ldg(p) : 0u;
  const uint32_t w1 = s + hi > 4 ? __ldg(p + 1) : 0u;
  return prmt(w0, w1, 0x3210u + 0x1111u * (uint32_t)s);
}

// Shared memory: the tables of rtile rows x kd j ([row][j][lo, hi] as
// uint4 pairs), then B's words of kd j x ctile words ([j][word]).
__global__ void __launch_bounds__(BLOCK8)
    rs_matmul8_kernel(const long long* __restrict__ groups, int G,
                      long long items, const uint8_t* __restrict__ b, int C,
                      uint8_t* __restrict__ out, int R, int rtile, int ctile,
                      int kd) {
  extern __shared__ uint4 smem8[];
  __shared__ int item_group;
  uint4* tab_s = smem8;
  uint32_t* word_s = reinterpret_cast<uint32_t*>(smem8 + rtile * kd * 2);
  int staged_g = -1, staged_r0 = -1, staged_j0 = -1;
  for (long long item = blockIdx.x; item < items; item += gridDim.x) {
    const Item it = decode_item<true>(
        groups, find_group_parallel(groups, G, items, item, &item_group), item, R,
        rtile, ctile);
    const uint4* tabs = reinterpret_cast<const uint4*>(it.a);
    const int nrb = (it.nrows + RB8 - 1) / RB8;
    const int units = nrb * it.nu;
    for (int base = 0; base < units; base += blockDim.x) {
      const int u = base + (int)threadIdx.x;
      const bool active = u < units;
      const int rb = active ? u / it.nu : 0;
      const int wl = active ? u - rb * it.nu : 0;
      const int c = 4 * (it.u0 + wl);
      const int lo_b = max(it.cb - c, 0), hi_b = min(it.ce - c, 4);
      const int rr0 = rb * RB8;
      uint32_t acc[RB8];
#pragma unroll
      for (int i = 0; i < RB8; ++i) acc[i] = 0;
      for (int j0 = 0; j0 < it.k; j0 += kd) {
        const int kc = min(kd, it.k - j0);
        __syncthreads();  // every thread is done with the last stage
        if (it.g != staged_g || it.r0 != staged_r0 || j0 != staged_j0) {
          for (int q = threadIdx.x; q < it.live * kc * 2; q += blockDim.x) {
            const int rr = q / (kc * 2), rem = q - rr * kc * 2;
            tab_s[rr * kd * 2 + rem] =
                __ldg(&tabs[((size_t)(it.r0 + rr) * it.k + j0) * 2 + rem]);
          }
          staged_g = it.g;
          staged_r0 = it.r0;
          staged_j0 = j0;
        }
        for (int q = threadIdx.x; q < kc * it.nu; q += blockDim.x) {
          const int jj = q / it.nu, wq = q - jj * it.nu;
          const int cq = 4 * (it.u0 + wq);
          word_s[jj * ctile + wq] = load_word(b + (long long)(j0 + jj) * C + cq,
                                              max(it.cb - cq, 0), min(it.ce - cq, 4));
        }
        __syncthreads();
        if (!active || rr0 >= it.live) continue;
        for (int jj = 0; jj < kc; ++jj) {
          const uint32_t w = word_s[jj * ctile + wl];
          uint32_t t = w & 0x07070707u;
          const uint32_t lo_sel = prmt(t | (t >> 4), 0u, 0x4420u);
          t = (w >> 4) & 0x07070707u;
          const uint32_t hi_sel = prmt(t | (t >> 4), 0u, 0x4420u);
          const uint32_t lo_mask = prmt(w << 4, 0u, 0xBA98u);
          const uint32_t hi_mask = prmt(w, 0u, 0xBA98u);
          const uint4* row = tab_s + (rr0 * kd + jj) * 2;
#pragma unroll
          for (int i = 0; i < RB8; ++i) {
            if (rr0 + i < it.live) {
              const uint4 tl = row[i * kd * 2];
              const uint4 th = row[i * kd * 2 + 1];
              const uint32_t x0 = prmt(tl.x, tl.y, lo_sel);
              const uint32_t x1 = prmt(tl.z, tl.w, lo_sel);
              const uint32_t y0 = prmt(th.x, th.y, hi_sel);
              const uint32_t y1 = prmt(th.z, th.w, hi_sel);
              acc[i] ^= ((x0 & ~lo_mask) | (x1 & lo_mask)) ^
                        ((y0 & ~hi_mask) | (y1 & hi_mask));
            }
          }
        }
      }
      if (!active) continue;
#pragma unroll
      for (int i = 0; i < RB8; ++i) {
        if (rr0 + i < it.nrows) {
          uint8_t* at = out + (long long)(it.r0 + rr0 + i) * C + c;
          if (lo_b == 0 && hi_b == 4 && (reinterpret_cast<uintptr_t>(at) & 3) == 0) {
            *reinterpret_cast<uint32_t*>(at) = acc[i];
          } else {
            for (int q = lo_b; q < hi_b; ++q) at[q] = (uint8_t)(acc[i] >> (8 * q));
          }
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// GF(2^16)
// ---------------------------------------------------------------------------

// One term: exp[log a + log b] XORed in where neither log is NO_LOG.
__device__ __forceinline__ void term16(const uint16_t* exp_s, uint32_t la,
                                       uint32_t lb, bool b_live, uint32_t& acc) {
  uint32_t e = la + lb;
  e = min(e, e - ORDER16);  // < 65,536: one subtraction, unsigned
  const uint32_t v = exp_s[e];
  if (b_live && la != NO_LOG) acc ^= v;
}

// Shared memory: exp (65,536 uint16), then log(A) of rtile rows x kd j
// ([row][j], a pitch of kd + 1 so that rows RB apart lie on other banks)
// and log(B) of kd j x ctile columns ([j][column]).
__global__ void __launch_bounds__(BLOCK16, 1)
    rs_matmul16_kernel(const uint16_t* __restrict__ exp,
                       const uint16_t* __restrict__ log,
                       const long long* __restrict__ groups, int G,
                       long long items, const uint16_t* __restrict__ b, int C,
                       uint16_t* __restrict__ out, int R, int rtile, int ctile,
                       int kd) {
  extern __shared__ uint4 smem16[];
  const int lap = kd + 1;
  uint16_t* exp_s = reinterpret_cast<uint16_t*>(smem16);
  uint16_t* la_s = exp_s + EXP16_BYTES / 2;
  uint16_t* lb_s = la_s + rtile * lap;
  for (int i = threadIdx.x; i < EXP16_BYTES / 16; i += blockDim.x) {
    cp_async16(smem16 + i, reinterpret_cast<const uint4*>(exp) + i);
  }
  asm volatile("cp.async.commit_group;\n" ::);
  int staged_g = -1, staged_r0 = -1, staged_j0 = -1;
  for (long long item = blockIdx.x; item < items; item += gridDim.x) {
    const Item it = decode_item<false>(groups, find_group_search(groups, G, item),
                                       item, R, rtile, ctile);
    const uint16_t* loga = reinterpret_cast<const uint16_t*>(it.a);
    const int nrb = (it.nrows + RB16 - 1) / RB16;
    const int units = nrb * it.nu;
    for (int base = 0; base < units; base += blockDim.x) {
      const int u = base + (int)threadIdx.x;
      const bool active = u < units;
      const int rb = active ? u / it.nu : 0;
      const int cl = active ? u - rb * it.nu : 0;
      const int rr0 = rb * RB16;
      uint32_t acc[RB16];
#pragma unroll
      for (int i = 0; i < RB16; ++i) acc[i] = 0;
      for (int j0 = 0; j0 < it.k; j0 += kd) {
        const int kc = min(kd, it.k - j0);
        __syncthreads();  // every thread is done with the last stage
        if (it.g != staged_g || it.r0 != staged_r0 || j0 != staged_j0) {
          for (int q = threadIdx.x; q < it.live * kc; q += blockDim.x) {
            const int rr = q / kc, jj = q - rr * kc;
            la_s[rr * lap + jj] = loga[(size_t)(it.r0 + rr) * it.k + j0 + jj];
          }
          staged_g = it.g;
          staged_r0 = it.r0;
          staged_j0 = j0;
        }
        for (int q = threadIdx.x; q < kc * it.nu; q += blockDim.x) {
          const int jj = q / it.nu, cc = q - jj * it.nu;
          lb_s[jj * ctile + cc] = __ldg(&log[b[(size_t)(j0 + jj) * C + it.u0 + cc]]);
        }
        cp_async_wait_all();  // the exp table (a no-op after the first)
        __syncthreads();
        if (!active || rr0 >= it.live) continue;
        for (int jj = 0; jj < kc; ++jj) {
          const uint32_t lb = lb_s[jj * ctile + cl];
          const bool b_live = lb != NO_LOG;
          const uint16_t* la_col = la_s + rr0 * lap + jj;
#pragma unroll
          for (int i = 0; i < RB16; ++i) {
            if (rr0 + i < it.live) term16(exp_s, la_col[i * lap], lb, b_live, acc[i]);
          }
        }
      }
      if (!active) continue;
#pragma unroll
      for (int i = 0; i < RB16; ++i) {
        if (rr0 + i < it.nrows) {
          out[(size_t)(it.r0 + rr0 + i) * C + it.u0 + cl] = (uint16_t)acc[i];
        }
      }
    }
  }
  cp_async_wait_all();  // a block with no item leaves no copy in flight
}

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

size_t smem_bytes8(int rtile, int ctile, int kd) {
  return (size_t)rtile * kd * 32 + (size_t)kd * ctile * 4;
}

size_t smem_bytes16(int rtile, int ctile, int kd) {
  return EXP16_BYTES + ((size_t)rtile * (kd + 1) + (size_t)kd * ctile) * 2;
}

// grid of at most `per_sm` blocks an SM
int grid_for(long long items, int per_sm) {
  const long long cap = (long long)sm_count() * per_sm;
  return (int)(items < cap ? items : cap);
}

}  // namespace

extern "C" {

// groups: G int64 rows [A's form (device address), rows_g, k_g, col_begin,
// col_end, first item]; items: the call's items; b: (K, C) symbols; out:
// (R, C) symbols; rtile rows x ctile column units a tile (words of 4
// columns in GF(2^8)), kd j a stage. GF(2^8)'s form: (rows_g, k_g, 32)
// bytes of nibble tables; GF(2^16)'s: log(A) (rows_g, k_g) uint16, with
// exp (65,536 uint16, the last 0) and log (65,536, log[0] = 0xFFFF).
int lt_rs_matmul8(const void* groups, int G, long long items, const void* b,
                  int C, void* out, int R, int rtile, int ctile, int kd,
                  void* stream) {
  if (rtile < 1 || rtile > RT8 || ctile < 1 || ctile > CT8 || kd < 1 || kd > KD8)
    return (int)cudaErrorInvalidValue;
  static bool smem_set = false;
  static int per_sm = 1;
  static size_t per_sm_smem = 0;
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        rs_matmul8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_bytes8(RT8, CT8, KD8));
    if (err != cudaSuccess) return (int)err;
    smem_set = true;
  }
  const size_t smem = smem_bytes8(rtile, ctile, kd);
  if (smem != per_sm_smem) {
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, rs_matmul8_kernel, BLOCK8, smem);
    if (err != cudaSuccess) return (int)err;
    per_sm = per_sm < 1 ? 1 : per_sm;
    per_sm_smem = smem;
  }
  if (G > 0 && items > 0) {
    rs_matmul8_kernel<<<grid_for(items, per_sm), BLOCK8, smem,
                        (cudaStream_t)stream>>>(
        (const long long*)groups, G, items, (const uint8_t*)b, C,
        (uint8_t*)out, R, rtile, ctile, kd);
  }
  return (int)cudaGetLastError();
}

int lt_rs_matmul16(const void* exp, const void* log, const void* groups,
                   int G, long long items, const void* b, int C, void* out,
                   int R, int rtile, int ctile, int kd, void* stream) {
  if (rtile < 1 || rtile > RT16 || ctile < 1 || ctile > CT16 || kd < 1 || kd > KD16)
    return (int)cudaErrorInvalidValue;
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        rs_matmul16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_bytes16(RT16, CT16, KD16));
    if (err != cudaSuccess) return (int)err;
    smem_set = true;
  }
  if (G > 0 && items > 0) {
    rs_matmul16_kernel<<<grid_for(items, 1), BLOCK16, smem_bytes16(rtile, ctile, kd),
                         (cudaStream_t)stream>>>(
        (const uint16_t*)exp, (const uint16_t*)log, (const long long*)groups,
        G, items, (const uint16_t*)b, C, (uint16_t*)out, R, rtile, ctile, kd);
  }
  return (int)cudaGetLastError();
}

// Rows a thread, columns a unit (4 columns a word, or 1), threads a
// block, and the largest rtile, ctile and kd of kernel `which` (0
// rs_matmul8, 1 rs_matmul16): what the wrapper cuts items by.
int lt_rs_geometry(int which, int* rows, int* cols, int* block, int* max_rtile,
                   int* max_ctile, int* max_kd) {
  if (which < 0 || which > 1) return (int)cudaErrorInvalidValue;
  *rows = which == 0 ? RB8 : RB16;
  *cols = which == 0 ? 4 : 1;
  *block = which == 0 ? BLOCK8 : BLOCK16;
  *max_rtile = which == 0 ? RT8 : RT16;
  *max_ctile = which == 0 ? CT8 : CT16;
  *max_kd = which == 0 ? KD8 : KD16;
  return 0;
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

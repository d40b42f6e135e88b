// BLS12-381 G2 kernels for Hopper (sm_90a): the three Pallas kernels of
// lachain_tpu/ops/pg2.py, thought through again for the card.
//
//   lt_g2_dbl       <- pg2._dbl2_kernel  (pl_dbl2,    pg2.py:218/:228)
//   lt_g2_add       <- pg2._add2_kernel  (pl_add2,    pg2.py:222/:250)
//   lt_g2_table     <- pg2._add2_kernel and _dbl2_kernel as build_table2
//                      chains them (pg2.py:356): the whole table, one launch
//   lt_g2_msm_scan  <- pg2._msm2_kernel  (_msm2_scan, pg2.py:272/:322)
//
// Representation. Fp2 = Fp[i]/(i^2 + 1) over fp.cuh's field (12 x 32-bit
// Montgomery limbs, canonical in [0, p)). A point is 72 rows X.c0 | X.c1 |
// Y.c0 | Y.c1 | Z.c0 | Z.c1, 12 rows each, lane-minor. pg2's 48-row
// component slots, its 44 x 10-bit limbs and its side-by-side packing of
// the three Karatsuba products on one lane block are TPU artifacts.
//
// Arithmetic: fp2g_mul is Karatsuba (3 Montgomery products), fp2g_sqr is
// (a+b)(a-b) and 2ab (2 products). The group law uses pg2's formulas
// (pg2._g2_dbl_val, pg2._g2_add_val, pg2.py:154-200) operation for
// operation (the group-field add groups one product otherwise, to the same
// values), so a collision p = +-q in an incomplete add gives Z = 0 exactly
// where the TPU kernel does, and the coin pipeline's escape to the host MSM
// fires on the same coins. A doubling is 16 Fp products, an add 44.
//
// Bound: integer multiply-adds, ~600 per Fp product; a 64-window scan needs
// up to 63 * (4 * 16 + 44) products per lane, the table build
// 16 + 5 + 13 * 39 = 528 (its 13 adds of one point make that point's z^2
// and z^3 once).
// Bytes are small beside them: the scan reads one 288-byte table entry per
// lane per nonzero digit, the table build writes 16.
//
// Every kernel runs on coop.cuh's group field over fp.cuh's p (BlsFp:
// carry-save column products, PTX carry chains for the carries, ballots
// between the threads), the group law inlined and the Fp2 products out of
// line, a lane on SCAN_T threads: the scan, g2_add, the table build and
// g2_dbl (since the table build is one launch it serves no main path).
// g2_add serves the tree reductions (the coin era's 12 launches, 2048 down
// to 32 lanes); one thread per lane, a launch of 4096 lanes was one lane's
// latency through 44 Fp products (0.094 ms). The table kernel builds
// build_table2's 16 entries in one launch: entry 0 zero, 1 the lane's
// point, 2 its doubling, 3..15 thirteen chained adds of the point, in
// pg2's order (a table in log depth would reach other Jacobian
// coordinates and break word-for-word identity), each entry stored as it
// is made. The scan: all windows in one launch with the accumulator and
// flag in registers,
// table[d] read from device memory after the doublings. The coin era's
// scan is latency-bound: on its Lagrange half only 22 of each coin's 64
// lanes are live and run all 64 windows, so the time a lane takes, not the
// card's throughput, sets the launch's time. While a lane's flag is set its
// accumulator is the zero point, which the doublings leave as it is: a warp
// whose lanes are all flagged skips them (lanes_any keeps the control flow
// uniform across the warp, so the shuffles run with the full warp's mask),
// and a lane of leading zero windows (the coin era's RLC half, its masked
// Lagrange lanes) costs no products.
//
// T sweep (python3 -m lachain_tpu_torch.scan_sweep; one NVIDIA H100 80GB
// HBM3 at 700 W, PERF.md), ms for the random-digit check (64 windows x
// 8192 lanes) / the coin era's layout (48 leading zero windows on the RLC
// half, 22 live lanes of 64):
//   T = 1: 12.29-12.30 / 11.92-11.95 (255 registers, 864 B spilled);
//   T = 2: 7.42-7.46 / 7.39-7.54 (248); T = 4: 8.86-8.94 / 7.21-7.22 (106)
//   <- SCAN_T, for the coin layout (the main path)
//   the sweep's variants at T = 4: the group's own shuffle mask and
//   divergent groups 38.3-38.4 / 35.3; the Fp2 products inlined 9.01-9.04
//   / 8.77-8.79 (248 registers); the entry loaded before the doublings
//   9.13-9.16 / 7.26-7.27;
//   the one-thread uint64 scan this replaced: 17.19-17.20 / 14.93-14.94.
// The same T serves g2_add (8192 lanes) and the table build (the coin
// era's 4096 lanes), medians of 10 rounds in ms (PERF.md, the table with
// its point's z powers made once): T = 1 0.0788 / 0.898 (230 / 254
// registers, the table 16 B spilled); T = 2 0.0544 / 0.547 (150 / 184);
// T = 4 0.0464 / 0.408 (72 / 96); the one-thread add and the 14-launch
// chain they replaced 0.0940-0.0951 / 1.263-1.268.
//
// Each extern "C" entry launches on the caller's stream and returns
// cudaGetLastError(); the Python wrapper raises when it is non-zero.

#include "coop.cuh"
#include "fp.cuh"

#ifndef LT_G2_SCAN_T  // the sweep builds T = 1 and 2 beside the shipped 4
#define LT_G2_SCAN_T 4
#endif

namespace {

constexpr int ROWS2 = 6 * NL;  // rows of a point: six Fp components
constexpr int WINDOW = 4;
constexpr int TABLE = 16;    // table entries: 4-bit windows
// threads per lane, and per block, of every kernel: the scan, g2_add, the
// table build and g2_dbl
constexpr int SCAN_T = LT_G2_SCAN_T;
constexpr int SCAN_BLOCK = 64;

// ---------------------------------------------------------------------------
// the group-field kernels: one lane on a group of T threads (coop.cuh)
// ---------------------------------------------------------------------------

template <int T>
using Group = CoopGroup<BlsFp, T>;

template <int T>
using FpG = CoopFp<BlsFp, T>;

template <int T>
struct Fp2G {
  FpG<T> c0, c1;
};

template <int T>
struct Pt2G {
  Fp2G<T> x, y, z;
};

template <int T>
__device__ __forceinline__ Fp2G<T> fp2g_add(const Group<T>& g,
                                            const Fp2G<T>& a,
                                            const Fp2G<T>& b) {
  return {fpg_add(g, a.c0, b.c0), fpg_add(g, a.c1, b.c1)};
}

template <int T>
__device__ __forceinline__ Fp2G<T> fp2g_sub(const Group<T>& g,
                                            const Fp2G<T>& a,
                                            const Fp2G<T>& b) {
  return {fpg_sub(g, a.c0, b.c0), fpg_sub(g, a.c1, b.c1)};
}

template <int T>
__device__ __forceinline__ Fp2G<T> fp2g_dbl(const Group<T>& g,
                                            const Fp2G<T>& a) {
  return fp2g_add(g, a, a);
}

// The scan's Fp2 products stay out of line by measurement: inlined, the
// scan took 248 registers and ran 22% slower on the coin layout (the T
// sweep's fp2inline variant).

// pg2._fp2_mul on the group field: (a + bi)(d + ei) = (ad - be) +
// ((a+b)(d+e) - ad - be) i (Karatsuba, 3 products).
template <int T>
__device__ __noinline__ Fp2G<T> fp2g_mul(const Group<T>& g, const Fp2G<T>& x,
                                         const Fp2G<T>& y) {
  const FpG<T> ad = fpg_mul(g, x.c0, y.c0);
  const FpG<T> be = fpg_mul(g, x.c1, y.c1);
  const FpG<T> k =
      fpg_mul(g, fpg_add(g, x.c0, x.c1), fpg_add(g, y.c0, y.c1));
  return {fpg_sub(g, ad, be), fpg_sub(g, fpg_sub(g, k, ad), be)};
}

// pg2._fp2_sqr on the group field: (a + bi)^2 = (a+b)(a-b) + 2ab i (2
// products).
template <int T>
__device__ __noinline__ Fp2G<T> fp2g_sqr(const Group<T>& g, const Fp2G<T>& x) {
  const FpG<T> re =
      fpg_mul(g, fpg_add(g, x.c0, x.c1), fpg_sub(g, x.c0, x.c1));
  const FpG<T> ab = fpg_mul(g, x.c0, x.c1);
  return {re, fpg_add(g, ab, ab)};
}

// pg2._g2_dbl_val on the group field: Jacobian doubling, a = 0,
// operation for operation (16 products).
template <int T>
__device__ __forceinline__ Pt2G<T> g2_dbl_g(const Group<T>& g,
                                            const Pt2G<T>& p) {
  const Fp2G<T> A = fp2g_sqr(g, p.x);
  const Fp2G<T> B = fp2g_sqr(g, p.y);
  const Fp2G<T> C = fp2g_sqr(g, B);
  Fp2G<T> D =
      fp2g_sub(g, fp2g_sub(g, fp2g_sqr(g, fp2g_add(g, p.x, B)), A), C);
  D = fp2g_dbl(g, D);
  const Fp2G<T> E = fp2g_add(g, fp2g_dbl(g, A), A);
  const Fp2G<T> F = fp2g_sqr(g, E);
  Pt2G<T> r;
  r.x = fp2g_sub(g, F, fp2g_dbl(g, D));
  const Fp2G<T> C8 = fp2g_dbl(g, fp2g_dbl(g, fp2g_dbl(g, C)));
  r.y = fp2g_sub(g, fp2g_mul(g, E, fp2g_sub(g, D, r.x)), C8);
  r.z = fp2g_dbl(g, fp2g_mul(g, p.y, p.z));
  return r;
}

// q.z^2 and q.z^3 for g2_add_g (5 products; coop.cuh's ZPow)
template <int T>
__device__ __forceinline__ ZPow<Fp2G<T>> z_pow2_g(const Group<T>& g,
                                                  const Fp2G<T>& z) {
  const Fp2G<T> zz = fp2g_sqr(g, z);
  return {zz, fp2g_mul(g, z, zz)};
}

// pg2._g2_add_val on the group field: incomplete Jacobian add, p != +-q,
// both finite, operation for operation but one. qz is q's ZPow: 39
// products here and 5 in qz, pg2's 44. S1 = Y1 * Z2^3 is grouped
// Y1 * (Z2 * Z2Z2) where pg2 has (Y1 * Z2) * Z2Z2: every Fp2 product is
// exact with canonical components, so the values are the same.
template <int T>
__device__ __forceinline__ Pt2G<T> g2_add_g(const Group<T>& g,
                                            const Pt2G<T>& p,
                                            const Pt2G<T>& q,
                                            const ZPow<Fp2G<T>>& qz) {
  const Fp2G<T> Z1Z1 = fp2g_sqr(g, p.z);
  const Fp2G<T> Z2Z2 = qz.zz;
  const Fp2G<T> U1 = fp2g_mul(g, p.x, Z2Z2);
  const Fp2G<T> U2 = fp2g_mul(g, q.x, Z1Z1);
  const Fp2G<T> S1 = fp2g_mul(g, p.y, qz.zzz);
  const Fp2G<T> S2 = fp2g_mul(g, fp2g_mul(g, q.y, p.z), Z1Z1);
  const Fp2G<T> H = fp2g_sub(g, U2, U1);
  const Fp2G<T> Rr = fp2g_sub(g, S2, S1);
  const Fp2G<T> I = fp2g_sqr(g, fp2g_dbl(g, H));
  const Fp2G<T> J = fp2g_mul(g, H, I);
  const Fp2G<T> Rr2 = fp2g_dbl(g, Rr);
  const Fp2G<T> V = fp2g_mul(g, U1, I);
  Pt2G<T> r;
  r.x = fp2g_sub(g, fp2g_sub(g, fp2g_sqr(g, Rr2), J), fp2g_dbl(g, V));
  const Fp2G<T> S1J = fp2g_mul(g, S1, J);
  r.y = fp2g_sub(g, fp2g_mul(g, Rr2, fp2g_sub(g, V, r.x)), fp2g_dbl(g, S1J));
  r.z = fp2g_dbl(g, fp2g_mul(g, fp2g_mul(g, p.z, q.z), H));
  return r;
}

// the add of any p and q (44 products)
template <int T>
__device__ __forceinline__ Pt2G<T> g2_add_g(const Group<T>& g,
                                            const Pt2G<T>& p,
                                            const Pt2G<T>& q) {
  return g2_add_g(g, p, q, z_pow2_g(g, q.z));
}

// a (72, n) point array: this thread's words of lane `lane`
template <int T>
__device__ __forceinline__ Pt2G<T> load_pt2_g(const Group<T>& g,
                                              const uint32_t* __restrict__ a,
                                              int n, int lane) {
  Pt2G<T> r;
  r.x.c0 = load_fpg(g, a, 0 * NL, n, lane);
  r.x.c1 = load_fpg(g, a, 1 * NL, n, lane);
  r.y.c0 = load_fpg(g, a, 2 * NL, n, lane);
  r.y.c1 = load_fpg(g, a, 3 * NL, n, lane);
  r.z.c0 = load_fpg(g, a, 4 * NL, n, lane);
  r.z.c1 = load_fpg(g, a, 5 * NL, n, lane);
  return r;
}

template <int T>
__device__ __forceinline__ void store_pt2_g(const Group<T>& g,
                                            uint32_t* __restrict__ a, int n,
                                            int lane, const Pt2G<T>& p) {
  store_fpg(g, a, 0 * NL, n, lane, p.x.c0);
  store_fpg(g, a, 1 * NL, n, lane, p.x.c1);
  store_fpg(g, a, 2 * NL, n, lane, p.y.c0);
  store_fpg(g, a, 3 * NL, n, lane, p.y.c1);
  store_fpg(g, a, 4 * NL, n, lane, p.z.c0);
  store_fpg(g, a, 5 * NL, n, lane, p.z.c1);
}

// table (16, 72, n): this thread's words of entry d; digit 0 selects the
// zero point (pg1._select_entry, which pg2 reuses: entry 0 never
// contributes).
template <int T>
__device__ __forceinline__ Pt2G<T> select_entry2_g(
    const Group<T>& g, const uint32_t* __restrict__ table, int d, int n,
    int lane) {
  if (d == 0) return Pt2G<T>{};
  return load_pt2_g(g, table + (size_t)d * ROWS2 * n, n, lane);
}

// pg2._dbl2_kernel on the group field: out = dbl(p), a lane on SCAN_T
// threads. An 8192-lane launch is far from the card's rate (0.0026 ms of
// multiply-adds): a lane's chain of 16 products bounds it. On SCAN_T
// threads each product's columns split 4 ways, and 4 times the warps of
// one thread a lane share the card. A lane on three groups of its warp,
// its Fp2 operations 3 levels deep (the sweep's `dbltrio`), issued twice
// the instructions a lane and ran 2.2 times slower (PERF.md). A group past
// n doubles lane 0's point and stores nothing.
template <int T>
__global__ void __launch_bounds__(SCAN_BLOCK)
    g2_dbl_kernel(const uint32_t* __restrict__ p, uint32_t* __restrict__ out,
                  int n) {
  const Group<T> g = make_coop_group<BlsFp, T>();
  bool live;
  const int col = group_lane<T, SCAN_BLOCK>(n, live);
  const Pt2G<T> r = g2_dbl_g(g, load_pt2_g(g, p, n, col));
  if (live) store_pt2_g(g, out, n, col, r);
}

// pg2._add2_kernel on the group field: out = p + q (incomplete).
template <int T>
__global__ void __launch_bounds__(SCAN_BLOCK)
    g2_add_kernel(const uint32_t* __restrict__ p,
                  const uint32_t* __restrict__ q, uint32_t* __restrict__ out,
                  int n) {
  const Group<T> g = make_coop_group<BlsFp, T>();
  bool live;
  const int col = group_lane<T, SCAN_BLOCK>(n, live);
  const Pt2G<T> r =
      g2_add_g(g, load_pt2_g(g, p, n, col), load_pt2_g(g, q, n, col));
  if (live) store_pt2_g(g, out, n, col, r);
}

// pg2.build_table2 in one launch: table (16, 72, n), pg2's chain of one
// doubling and 13 adds of the lane's point (coop.cuh chain_table), word for
// word the chain of g2_dbl and g2_add launches.
template <int T>
__global__ void __launch_bounds__(SCAN_BLOCK)
    g2_table_kernel(const uint32_t* __restrict__ lanes,
                    uint32_t* __restrict__ table, int n) {
  const Group<T> g = make_coop_group<BlsFp, T>();
  bool live;
  const int col = group_lane<T, SCAN_BLOCK>(n, live);
  const Pt2G<T> p = load_pt2_g(g, lanes, n, col);
  const ZPow<Fp2G<T>> pz = z_pow2_g(g, p.z);
  chain_table<TABLE>(
      p, live, [&](const Pt2G<T>& q) { return g2_dbl_g(g, q); },
      [&](const Pt2G<T>& q) { return g2_add_g(g, q, p, pz); },
      [&](int k, const Pt2G<T>& q) {
        store_pt2_g(g, table + (size_t)k * ROWS2 * n, n, col, q);
      });
}

// pg2._msm2_kernel semantics, all W windows in one launch: window 0 selects
// table[d]; each later window doubles 4 times, then a digit 0 keeps the
// accumulator (and keeps the flag set), a flagged accumulator takes the
// entry, and otherwise the entry is added. Digits must lie in [0, 16). A
// group past n reads no digit (digit 0: its flag stays set, it does no
// work) and stores nothing, but stays alive.
template <int T>
__global__ void __launch_bounds__(SCAN_BLOCK)
    g2_msm_scan_kernel(const uint32_t* __restrict__ table,
                       const int32_t* __restrict__ digits,
                       uint32_t* __restrict__ acc_out,
                       uint8_t* __restrict__ flag_out, int n, int nwin) {
  const Group<T> g = make_coop_group<BlsFp, T>();
  bool live;
  const int col = group_lane<T, SCAN_BLOCK>(n, live);
  int d = live ? digits[col] : 0;
  Pt2G<T> acc = select_entry2_g(g, table, d, n, col);
  bool flag = d == 0;
  int next = live && nwin > 1 ? digits[(size_t)n + col] : 0;
#pragma unroll 1
  for (int w = 1; w < nwin; ++w) {
    d = next;
    if (live && w + 1 < nwin) next = digits[(size_t)(w + 1) * n + col];
    if (lanes_any(g, !flag)) {  // a flagged accumulator is the zero point
#pragma unroll 1
      for (int k = 0; k < WINDOW; ++k) acc = g2_dbl_g(g, acc);
    }
    const Pt2G<T> entry = select_entry2_g(g, table, d, n, col);
    const bool add = d != 0 && !flag;
    if (lanes_any(g, add)) {
      const Pt2G<T> sum = g2_add_g(g, acc, entry);
      if (add) acc = sum;
    }
    if (d != 0 && flag) acc = entry;
    flag = flag && d == 0;
  }
  if (live) {
    store_pt2_g(g, acc_out, n, col, acc);
    if (g.rank == 0) flag_out[col] = flag ? 1 : 0;
  }
}

}  // namespace

extern "C" {

int lt_g2_dbl(const void* p, void* out, int n, void* stream) {
  if (n > 0) {
    g2_dbl_kernel<SCAN_T>
        <<<group_blocks<SCAN_T, SCAN_BLOCK>(n), SCAN_BLOCK, 0,
           (cudaStream_t)stream>>>((const uint32_t*)p, (uint32_t*)out, n);
  }
  return (int)cudaGetLastError();
}

int lt_g2_add(const void* p, const void* q, void* out, int n, void* stream) {
  if (n > 0) {
    g2_add_kernel<SCAN_T>
        <<<group_blocks<SCAN_T, SCAN_BLOCK>(n), SCAN_BLOCK, 0,
           (cudaStream_t)stream>>>(
            (const uint32_t*)p, (const uint32_t*)q, (uint32_t*)out, n);
  }
  return (int)cudaGetLastError();
}

int lt_g2_table(const void* lanes, void* table, int n, void* stream) {
  if (n > 0) {
    g2_table_kernel<SCAN_T>
        <<<group_blocks<SCAN_T, SCAN_BLOCK>(n), SCAN_BLOCK, 0,
           (cudaStream_t)stream>>>(
            (const uint32_t*)lanes, (uint32_t*)table, n);
  }
  return (int)cudaGetLastError();
}

int lt_g2_msm_scan(const void* table, const void* digits, void* acc,
                   void* flags, int n, int nwin, void* stream) {
  if (n > 0 && nwin > 0) {
    g2_msm_scan_kernel<SCAN_T>
        <<<group_blocks<SCAN_T, SCAN_BLOCK>(n), SCAN_BLOCK, 0,
           (cudaStream_t)stream>>>(
            (const uint32_t*)table, (const int32_t*)digits, (uint32_t*)acc,
            (uint8_t*)flags, n, nwin);
  }
  return (int)cudaGetLastError();
}

// Registers per thread, local (spill) bytes, threads per lane and threads
// per block of kernel `which` (0 dbl, 1 add, 2 msm_scan, 3 table), for the
// chip report.
int lt_g2_kernel_attrs(int which, int* regs, int* local_bytes,
                       int* threads_per_lane, int* block) {
  const void* fns[4] = {(const void*)g2_dbl_kernel<SCAN_T>,
                        (const void*)g2_add_kernel<SCAN_T>,
                        (const void*)g2_msm_scan_kernel<SCAN_T>,
                        (const void*)g2_table_kernel<SCAN_T>};
  if (which < 0 || which > 3) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, fns[which]);
  if (err != cudaSuccess) return (int)err;
  *regs = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  *threads_per_lane = SCAN_T;
  *block = SCAN_BLOCK;
  return 0;
}

}  // extern "C"

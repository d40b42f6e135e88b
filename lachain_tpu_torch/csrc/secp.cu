// secp256k1 kernels for Hopper (sm_90a): the three Pallas kernels of
// lachain_tpu/ops/psecp.py and its XLA square root, thought through again
// for the card. They run batched ECDSA public-key recovery.
//
//   lt_secp_dbl       <- psecp._dbl_kernel  (pl_dbl,    psecp.py:235/:243)
//   lt_secp_add       <- psecp._add_kernel  (pl_add,    psecp.py:239/:264)
//   lt_secp_table     <- psecp._add_kernel and _dbl_kernel as build_table
//                        chains them (psecp.py:364): the table, one launch
//   lt_secp_msm_scan  <- psecp._msm_kernel  (_msm_scan, psecp.py:285/:331)
//   lt_secp_sqrt      <- psecp.sqrt_kernel  (plain XLA, psecp.py:380), plain
//                        words in and out
//   lt_secp_fp_mul    the field product (psecp._mul, :121)
//   lt_secp_mont      this port's own: every element of a buffer into or
//                     out of Montgomery form, in one launch (psecp has no
//                     Montgomery form)
//
// Representation. psecp's 26 x 10-bit signed limbs, its f32 MXU residue
// fold and its 32-row component slots are TPU artifacts. Here a field
// element is 8 x 32-bit limbs in Montgomery form (R = 2^256), always
// canonical in [0, p); a point is 24 rows X | Y | Z, lane-minor, so a
// warp's loads of one limb coalesce. Every kernel of this file runs on
// coop.cuh's group field over this file's p (SecpFp); the file has no
// one-thread field or point code.
//
// p = 2^256 - 2^32 - 977 fills its top limb, so a + b and the Montgomery
// product's last step can carry out of 256 bits (unlike the BLS field,
// fp.cuh:53): coop.cuh's add and product, with SecpFp::top_carry, take
// that carry word into the final conditional subtraction.
//
// Multiply: coop.cuh's CIOS Montgomery product over carry-save columns
// split across the group's threads, 2*8*8 + 8 word products. The group law
// uses psecp's formulas (psecp._pt_dbl_val, psecp._pt_add_val, :158-194)
// operation for operation (the group-field add groups one product
// otherwise, to the same values), so a collision p = +-q in an incomplete
// add gives Z = 0 exactly where the TPU kernel does, and the recover path's
// escape to the host oracle fires on the same signatures. A doubling is 7
// products, an add 16.
//
// Bound: integer multiply-adds (a 64-window scan needs up to
// 63 * (4 * 7 + 16) field products per lane, the table build 7 + 2 + 13 *
// 14 = 191: its 13 adds of one point make that point's z^2 and z^3 once;
// these count a squaring as a product. The square root needs 254
// squarings at 108 word products, 15 products at 136 and one reduction
// at 72: 29,544 word products a lane). Bytes are small beside them: the scan
// reads one 96-byte table entry per lane per nonzero digit. The
// Montgomery conversions are bound by their bytes (32 in and out a
// coordinate against 136 or 72 word products).
//
// fp_mul and dbl: a lane on SCAN_T threads like add. Since the table
// build is one launch, dbl serves no main path, and since the conversions
// are secp_mont, neither does fp_mul; both are bound by one launch's
// latency and a lane's product chain, not by their bytes.
//
// The square root: where psecp walks the exponent's bits (501 products a
// lane), sqrt runs libsecp256k1's addition chain for (p+1)/4 (268), on the
// group field, and converts into and out of Montgomery form itself: a pure
// product chain, no branch on data, so every warp stays converged. Its
// lanes are the batch's, with no padding to a power of two.
//
// Every kernel (the scan, add, dbl, fp_mul, the table build, sqrt, mont):
// SCAN_T threads per lane on coop.cuh's group field over secp256k1 (SecpFp:
// carry-save column products, PTX carry chains, ballots between the
// threads, the carry word past 256 bits folded into the top thread's carry
// out), the group law inlined. add serves recover_kernel's pair add (one
// launch a chunk); the table kernel builds build_table's 16 entries in one
// launch in psecp's order (entry 2 a doubling, 3..15 thirteen chained adds
// of the point), each entry stored as it is made; both branch only around
// their stores. The scan: all windows in one launch
// with the accumulator and flag in registers, table[d] read from device
// memory after the doublings. The recovery's lanes are nearly all live
// (interleaved [R_i, G] with full 256-bit digits u1, u2), so more warps on
// the card turn into throughput. While a lane's flag is set its
// accumulator is the zero point (0, 0, 0), which the doubling maps to
// itself: a warp whose lanes are all flagged skips the doublings
// (lanes_any keeps the control flow uniform across the warp, so the
// shuffles run with the full warp's mask), and a flagged lane in a
// doubling warp stays exact (the z = 0 signatures' G lanes stay flagged
// through all 64 windows).
//
// T sweep (python3 -m lachain_tpu_torch.scan_sweep; one NVIDIA H100 80GB
// HBM3 at 700 W, PERF.md), ms for the random-digit check (64 windows
// x 8192 lanes) / one 4096-signature recovery chunk (secp.recover_layout):
//   T = 1: 3.022-3.041 / 3.019-3.039 (148 registers);
//   T = 2: 2.248-2.255 / 2.246-2.254 (96, 12 B spilled);
//   T = 4: 1.583-1.613 / 1.595-1.606 (72)  <- SCAN_T
//   the sweep's variants at T = 4: the group's own shuffle mask and
//   divergent groups 10.36-10.38 / 10.19-10.20; the entry loaded before
//   the doublings 1.624-1.674 / 1.635-1.699;
//   the one-thread uint64 scan this replaced: 3.81-3.84 / 3.81-3.84.
// The same T serves add and the table build, medians of 10 rounds in ms
// (PERF.md): add at 8192 lanes / at a chunk's pair add (4096
// lanes); the table at a chunk's 8192 lanes:
//   T = 1: 0.0138 / 0.0137, 0.158 (96 / 142 registers, the add 12 B
//   spilled);
//   T = 2: 0.0108 / 0.0109, 0.120 (78 / 80);
//   T = 4: 0.0103 / 0.0089, 0.112 (56 / 54)  <- SCAN_T
//   the one-thread add and the 14-launch chain they replaced: 0.0248 /
//   0.0246, 0.341.
// The same T serves the square root and the conversions, medians of 10
// rounds in ms: sqrt at the 16,384-lane check / the recovery's 9,980
// lanes; secp_mont into form on a chunk's (24, 8192) pack / out of it on
// a (25, 8192) buffer with its flag row:
//   T = 1: 0.168 / 0.167, 0.0046 / 0.0044 (88 / 50 registers);
//   T = 2: 0.192 / 0.187, 0.0043 / 0.0042 (52 / 38);
//   T = 4: 0.211 / 0.166, 0.0043 / 0.0044 (38 / 28)  <- SCAN_T
//   T = 8: 0.309 / 0.203, 0.0049 / 0.0050 (26 / 26);
//   the one-thread bit walk and the secp_fp_mul conversions they
//   replaced (permute copies, an uploaded constant): 0.362 / 0.361,
//   0.089 / 0.093.
// At 16,384 lanes T = 1 wins (the card is full, and the group field's
// shuffles and ballots cost issue slots); at the recovery's 9,980 one
// thread a lane leaves the schedulers short of warps and T = 4 ties it.
// The same T serves dbl and fp_mul, medians of 10 rounds in ms at 8192
// lanes with the stream held while the sweep enqueues (a launch's host
// time is longer than either kernel), dbl / fp_mul:
//   T = 1: 0.00764 / 0.00281 (80 / 42 registers);
//   T = 2: 0.00684 / 0.00285 (48 / 34);
//   T = 4: 0.00696 / 0.00281 (32 / 28)  <- SCAN_T
//   T = 8: 0.00766 / 0.00316 (32 / 18);
//   the one-thread kernels they replaced: 0.00966 / 0.00289 (90 registers
//   and 96 local bytes / 40).
// T = 2 leads the doubling by 1.7% and trails the product; the product
// reads the same at every T and on one thread: the launch, not its 136
// word products a lane, sets its time.
//
// Each extern "C" entry launches on the caller's stream and returns
// cudaGetLastError(); the Python wrapper raises when it is non-zero.

#include <cstdint>
#include <cuda_runtime.h>

#include "coop.cuh"

#ifndef LT_SECP_SCAN_T  // the sweep builds the other values of T beside it
#define LT_SECP_SCAN_T 4
#endif

namespace {

constexpr int NL = 8;        // 32-bit limbs per field element
constexpr int PR = 3 * NL;   // rows per point: X | Y | Z
constexpr int WINDOW = 4;
constexpr int TABLE = 16;    // entries k*P, k in [0, 16)
constexpr int SCAN_T = LT_SECP_SCAN_T;  // threads per lane (group field)
constexpr int SCAN_BLOCK = 64;          // their threads per block

__constant__ uint32_t kP[NL] = {
    0xfffffc2fu, 0xfffffffeu, 0xffffffffu, 0xffffffffu,
    0xffffffffu, 0xffffffffu, 0xffffffffu, 0xffffffffu};
constexpr uint32_t kPInv = 0xd2253531u;  // -p^-1 mod 2^32
// 7 in Montgomery form: 7 * 2^256 mod p
__constant__ uint32_t kSevenR[NL] = {0x00001ab7u, 0x00000007u, 0u, 0u,
                                     0u, 0u, 0u, 0u};
// R^2 mod p = 2^512 mod p: a product by it converts into Montgomery form
__constant__ uint32_t kR2[NL] = {0x000e90a1u, 0x000007a2u, 0x00000001u, 0u,
                                 0u, 0u, 0u, 0u};

// ---------------------------------------------------------------------------
// every kernel: one lane on a group of T threads (coop.cuh over secp256k1)
// ---------------------------------------------------------------------------

// p = 2^256 - 2^32 - 977 fills its top word: a sum below 2p can carry out
// of the group, and the carry word reaches the conditional subtraction.
struct SecpFp {
  static constexpr int words = NL;
  static constexpr uint32_t pinv = kPInv;
  static constexpr bool top_carry = true;
  static __device__ __forceinline__ uint32_t p_word(int i) { return kP[i]; }
};

template <int T>
using SecpGroup = CoopGroup<SecpFp, T>;

template <int T>
using FeG = CoopFp<SecpFp, T>;

template <int T>
using PtG = CoopPt<SecpFp, T>;

// psecp._pt_dbl_val on the group field: Jacobian doubling, a = 0, 7
// products, operation for operation.
template <int T>
__device__ __forceinline__ PtG<T> secp_dbl_g(const SecpGroup<T>& g,
                                             const PtG<T>& p) {
  const FeG<T> A = fpg_sqr(g, p.x);
  const FeG<T> B = fpg_sqr(g, p.y);
  const FeG<T> C = fpg_sqr(g, B);
  FeG<T> D = fpg_sub(g, fpg_sub(g, fpg_sqr(g, fpg_add(g, p.x, B)), A), C);
  D = fpg_add(g, D, D);
  const FeG<T> E = fpg_add(g, fpg_add(g, A, A), A);
  const FeG<T> F = fpg_sqr(g, E);
  PtG<T> r;
  r.x = fpg_sub(g, F, fpg_add(g, D, D));
  FeG<T> C8 = fpg_add(g, C, C);
  C8 = fpg_add(g, C8, C8);
  C8 = fpg_add(g, C8, C8);
  r.y = fpg_sub(g, fpg_mul(g, E, fpg_sub(g, D, r.x)), C8);
  const FeG<T> Z3 = fpg_mul(g, p.y, p.z);
  r.z = fpg_add(g, Z3, Z3);
  return r;
}

// psecp._pt_add_val on the group field: incomplete Jacobian add, p != +-q,
// both finite; p = +-q gives Z = 0, as there. qz is q's ZPow (coop.cuh):
// 14 products here and 2 in qz, psecp's 16. S1 = Y1 * Z2^3 is grouped
// Y1 * (Z2 * Z2Z2) where psecp has (Y1 * Z2) * Z2Z2: every product is the
// canonical residue, so the values are the same.
template <int T>
__device__ __forceinline__ PtG<T> secp_add_g(const SecpGroup<T>& g,
                                             const PtG<T>& p, const PtG<T>& q,
                                             const ZPow<FeG<T>>& qz) {
  const FeG<T> Z1Z1 = fpg_sqr(g, p.z);
  const FeG<T> Z2Z2 = qz.zz;
  const FeG<T> U1 = fpg_mul(g, p.x, Z2Z2);
  const FeG<T> U2 = fpg_mul(g, q.x, Z1Z1);
  const FeG<T> S1 = fpg_mul(g, p.y, qz.zzz);
  const FeG<T> S2 = fpg_mul(g, fpg_mul(g, q.y, p.z), Z1Z1);
  const FeG<T> H = fpg_sub(g, U2, U1);
  const FeG<T> Rr = fpg_sub(g, S2, S1);
  const FeG<T> I = fpg_sqr(g, fpg_add(g, H, H));
  const FeG<T> J = fpg_mul(g, H, I);
  const FeG<T> Rr2 = fpg_add(g, Rr, Rr);
  const FeG<T> V = fpg_mul(g, U1, I);
  PtG<T> r;
  r.x = fpg_sub(g, fpg_sub(g, fpg_sqr(g, Rr2), J), fpg_add(g, V, V));
  const FeG<T> S1J = fpg_mul(g, S1, J);
  r.y = fpg_sub(g, fpg_mul(g, Rr2, fpg_sub(g, V, r.x)), fpg_add(g, S1J, S1J));
  const FeG<T> Z3 = fpg_mul(g, fpg_mul(g, p.z, q.z), H);
  r.z = fpg_add(g, Z3, Z3);
  return r;
}

// the add of any p and q (16 products)
template <int T>
__device__ __forceinline__ PtG<T> secp_add_g(const SecpGroup<T>& g,
                                             const PtG<T>& p,
                                             const PtG<T>& q) {
  return secp_add_g(g, p, q, z_pow_g(g, q.z));
}

// psecp._add_kernel on the group field: out = p + q (incomplete). A group
// past n adds lane 0's points and stores nothing.
template <int T>
__global__ void __launch_bounds__(SCAN_BLOCK)
    secp_add_kernel(const uint32_t* __restrict__ p,
                    const uint32_t* __restrict__ q, uint32_t* __restrict__ out,
                    int n) {
  const SecpGroup<T> g = make_coop_group<SecpFp, T>();
  bool live;
  const int col = group_lane<T, SCAN_BLOCK>(n, live);
  const PtG<T> r =
      secp_add_g(g, load_pt_g(g, p, n, col), load_pt_g(g, q, n, col));
  if (live) store_pt_g(g, out, n, col, r);
}

// psecp._dbl_kernel on the group field: out = dbl(p), a lane on SCAN_T
// threads. An 8192-lane launch is far from both of the card's rates (its
// bound is 0.00047 ms of bytes): a lane's chain of 7 products in 3
// dependent levels, and the launch's own latency, bound it. One thread a
// lane (the uint32 CIOS code this replaced, 90 registers and 96 local
// bytes) put 2 warps a block of 64 on an SM, each waiting out its own
// chain; on SCAN_T threads each product's columns split 4 ways and 4 times
// the warps share the card, as in dbl_kernel (g1.cu). A lane on three
// groups of its warp (the sweep's `dbltrio`) ran 1.7 times slower for G1,
// so the lane stays on one group. A group past n doubles lane 0's point
// and stores nothing.
template <int T>
__global__ void __launch_bounds__(SCAN_BLOCK)
    secp_dbl_kernel(const uint32_t* __restrict__ p, uint32_t* __restrict__ out,
                    int n) {
  const SecpGroup<T> g = make_coop_group<SecpFp, T>();
  bool live;
  const int col = group_lane<T, SCAN_BLOCK>(n, live);
  const PtG<T> r = secp_dbl_g(g, load_pt_g(g, p, n, col));
  if (live) store_pt_g(g, out, n, col, r);
}

// psecp.build_table in one launch: table (16, 24, n), psecp's chain of one
// doubling and 13 adds of the lane's point (coop.cuh chain_table), word for
// word the chain of secp_dbl_kernel and secp_add_kernel launches.
template <int T>
__global__ void __launch_bounds__(SCAN_BLOCK)
    secp_table_kernel(const uint32_t* __restrict__ lanes,
                      uint32_t* __restrict__ table, int n) {
  const SecpGroup<T> g = make_coop_group<SecpFp, T>();
  bool live;
  const int col = group_lane<T, SCAN_BLOCK>(n, live);
  const PtG<T> p = load_pt_g(g, lanes, n, col);
  const ZPow<FeG<T>> pz = z_pow_g(g, p.z);
  chain_table<TABLE>(
      p, live, [&](const PtG<T>& q) { return secp_dbl_g(g, q); },
      [&](const PtG<T>& q) { return secp_add_g(g, q, p, pz); },
      [&](int k, const PtG<T>& q) {
        store_pt_g(g, table + (size_t)k * PR * n, n, col, q);
      });
}

// psecp._msm_kernel semantics (pg1's), all W windows in one launch: window
// 0 selects table[d]; each later window doubles 4 times, then a digit 0
// keeps the accumulator (and keeps the flag set), a flagged accumulator
// takes the entry, and otherwise the entry is added. Digits must lie in
// [0, 16). A group past n reads no digit (digit 0: its flag stays set, it
// does no work) and stores nothing, but stays alive.
template <int T>
__global__ void __launch_bounds__(SCAN_BLOCK)
    secp_msm_scan_kernel(const uint32_t* __restrict__ table,
                         const int32_t* __restrict__ digits,
                         uint32_t* __restrict__ acc_out,
                         uint8_t* __restrict__ flag_out, int n, int nwin) {
  const SecpGroup<T> g = make_coop_group<SecpFp, T>();
  bool live;
  const int col = group_lane<T, SCAN_BLOCK>(n, live);
  int d = live ? digits[col] : 0;
  PtG<T> acc = select_entry_g(g, table, d, n, col);
  bool flag = d == 0;
  int next = live && nwin > 1 ? digits[(size_t)n + col] : 0;
#pragma unroll 1
  for (int w = 1; w < nwin; ++w) {
    d = next;
    if (live && w + 1 < nwin) next = digits[(size_t)(w + 1) * n + col];
    if (lanes_any(g, !flag)) {  // a flagged accumulator is the zero point
#pragma unroll 1
      for (int k = 0; k < WINDOW; ++k) acc = secp_dbl_g(g, acc);
    }
    const PtG<T> entry = select_entry_g(g, table, d, n, col);
    const bool add = d != 0 && !flag;
    if (lanes_any(g, add)) {
      const PtG<T> sum = secp_add_g(g, acc, entry);
      if (add) acc = sum;
    }
    if (d != 0 && flag) acc = entry;
    flag = flag && d == 0;
  }
  if (live) {
    store_pt_g(g, acc_out, n, col, acc);
    if (g.rank == 0) flag_out[col] = flag ? 1 : 0;
  }
}

// a^(2^k): k squarings
template <int T>
__device__ __forceinline__ FeG<T> sqr_n(const SecpGroup<T>& g, FeG<T> a,
                                        int k) {
#pragma unroll 1
  for (int i = 0; i < k; ++i) a = fpg_sqr(g, a);
  return a;
}

// y2^((p+1)/4) by libsecp256k1's addition chain for that exponent
// (secp256k1_fe_sqrt in its field_impl.h): 253 squarings and 13 products,
// in the steps of ops/secp.py's SQRT_CHAIN. x_k = y2^(2^k - 1); the x_k
// that later steps multiply by stay in registers.
template <int T>
__device__ __forceinline__ FeG<T> sqrt_chain(const SecpGroup<T>& g,
                                             const FeG<T>& y2) {
  const FeG<T> x2 = fpg_mul(g, fpg_sqr(g, y2), y2);
  const FeG<T> x3 = fpg_mul(g, fpg_sqr(g, x2), y2);
  const FeG<T> x6 = fpg_mul(g, sqr_n(g, x3, 3), x3);
  const FeG<T> x9 = fpg_mul(g, sqr_n(g, x6, 3), x3);
  const FeG<T> x11 = fpg_mul(g, sqr_n(g, x9, 2), x2);
  const FeG<T> x22 = fpg_mul(g, sqr_n(g, x11, 11), x11);
  const FeG<T> x44 = fpg_mul(g, sqr_n(g, x22, 22), x22);
  const FeG<T> x88 = fpg_mul(g, sqr_n(g, x44, 44), x44);
  const FeG<T> x176 = fpg_mul(g, sqr_n(g, x88, 88), x88);
  const FeG<T> x220 = fpg_mul(g, sqr_n(g, x176, 44), x44);
  const FeG<T> x223 = fpg_mul(g, sqr_n(g, x220, 3), x3);
  FeG<T> t = fpg_mul(g, sqr_n(g, x223, 23), x22);
  t = fpg_mul(g, sqr_n(g, t, 6), x2);
  return sqr_n(g, t, 2);
}

template <int T>
__device__ __forceinline__ FeG<T> r2_g(const SecpGroup<T>& g) {
  return fpg_const(g, [](int i) { return kR2[i]; });
}

// psecp.sqrt_kernel: y = (x^3 + 7)^((p+1)/4) per lane, x (8, n) plain
// words in, y (8, n) plain words out. Into Montgomery form by one product
// with R^2, y2 = x^2 * x + 7R, the chain, out of form by one reduction: 270
// steps a lane (254 of them squarings, run as products), no branch on data. A group past n computes lane 0's and
// stores nothing.
template <int T>
__global__ void __launch_bounds__(SCAN_BLOCK)
    secp_sqrt_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
                     int n) {
  const SecpGroup<T> g = make_coop_group<SecpFp, T>();
  bool live;
  const int col = group_lane<T, SCAN_BLOCK>(n, live);
  const FeG<T> xm = fpg_mul(g, load_fpg(g, x, 0, n, col), r2_g(g));
  const FeG<T> y2 = fpg_add(g, fpg_mul(g, fpg_sqr(g, xm), xm),
                            fpg_const(g, [](int i) { return kSevenR[i]; }));
  const FeG<T> y = fpg_redc(g, sqrt_chain(g, y2));
  if (live) store_fpg(g, out, 0, n, col, y);
}

// psecp._mul on the group field: out = x y / R mod p, a lane's product on
// SCAN_T threads (x, y (8, n) Montgomery words; psecp.py:121). Its bytes
// (96 a lane: 0.00023 ms at 8192 lanes) and its 136 word products a lane
// are far below what one launch costs: a lone launch's latency bounds it,
// and it reads the same at every T and as the one-thread uint32 CIOS
// kernel it replaced (the sweep above). On the group field, as secp_mont,
// the file keeps one field code. A group past n multiplies lane 0's words
// and stores nothing.
template <int T>
__global__ void __launch_bounds__(SCAN_BLOCK)
    secp_fp_mul_kernel(const uint32_t* __restrict__ x,
                       const uint32_t* __restrict__ y,
                       uint32_t* __restrict__ out, int n) {
  const SecpGroup<T> g = make_coop_group<SecpFp, T>();
  bool live;
  const int col = group_lane<T, SCAN_BLOCK>(n, live);
  const FeG<T> r =
      fpg_mul(g, load_fpg(g, x, 0, n, col), load_fpg(g, y, 0, n, col));
  if (live) store_fpg(g, out, 0, n, col, r);
}

// Montgomery form of every element of a (8 coords [+ 1], n) buffer, in
// one launch: element c * n + j is coordinate c's words at rows 8c .. 8c +
// 7, lane j, read as the buffer lies. into: x * R mod p, one product by R^2
// from the constant bank; otherwise x / R mod p, one reduction. A trailing
// flag row (flag_row) is copied as it is.
template <int T>
__global__ void __launch_bounds__(SCAN_BLOCK)
    secp_mont_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
                     int coords, int n, bool flag_row, bool into) {
  const SecpGroup<T> g = make_coop_group<SecpFp, T>();
  bool live;
  const int e = group_lane<T, SCAN_BLOCK>(coords * n, live);
  const int c = e / n, col = e - c * n;
  const FeG<T> a = load_fpg(g, x, c * NL, n, col);
  const FeG<T> r = into ? fpg_mul(g, a, r2_g(g)) : fpg_redc(g, a);
  if (live) {
    store_fpg(g, out, c * NL, n, col, r);
    const size_t flags = (size_t)coords * NL * n + col;
    if (flag_row && c == 0 && g.rank == 0) out[flags] = x[flags];
  }
}

}  // namespace

extern "C" {

int lt_secp_fp_mul(const void* x, const void* y, void* out, int n,
                   void* stream) {
  if (n > 0) {
    secp_fp_mul_kernel<SCAN_T>
        <<<group_blocks<SCAN_T, SCAN_BLOCK>(n), SCAN_BLOCK, 0,
           (cudaStream_t)stream>>>(
            (const uint32_t*)x, (const uint32_t*)y, (uint32_t*)out, n);
  }
  return (int)cudaGetLastError();
}

int lt_secp_dbl(const void* p, void* out, int n, void* stream) {
  if (n > 0) {
    secp_dbl_kernel<SCAN_T>
        <<<group_blocks<SCAN_T, SCAN_BLOCK>(n), SCAN_BLOCK, 0,
           (cudaStream_t)stream>>>((const uint32_t*)p, (uint32_t*)out, n);
  }
  return (int)cudaGetLastError();
}

int lt_secp_add(const void* p, const void* q, void* out, int n,
                void* stream) {
  if (n > 0) {
    secp_add_kernel<SCAN_T>
        <<<group_blocks<SCAN_T, SCAN_BLOCK>(n), SCAN_BLOCK, 0,
           (cudaStream_t)stream>>>(
            (const uint32_t*)p, (const uint32_t*)q, (uint32_t*)out, n);
  }
  return (int)cudaGetLastError();
}

int lt_secp_table(const void* lanes, void* table, int n, void* stream) {
  if (n > 0) {
    secp_table_kernel<SCAN_T>
        <<<group_blocks<SCAN_T, SCAN_BLOCK>(n), SCAN_BLOCK, 0,
           (cudaStream_t)stream>>>((const uint32_t*)lanes, (uint32_t*)table,
                                   n);
  }
  return (int)cudaGetLastError();
}

int lt_secp_msm_scan(const void* table, const void* digits, void* acc,
                     void* flags, int n, int nwin, void* stream) {
  if (n > 0 && nwin > 0) {
    secp_msm_scan_kernel<SCAN_T>
        <<<group_blocks<SCAN_T, SCAN_BLOCK>(n), SCAN_BLOCK, 0,
           (cudaStream_t)stream>>>(
            (const uint32_t*)table, (const int32_t*)digits, (uint32_t*)acc,
            (uint8_t*)flags, n, nwin);
  }
  return (int)cudaGetLastError();
}

int lt_secp_sqrt(const void* x, void* out, int n, void* stream) {
  if (n > 0) {
    secp_sqrt_kernel<SCAN_T>
        <<<group_blocks<SCAN_T, SCAN_BLOCK>(n), SCAN_BLOCK, 0,
           (cudaStream_t)stream>>>((const uint32_t*)x, (uint32_t*)out, n);
  }
  return (int)cudaGetLastError();
}

// rows = 8 * coords, or 8 * coords + 1 with a trailing flag row
int lt_secp_mont(const void* x, void* out, int rows, int n, int into,
                 void* stream) {
  const int coords = rows / NL;
  if (coords > 0 && n > 0) {
    secp_mont_kernel<SCAN_T>
        <<<group_blocks<SCAN_T, SCAN_BLOCK>(coords * n), SCAN_BLOCK, 0,
           (cudaStream_t)stream>>>((const uint32_t*)x, (uint32_t*)out, coords,
                                   n, rows > coords * NL, into != 0);
  }
  return (int)cudaGetLastError();
}

// Registers per thread, local (spill) bytes, threads per lane and threads
// per block of kernel `which` (0 fp_mul, 1 dbl, 2 add, 3 msm_scan, 4 sqrt,
// 5 table, 6 mont), for the chip report.
int lt_secp_kernel_attrs(int which, int* regs, int* local_bytes,
                         int* threads_per_lane, int* block) {
  const void* fns[7] = {(const void*)secp_fp_mul_kernel<SCAN_T>,
                        (const void*)secp_dbl_kernel<SCAN_T>,
                        (const void*)secp_add_kernel<SCAN_T>,
                        (const void*)secp_msm_scan_kernel<SCAN_T>,
                        (const void*)secp_sqrt_kernel<SCAN_T>,
                        (const void*)secp_table_kernel<SCAN_T>,
                        (const void*)secp_mont_kernel<SCAN_T>};
  if (which < 0 || which > 6) return (int)cudaErrorInvalidValue;
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

// BLS12-381 G1 kernels for Hopper (sm_90a): the four Pallas kernels of
// lachain_tpu/ops/pg1.py, thought through again for the card.
//
//   lt_g1_fp_mul    <- pg1._mul_kernel   (pl_fp_mul, pg1.py:262/:323)
//   lt_g1_dbl       <- pg1._dbl_kernel   (pl_dbl,    pg1.py:253/:279)
//   lt_g1_add       <- pg1._add_kernel   (pl_add,    pg1.py:257/:301)
//   lt_g1_table     <- pg1._add_kernel and _dbl_kernel as build_table
//                      chains them (pg1.py:447): the whole table, one launch
//   lt_g1_msm_scan  <- pg1._msm_kernel   (_msm_scan, pg1.py:355/:412)
//   lt_g1_mont      this port's own: every coordinate of a buffer into or
//                   out of Montgomery form, or times beta (phi's X), in one
//                   launch (pg1 has no Montgomery form)
//   lt_g1_fixed_tables <- msm.y_fixed_base_tables (XLA, msm.py:246): the
//                   keys' 16 x 16 fixed-base table entries, one launch
//   lt_g1_fixed_scan   <- msm.y_agg_fixed_base's gathers (XLA, msm.py:266):
//                   the RLC windows' entries summed per lane, no doublings
//
// The two fixed-base kernels run few lanes (a validator set's K keys; the
// era's S x K key lanes), so latency bounds them, not their operations
// bound (microseconds, chip_smoke.py). The tables: a key's bases 16^w * Y
// are one chain of 60 doublings, which no design shortens (an addition
// chain for 2^60 Y has at least 60 steps). The kernel runs that chain once
// a key, each doubling's 7 products over three groups of warp 0 (3
// products deep; an earlier design re-doubled from Y in every (window,
// key) lane, 6416 products a key against ~3570, w = 0's lane 635 products
// deep), then builds the 16 windows' tables together in 4 levels from
// shared memory. Its floor is that chain at one warp's latency. The scan:
// up to 15 dependent adds a lane at 4 warps an SM ran each add at one
// warp's latency; splitting a lane's windows over 4 sub-lanes puts 4 times
// the warps on the card and leaves 3 + 2 adds a lane deep. Its floor is
// the group field's product rate, which every group-field kernel shares.
// The scan's adds and the tables' table phase call their field products
// out of line (MulCall): a point add inlines ~16 copies of the product's
// unrolled code, and the calls ran both faster (scan_sweep.py's
// `mulinline` variant; PERF.md). The tables' chain keeps them inline: a
// lone warp's 3 products a step, out of line they ran it 2% slower.
// Representation. pg1's 44 x 10-bit signed limbs, its f32 MXU residue fold
// and its 256-lane VMEM tiles are TPU artifacts. Here a field element is 12
// x 32-bit limbs in Montgomery form (R = 2^384), always canonical in [0, p)
// (fp.cuh, shared with g2.cu); a point is 36 rows X | Y | Z, lane-minor.
// The host converts into and out of Montgomery form with lt_g1_mont, one
// launch a buffer read as it lies (lachain_tpu_torch/ops/g1.py mont_convert;
// G2's (72, n) buffers too).
//
// Multiply: CIOS Montgomery, 2*12*12 + 12 word products. The group law uses
// pg1's formulas (pg1._g1_dbl_val, pg1._g1_add_val, pg1.py:181-220)
// operation for operation (the group-field add groups one product
// otherwise, to the same values), so a collision p = +-q in an incomplete add
// gives Z = 0 exactly where the TPU kernel does, and the era pipeline's
// Z==0 escape fires on the same slots.
//
// Bound: integer multiply-adds (about 44 field products per lane per MSM
// window, ~600 IMADs each; the table build 7 + 2 + 13 * 14 = 191 per lane:
// its 13 adds of one point make that point's z^2 and z^3 once).
// Bytes are small beside them: the MSM reads its 16-entry table (2304
// B/lane) once per lane per window at most, the table build writes it.
//
// Every kernel runs on coop.cuh's group field over fp.cuh's p (BlsFp:
// carry-save column products, PTX carry chains for the carries, ballots
// between the threads), the group law inlined: the scan, add, the table
// build, mont, dbl and fp_mul a lane on SCAN_T threads (dbl since the
// table build is one launch, fp_mul since the conversions and phi's
// product by beta are g1_mont, serve no main path). add serves the tree
// reductions (6 passes an era, 8192 down to 256 lanes), where one thread
// per lane left a launch one lane's latency through 16 uint64 products
// (0.057 ms at any lane count). The table kernel builds build_table's 16
// entries in one launch in pg1's order (entry 2 a doubling, 3..15 thirteen
// chained adds of the point; a table in log depth would reach other
// Jacobian coordinates and break word-for-word identity), each entry stored
// as it is made. The scan: all windows in one launch with the accumulator
// and flag in registers, table[d] read from device memory (L2 holds the
// 37.7 MB table of the TPKE era's 16,384 lanes) after the doublings. The
// scan's control flow is uniform across each warp (lanes_any), so the
// shuffles and ballots run with the full warp's mask; add and the table
// build branch only around their stores, which hold no collective.
//
// T sweep (python3 -m lachain_tpu_torch.scan_sweep; one NVIDIA H100 80GB
// HBM3 at 700 W, PERF.md), ms for the random-digit check (32 windows x
// 8192 lanes) / the TPKE era's joined scan (32 windows x 16,384 lanes):
//   T = 1: 3.16 / 3.22-3.32 (254 registers); T = 2: 2.08 / 2.37-2.54 (162);
//   T = 4: 1.41 / 2.28-2.31 (96)  <- SCAN_T
//   the sweep's variants at T = 4: the group's own shuffle mask and
//   divergent groups 5.64-5.65 / 5.96; the entry loaded before the
//   doublings 1.42 / 2.30-2.33;
//   the one-thread uint64 scan this replaced: 5.46 / 8.41 (two launches).
// The same T serves add and the table build, medians of 10 rounds in ms
// (PERF.md): add at 8192 lanes / at the TPKE era's last tree pass
// (256 lanes); the table at the TPKE era's 16,384 joined lanes / the coin
// era's 4096 key lanes:
//   T = 1: 0.0491 / 0.0470, 0.676 / 0.641 (200 / 255 registers, the
//   table 12 B spilled);
//   T = 2: 0.0255 / 0.0242, 0.436 / 0.409 (148 / 144);
//   T = 4: 0.0153 / 0.0123, 0.355 / 0.138 (76 / 80)  <- SCAN_T
//   the one-thread add and the 14-launch chain they replaced: 0.0562 /
//   0.0534, 0.776 / 0.762.
//
// mont: one Fp product a coordinate (into form: by R^2 mod p; phi's X: by
// beta R mod p, both from the constant bank) or one reduction (out of form,
// 156 word products at 12 words), so the bound is its bytes, 2 x 48 a
// coordinate, read and written where the buffer lies: no permute copy, no
// constant expanded over the lanes, no torch.cat with the flag row.
//
// Each extern "C" entry launches on the caller's stream and returns
// cudaGetLastError(); the Python wrapper raises when it is non-zero.

#include "coop.cuh"
#include "fp.cuh"

#ifndef LT_G1_SCAN_T  // the sweep builds T = 1 and 2 beside the shipped 4
#define LT_G1_SCAN_T 4
#endif

namespace {

constexpr int PR = 3 * NL;   // rows per point: X | Y | Z
constexpr int WINDOW = 4;
constexpr int TABLE = 16;   // entries k*P, k in [0, 16)
constexpr int W64 = 16;     // windows of a 64-bit RLC coefficient
constexpr int SCAN_T = LT_G1_SCAN_T;  // threads per lane (group field)
constexpr int SCAN_BLOCK = 64;        // their threads per block
// g1_fixed_tables: level 4's adds (16 windows x entries 9 .. 15), the most
// groups a level of its table phase uses
constexpr int TABLE_OPS = W64 * (TABLE / 2 - 1);
// g1_fixed_scan: a lane's 16 windows split over FIXED_G sub-lanes, in
// blocks of FIXED_BLOCK threads
constexpr int FIXED_G = 4;
constexpr int FIXED_BLOCK = 128;

// beta R mod p: a product by it multiplies a Montgomery word by beta, the
// cube root of unity of phi(x, y) = (beta x, y) (ops/glv.py BETA)
__constant__ uint32_t kBetaR[NL] = {
    0x8671f071u, 0xcd03c9e4u, 0x1fcda5d2u, 0x5dab2246u,
    0xd3851b95u, 0x587042afu, 0x01bacb9eu, 0x8eb60ebeu,
    0x83d050d2u, 0x03f97d6eu, 0x54638741u, 0x18f02065u};

// lt_g1_mont's op: out of Montgomery form, into it, times beta
enum MontOp { kMontOut = 0, kMontInto = 1, kMontBeta = 2 };

// ---------------------------------------------------------------------------
// the scan: one lane on a group of T threads (coop.cuh)
// ---------------------------------------------------------------------------

template <int T>
using Group = CoopGroup<BlsFp, T>;

template <int T>
using FpG = CoopFp<BlsFp, T>;

template <int T>
using PtG = CoopPt<BlsFp, T>;

// How a group-law function below takes its field products: MulInline
// inlines each (the scans, adds and table builds), MulCall calls one
// out-of-line copy of the product. Inlined, a point add is ~16 copies of
// the product's unrolled code: a lone lane's chain (g1_fixed_tables) and a
// scan of adds only (g1_fixed_scan) then wait on instruction fetch, and
// the calls ran them faster (PERF.md). The values are the same.
struct MulInline {
  template <int T>
  static __device__ __forceinline__ FpG<T> mul(const Group<T>& g,
                                               const FpG<T>& a,
                                               const FpG<T>& b) {
    return fpg_mul(g, a, b);
  }
};

template <int T>
__device__ __noinline__ FpG<T> fpg_mul_call(const Group<T> g, const FpG<T> a,
                                            const FpG<T> b) {
  return fpg_mul(g, a, b);
}

struct MulCall {
  template <int T>
  static __device__ __forceinline__ FpG<T> mul(const Group<T>& g,
                                               const FpG<T>& a,
                                               const FpG<T>& b) {
    return fpg_mul_call(g, a, b);
  }
};

// pg1._g1_dbl_val on the group field: Jacobian doubling, a = 0, operation
// for operation (7 products).
template <int T, class M = MulInline>
__device__ __forceinline__ PtG<T> g1_dbl_g(const Group<T>& g,
                                           const PtG<T>& p) {
  const FpG<T> A = M::mul(g, p.x, p.x);
  const FpG<T> B = M::mul(g, p.y, p.y);
  const FpG<T> C = M::mul(g, B, B);
  const FpG<T> XB = fpg_add(g, p.x, B);
  FpG<T> D = fpg_sub(g, fpg_sub(g, M::mul(g, XB, XB), A), C);
  D = fpg_add(g, D, D);
  const FpG<T> E = fpg_add(g, fpg_add(g, A, A), A);
  const FpG<T> F = M::mul(g, E, E);
  PtG<T> r;
  r.x = fpg_sub(g, F, fpg_add(g, D, D));
  FpG<T> C8 = fpg_add(g, C, C);
  C8 = fpg_add(g, C8, C8);
  C8 = fpg_add(g, C8, C8);
  r.y = fpg_sub(g, M::mul(g, E, fpg_sub(g, D, r.x)), C8);
  const FpG<T> Z3 = M::mul(g, p.y, p.z);
  r.z = fpg_add(g, Z3, Z3);
  return r;
}

// pg1._g1_add_val on the group field: incomplete Jacobian add, p != +-q,
// both finite; p = +-q gives Z = 0, as there. qz is q's ZPow (coop.cuh):
// 14 products here and 2 in qz, pg1's 16. S1 = Y1 * Z2^3 is grouped
// Y1 * (Z2 * Z2Z2) where pg1 has (Y1 * Z2) * Z2Z2: every product is the
// canonical residue, so the values are the same.
template <int T, class M = MulInline>
__device__ __forceinline__ PtG<T> g1_add_g(const Group<T>& g, const PtG<T>& p,
                                           const PtG<T>& q,
                                           const ZPow<FpG<T>>& qz) {
  const FpG<T> Z1Z1 = M::mul(g, p.z, p.z);
  const FpG<T> Z2Z2 = qz.zz;
  const FpG<T> U1 = M::mul(g, p.x, Z2Z2);
  const FpG<T> U2 = M::mul(g, q.x, Z1Z1);
  const FpG<T> S1 = M::mul(g, p.y, qz.zzz);
  const FpG<T> S2 = M::mul(g, M::mul(g, q.y, p.z), Z1Z1);
  const FpG<T> H = fpg_sub(g, U2, U1);
  const FpG<T> Rr = fpg_sub(g, S2, S1);
  const FpG<T> H2 = fpg_add(g, H, H);
  const FpG<T> I = M::mul(g, H2, H2);
  const FpG<T> J = M::mul(g, H, I);
  const FpG<T> Rr2 = fpg_add(g, Rr, Rr);
  const FpG<T> V = M::mul(g, U1, I);
  PtG<T> r;
  r.x = fpg_sub(g, fpg_sub(g, M::mul(g, Rr2, Rr2), J), fpg_add(g, V, V));
  const FpG<T> S1J = M::mul(g, S1, J);
  r.y = fpg_sub(g, M::mul(g, Rr2, fpg_sub(g, V, r.x)), fpg_add(g, S1J, S1J));
  const FpG<T> Z3 = M::mul(g, M::mul(g, p.z, q.z), H);
  r.z = fpg_add(g, Z3, Z3);
  return r;
}

// x of group `src` of the warp (this thread's words of it): a warp-wide
// shuffle, so every thread of the warp must call it
template <int T>
__device__ __forceinline__ FpG<T> from_group(const Group<T>& g, const FpG<T>& x,
                                             int src) {
  FpG<T> r;
#pragma unroll
  for (int j = 0; j < NL / T; ++j)
    r.v[j] = __shfl_sync(g.mask, x.v[j], src * T + g.rank);
  return r;
}

// g1_dbl_g over three groups of a warp, for a chain of doublings on one
// lane (g1_fixed_tables): the 7 products are 3 levels of independent ones,
// (X^2, Y^2, YZ), (B^2, (X + B)^2, E^2) and E (D - X3); groups 0, 1, 2
// each take one product of a level (a group g takes slot g % 3, its
// operands chosen by selects, so the warp runs one instruction stream) and
// every group reads the three results by shuffles. Every group of the warp
// ends with the same point, word for word g1_dbl_g's: each product is the
// canonical residue, whichever group makes it. The critical path is 3
// products, not 7.
template <int T>
__device__ __forceinline__ PtG<T> g1_dbl_warp(const Group<T>& g,
                                              const PtG<T>& p) {
  const int slot = ((int)(threadIdx.x & 31u) / T) % 3;
  const FpG<T> a1 = slot == 0 ? p.x : p.y;
  const FpG<T> b1 = slot == 0 ? p.x : slot == 1 ? p.y : p.z;
  const FpG<T> r1 = fpg_mul(g, a1, b1);
  const FpG<T> A = from_group(g, r1, 0), B = from_group(g, r1, 1);
  const FpG<T> YZ = from_group(g, r1, 2);
  const FpG<T> XB = fpg_add(g, p.x, B);
  const FpG<T> E = fpg_add(g, fpg_add(g, A, A), A);
  const FpG<T> a2 = slot == 0 ? B : slot == 1 ? XB : E;
  const FpG<T> r2 = fpg_mul(g, a2, a2);
  const FpG<T> C = from_group(g, r2, 0), XB2 = from_group(g, r2, 1);
  const FpG<T> F = from_group(g, r2, 2);
  FpG<T> D = fpg_sub(g, fpg_sub(g, XB2, A), C);
  D = fpg_add(g, D, D);
  PtG<T> r;
  r.x = fpg_sub(g, F, fpg_add(g, D, D));
  FpG<T> C8 = fpg_add(g, C, C);
  C8 = fpg_add(g, C8, C8);
  C8 = fpg_add(g, C8, C8);
  r.y = fpg_sub(g, fpg_mul(g, E, fpg_sub(g, D, r.x)), C8);
  r.z = fpg_add(g, YZ, YZ);
  return r;
}

// the add of any p and q (16 products)
template <int T, class M = MulInline>
__device__ __forceinline__ PtG<T> g1_add_g(const Group<T>& g, const PtG<T>& p,
                                           const PtG<T>& q) {
  const FpG<T> zz = M::mul(g, q.z, q.z);
  return g1_add_g<T, M>(g, p, q, ZPow<FpG<T>>{zz, M::mul(g, q.z, zz)});
}

// pg1._add_kernel on the group field: out = p + q (incomplete). A group
// past n adds lane 0's points and stores nothing.
template <int T>
__global__ void __launch_bounds__(SCAN_BLOCK)
    add_kernel(const uint32_t* __restrict__ p, const uint32_t* __restrict__ q,
               uint32_t* __restrict__ out, int n) {
  const Group<T> g = make_coop_group<BlsFp, T>();
  bool live;
  const int col = group_lane<T, SCAN_BLOCK>(n, live);
  const PtG<T> r =
      g1_add_g(g, load_pt_g(g, p, n, col), load_pt_g(g, q, n, col));
  if (live) store_pt_g(g, out, n, col, r);
}

// pg1._dbl_kernel on the group field: out = dbl(p), a lane on SCAN_T
// threads. An 8192-lane launch is far from the card's rate (0.0011 ms of
// multiply-adds): a lane's chain of 7 products bounds it. On SCAN_T
// threads each product's columns split 4 ways, and 4 times the warps of
// one thread a lane share the card. A lane on three groups of its warp,
// its products 3 deep as in g1_dbl_warp (the sweep's `dbltrio`), issued
// 1.7 times the instructions a lane and ran 1.7 times slower (PERF.md). A
// group past n doubles lane 0's point and stores nothing.
template <int T>
__global__ void __launch_bounds__(SCAN_BLOCK)
    dbl_kernel(const uint32_t* __restrict__ p, uint32_t* __restrict__ out,
               int n) {
  const Group<T> g = make_coop_group<BlsFp, T>();
  bool live;
  const int col = group_lane<T, SCAN_BLOCK>(n, live);
  const PtG<T> r = g1_dbl_g(g, load_pt_g(g, p, n, col));
  if (live) store_pt_g(g, out, n, col, r);
}

// pg1.build_table in one launch: table (16, 36, n), pg1's chain of one
// doubling and 13 adds of the lane's point (coop.cuh chain_table), word for
// word the chain of dbl_kernel and add_kernel launches.
template <int T>
__global__ void __launch_bounds__(SCAN_BLOCK)
    g1_table_kernel(const uint32_t* __restrict__ lanes,
                    uint32_t* __restrict__ table, int n) {
  const Group<T> g = make_coop_group<BlsFp, T>();
  bool live;
  const int col = group_lane<T, SCAN_BLOCK>(n, live);
  const PtG<T> p = load_pt_g(g, lanes, n, col);
  const ZPow<FpG<T>> pz = z_pow_g(g, p.z);
  chain_table<TABLE>(
      p, live, [&](const PtG<T>& q) { return g1_dbl_g(g, q); },
      [&](const PtG<T>& q) { return g1_add_g(g, q, p, pz); },
      [&](int k, const PtG<T>& q) {
        store_pt_g(g, table + (size_t)k * PR * n, n, col, q);
      });
}

// pg1._msm_kernel semantics, all W windows in one launch: window 0 selects
// table[d]; each later window doubles 4 times, then a digit 0 keeps the
// accumulator (and keeps the flag set), a flagged accumulator takes the
// entry, and otherwise the entry is added. While a lane's flag is set its
// accumulator is the zero point (0, 0, 0), which g1_dbl maps to itself, so
// the scan skips those doublings: the output is unchanged, and leading zero
// windows (the RLC quarter of the TPKE era's joined scan) cost nothing.
// Digits must lie in [0, 16). A group past n reads no digit (digit 0: its
// flag stays set, it does no work) and stores nothing, but stays alive.
template <int T>
__global__ void __launch_bounds__(SCAN_BLOCK)
    msm_scan_kernel(const uint32_t* __restrict__ table,
                    const int32_t* __restrict__ digits,
                    uint32_t* __restrict__ acc_out,
                    uint8_t* __restrict__ flag_out, int n, int nwin) {
  const Group<T> g = make_coop_group<BlsFp, T>();
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
      for (int k = 0; k < WINDOW; ++k) acc = g1_dbl_g(g, acc);
    }
    const PtG<T> entry = select_entry_g(g, table, d, n, col);
    const bool add = d != 0 && !flag;
    if (lanes_any(g, add)) {
      const PtG<T> sum = g1_add_g(g, acc, entry);
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

// A point of 3 x NL words in shared memory, word c * NL + i of coordinate
// c: this thread's words of it (the same words a lane-minor array holds).
template <int T>
__device__ __forceinline__ PtG<T> load_pt_s(const Group<T>& g,
                                            const uint32_t* s) {
  constexpr int W = NL / T;
  PtG<T> r;
#pragma unroll
  for (int j = 0; j < W; ++j) {
    r.x.v[j] = s[g.rank * W + j];
    r.y.v[j] = s[NL + g.rank * W + j];
    r.z.v[j] = s[2 * NL + g.rank * W + j];
  }
  return r;
}

template <int T>
__device__ __forceinline__ void store_pt_s(const Group<T>& g, uint32_t* s,
                                           const PtG<T>& p) {
  constexpr int W = NL / T;
#pragma unroll
  for (int j = 0; j < W; ++j) {
    s[g.rank * W + j] = p.x.v[j];
    s[NL + g.rank * W + j] = p.y.v[j];
    s[2 * NL + g.rank * W + j] = p.z.v[j];
  }
}

// msm.y_fixed_base_tables (msm.py:246) in one launch: the tables (16, 16,
// 36, K) of K keys, entry [w, d] = d * 16^(15 - w) * Y, one block a key.
// Chain phase: warp 0 runs the key's 60 doublings once, each doubling over
// three groups of the warp
// (g1_dbl_warp: 3 products deep, not 7), and puts base_w = 16^(15 - w) * Y
// in shared memory every 4th doubling, base_15 = Y; the other warps write
// the zero entries 0. Table phase, after a barrier: the block's 112 groups
// build the 16 windows' tables at once in 4 levels, B =
// entry 1:
//   level 1: 2B = dbl(B)
//   level 2: 4B = dbl(2B), 3B = 1B + 2B
//   level 3: 8B = dbl(4B), 5B, 6B, 7B = {1, 2, 3}B + 4B
//   level 4: 9B .. 15B = {1 .. 7}B + 8B
// (entry h + j = add(entry j, entry h), the incomplete add of two
// different multiples below 16 < r: no collision), their products called
// out of line (MulCall). A level's doublings (16 groups) and adds (16, 48,
// 112) each fill whole warps at T = 2 and 4, so every collective finds its
// warp converged (T = 1 has none); a barrier ends each level. Each entry goes to shared memory, where the next levels read
// it, and to the tables as it is made. The plain version
// (g1_ref.fixed_tables) runs the same doublings and adds, so every entry
// is word for word its one. An infinity key (Z = 0) keeps Z = 0 in every
// entry: a doubling's Z is 2YZ, an add's 2 Z1 Z2 H.
template <int T>
__global__ void __launch_bounds__(TABLE_OPS * T)
    g1_fixed_tables_kernel(const uint32_t* __restrict__ keys,
                           uint32_t* __restrict__ tables, int k) {
  __shared__ uint32_t ent[W64][TABLE][PR];  // entry 0 unused: 36,864 B
  const int key = blockIdx.x;
  const auto out = [&](int w, int d) {
    return tables + (size_t)(w * TABLE + d) * PR * k;
  };
  const Group<T> g = make_coop_group<BlsFp, T>();
  if (threadIdx.x < 32) {
    const bool lead = threadIdx.x < T;
    PtG<T> p = load_pt_g(g, keys, k, key);
#pragma unroll 1
    for (int w = W64 - 1;; --w) {
      if (lead) {
        store_pt_s(g, ent[w][1], p);
        store_pt_g(g, out(w, 1), k, key, p);
      }
      if (w == 0) break;
#pragma unroll 1
      for (int i = 0; i < WINDOW; ++i) p = g1_dbl_warp(g, p);
    }
  } else {
    for (int i = threadIdx.x - 32; i < W64 * PR; i += blockDim.x - 32) {
      const int w = i / PR;
      out(w, 0)[(size_t)(i - w * PR) * k + key] = 0u;
    }
  }
  __syncthreads();
  const int op = threadIdx.x / T;
#pragma unroll 1
  for (int h = 1; h < TABLE; h *= 2) {  // entries h + 1 .. 2h
    const int ndbl = 2 * h < TABLE ? W64 : 0;
    if (op < ndbl) {
      const PtG<T> r = g1_dbl_g<T, MulCall>(g, load_pt_s(g, ent[op][h]));
      store_pt_s(g, ent[op][2 * h], r);
      store_pt_g(g, out(op, 2 * h), k, key, r);
    } else if (op < ndbl + W64 * (h - 1)) {
      const int a = op - ndbl, w = a % W64, j = 1 + a / W64;
      const PtG<T> r = g1_add_g<T, MulCall>(g, load_pt_s(g, ent[w][j]),
                                            load_pt_s(g, ent[w][h]));
      store_pt_s(g, ent[w][h + j], r);
      store_pt_g(g, out(w, h + j), k, key, r);
    }
    __syncthreads();
  }
}

// msm.y_agg_fixed_base's gathers (msm.py:266) as a scan: lane j of n sums
// tables[w, d_w] of key column j % k_pad over the 16 MSB-first RLC
// windows. The windows are split over G = FIXED_G = 4 sub-lanes: sub-lane
// q sums windows [4q, 4q + 4) with msm_scan's flag rules (a zero digit
// keeps the accumulator and the flag, a flagged accumulator takes the
// entry, otherwise the entry is added), then the 4 partials meet in shared
// memory in 2 levels in a fixed order (0 + 1, 2 + 3, then 01 + 23; where
// one side is flagged the other is taken). A block of 128 threads holds
// 128 / T groups, 32 / T lanes: sub-lane q of them is groups [q * 32/T,
// (q + 1) * 32/T), one warp, so each level's combining groups fill whole
// warps. No add collides: a sub-lane's partial sums, and the partials two
// sides bring to a combine, are c * Y for c from disjoint digit positions,
// so two of them differ whenever both are nonzero, and 0 < c_a + c_b <
// 2^64 < r. The adds call their products out of line (MulCall). One G at
// every lane count: G = 4 ran fastest at N=64's 4096 lanes and within 1.4%
// of the fastest G at N=256's 65,536 (PERF.md).
template <int T>
__global__ void __launch_bounds__(FIXED_BLOCK)
    g1_fixed_scan_kernel(const uint32_t* __restrict__ tables,
                         const int32_t* __restrict__ digits,
                         uint32_t* __restrict__ acc_out,
                         uint8_t* __restrict__ flag_out, int n, int k_pad) {
  constexpr int G = FIXED_G;
  constexpr int GROUPS = FIXED_BLOCK / T, PER = GROUPS / G, NW = W64 / G;
  __shared__ uint32_t part[GROUPS][PR];
  __shared__ uint8_t part_flag[GROUPS];
  const Group<T> g = make_coop_group<BlsFp, T>();
  const int gi = threadIdx.x / T;
  const int q = gi / PER;
  const int lane0 = blockIdx.x * PER + (gi - q * PER);
  const bool live = lane0 < n;
  const int lane = live ? lane0 : 0, col = lane % k_pad;
  const size_t window = (size_t)TABLE * PR * k_pad;
  const int w0 = q * NW;
  int d = live ? digits[(size_t)w0 * n + lane] : 0;
  PtG<T> acc = select_entry_g(g, tables + w0 * window, d, k_pad, col);
  bool flag = d == 0;
#pragma unroll 1
  for (int w = w0 + 1; w < w0 + NW; ++w) {
    d = live ? digits[(size_t)w * n + lane] : 0;
    const PtG<T> entry = select_entry_g(g, tables + w * window, d, k_pad, col);
    const bool add = d != 0 && !flag;
    if (lanes_any(g, add)) {
      const PtG<T> sum = g1_add_g<T, MulCall>(g, acc, entry);
      if (add) acc = sum;
    }
    if (d != 0 && flag) acc = entry;
    flag = flag && d == 0;
  }
#pragma unroll
  for (int s = 1; s < G; s *= 2) {
    __syncthreads();  // the last level's reads are done
    if (q % (2 * s) == s) {
      store_pt_s(g, part[gi], acc);
      if (g.rank == 0) part_flag[gi] = flag;
    }
    __syncthreads();
    if (q % (2 * s) == 0) {
      const PtG<T> other = load_pt_s(g, part[gi + s * PER]);
      const bool oflag = part_flag[gi + s * PER] != 0;
      const bool add = !flag && !oflag;
      if (lanes_any(g, add)) {
        const PtG<T> sum = g1_add_g<T, MulCall>(g, acc, other);
        if (add) acc = sum;
      }
      if (flag) acc = other;
      flag = flag && oflag;
    }
  }
  if (q == 0 && live) {
    store_pt_g(g, acc_out, n, lane, acc);
    if (g.rank == 0) flag_out[lane] = flag ? 1 : 0;
  }
}

// pg1._mul_kernel on the group field: out = x y / R mod p, a lane's
// product on SCAN_T threads (x, y (12, n) Montgomery words; pg1.py:262).
// Its bytes (144 a lane: 0.00035 ms at 8192 lanes) and its 300 word
// products a lane are far below what one launch costs, so a lone launch's
// latency bounds it. A group past n multiplies lane 0's words and stores
// nothing.
template <int T>
__global__ void __launch_bounds__(SCAN_BLOCK)
    fp_mul_kernel(const uint32_t* __restrict__ x,
                  const uint32_t* __restrict__ y, uint32_t* __restrict__ out,
                  int n) {
  const Group<T> g = make_coop_group<BlsFp, T>();
  bool live;
  const int col = group_lane<T, SCAN_BLOCK>(n, live);
  const FpG<T> r =
      fpg_mul(g, load_fpg(g, x, 0, n, col), load_fpg(g, y, 0, n, col));
  if (live) store_fpg(g, out, 0, n, col, r);
}

// Every coordinate of a (12 coords [+ 1], n) buffer in one launch:
// element c * n + j is coordinate c's words at rows 12c .. 12c + 11, lane
// j, read as the buffer lies. kMontInto: x R mod p, one product by R^2;
// kMontBeta: x beta, one product by beta R (both from the constant bank);
// kMontOut: x / R mod p, one reduction, canonical for any 384-bit x. A
// trailing flag row (flag_row) is copied as it is. op is the same for the
// whole launch, so every collective takes the full warp.
template <int T>
__global__ void __launch_bounds__(SCAN_BLOCK)
    g1_mont_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
                   int coords, int n, bool flag_row, int op) {
  const Group<T> g = make_coop_group<BlsFp, T>();
  bool live;
  const int e = group_lane<T, SCAN_BLOCK>(coords * n, live);
  const int c = e / n, col = e - c * n;
  const FpG<T> a = load_fpg(g, x, c * NL, n, col);
  FpG<T> r;
  if (op == kMontOut) {
    r = fpg_redc(g, a);
  } else {
    const bool into = op == kMontInto;
    r = fpg_mul(g, a, fpg_const(g, [into](int i) {
                  return into ? kR2[i] : kBetaR[i];
                }));
  }
  if (live) {
    store_fpg(g, out, c * NL, n, col, r);
    const size_t flags = (size_t)coords * NL * n + col;
    if (flag_row && c == 0 && g.rank == 0) out[flags] = x[flags];
  }
}

}  // namespace

extern "C" {

int lt_g1_fp_mul(const void* x, const void* y, void* out, int n,
                 void* stream) {
  if (n > 0) {
    fp_mul_kernel<SCAN_T><<<group_blocks<SCAN_T, SCAN_BLOCK>(n), SCAN_BLOCK,
                            0, (cudaStream_t)stream>>>(
        (const uint32_t*)x, (const uint32_t*)y, (uint32_t*)out, n);
  }
  return (int)cudaGetLastError();
}

int lt_g1_dbl(const void* p, void* out, int n, void* stream) {
  if (n > 0) {
    dbl_kernel<SCAN_T><<<group_blocks<SCAN_T, SCAN_BLOCK>(n), SCAN_BLOCK, 0,
                         (cudaStream_t)stream>>>((const uint32_t*)p,
                                                 (uint32_t*)out, n);
  }
  return (int)cudaGetLastError();
}

int lt_g1_add(const void* p, const void* q, void* out, int n, void* stream) {
  if (n > 0) {
    add_kernel<SCAN_T><<<group_blocks<SCAN_T, SCAN_BLOCK>(n), SCAN_BLOCK, 0,
                         (cudaStream_t)stream>>>(
        (const uint32_t*)p, (const uint32_t*)q, (uint32_t*)out, n);
  }
  return (int)cudaGetLastError();
}

int lt_g1_table(const void* lanes, void* table, int n, void* stream) {
  if (n > 0) {
    g1_table_kernel<SCAN_T>
        <<<group_blocks<SCAN_T, SCAN_BLOCK>(n), SCAN_BLOCK, 0,
           (cudaStream_t)stream>>>((const uint32_t*)lanes, (uint32_t*)table,
                                   n);
  }
  return (int)cudaGetLastError();
}

int lt_g1_msm_scan(const void* table, const void* digits, void* acc,
                   void* flags, int n, int nwin, void* stream) {
  if (n > 0 && nwin > 0) {
    msm_scan_kernel<SCAN_T><<<group_blocks<SCAN_T, SCAN_BLOCK>(n), SCAN_BLOCK,
                              0, (cudaStream_t)stream>>>(
        (const uint32_t*)table, (const int32_t*)digits, (uint32_t*)acc,
        (uint8_t*)flags, n, nwin);
  }
  return (int)cudaGetLastError();
}

int lt_g1_fixed_tables(const void* keys, void* tables, int k, void* stream) {
  if (k > 0) {
    g1_fixed_tables_kernel<SCAN_T>
        <<<k, TABLE_OPS * SCAN_T, 0,
           (cudaStream_t)stream>>>((const uint32_t*)keys, (uint32_t*)tables,
                                   k);
  }
  return (int)cudaGetLastError();
}

// n lanes, a multiple of k_pad: lane j reads key column j % k_pad
int lt_g1_fixed_scan(const void* tables, const void* digits, void* acc,
                     void* flags, int n, int k_pad, void* stream) {
  if (k_pad < 1 || n % k_pad != 0) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    constexpr int per = FIXED_BLOCK / SCAN_T / FIXED_G;  // lanes a block
    g1_fixed_scan_kernel<SCAN_T>
        <<<(n + per - 1) / per, FIXED_BLOCK, 0, (cudaStream_t)stream>>>(
            (const uint32_t*)tables, (const int32_t*)digits, (uint32_t*)acc,
            (uint8_t*)flags, n, k_pad);
  }
  return (int)cudaGetLastError();
}

// rows = 12 * coords, or 12 * coords + 1 with a trailing flag row; op a
// MontOp
int lt_g1_mont(const void* x, void* out, int rows, int n, int op,
               void* stream) {
  const int coords = rows / NL;
  if (op < kMontOut || op > kMontBeta) return (int)cudaErrorInvalidValue;
  if (coords > 0 && n > 0) {
    g1_mont_kernel<SCAN_T>
        <<<group_blocks<SCAN_T, SCAN_BLOCK>(coords * n), SCAN_BLOCK, 0,
           (cudaStream_t)stream>>>((const uint32_t*)x, (uint32_t*)out, coords,
                                   n, rows > coords * NL, op);
  }
  return (int)cudaGetLastError();
}

// Registers per thread, local (spill) bytes, threads per lane and threads
// per block of kernel `which` (0 fp_mul, 1 dbl, 2 add, 3 msm_scan, 4
// table, 5 mont, 6 fixed_tables, 7 fixed_scan), for the chip report.
int lt_g1_kernel_attrs(int which, int* regs, int* local_bytes,
                       int* threads_per_lane, int* block) {
  const void* fns[8] = {(const void*)fp_mul_kernel<SCAN_T>,
                        (const void*)dbl_kernel<SCAN_T>,
                        (const void*)add_kernel<SCAN_T>,
                        (const void*)msm_scan_kernel<SCAN_T>,
                        (const void*)g1_table_kernel<SCAN_T>,
                        (const void*)g1_mont_kernel<SCAN_T>,
                        (const void*)g1_fixed_tables_kernel<SCAN_T>,
                        (const void*)g1_fixed_scan_kernel<SCAN_T>};
  const int blocks[8] = {SCAN_BLOCK, SCAN_BLOCK, SCAN_BLOCK,
                         SCAN_BLOCK, SCAN_BLOCK, SCAN_BLOCK,
                         TABLE_OPS * SCAN_T, FIXED_BLOCK};
  if (which < 0 || which > 7) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, fns[which]);
  if (err != cudaSuccess) return (int)err;
  *regs = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  *threads_per_lane = SCAN_T;
  *block = blocks[which];
  return 0;
}

}  // extern "C"

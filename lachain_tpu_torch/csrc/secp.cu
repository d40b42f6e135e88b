// secp256k1 kernels for Hopper (sm_90a): the three Pallas kernels of
// lachain_tpu/ops/psecp.py and its XLA square root, thought through again
// for the card. They run batched ECDSA public-key recovery.
//
//   lt_secp_dbl       <- psecp._dbl_kernel  (pl_dbl,    psecp.py:235/:243)
//   lt_secp_add       <- psecp._add_kernel  (pl_add,    psecp.py:239/:264)
//   lt_secp_table     <- psecp._add_kernel and _dbl_kernel as build_table
//                        chains them (psecp.py:364): the table, one launch
//   lt_secp_msm_scan  <- psecp._msm_kernel  (_msm_scan, psecp.py:285/:331)
//   lt_secp_sqrt      <- psecp.sqrt_kernel  (plain XLA, psecp.py:380)
//   lt_secp_fp_mul    the field product (psecp._mul, :121); the host wrapper
//                     converts into and out of Montgomery form with it
//
// Representation. psecp's 26 x 10-bit signed limbs, its f32 MXU residue
// fold and its 32-row component slots are TPU artifacts. Here a field
// element is 8 x 32-bit limbs in Montgomery form (R = 2^256), always
// canonical in [0, p); a point is 24 rows X | Y | Z, lane-minor, so a
// warp's loads of one limb coalesce. The one-thread field code is this
// file's own, with internal linkage (fp.cuh's field is BLS12-381's); the
// scan's is coop.cuh's group field over this file's p (SecpFp).
//
// p = 2^256 - 2^32 - 977 fills its top limb, so a + b and the Montgomery
// product's last step can carry out of 256 bits (unlike the BLS field,
// fp.cuh:53): fe_add and mont_mul, and coop.cuh's code with
// SecpFp::top_carry, take that carry word into the final conditional
// subtraction.
//
// Multiply: CIOS Montgomery, 2*8*8 + 8 word products. The group law uses
// psecp's formulas (psecp._pt_dbl_val, psecp._pt_add_val, :158-194)
// operation for operation (the group-field add groups one product
// otherwise, to the same values), so a collision p = +-q in an incomplete add
// gives Z = 0 exactly where the TPU kernel does, and the recover path's
// escape to the host oracle fires on the same signatures. A doubling is 7
// products, an add 16.
//
// Bound: integer multiply-adds (a 64-window scan needs up to
// 63 * (4 * 7 + 16) field products per lane, the square root 501, the
// table build 7 + 2 + 13 * 14 = 191: its 13 adds of one point make that
// point's z^2 and z^3 once). Bytes are small beside them: the scan
// reads one 96-byte table entry per lane per nonzero digit.
//
// fp_mul, dbl and sqrt: one thread per lane on this file's uint64 field;
// since the table build is one launch, dbl serves no main path. The square
// root walks the static exponent's bits with a branch that is uniform
// across the warp and computes only the product its bit selects (psecp
// computes both and selects; the values are the same).
//
// The group-field kernels (the scan, add and the table build): SCAN_T
// threads per lane on coop.cuh's group field over secp256k1 (SecpFp:
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
constexpr int THREADS = 64;  // n = 8192 lanes -> 128 blocks over 132 SMs
constexpr int SCAN_T = LT_SECP_SCAN_T;  // threads per lane (group field)
constexpr int SCAN_BLOCK = 64;          // their threads per block

__constant__ uint32_t kP[NL] = {
    0xfffffc2fu, 0xfffffffeu, 0xffffffffu, 0xffffffffu,
    0xffffffffu, 0xffffffffu, 0xffffffffu, 0xffffffffu};
constexpr uint32_t kPInv = 0xd2253531u;  // -p^-1 mod 2^32
// 7 in Montgomery form: 7 * 2^256 mod p
__constant__ uint32_t kSevenR[NL] = {0x00001ab7u, 0x00000007u, 0u, 0u,
                                     0u, 0u, 0u, 0u};
// the square-root exponent (p + 1) / 4, little-endian words; its top set
// bit is bit 253
__constant__ uint32_t kSqrtExp[NL] = {
    0xbfffff0cu, 0xffffffffu, 0xffffffffu, 0xffffffffu,
    0xffffffffu, 0xffffffffu, 0xffffffffu, 0x3fffffffu};
constexpr int kSqrtTopBit = 253;

struct Fe {
  uint32_t v[NL];
};

struct Pt {
  Fe x, y, z;
};

__device__ __forceinline__ Fe fe_zero() {
  Fe r;
#pragma unroll
  for (int i = 0; i < NL; ++i) r.v[i] = 0u;
  return r;
}

// (top * 2^256 + a) mod p for a value below 2p (top is 0 or 1): subtract p
// when the carry word is set or a >= p.
__device__ __forceinline__ Fe reduce_once(const Fe& a, uint32_t top) {
  Fe t;
  uint32_t borrow = 0u;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    const uint64_t d = (uint64_t)a.v[i] - kP[i] - borrow;
    t.v[i] = (uint32_t)d;
    borrow = (uint32_t)(d >> 63);
  }
  const bool keep = top == 0u && borrow != 0u;  // a < p and no carry word
  Fe r;
#pragma unroll
  for (int i = 0; i < NL; ++i) r.v[i] = keep ? a.v[i] : t.v[i];
  return r;
}

// a + b < 2p < 2^257: the carry out of the top limb goes to reduce_once.
__device__ __forceinline__ Fe fe_add(const Fe& a, const Fe& b) {
  Fe s;
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    c += (uint64_t)a.v[i] + b.v[i];
    s.v[i] = (uint32_t)c;
    c >>= 32;
  }
  return reduce_once(s, (uint32_t)c);
}

// a - b, plus p when it borrows; the carry of that addition leaves 256
// bits and is dropped (a - b + p lies in [0, p)).
__device__ __forceinline__ Fe fe_sub(const Fe& a, const Fe& b) {
  Fe d;
  uint32_t borrow = 0u;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    const uint64_t t = (uint64_t)a.v[i] - b.v[i] - borrow;
    d.v[i] = (uint32_t)t;
    borrow = (uint32_t)(t >> 63);
  }
  const uint32_t mask = 0u - borrow;
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    c += (uint64_t)d.v[i] + (kP[i] & mask);
    d.v[i] = (uint32_t)c;
    c >>= 32;
  }
  return d;
}

// CIOS Montgomery product a*b/R mod p for a, b < p. Every partial result
// stays below 2p < 2^257, so the word t[NL] is 0 or 1 at the end and goes
// to the final subtraction with the low eight.
__device__ __forceinline__ Fe mont_mul(const Fe& a, const Fe& b) {
  uint32_t t[NL + 2];
#pragma unroll
  for (int i = 0; i < NL + 2; ++i) t[i] = 0u;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < NL; ++j) {
      c += (uint64_t)a.v[j] * b.v[i] + t[j];
      t[j] = (uint32_t)c;
      c >>= 32;
    }
    c += t[NL];
    t[NL] = (uint32_t)c;
    t[NL + 1] = (uint32_t)(c >> 32);
    const uint32_t m = t[0] * kPInv;
    c = ((uint64_t)m * kP[0] + t[0]) >> 32;
#pragma unroll
    for (int j = 1; j < NL; ++j) {
      c += (uint64_t)m * kP[j] + t[j];
      t[j - 1] = (uint32_t)c;
      c >>= 32;
    }
    c += t[NL];
    t[NL - 1] = (uint32_t)c;
    t[NL] = t[NL + 1] + (uint32_t)(c >> 32);
  }
  Fe r;
#pragma unroll
  for (int i = 0; i < NL; ++i) r.v[i] = t[i];
  return reduce_once(r, t[NL]);
}

__device__ __forceinline__ Fe fe_sqr(const Fe& a) { return mont_mul(a, a); }

__device__ __forceinline__ Fe load_fe(const uint32_t* __restrict__ a,
                                      int row0, int n, int lane) {
  Fe r;
#pragma unroll
  for (int i = 0; i < NL; ++i) r.v[i] = a[(size_t)(row0 + i) * n + lane];
  return r;
}

__device__ __forceinline__ void store_fe(uint32_t* __restrict__ a, int row0,
                                         int n, int lane, const Fe& v) {
#pragma unroll
  for (int i = 0; i < NL; ++i) a[(size_t)(row0 + i) * n + lane] = v.v[i];
}

// The one-thread group law stays out of line, as in g1.cu, where nvcc
// 12.9's device front end crashed on a fully inlined one-thread source.

// psecp._pt_dbl_val: Jacobian doubling, a = 0 (7 products).
__device__ __noinline__ Pt secp_dbl(const Pt& p) {
  const Fe A = fe_sqr(p.x);
  const Fe B = fe_sqr(p.y);
  const Fe C = fe_sqr(B);
  Fe D = fe_sub(fe_sub(fe_sqr(fe_add(p.x, B)), A), C);
  D = fe_add(D, D);
  const Fe E = fe_add(fe_add(A, A), A);
  const Fe F = fe_sqr(E);
  Pt r;
  r.x = fe_sub(F, fe_add(D, D));
  Fe C8 = fe_add(C, C);
  C8 = fe_add(C8, C8);
  C8 = fe_add(C8, C8);
  r.y = fe_sub(mont_mul(E, fe_sub(D, r.x)), C8);
  const Fe Z3 = mont_mul(p.y, p.z);
  r.z = fe_add(Z3, Z3);
  return r;
}

__device__ __forceinline__ Pt load_pt(const uint32_t* __restrict__ a, int n,
                                      int lane) {
  Pt r;
  r.x = load_fe(a, 0, n, lane);
  r.y = load_fe(a, NL, n, lane);
  r.z = load_fe(a, 2 * NL, n, lane);
  return r;
}

__device__ __forceinline__ void store_pt(uint32_t* __restrict__ a, int n,
                                         int lane, const Pt& p) {
  store_fe(a, 0, n, lane, p.x);
  store_fe(a, NL, n, lane, p.y);
  store_fe(a, 2 * NL, n, lane, p.z);
}

__global__ void __launch_bounds__(THREADS)
    secp_fp_mul_kernel(const uint32_t* __restrict__ x,
                       const uint32_t* __restrict__ y,
                       uint32_t* __restrict__ out, int n) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  store_fe(out, 0, n, lane,
           mont_mul(load_fe(x, 0, n, lane), load_fe(y, 0, n, lane)));
}

__global__ void __launch_bounds__(THREADS)
    secp_dbl_kernel(const uint32_t* __restrict__ p, uint32_t* __restrict__ out,
                    int n) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  store_pt(out, n, lane, secp_dbl(load_pt(p, n, lane)));
}

// psecp.sqrt_kernel: y = (x^3 + 7)^((p+1)/4) per lane, Montgomery in and
// out. Square-and-multiply from y2 (the exponent's top bit), MSB first.
__global__ void __launch_bounds__(THREADS)
    secp_sqrt_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
                     int n) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  const Fe xv = load_fe(x, 0, n, lane);
  Fe seven;
#pragma unroll
  for (int i = 0; i < NL; ++i) seven.v[i] = kSevenR[i];
  const Fe y2 = fe_add(mont_mul(fe_sqr(xv), xv), seven);
  Fe acc = y2;
#pragma unroll 1
  for (int i = kSqrtTopBit - 1; i >= 0; --i) {
    acc = fe_sqr(acc);
    if ((kSqrtExp[i >> 5] >> (i & 31)) & 1u) acc = mont_mul(acc, y2);
  }
  store_fe(out, 0, n, lane, acc);
}

// ---------------------------------------------------------------------------
// the scan: one lane on a group of T threads (coop.cuh over secp256k1)
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

// secp_dbl on the group field, operation for operation.
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

inline int blocks_for(int n) { return (n + THREADS - 1) / THREADS; }

}  // namespace

extern "C" {

int lt_secp_fp_mul(const void* x, const void* y, void* out, int n,
                   void* stream) {
  if (n > 0) {
    secp_fp_mul_kernel<<<blocks_for(n), THREADS, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)x, (const uint32_t*)y, (uint32_t*)out, n);
  }
  return (int)cudaGetLastError();
}

int lt_secp_dbl(const void* p, void* out, int n, void* stream) {
  if (n > 0) {
    secp_dbl_kernel<<<blocks_for(n), THREADS, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)p, (uint32_t*)out, n);
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
    secp_sqrt_kernel<<<blocks_for(n), THREADS, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)x, (uint32_t*)out, n);
  }
  return (int)cudaGetLastError();
}

// Registers per thread, local (spill) bytes, threads per lane and threads
// per block of kernel `which` (0 fp_mul, 1 dbl, 2 add, 3 msm_scan, 4 sqrt,
// 5 table), for the chip report.
int lt_secp_kernel_attrs(int which, int* regs, int* local_bytes,
                         int* threads_per_lane, int* block) {
  const void* fns[6] = {(const void*)secp_fp_mul_kernel,
                        (const void*)secp_dbl_kernel,
                        (const void*)secp_add_kernel<SCAN_T>,
                        (const void*)secp_msm_scan_kernel<SCAN_T>,
                        (const void*)secp_sqrt_kernel,
                        (const void*)secp_table_kernel<SCAN_T>};
  if (which < 0 || which > 5) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, fns[which]);
  if (err != cudaSuccess) return (int)err;
  const bool group = which == 2 || which == 3 || which == 5;
  *regs = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  *threads_per_lane = group ? SCAN_T : 1;
  *block = group ? SCAN_BLOCK : THREADS;
  return 0;
}

}  // extern "C"

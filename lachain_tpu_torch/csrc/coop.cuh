// A prime field on a group of T threads per lane, for the window scans and
// the group-field kernels of g1.cu, g2.cu and secp.cu, with the points and
// the table chain those kernels share. The field is a
// template parameter F, a traits type:
//   F::words      32-bit words per element (12 for BLS12-381, 8 for secp256k1)
//   F::pinv       -p^-1 mod 2^32
//   F::top_carry  whether p fills its top word, so that a sum below 2p can
//                 carry out of the element's words (secp256k1; not BLS12-381,
//                 whose 2p < 2^383)
//   F::p_word(i)  word i of p, read from the including file's constant bank
// fp.cuh instantiates it for BLS12-381 (BlsFp), secp.cu for secp256k1
// (SecpFp).
//
// Why. A scan lane is a long serial chain of Montgomery products, and at
// 8192 lanes one thread per lane leaves the card almost empty (256 warps on
// 528 schedulers): each dependent instruction waits its full latency.
// Splitting a lane's words over T threads (W = words / T each) cuts the
// chain per thread and puts T times the warps on the card. The values are
// the same: every operation here returns the canonical residue in [0, p),
// as the plain versions do, so a kernel's output is word for word theirs
// (and that of the one-thread kernels the group field replaced).
//
// Layout. The T threads of a group are adjacent lanes of one warp (T
// divides 32); rank r holds words [rW, rW + W) of each element, and of p.
// Groups are whole: a kernel keeps a group past n alive to the end and
// masks its stores, it never returns early from some of its threads.
// Shuffles and ballots take CoopGroup::mask, the full warp: the kernels
// keep the warp's control flow uniform (lanes_any: a warp doubles when any
// of its lanes must, and a flagged lane's zero accumulator doubles to
// itself), so every collective finds its whole warp converged. (With each
// group's own lanes as the mask and groups of one warp diverging on their
// flags, every collective was wrapped in WARPSYNC, BSSY/BSYNC and
// ENDCOLLECTIVE and the scans ran about 4x slower, PERF.md.)
//
// Product: CIOS across the group (after CGBN's threads-per-instance and
// sppark's Montgomery code) over carry-save columns. (A first version kept
// CGBN's PTX carry chains along each thread's words, mad.lo.cc/madc.hi.cc:
// every step then waited on a chain of about 2W + 4 dependent carries, and
// the G1 scan ran 5.70 ms at T = 4 against 5.30 at T = 1 and 5.43 for the
// one-thread uint64 scan it replaced; the columns took it to 1.41 ms, see
// PERF.md.) Thread r keeps its W columns as 64-bit sums t[j] < 2^33 - 1.
// Step i: b_i is broadcast from its owner; u[j] = t[j] + a_j * b_i (one
// mad.wide.u32 each, < 2^64); m = lo(u[0]) * -p^-1 on rank 0, broadcast;
// v[j] = lo(u[j]) + hi(u[j-1]) + m * p_j (< 2^64), where column 0 takes
// hi(u[W-1]) of the thread below (shuffle up); then every column moves one
// down: t[j] = lo(v[j+1]) + hi(v[j]) (< 2^33 - 1), the top column taking
// lo(v[0]) of the thread above (shuffle down) or, on the top thread, its
// own hi(u[W-1]). These bounds hold for any odd p below 2^(32 words). No
// carry ripples along the words inside a step, so a step's dependent path
// is a few instructions and a shuffle, not a chain of 2W carries. After
// `words` steps one PTX carry chain per thread turns the columns into
// words and one ballot resolution settles the carries between threads. The
// value is then below 2p (the CIOS invariant, a, b < p). For BLS12-381
// that is < 2^383, so nothing leaves the group. For secp256k1 2p > 2^256:
// one bit may leave, either as the high bit of the top thread's top column
// or as the carry out of its words, never both (the value would be >=
// 2^257 > 2p); the top thread folds the first into its generate bit, whose
// carry out of the group is bit T of (G | P) + G, and that reaches the
// conditional subtraction of p as its carry word. Folding it changes no
// carry into a thread of the group: carries move up only. The bounds are
// tight (p - 1 operands reach them) and are checked, edge operands
// included, by a word-level model of this code against Python ints for
// both primes at T = 1, 2 and 4, and for secp256k1 at T = 8 (one word a
// thread; tests/test_torch_coop_model.py). The conditional subtraction of
// p is a group-wide subtraction whose final borrow, and for secp256k1 the
// carry word, picks the result. The Montgomery reduction (fpg_redc, out of
// Montgomery form) is the same steps with no word products: the columns
// start as the operand's words.
//
// Carry resolution (add, sub, the product's end): each thread adds or
// subtracts its words locally with a PTX carry chain, then two ballots
// give every thread the group's generate bits G (carry out) and propagate
// bits P (its words are all ones for an add, all zeros for a subtraction,
// so a carry in would pass through). The carry into rank r is bit r of
// ((G | P) + G) ^ P, and bit T of (G | P) + G is the carry out of the
// group.
//
// T = 1 is the same code with no shuffle and no ballot. T = 8 serves
// secp256k1 only (BLS12-381's 12 words do not split 8 ways).

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// ---------------------------------------------------------------------------
// PTX carry chains: CC.CF carries from one call to the next
// ---------------------------------------------------------------------------

// Each step of a chain is its own asm volatile statement, as in CGBN, and
// the carry flag passes from one statement to the next with ordinary code
// (the word extracts of fpg_mul's settle) between them. The inline-PTX
// rules do not promise that the flag survives between statements; nvcc
// 12.9 keeps it (the scans are exact against their plain versions on the
// card, tests/test_torch_cuda.py). After a compiler update, run those tests
// before anything else: a broken chain builds without an error.

__device__ __forceinline__ uint32_t add_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("add.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t addc_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("addc.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t addc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("addc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t sub_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("sub.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t subc_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("subc.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t subc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("subc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
// ---------------------------------------------------------------------------
// the group
// ---------------------------------------------------------------------------

template <class F, int T>
struct CoopGroup {
  static_assert(T == 1 || T == 2 || T == 4 || T == 8,
                "T threads per lane: 1, 2, 4 or 8");
  static_assert(F::words % T == 0, "T must divide the words");
  static constexpr int W = F::words / T;  // words per thread
  static constexpr uint32_t mask = 0xffffffffu;  // every collective's lanes
  int shift;                        // warp lane of rank 0
  int rank;                         // this thread's words: [rank*W, rank*W+W)
  uint32_t p[W];                    // this thread's words of p
};

// Word j of rank `rank`'s share of a constant of the including file's
// bank, word(i) its word i. Every word is read at a constant index (the
// same address on every thread: a divergent index would serialize the
// constant cache) and the rank's is selected.
template <class F, int T, class Word>
__device__ __forceinline__ uint32_t rank_word(int rank, int j, Word word) {
  constexpr int W = F::words / T;
  uint32_t v = word(j);
#pragma unroll
  for (int r = 1; r < T; ++r) v = rank == r ? word(r * W + j) : v;
  return v;
}

template <class F, int T>
__device__ __forceinline__ CoopGroup<F, T> make_coop_group() {
  constexpr int W = CoopGroup<F, T>::W;
  CoopGroup<F, T> g;
  const int wl = (int)(threadIdx.x & 31u);
  g.rank = wl & (T - 1);
  g.shift = wl - g.rank;
#pragma unroll
  for (int j = 0; j < W; ++j)
    g.p[j] = rank_word<F, T>(g.rank, j, [](int i) { return F::p_word(i); });
  return g;
}

// Whether any lane of the warp needs `pred`: the warp decides as one, so
// its collectives stay converged.
template <class F, int T>
__device__ __forceinline__ bool lanes_any(const CoopGroup<F, T>& g, bool pred) {
  return __any_sync(g.mask, pred);
}

// This thread's lane, and whether it is below n: a group past n works on
// lane 0's data and stores nothing, but stays alive to the end (every
// collective takes the full warp). Blocks are BLOCK threads.
template <int T, int BLOCK>
__device__ __forceinline__ int group_lane(int n, bool& live) {
  const int lane = (int)((blockIdx.x * (unsigned)BLOCK + threadIdx.x) / T);
  live = lane < n;
  return live ? lane : 0;
}

// blocks of BLOCK threads for n lanes of T threads each
template <int T, int BLOCK>
inline int group_blocks(int n) {
  return (int)(((long long)n * T + BLOCK - 1) / BLOCK);
}

template <class F, int T>
struct CoopFp {
  uint32_t v[F::words / T];
};

// a field constant of the including file's bank, word(i) its word i: this
// thread's W words
template <class F, int T, class Word>
__device__ __forceinline__ CoopFp<F, T> fpg_const(const CoopGroup<F, T>& g,
                                                  Word word) {
  CoopFp<F, T> r;
#pragma unroll
  for (int j = 0; j < F::words / T; ++j) r.v[j] = rank_word<F, T>(g.rank, j, word);
  return r;
}

// rows [row0, row0 + words) of a lane-minor array: this thread's W words
template <class F, int T>
__device__ __forceinline__ CoopFp<F, T> load_fpg(const CoopGroup<F, T>& g,
                                                 const uint32_t* __restrict__ a,
                                                 int row0, int n, int lane) {
  constexpr int W = F::words / T;
  CoopFp<F, T> r;
#pragma unroll
  for (int j = 0; j < W; ++j)
    r.v[j] = a[(size_t)(row0 + g.rank * W + j) * n + lane];
  return r;
}

template <class F, int T>
__device__ __forceinline__ void store_fpg(const CoopGroup<F, T>& g,
                                          uint32_t* __restrict__ a, int row0,
                                          int n, int lane,
                                          const CoopFp<F, T>& v) {
  constexpr int W = F::words / T;
#pragma unroll
  for (int j = 0; j < W; ++j)
    a[(size_t)(row0 + g.rank * W + j) * n + lane] = v.v[j];
}

// ---------------------------------------------------------------------------
// carries across the group
// ---------------------------------------------------------------------------

template <int W>
__device__ __forceinline__ bool all_ones(const uint32_t (&s)[W]) {
  uint32_t x = s[0];
#pragma unroll
  for (int j = 1; j < W; ++j) x &= s[j];
  return x == 0xffffffffu;
}

template <int W>
__device__ __forceinline__ bool all_zero(const uint32_t (&s)[W]) {
  uint32_t x = s[0];
#pragma unroll
  for (int j = 1; j < W; ++j) x |= s[j];
  return x == 0u;
}

// The carry into this thread from the generate bit `gen` and propagate bit
// `prop` of every thread of the group; `top` gets the carry out of the
// group's top thread.
template <class F, int T>
__device__ __forceinline__ uint32_t group_carry(const CoopGroup<F, T>& g,
                                                uint32_t gen, bool prop,
                                                uint32_t& top) {
  const uint32_t all = (1u << T) - 1u;
  const uint32_t G = (__ballot_sync(g.mask, gen != 0u) >> g.shift) & all;
  const uint32_t P = (__ballot_sync(g.mask, prop) >> g.shift) & all;
  const uint32_t S = (G | P) + G;
  top = (S >> T) & 1u;
  return ((S ^ P) >> g.rank) & 1u;
}

// s += (carry in) after a local add whose carry out was `gen`; returns the
// carry out of the group.
template <class F, int T>
__device__ __forceinline__ uint32_t settle_add(const CoopGroup<F, T>& g,
                                               uint32_t (&s)[F::words / T],
                                               uint32_t gen) {
  if constexpr (T == 1) {
    return gen;
  } else {
    uint32_t top;
    const uint32_t c = group_carry(g, gen, all_ones(s), top);
    s[0] = add_cc(s[0], c);
#pragma unroll
    for (int j = 1; j < F::words / T; ++j) s[j] = addc_cc(s[j], 0u);
    return top;
  }
}

// s -= (borrow in) after a local subtraction whose borrow out was `gen`;
// returns the borrow out of the group.
template <class F, int T>
__device__ __forceinline__ uint32_t settle_sub(const CoopGroup<F, T>& g,
                                               uint32_t (&s)[F::words / T],
                                               uint32_t gen) {
  if constexpr (T == 1) {
    return gen;
  } else {
    uint32_t top;
    const uint32_t b = group_carry(g, gen, all_zero(s), top);
    s[0] = sub_cc(s[0], b);
#pragma unroll
    for (int j = 1; j < F::words / T; ++j) s[j] = subc_cc(s[j], 0u);
    return top;
  }
}

// s = a + b over this thread's words; returns the carry out (0 or 1)
template <int W>
__device__ __forceinline__ uint32_t add_words(uint32_t (&s)[W],
                                              const uint32_t (&a)[W],
                                              const uint32_t (&b)[W]) {
  s[0] = add_cc(a[0], b[0]);
#pragma unroll
  for (int j = 1; j < W; ++j) s[j] = addc_cc(a[j], b[j]);
  return addc(0u, 0u);
}

// s = a - b over this thread's words; returns the borrow out (0 or 1)
template <int W>
__device__ __forceinline__ uint32_t sub_words(uint32_t (&s)[W],
                                              const uint32_t (&a)[W],
                                              const uint32_t (&b)[W]) {
  s[0] = sub_cc(a[0], b[0]);
#pragma unroll
  for (int j = 1; j < W; ++j) s[j] = subc_cc(a[j], b[j]);
  return subc(0u, 0u) & 1u;
}

// ---------------------------------------------------------------------------
// the field
// ---------------------------------------------------------------------------

// (top * 2^(32 words) + s) mod p for a value below 2p: s - p when the carry
// word `top` is set or s >= p. Without F::top_carry, top is always 0 and is
// not read.
template <class F, int T>
__device__ __forceinline__ CoopFp<F, T> reduce_once_g(const CoopGroup<F, T>& g,
                                                      const CoopFp<F, T>& s,
                                                      uint32_t top) {
  CoopFp<F, T> d;
  const uint32_t borrow = settle_sub(g, d.v, sub_words(d.v, s.v, g.p));
  bool keep = borrow != 0u;  // s < p
  if constexpr (F::top_carry) keep = keep && top == 0u;
  CoopFp<F, T> r;
#pragma unroll
  for (int j = 0; j < F::words / T; ++j) r.v[j] = keep ? s.v[j] : d.v[j];
  return r;
}

// a + b < 2p: its carry out of the group is the carry word.
template <class F, int T>
__device__ __forceinline__ CoopFp<F, T> fpg_add(const CoopGroup<F, T>& g,
                                                const CoopFp<F, T>& a,
                                                const CoopFp<F, T>& b) {
  CoopFp<F, T> s;
  const uint32_t top = settle_add(g, s.v, add_words(s.v, a.v, b.v));
  return reduce_once_g(g, s, top);
}

// a - b, plus p when it borrows; the carry of that addition leaves the
// group and is dropped (a - b + p lies in [0, p)).
template <class F, int T>
__device__ __forceinline__ CoopFp<F, T> fpg_sub(const CoopGroup<F, T>& g,
                                                const CoopFp<F, T>& a,
                                                const CoopFp<F, T>& b) {
  CoopFp<F, T> d;
  const uint32_t mask = 0u - settle_sub(g, d.v, sub_words(d.v, a.v, b.v));
  uint32_t pm[F::words / T];  // a < b: add p back
#pragma unroll
  for (int j = 0; j < F::words / T; ++j) pm[j] = g.p[j] & mask;
  settle_add(g, d.v, add_words(d.v, d.v, pm));
  return d;
}

// One CIOS step over the carry-save columns t (64 bits each, below 2^33 - 1),
// given the step's columns u: t plus the word products a_j * b_i in a
// product, t itself in a reduction. m = lo(u[0]) * -p^-1 on rank 0,
// broadcast; m * p joins the columns and every column moves one down. u may
// be t: every read of u comes before the first write of t.
template <class F, int T>
__device__ __forceinline__ void cios_step(const CoopGroup<F, T>& g,
                                          uint64_t (&t)[F::words / T],
                                          const uint64_t (&u)[F::words / T]) {
  constexpr int W = F::words / T;
  uint32_t m = (uint32_t)u[0] * F::pinv;
  const uint32_t c1 = (uint32_t)(u[W - 1] >> 32);  // to the next thread
  uint32_t cin = 0u;
  if constexpr (T > 1) {
    m = __shfl_sync(g.mask, m, 0, T);
    cin = __shfl_up_sync(g.mask, c1, 1, T);
    if (g.rank == 0) cin = 0u;
  }
  uint64_t v[W];  // < 2^64 likewise; column 0 of rank 0 is now 0 mod 2^32
  v[0] = (uint64_t)(uint32_t)u[0] + cin + (uint64_t)m * g.p[0];
#pragma unroll
  for (int j = 1; j < W; ++j)
    v[j] = (uint64_t)(uint32_t)u[j] + (u[j - 1] >> 32) + (uint64_t)m * g.p[j];
  // one column down: the top column takes the next thread's column 0, or
  // on the top thread its own carry c1
  uint32_t recv = c1;
  if constexpr (T > 1) {
    recv = __shfl_down_sync(g.mask, (uint32_t)v[0], 1, T);
    if (g.rank == T - 1) recv = c1;
  }
#pragma unroll
  for (int j = 0; j + 1 < W; ++j)
    t[j] = (uint64_t)(uint32_t)v[j + 1] + (v[j] >> 32);
  t[W - 1] = (uint64_t)recv + (v[W - 1] >> 32);
}

// The columns after the last CIOS step, a value below 2p, settled into
// words (word j = lo(t[j]) + hi(t[j-1]) + carry) and reduced below p.
template <class F, int T>
__device__ __forceinline__ CoopFp<F, T> cios_settle(
    const CoopGroup<F, T>& g, const uint64_t (&t)[F::words / T]) {
  constexpr int W = F::words / T;
  uint32_t cin = 0u;
  if constexpr (T > 1) {
    cin = __shfl_up_sync(g.mask, (uint32_t)(t[W - 1] >> 32), 1, T);
    if (g.rank == 0) cin = 0u;
  }
  CoopFp<F, T> r;
  r.v[0] = add_cc((uint32_t)t[0], cin);
#pragma unroll
  for (int j = 1; j < W; ++j)
    r.v[j] = addc_cc((uint32_t)t[j], (uint32_t)(t[j - 1] >> 32));
  uint32_t gen = addc(0u, 0u);
  if constexpr (F::top_carry) {
    // the top column's high bit is above the top word: fold it into the
    // top thread's carry out (at most one of the two is set, see the header)
    if (g.rank == T - 1) gen |= (uint32_t)(t[W - 1] >> 32);
  }
  const uint32_t top = settle_add(g, r.v, gen);
  return reduce_once_g(g, r, top);
}

// Montgomery product a*b/R mod p for a, b < p (canonical result), CIOS over
// carry-save columns: t[j] (64 bits) holds column j's pending sum, below
// 2^33 - 1, so each word product is one mad.wide.u32 into its own column
// and no carry ripples along the words inside a step (see the header).
template <class F, int T>
__device__ __forceinline__ CoopFp<F, T> fpg_mul(const CoopGroup<F, T>& g,
                                                const CoopFp<F, T>& a,
                                                const CoopFp<F, T>& b) {
  constexpr int W = F::words / T;
  uint64_t t[W];
#pragma unroll
  for (int j = 0; j < W; ++j) t[j] = 0u;
#pragma unroll
  for (int i = 0; i < F::words; ++i) {
    uint32_t bi = b.v[i % W];
    if constexpr (T > 1) bi = __shfl_sync(g.mask, bi, i / W, T);
    uint64_t u[W];  // < 2^64: t[j] < 2^33 - 1, a_j * b_i <= 2^64 - 2^33 + 1
#pragma unroll
    for (int j = 0; j < W; ++j) u[j] = t[j] + (uint64_t)a.v[j] * bi;
    cios_step(g, t, u);
  }
  return cios_settle(g, t);
}

// Montgomery reduction a/R mod p (canonical) of any a < 2^(32 words): the
// product by 1 without its word products. The columns start as a's words
// and each of the `words` steps only adds m * p: words * (words + 1) word
// products (72 for secp256k1) against the product's 2 words^2 + words
// (136). The value stays below (a + R p) / R < 2p.
template <class F, int T>
__device__ __forceinline__ CoopFp<F, T> fpg_redc(const CoopGroup<F, T>& g,
                                                 const CoopFp<F, T>& a) {
  constexpr int W = F::words / T;
  uint64_t t[W];
#pragma unroll
  for (int j = 0; j < W; ++j) t[j] = a.v[j];
#pragma unroll
  for (int i = 0; i < F::words; ++i) cios_step(g, t, t);
  return cios_settle(g, t);
}

template <class F, int T>
__device__ __forceinline__ CoopFp<F, T> fpg_sqr(const CoopGroup<F, T>& g,
                                                const CoopFp<F, T>& a) {
  return fpg_mul(g, a, a);
}

// ---------------------------------------------------------------------------
// points, and the window table's chain
// ---------------------------------------------------------------------------

// A Jacobian point over F (G1, secp256k1): rows X | Y | Z of a lane-minor
// array, F::words rows each.
template <class F, int T>
struct CoopPt {
  CoopFp<F, T> x, y, z;
};

// a (3 words, n) point array: this thread's words of lane `lane`
template <class F, int T>
__device__ __forceinline__ CoopPt<F, T> load_pt_g(
    const CoopGroup<F, T>& g, const uint32_t* __restrict__ a, int n,
    int lane) {
  CoopPt<F, T> r;
  r.x = load_fpg(g, a, 0, n, lane);
  r.y = load_fpg(g, a, F::words, n, lane);
  r.z = load_fpg(g, a, 2 * F::words, n, lane);
  return r;
}

template <class F, int T>
__device__ __forceinline__ void store_pt_g(const CoopGroup<F, T>& g,
                                           uint32_t* __restrict__ a, int n,
                                           int lane, const CoopPt<F, T>& p) {
  store_fpg(g, a, 0, n, lane, p.x);
  store_fpg(g, a, F::words, n, lane, p.y);
  store_fpg(g, a, 2 * F::words, n, lane, p.z);
}

// table (16, 3 words, n): this thread's words of entry d; digit 0 selects
// the zero point, as pg1._select_entry (which psecp uses) does: entry 0
// never contributes.
template <class F, int T>
__device__ __forceinline__ CoopPt<F, T> select_entry_g(
    const CoopGroup<F, T>& g, const uint32_t* __restrict__ table, int d,
    int n, int lane) {
  if (d == 0) return CoopPt<F, T>{};
  return load_pt_g(g, table + (size_t)d * 3 * F::words * n, n, lane);
}

// z^2 and z^3 of the point q of an incomplete add p + q, the two products
// of the add that read only q: a chain that adds one q makes them once.
template <class E>
struct ZPow {
  E zz, zzz;
};

template <class F, int T>
__device__ __forceinline__ ZPow<CoopFp<F, T>> z_pow_g(
    const CoopGroup<F, T>& g, const CoopFp<F, T>& z) {
  const CoopFp<F, T> zz = fpg_sqr(g, z);
  return {zz, fpg_mul(g, z, zz)};
}

// The window table of a lane's point p, entry k = k * p: entry 0 the zero
// point, 1 p, 2 dbl(p), then k = (k - 1) * p + p for k = 3 .. ENTRIES - 1
// by add(cur), the incomplete add of p (with p's ZPow made once). This is
// the chain of the TPU package's build_table (one doubling launch, then
// chained add launches), so every entry is word for word what that chain
// gives, and an infinity lane (0, 1, 0) keeps Z = 0 all along, as there (a
// table in log depth would reach other Jacobian coordinates). store(k, pt)
// writes entry k; only a live lane stores, and a group past n computes on
// to the end (its adds' collectives take the full warp).
template <int ENTRIES, class Pt, class Dbl, class Add, class Store>
__device__ __forceinline__ void chain_table(const Pt& p, bool live, Dbl dbl,
                                            Add add, Store store) {
  if (live) {
    store(0, Pt{});
    store(1, p);
  }
  Pt cur = dbl(p);
  if (live) store(2, cur);
#pragma unroll 1
  for (int k = 3; k < ENTRIES; ++k) {
    cur = add(cur);
    if (live) store(k, cur);
  }
}

}  // namespace

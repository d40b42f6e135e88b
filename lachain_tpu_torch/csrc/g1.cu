// BLS12-381 G1 kernels for Hopper (sm_90a): the four Pallas kernels of
// lachain_tpu/ops/pg1.py, thought through again for the card.
//
//   lt_g1_fp_mul    <- pg1._mul_kernel   (pl_fp_mul, pg1.py:262/:323)
//   lt_g1_dbl       <- pg1._dbl_kernel   (pl_dbl,    pg1.py:253/:279)
//   lt_g1_add       <- pg1._add_kernel   (pl_add,    pg1.py:257/:301)
//   lt_g1_table     <- pg1._add_kernel and _dbl_kernel as build_table
//                      chains them (pg1.py:447): the whole table, one launch
//   lt_g1_msm_scan  <- pg1._msm_kernel   (_msm_scan, pg1.py:355/:412)
//
// Representation. pg1's 44 x 10-bit signed limbs, its f32 MXU residue fold
// and its 256-lane VMEM tiles are TPU artifacts. Here a field element is 12
// x 32-bit limbs in Montgomery form (R = 2^384), always canonical in [0, p)
// (fp.cuh, shared with g2.cu); a point is 36 rows X | Y | Z, lane-minor.
// The host converts into and out of Montgomery form with lt_g1_fp_mul by
// R^2 mod p and by 1 (lachain_tpu_torch/ops/g1.py).
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
// fp_mul and dbl: one thread per lane on fp.cuh's field (uint64 CIOS); since
// the table build is one launch, dbl serves no main path.
// The group-field kernels (the scan, add and the table build): SCAN_T
// threads per lane on coop.cuh's group field over fp.cuh's p (BlsFp:
// carry-save column products, PTX carry chains for the carries, ballots
// between the threads), the group law inlined. add serves the tree
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
constexpr int THREADS = 64;  // n = 8192 lanes -> 128 blocks over 132 SMs
constexpr int SCAN_T = LT_G1_SCAN_T;  // threads per lane (group field)
constexpr int SCAN_BLOCK = 64;        // their threads per block

struct Pt {
  Fp x, y, z;
};

// The one-thread doubling of dbl_kernel stays out of line: with the
// one-thread group law's uint64 products inlined into every kernel, nvcc
// 12.9's device front end (cicc) crashed with a segmentation fault on this
// file.

// pg1._g1_dbl_val: Jacobian doubling, a = 0 (7 products).
__device__ __noinline__ Pt g1_dbl(const Pt& p) {
  const Fp A = fp_sqr(p.x);
  const Fp B = fp_sqr(p.y);
  const Fp C = fp_sqr(B);
  Fp D = fp_sub(fp_sub(fp_sqr(fp_add(p.x, B)), A), C);
  D = fp_add(D, D);
  const Fp E = fp_add(fp_add(A, A), A);
  const Fp F = fp_sqr(E);
  Pt r;
  r.x = fp_sub(F, fp_add(D, D));
  Fp C8 = fp_add(C, C);
  C8 = fp_add(C8, C8);
  C8 = fp_add(C8, C8);
  r.y = fp_sub(mont_mul(E, fp_sub(D, r.x)), C8);
  const Fp Z3 = mont_mul(p.y, p.z);
  r.z = fp_add(Z3, Z3);
  return r;
}

__device__ __forceinline__ Pt load_pt(const uint32_t* __restrict__ a, int n,
                                      int lane) {
  Pt r;
  r.x = load_fp(a, 0, n, lane);
  r.y = load_fp(a, NL, n, lane);
  r.z = load_fp(a, 2 * NL, n, lane);
  return r;
}

__device__ __forceinline__ void store_pt(uint32_t* __restrict__ a, int n,
                                         int lane, const Pt& p) {
  store_fp(a, 0, n, lane, p.x);
  store_fp(a, NL, n, lane, p.y);
  store_fp(a, 2 * NL, n, lane, p.z);
}

__global__ void __launch_bounds__(THREADS)
    fp_mul_kernel(const uint32_t* __restrict__ x,
                  const uint32_t* __restrict__ y, uint32_t* __restrict__ out,
                  int n) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  store_fp(out, 0, n, lane,
           mont_mul(load_fp(x, 0, n, lane), load_fp(y, 0, n, lane)));
}

__global__ void __launch_bounds__(THREADS)
    dbl_kernel(const uint32_t* __restrict__ p, uint32_t* __restrict__ out,
               int n) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  store_pt(out, n, lane, g1_dbl(load_pt(p, n, lane)));
}

// ---------------------------------------------------------------------------
// the scan: one lane on a group of T threads (coop.cuh)
// ---------------------------------------------------------------------------

template <int T>
using Group = CoopGroup<BlsFp, T>;

template <int T>
using FpG = CoopFp<BlsFp, T>;

template <int T>
using PtG = CoopPt<BlsFp, T>;

// g1_dbl on the group field, operation for operation.
template <int T>
__device__ __forceinline__ PtG<T> g1_dbl_g(const Group<T>& g,
                                           const PtG<T>& p) {
  const FpG<T> A = fpg_sqr(g, p.x);
  const FpG<T> B = fpg_sqr(g, p.y);
  const FpG<T> C = fpg_sqr(g, B);
  FpG<T> D = fpg_sub(g, fpg_sub(g, fpg_sqr(g, fpg_add(g, p.x, B)), A), C);
  D = fpg_add(g, D, D);
  const FpG<T> E = fpg_add(g, fpg_add(g, A, A), A);
  const FpG<T> F = fpg_sqr(g, E);
  PtG<T> r;
  r.x = fpg_sub(g, F, fpg_add(g, D, D));
  FpG<T> C8 = fpg_add(g, C, C);
  C8 = fpg_add(g, C8, C8);
  C8 = fpg_add(g, C8, C8);
  r.y = fpg_sub(g, fpg_mul(g, E, fpg_sub(g, D, r.x)), C8);
  const FpG<T> Z3 = fpg_mul(g, p.y, p.z);
  r.z = fpg_add(g, Z3, Z3);
  return r;
}

// pg1._g1_add_val on the group field: incomplete Jacobian add, p != +-q,
// both finite; p = +-q gives Z = 0, as there. qz is q's ZPow (coop.cuh):
// 14 products here and 2 in qz, pg1's 16. S1 = Y1 * Z2^3 is grouped
// Y1 * (Z2 * Z2Z2) where pg1 has (Y1 * Z2) * Z2Z2: every product is the
// canonical residue, so the values are the same.
template <int T>
__device__ __forceinline__ PtG<T> g1_add_g(const Group<T>& g, const PtG<T>& p,
                                           const PtG<T>& q,
                                           const ZPow<FpG<T>>& qz) {
  const FpG<T> Z1Z1 = fpg_sqr(g, p.z);
  const FpG<T> Z2Z2 = qz.zz;
  const FpG<T> U1 = fpg_mul(g, p.x, Z2Z2);
  const FpG<T> U2 = fpg_mul(g, q.x, Z1Z1);
  const FpG<T> S1 = fpg_mul(g, p.y, qz.zzz);
  const FpG<T> S2 = fpg_mul(g, fpg_mul(g, q.y, p.z), Z1Z1);
  const FpG<T> H = fpg_sub(g, U2, U1);
  const FpG<T> Rr = fpg_sub(g, S2, S1);
  const FpG<T> I = fpg_sqr(g, fpg_add(g, H, H));
  const FpG<T> J = fpg_mul(g, H, I);
  const FpG<T> Rr2 = fpg_add(g, Rr, Rr);
  const FpG<T> V = fpg_mul(g, U1, I);
  PtG<T> r;
  r.x = fpg_sub(g, fpg_sub(g, fpg_sqr(g, Rr2), J), fpg_add(g, V, V));
  const FpG<T> S1J = fpg_mul(g, S1, J);
  r.y = fpg_sub(g, fpg_mul(g, Rr2, fpg_sub(g, V, r.x)), fpg_add(g, S1J, S1J));
  const FpG<T> Z3 = fpg_mul(g, fpg_mul(g, p.z, q.z), H);
  r.z = fpg_add(g, Z3, Z3);
  return r;
}

// the add of any p and q (16 products)
template <int T>
__device__ __forceinline__ PtG<T> g1_add_g(const Group<T>& g, const PtG<T>& p,
                                           const PtG<T>& q) {
  return g1_add_g(g, p, q, z_pow_g(g, q.z));
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

inline int blocks_for(int n) { return (n + THREADS - 1) / THREADS; }

}  // namespace

extern "C" {

int lt_g1_fp_mul(const void* x, const void* y, void* out, int n,
                 void* stream) {
  if (n > 0) {
    fp_mul_kernel<<<blocks_for(n), THREADS, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)x, (const uint32_t*)y, (uint32_t*)out, n);
  }
  return (int)cudaGetLastError();
}

int lt_g1_dbl(const void* p, void* out, int n, void* stream) {
  if (n > 0) {
    dbl_kernel<<<blocks_for(n), THREADS, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)p, (uint32_t*)out, n);
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

// Registers per thread, local (spill) bytes, threads per lane and threads
// per block of kernel `which` (0 fp_mul, 1 dbl, 2 add, 3 msm_scan, 4
// table), for the chip report.
int lt_g1_kernel_attrs(int which, int* regs, int* local_bytes,
                       int* threads_per_lane, int* block) {
  const void* fns[5] = {(const void*)fp_mul_kernel, (const void*)dbl_kernel,
                        (const void*)add_kernel<SCAN_T>,
                        (const void*)msm_scan_kernel<SCAN_T>,
                        (const void*)g1_table_kernel<SCAN_T>};
  if (which < 0 || which > 4) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, fns[which]);
  if (err != cudaSuccess) return (int)err;
  const bool one_thread = which < 2;  // fp_mul and dbl
  *regs = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  *threads_per_lane = one_thread ? 1 : SCAN_T;
  *block = one_thread ? THREADS : SCAN_BLOCK;
  return 0;
}

}  // extern "C"

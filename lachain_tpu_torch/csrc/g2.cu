// BLS12-381 G2 kernels for Hopper (sm_90a): the three Pallas kernels of
// lachain_tpu/ops/pg2.py, thought through again for the card.
//
//   lt_g2_dbl       <- pg2._dbl2_kernel  (pl_dbl2,    pg2.py:218/:228)
//   lt_g2_add       <- pg2._add2_kernel  (pl_add2,    pg2.py:222/:250)
//   lt_g2_msm_scan  <- pg2._msm2_kernel  (_msm2_scan, pg2.py:272/:322)
//
// Representation. Fp2 = Fp[i]/(i^2 + 1) over fp.cuh's field (12 x 32-bit
// Montgomery limbs, canonical in [0, p)). A point is 72 rows X.c0 | X.c1 |
// Y.c0 | Y.c1 | Z.c0 | Z.c1, 12 rows each, lane-minor. pg2's 48-row
// component slots, its 44 x 10-bit limbs and its side-by-side packing of
// the three Karatsuba products on one lane block are TPU artifacts.
//
// Arithmetic: fp2_mul is Karatsuba (3 Montgomery products), fp2_sqr is
// (a+b)(a-b) and 2ab (2 products). The group law uses pg2's formulas
// (pg2._g2_dbl_val, pg2._g2_add_val, pg2.py:154-200) operation for
// operation, so a collision p = +-q in an incomplete add gives Z = 0 exactly
// where the TPU kernel does, and the coin pipeline's escape to the host MSM
// fires on the same coins. A doubling is 16 Fp products, an add 44.
//
// Bound: integer multiply-adds, ~600 per Fp product; a 64-window scan needs
// up to 63 * (4 * 16 + 44) products per lane. Bytes are small beside them:
// the scan reads one 288-byte table entry per lane per nonzero digit. Design:
// one thread per lane; the scan keeps its accumulator and flag in registers
// across all windows in one launch and reads table[d] from device memory.
// While a lane's flag is set its accumulator is the zero point, which the
// doublings leave as it is, so the scan skips them: the output is the one
// the plain version gives, and a lane of leading zero windows (the coin
// era's RLC half, its masked Lagrange lanes) costs no products.
//
// Each extern "C" entry launches on the caller's stream and returns
// cudaGetLastError(); the Python wrapper raises when it is non-zero.

#include "fp.cuh"

namespace {

constexpr int ROWS2 = 6 * NL;  // rows of a point: six Fp components
constexpr int WINDOW = 4;
constexpr int THREADS = 64;  // n = 8192 lanes -> 128 blocks over 132 SMs

struct Fp2 {
  Fp c0, c1;
};

struct Pt2 {
  Fp2 x, y, z;
};

__device__ __forceinline__ Fp2 fp2_add(const Fp2& a, const Fp2& b) {
  return {fp_add(a.c0, b.c0), fp_add(a.c1, b.c1)};
}

__device__ __forceinline__ Fp2 fp2_sub(const Fp2& a, const Fp2& b) {
  return {fp_sub(a.c0, b.c0), fp_sub(a.c1, b.c1)};
}

__device__ __forceinline__ Fp2 fp2_dbl(const Fp2& a) { return fp2_add(a, a); }

// The products stay out of line, like the group law below: a G2 add holds
// 44 Montgomery products, and inlining all of them into one function is
// what crashed nvcc 12.9's device front end (cicc) on the G1 source.

// pg2._fp2_mul: (a + bi)(d + ei) = (ad - be) + ((a+b)(d+e) - ad - be) i.
__device__ __noinline__ Fp2 fp2_mul(const Fp2& x, const Fp2& y) {
  const Fp ad = mont_mul(x.c0, y.c0);
  const Fp be = mont_mul(x.c1, y.c1);
  const Fp k = mont_mul(fp_add(x.c0, x.c1), fp_add(y.c0, y.c1));
  return {fp_sub(ad, be), fp_sub(fp_sub(k, ad), be)};
}

// pg2._fp2_sqr: (a + bi)^2 = (a+b)(a-b) + 2ab i.
__device__ __noinline__ Fp2 fp2_sqr(const Fp2& x) {
  const Fp re = mont_mul(fp_add(x.c0, x.c1), fp_sub(x.c0, x.c1));
  const Fp ab = mont_mul(x.c0, x.c1);
  return {re, fp_add(ab, ab)};
}

// pg2._g2_dbl_val: Jacobian doubling, a = 0 (16 products).
__device__ __noinline__ Pt2 g2_dbl(const Pt2& p) {
  const Fp2 A = fp2_sqr(p.x);
  const Fp2 B = fp2_sqr(p.y);
  const Fp2 C = fp2_sqr(B);
  Fp2 D = fp2_sub(fp2_sub(fp2_sqr(fp2_add(p.x, B)), A), C);
  D = fp2_dbl(D);
  const Fp2 E = fp2_add(fp2_dbl(A), A);
  const Fp2 F = fp2_sqr(E);
  Pt2 r;
  r.x = fp2_sub(F, fp2_dbl(D));
  const Fp2 C8 = fp2_dbl(fp2_dbl(fp2_dbl(C)));
  r.y = fp2_sub(fp2_mul(E, fp2_sub(D, r.x)), C8);
  r.z = fp2_dbl(fp2_mul(p.y, p.z));
  return r;
}

// pg2._g2_add_val: incomplete Jacobian add, p != +-q, both finite
// (44 products).
__device__ __noinline__ Pt2 g2_add(const Pt2& p, const Pt2& q) {
  const Fp2 Z1Z1 = fp2_sqr(p.z);
  const Fp2 Z2Z2 = fp2_sqr(q.z);
  const Fp2 U1 = fp2_mul(p.x, Z2Z2);
  const Fp2 U2 = fp2_mul(q.x, Z1Z1);
  const Fp2 S1 = fp2_mul(fp2_mul(p.y, q.z), Z2Z2);
  const Fp2 S2 = fp2_mul(fp2_mul(q.y, p.z), Z1Z1);
  const Fp2 H = fp2_sub(U2, U1);
  const Fp2 Rr = fp2_sub(S2, S1);
  const Fp2 I = fp2_sqr(fp2_dbl(H));
  const Fp2 J = fp2_mul(H, I);
  const Fp2 Rr2 = fp2_dbl(Rr);
  const Fp2 V = fp2_mul(U1, I);
  Pt2 r;
  r.x = fp2_sub(fp2_sub(fp2_sqr(Rr2), J), fp2_dbl(V));
  const Fp2 S1J = fp2_mul(S1, J);
  r.y = fp2_sub(fp2_mul(Rr2, fp2_sub(V, r.x)), fp2_dbl(S1J));
  r.z = fp2_dbl(fp2_mul(fp2_mul(p.z, q.z), H));
  return r;
}

__device__ __forceinline__ Pt2 load_pt2(const uint32_t* __restrict__ a,
                                        int n, int lane) {
  Pt2 r;
  r.x.c0 = load_fp(a, 0 * NL, n, lane);
  r.x.c1 = load_fp(a, 1 * NL, n, lane);
  r.y.c0 = load_fp(a, 2 * NL, n, lane);
  r.y.c1 = load_fp(a, 3 * NL, n, lane);
  r.z.c0 = load_fp(a, 4 * NL, n, lane);
  r.z.c1 = load_fp(a, 5 * NL, n, lane);
  return r;
}

__device__ __forceinline__ void store_pt2(uint32_t* __restrict__ a, int n,
                                          int lane, const Pt2& p) {
  store_fp(a, 0 * NL, n, lane, p.x.c0);
  store_fp(a, 1 * NL, n, lane, p.x.c1);
  store_fp(a, 2 * NL, n, lane, p.y.c0);
  store_fp(a, 3 * NL, n, lane, p.y.c1);
  store_fp(a, 4 * NL, n, lane, p.z.c0);
  store_fp(a, 5 * NL, n, lane, p.z.c1);
}

// table (16, 72, n): entry d of lane `lane`; digit 0 selects the zero point
// (pg1._select_entry, which pg2 reuses: entry 0 never contributes).
__device__ __forceinline__ Pt2 select_entry2(
    const uint32_t* __restrict__ table, int d, int n, int lane) {
  if (d == 0) {
    Pt2 z;
    z.x.c0 = z.x.c1 = z.y.c0 = z.y.c1 = z.z.c0 = z.z.c1 = fp_zero();
    return z;
  }
  return load_pt2(table + (size_t)d * ROWS2 * n, n, lane);
}

__global__ void __launch_bounds__(THREADS)
    g2_dbl_kernel(const uint32_t* __restrict__ p, uint32_t* __restrict__ out,
                  int n) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  store_pt2(out, n, lane, g2_dbl(load_pt2(p, n, lane)));
}

__global__ void __launch_bounds__(THREADS)
    g2_add_kernel(const uint32_t* __restrict__ p,
                  const uint32_t* __restrict__ q, uint32_t* __restrict__ out,
                  int n) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  store_pt2(out, n, lane,
            g2_add(load_pt2(p, n, lane), load_pt2(q, n, lane)));
}

// pg2._msm2_kernel semantics, all W windows in one launch: window 0 selects
// table[d]; each later window doubles 4 times, then a digit 0 keeps the
// accumulator (and keeps the flag set), a flagged accumulator takes the
// entry, and otherwise the entry is added. Digits must lie in [0, 16).
__global__ void __launch_bounds__(THREADS)
    g2_msm_scan_kernel(const uint32_t* __restrict__ table,
                       const int32_t* __restrict__ digits,
                       uint32_t* __restrict__ acc_out,
                       uint8_t* __restrict__ flag_out, int n, int nwin) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  int d = digits[lane];
  Pt2 acc = select_entry2(table, d, n, lane);
  bool flag = d == 0;
#pragma unroll 1
  for (int w = 1; w < nwin; ++w) {
    d = digits[(size_t)w * n + lane];
    if (!flag) {  // a flagged accumulator is the zero point: dbl keeps it
#pragma unroll 1
      for (int k = 0; k < WINDOW; ++k) acc = g2_dbl(acc);
    }
    if (d != 0) {
      const Pt2 entry = select_entry2(table, d, n, lane);
      acc = flag ? entry : g2_add(acc, entry);
      flag = false;
    }
  }
  store_pt2(acc_out, n, lane, acc);
  flag_out[lane] = flag ? 1 : 0;
}

inline int blocks_for(int n) { return (n + THREADS - 1) / THREADS; }

}  // namespace

extern "C" {

int lt_g2_dbl(const void* p, void* out, int n, void* stream) {
  if (n > 0) {
    g2_dbl_kernel<<<blocks_for(n), THREADS, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)p, (uint32_t*)out, n);
  }
  return (int)cudaGetLastError();
}

int lt_g2_add(const void* p, const void* q, void* out, int n, void* stream) {
  if (n > 0) {
    g2_add_kernel<<<blocks_for(n), THREADS, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)p, (const uint32_t*)q, (uint32_t*)out, n);
  }
  return (int)cudaGetLastError();
}

int lt_g2_msm_scan(const void* table, const void* digits, void* acc,
                   void* flags, int n, int nwin, void* stream) {
  if (n > 0 && nwin > 0) {
    g2_msm_scan_kernel<<<blocks_for(n), THREADS, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)table, (const int32_t*)digits, (uint32_t*)acc,
        (uint8_t*)flags, n, nwin);
  }
  return (int)cudaGetLastError();
}

// Registers per thread and local (spill) bytes of kernel `which`
// (0 dbl, 1 add, 2 msm_scan), for the chip report.
int lt_g2_kernel_attrs(int which, int* regs, int* local_bytes) {
  const void* fns[3] = {(const void*)g2_dbl_kernel,
                        (const void*)g2_add_kernel,
                        (const void*)g2_msm_scan_kernel};
  if (which < 0 || which > 2) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, fns[which]);
  if (err != cudaSuccess) return (int)err;
  *regs = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  return 0;
}

}  // extern "C"

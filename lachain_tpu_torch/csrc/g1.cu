// BLS12-381 G1 kernels for Hopper (sm_90a): the four Pallas kernels of
// lachain_tpu/ops/pg1.py, thought through again for the card.
//
//   lt_g1_fp_mul    <- pg1._mul_kernel   (pl_fp_mul, pg1.py:262/:323)
//   lt_g1_dbl       <- pg1._dbl_kernel   (pl_dbl,    pg1.py:253/:279)
//   lt_g1_add       <- pg1._add_kernel   (pl_add,    pg1.py:257/:301)
//   lt_g1_msm_scan  <- pg1._msm_kernel   (_msm_scan, pg1.py:355/:412)
//
// Representation. pg1's 44 x 10-bit signed limbs, its f32 MXU residue fold
// and its 256-lane VMEM tiles are TPU artifacts. Here a field element is 12
// x 32-bit limbs in Montgomery form (R = 2^384), always canonical in [0, p)
// (fp.cuh, shared with g2.cu); a point is 36 rows X | Y | Z, lane-minor.
// The host converts into and out of Montgomery form with lt_g1_fp_mul by
// R^2 mod p and by 1 (lachain_tpu_torch/ops/g1.py).
//
// Multiply: CIOS Montgomery on uint64 accumulators, 2*12*12 + 12 word
// products. The group law uses pg1's formulas (pg1._g1_dbl_val,
// pg1._g1_add_val, pg1.py:181-220) operation for operation, so a collision
// p = +-q in an incomplete add gives Z = 0 exactly where the TPU kernel
// does, and the era pipeline's Z==0 escape fires on the same slots.
//
// Bound: integer multiply-adds (about 44 field products per lane per MSM
// window, ~600 IMADs each). Bytes are small beside them: the MSM reads its
// 16-entry table (2304 B/lane) once per lane per window at most. Design: one
// thread per lane; the MSM keeps its accumulator and flag in registers across
// all windows in a single launch and reads table[d] from device memory (L2
// holds the whole 18.9 MB table at n = 8192). Tensor-core and shared-memory
// designs are later work.
//
// Each extern "C" entry launches on the caller's stream and returns
// cudaGetLastError(); the Python wrapper raises when it is non-zero.

#include "fp.cuh"

namespace {

constexpr int PR = 3 * NL;   // rows per point: X | Y | Z
constexpr int WINDOW = 4;
constexpr int THREADS = 64;  // n = 8192 lanes -> 128 blocks over 132 SMs

struct Pt {
  Fp x, y, z;
};

// The two group-law functions stay out of line: with every product inlined
// into every kernel, nvcc 12.9's device front end (cicc) crashes with a
// segmentation fault on this file.

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

// pg1._g1_add_val: incomplete Jacobian add, p != +-q, both finite
// (16 products).
__device__ __noinline__ Pt g1_add(const Pt& p, const Pt& q) {
  const Fp Z1Z1 = fp_sqr(p.z);
  const Fp Z2Z2 = fp_sqr(q.z);
  const Fp U1 = mont_mul(p.x, Z2Z2);
  const Fp U2 = mont_mul(q.x, Z1Z1);
  const Fp S1 = mont_mul(mont_mul(p.y, q.z), Z2Z2);
  const Fp S2 = mont_mul(mont_mul(q.y, p.z), Z1Z1);
  const Fp H = fp_sub(U2, U1);
  const Fp Rr = fp_sub(S2, S1);
  const Fp I = fp_sqr(fp_add(H, H));
  const Fp J = mont_mul(H, I);
  const Fp Rr2 = fp_add(Rr, Rr);
  const Fp V = mont_mul(U1, I);
  Pt r;
  r.x = fp_sub(fp_sub(fp_sqr(Rr2), J), fp_add(V, V));
  const Fp S1J = mont_mul(S1, J);
  r.y = fp_sub(mont_mul(Rr2, fp_sub(V, r.x)), fp_add(S1J, S1J));
  const Fp Z3 = mont_mul(mont_mul(p.z, q.z), H);
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

// table (16, 36, n): entry d of lane `lane`; digit 0 selects the zero point,
// as pg1._select_entry does (entry 0 never contributes).
__device__ __forceinline__ Pt select_entry(const uint32_t* __restrict__ table,
                                           int d, int n, int lane) {
  if (d == 0) {
    Pt z;
    z.x = fp_zero();
    z.y = fp_zero();
    z.z = fp_zero();
    return z;
  }
  return load_pt(table + (size_t)d * PR * n, n, lane);
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

__global__ void __launch_bounds__(THREADS)
    add_kernel(const uint32_t* __restrict__ p, const uint32_t* __restrict__ q,
               uint32_t* __restrict__ out, int n) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  store_pt(out, n, lane, g1_add(load_pt(p, n, lane), load_pt(q, n, lane)));
}

// pg1._msm_kernel semantics, all W windows in one launch: window 0 selects
// table[d]; each later window doubles 4 times, then a digit 0 keeps the
// accumulator (and keeps the flag set), a flagged accumulator takes the
// entry, and otherwise the entry is added. Digits must lie in [0, 16).
__global__ void __launch_bounds__(THREADS)
    msm_scan_kernel(const uint32_t* __restrict__ table,
                    const int32_t* __restrict__ digits,
                    uint32_t* __restrict__ acc_out,
                    uint8_t* __restrict__ flag_out, int n, int nwin) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  int d = digits[lane];
  Pt acc = select_entry(table, d, n, lane);
  bool flag = d == 0;
#pragma unroll 1
  for (int w = 1; w < nwin; ++w) {
    d = digits[(size_t)w * n + lane];
#pragma unroll 1
    for (int k = 0; k < WINDOW; ++k) acc = g1_dbl(acc);
    if (d != 0) {
      const Pt entry = select_entry(table, d, n, lane);
      acc = flag ? entry : g1_add(acc, entry);
      flag = false;
    }
  }
  store_pt(acc_out, n, lane, acc);
  flag_out[lane] = flag ? 1 : 0;
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
    add_kernel<<<blocks_for(n), THREADS, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)p, (const uint32_t*)q, (uint32_t*)out, n);
  }
  return (int)cudaGetLastError();
}

int lt_g1_msm_scan(const void* table, const void* digits, void* acc,
                   void* flags, int n, int nwin, void* stream) {
  if (n > 0 && nwin > 0) {
    msm_scan_kernel<<<blocks_for(n), THREADS, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)table, (const int32_t*)digits, (uint32_t*)acc,
        (uint8_t*)flags, n, nwin);
  }
  return (int)cudaGetLastError();
}

// Registers per thread and local (spill) bytes of kernel `which`
// (0 fp_mul, 1 dbl, 2 add, 3 msm_scan), for the chip report.
int lt_g1_kernel_attrs(int which, int* regs, int* local_bytes) {
  const void* fns[4] = {(const void*)fp_mul_kernel, (const void*)dbl_kernel,
                        (const void*)add_kernel,
                        (const void*)msm_scan_kernel};
  if (which < 0 || which > 3) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, fns[which]);
  if (err != cudaSuccess) return (int)err;
  *regs = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  return 0;
}

}  // extern "C"

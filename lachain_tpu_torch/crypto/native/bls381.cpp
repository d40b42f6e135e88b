// libbls381 — native BLS12-381 backend, the port's copy.
//
// A copy of lachain_tpu/crypto/native/bls381.cpp (the JAX package's host
// library, in the role of the upstream Lachain's MCL.BLS12_381.Native
// binding, src/Lachain.Crypto/MclBls12381.cs): pairings, G1/G2
// arithmetic, hash-to-curve, plus batch-first MSM entry points. Only this
// header differs from the JAX package's file; the arithmetic is the same.
//
// Conformance: lachain_tpu_torch/crypto/native_backend.py binds the subset
// the port uses, and tests/test_torch_native_host.py holds it against the
// port's pure-Python oracle (crypto/bls12381.py, crypto/host.py) and the
// JAX package's backends. The algorithms intentionally mirror the oracle's
// structure (affine Miller loop on the untwisted curve, base-p final-exp
// decomposition) so the two implementations stay auditable against each
// other.
//
// Build: lachain_tpu_torch/ops/_build.py host_library() (g++ -O3
// -march=native -shared -fPIC, with secp256k1.cpp in one shared object).

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

typedef uint64_t u64;
typedef unsigned __int128 u128;

// ===========================================================================
// Fp — 6x64 Montgomery arithmetic
// ===========================================================================

static const u64 P_LIMBS[6] = {
    0xb9feffffffffaaabull, 0x1eabfffeb153ffffull, 0x6730d2a0f6b0f624ull,
    0x64774b84f38512bfull, 0x4b1ba7b6434bacd7ull, 0x1a0111ea397fe69aull};

// Scalar field order r (for subgroup checks), big-endian bytes on the wire.
static const u64 R_LIMBS[4] = {
    0xffffffff00000001ull, 0x53bda402fffe5bfeull, 0x3339d80809a1d805ull,
    0x73eda753299d7d48ull};

struct Fp {
  u64 v[6];
};

static u64 PINV;     // -p^{-1} mod 2^64
static Fp MONT_ONE;  // R mod p
static Fp MONT_R2;   // R^2 mod p
static Fp MONT_R3;   // R^3 mod p
static Fp FP_ZERO;

static inline bool fp_is_zero(const Fp &a) {
  u64 acc = 0;
  for (int i = 0; i < 6; i++) acc |= a.v[i];
  return acc == 0;
}

static inline bool fp_eq(const Fp &a, const Fp &b) {
  u64 acc = 0;
  for (int i = 0; i < 6; i++) acc |= a.v[i] ^ b.v[i];
  return acc == 0;
}

static inline int cmp_limbs(const u64 *a, const u64 *b, int n) {
  for (int i = n - 1; i >= 0; i--) {
    if (a[i] < b[i]) return -1;
    if (a[i] > b[i]) return 1;
  }
  return 0;
}

static inline void sub_p_if_ge(u64 *t) {  // t has 6 limbs, t < 2p
  // BRANCHLESS: the compare-then-subtract was a data-dependent branch on
  // the hottest helper in the library (~50% mispredict on random values);
  // compute t - p unconditionally and mask-select on the borrow.
  u64 s[6];
  u128 borrow = 0;
  for (int i = 0; i < 6; i++) {
    u128 cur = (u128)t[i] - P_LIMBS[i] - (u64)borrow;
    s[i] = (u64)cur;
    borrow = (cur >> 64) ? 1 : 0;
  }
  u64 keep = (u64)0 - (u64)borrow;  // all-ones if t < p (keep t)
  for (int i = 0; i < 6; i++) t[i] = (t[i] & keep) | (s[i] & ~keep);
}

static inline void fp_add(Fp &z, const Fp &a, const Fp &b) {
  u128 carry = 0;
  u64 t[6];
  for (int i = 0; i < 6; i++) {
    u128 cur = (u128)a.v[i] + b.v[i] + (u64)carry;
    t[i] = (u64)cur;
    carry = cur >> 64;
  }
  // a+b < 2p fits in 384 bits (p has 381 bits) — no 7th limb needed.
  sub_p_if_ge(t);
  memcpy(z.v, t, sizeof(t));
}

static inline void fp_sub(Fp &z, const Fp &a, const Fp &b) {
  u128 borrow = 0;
  u64 t[6];
  for (int i = 0; i < 6; i++) {
    u128 cur = (u128)a.v[i] - b.v[i] - (u64)borrow;
    t[i] = (u64)cur;
    borrow = (cur >> 64) ? 1 : 0;
  }
  // branchless: add p back masked by the borrow (data-dependent branch
  // mispredicts ~50% on random inputs)
  u64 mask = (u64)0 - (u64)borrow;
  u128 carry = 0;
  for (int i = 0; i < 6; i++) {
    u128 cur = (u128)t[i] + (P_LIMBS[i] & mask) + (u64)carry;
    t[i] = (u64)cur;
    carry = cur >> 64;
  }
  memcpy(z.v, t, sizeof(t));
}

static inline void fp_neg(Fp &z, const Fp &a) {
  if (fp_is_zero(a)) {
    z = a;
    return;
  }
  u128 borrow = 0;
  for (int i = 0; i < 6; i++) {
    u128 cur = (u128)P_LIMBS[i] - a.v[i] - (u64)borrow;
    z.v[i] = (u64)cur;
    borrow = (cur >> 64) ? 1 : 0;
  }
}

// ---------------------------------------------------------------------------
// ADX/BMI2 Montgomery multiplication (the MCL/blst-class hot path).
//
// Interleaved operand-scanning CIOS with DUAL carry chains: mulx keeps CF/OF
// untouched, so the lo-limb additions ride the OF chain (adox) while the
// hi-limb additions ride the CF chain (adcx) — the two chains retire in
// parallel and the round is mulx-throughput-bound (~12 mulx/round, 6 rounds).
// Register scheme: the 7-limb accumulator lives in r8..r14 and ROTATES one
// position per round (phase B's shift-by-one-limb is free renaming; the
// freshly-zeroed low limb becomes the next round's top limb).
//
// Guarded by a start-up differential self-check against the portable CIOS
// below (fp_mul_c); any mismatch keeps the portable path (HAVE_ADX=false).
#if defined(__x86_64__) && defined(__ADX__) && defined(__BMI2__)
#define LT_HAVE_ADX_BUILD 1

// round phase A: t(T0..T5) += a_i * b;  7th limb into T6 (must enter 0)
#define LT_MUL_ROUND_A(i, T0, T1, T2, T3, T4, T5, T6)                       \
  "movq " #i "*8(%rsi), %rdx\n\t"                                           \
  "xorl %eax, %eax\n\t" /* clear CF+OF */                                   \
  "mulxq 0(%rcx), %rax, %rbp\n\t"                                           \
  "adoxq %rax, " T0 "\n\t"                                                  \
  "mulxq 8(%rcx), %rax, %r15\n\t"                                           \
  "adcxq %rbp, " T1 "\n\t"                                                  \
  "adoxq %rax, " T1 "\n\t"                                                  \
  "mulxq 16(%rcx), %rax, %rbp\n\t"                                          \
  "adcxq %r15, " T2 "\n\t"                                                  \
  "adoxq %rax, " T2 "\n\t"                                                  \
  "mulxq 24(%rcx), %rax, %r15\n\t"                                          \
  "adcxq %rbp, " T3 "\n\t"                                                  \
  "adoxq %rax, " T3 "\n\t"                                                  \
  "mulxq 32(%rcx), %rax, %rbp\n\t"                                          \
  "adcxq %r15, " T4 "\n\t"                                                  \
  "adoxq %rax, " T4 "\n\t"                                                  \
  "mulxq 40(%rcx), %rax, %r15\n\t"                                          \
  "adcxq %rbp, " T5 "\n\t"                                                  \
  "adoxq %rax, " T5 "\n\t"                                                  \
  "movl $0, %eax\n\t"                                                       \
  "adcxq %r15, " T6 "\n\t"                                                  \
  "adoxq %rax, " T6 "\n\t"

// round phase B: m = T0*PINV; t += m*p; logical >>64 (T0 becomes 0 and is
// the caller's next-round T6)
#define LT_MUL_ROUND_B(T0, T1, T2, T3, T4, T5, T6)                          \
  "movq " T0 ", %rdx\n\t"                                                   \
  "imulq lt_adx_pinv(%rip), %rdx\n\t"                                       \
  "xorl %eax, %eax\n\t"                                                     \
  "mulxq lt_adx_p(%rip), %rax, %rbp\n\t"                                    \
  "adcxq %rax, " T0 "\n\t" /* T0 -> 0 */                                    \
  "mulxq lt_adx_p+8(%rip), %rax, %r15\n\t"                                  \
  "adcxq %rbp, " T1 "\n\t"                                                  \
  "adoxq %rax, " T1 "\n\t"                                                  \
  "mulxq lt_adx_p+16(%rip), %rax, %rbp\n\t"                                 \
  "adcxq %r15, " T2 "\n\t"                                                  \
  "adoxq %rax, " T2 "\n\t"                                                  \
  "mulxq lt_adx_p+24(%rip), %rax, %r15\n\t"                                 \
  "adcxq %rbp, " T3 "\n\t"                                                  \
  "adoxq %rax, " T3 "\n\t"                                                  \
  "mulxq lt_adx_p+32(%rip), %rax, %rbp\n\t"                                 \
  "adcxq %r15, " T4 "\n\t"                                                  \
  "adoxq %rax, " T4 "\n\t"                                                  \
  "mulxq lt_adx_p+40(%rip), %rax, %r15\n\t"                                 \
  "adcxq %rbp, " T5 "\n\t"                                                  \
  "adoxq %rax, " T5 "\n\t"                                                  \
  "movl $0, %eax\n\t"                                                       \
  "adcxq %r15, " T6 "\n\t"                                                  \
  "adoxq %rax, " T6 "\n\t"

#define LT_MUL_ROUND(i, T0, T1, T2, T3, T4, T5, T6)                         \
  LT_MUL_ROUND_A(i, T0, T1, T2, T3, T4, T5, T6)                             \
  LT_MUL_ROUND_B(T0, T1, T2, T3, T4, T5, T6)

__asm__(
    ".section .rodata\n\t"
    ".balign 64\n"
    "lt_adx_p:\n\t"
    ".quad 0xb9feffffffffaaab, 0x1eabfffeb153ffff, 0x6730d2a0f6b0f624\n\t"
    ".quad 0x64774b84f38512bf, 0x4b1ba7b6434bacd7, 0x1a0111ea397fe69a\n"
    "lt_adx_pinv:\n\t"
    ".quad 0x89f3fffcfffcfffd\n\t"
    ".text\n\t"
    ".globl lt_fp_mul_adx\n\t"
    ".hidden lt_fp_mul_adx\n\t"
    ".type lt_fp_mul_adx,@function\n\t"
    ".balign 32\n"
    "lt_fp_mul_adx:\n\t"
    // rdi = z, rsi = a, rdx = b
    "pushq %rbp\n\t"
    "pushq %r12\n\t"
    "pushq %r13\n\t"
    "pushq %r14\n\t"
    "pushq %r15\n\t"
    "movq %rdx, %rcx\n\t"
    "xorl %r8d, %r8d\n\t"
    "xorl %r9d, %r9d\n\t"
    "xorl %r10d, %r10d\n\t"
    "xorl %r11d, %r11d\n\t"
    "xorl %r12d, %r12d\n\t"
    "xorl %r13d, %r13d\n\t"
    "xorl %r14d, %r14d\n\t"
    // clang-format off
    LT_MUL_ROUND(0, "%r8",  "%r9",  "%r10", "%r11", "%r12", "%r13", "%r14")
    LT_MUL_ROUND(1, "%r9",  "%r10", "%r11", "%r12", "%r13", "%r14", "%r8")
    LT_MUL_ROUND(2, "%r10", "%r11", "%r12", "%r13", "%r14", "%r8",  "%r9")
    LT_MUL_ROUND(3, "%r11", "%r12", "%r13", "%r14", "%r8",  "%r9",  "%r10")
    LT_MUL_ROUND(4, "%r12", "%r13", "%r14", "%r8",  "%r9",  "%r10", "%r11")
    LT_MUL_ROUND(5, "%r13", "%r14", "%r8",  "%r9",  "%r10", "%r11", "%r12")
    // clang-format on
    // result t0..t5 = r14, r8, r9, r10, r11, r12 (< 2p); subtract p if >= p
    "movq %r14, %rax\n\t"
    "movq %r8,  %rcx\n\t"
    "movq %r9,  %rdx\n\t"
    "movq %r10, %rsi\n\t"
    "movq %r11, %r15\n\t"
    "movq %r12, %r13\n\t"
    "subq lt_adx_p+0(%rip),  %rax\n\t"
    "sbbq lt_adx_p+8(%rip),  %rcx\n\t"
    "sbbq lt_adx_p+16(%rip), %rdx\n\t"
    "sbbq lt_adx_p+24(%rip), %rsi\n\t"
    "sbbq lt_adx_p+32(%rip), %r15\n\t"
    "sbbq lt_adx_p+40(%rip), %r13\n\t"
    "cmovcq %r14, %rax\n\t"
    "cmovcq %r8,  %rcx\n\t"
    "cmovcq %r9,  %rdx\n\t"
    "cmovcq %r10, %rsi\n\t"
    "cmovcq %r11, %r15\n\t"
    "cmovcq %r12, %r13\n\t"
    "movq %rax, 0(%rdi)\n\t"
    "movq %rcx, 8(%rdi)\n\t"
    "movq %rdx, 16(%rdi)\n\t"
    "movq %rsi, 24(%rdi)\n\t"
    "movq %r15, 32(%rdi)\n\t"
    "movq %r13, 40(%rdi)\n\t"
    "popq %r15\n\t"
    "popq %r14\n\t"
    "popq %r13\n\t"
    "popq %r12\n\t"
    "popq %rbp\n\t"
    "ret\n\t"
    ".size lt_fp_mul_adx, .-lt_fp_mul_adx\n\t");

extern "C" void lt_fp_mul_adx(u64 *z, const u64 *a, const u64 *b);
#endif  // __x86_64__ && __ADX__ && __BMI2__

static bool HAVE_ADX = false;  // set by the init self-check

// Portable CIOS Montgomery multiplication (also the self-check oracle).
static void fp_mul_c(Fp &z, const Fp &a, const Fp &b) {
  u64 t[8];
  memset(t, 0, sizeof(t));
  for (int i = 0; i < 6; i++) {
    u64 carry = 0;
    u64 ai = a.v[i];
    for (int j = 0; j < 6; j++) {
      u128 cur = (u128)ai * b.v[j] + t[j] + carry;
      t[j] = (u64)cur;
      carry = (u64)(cur >> 64);
    }
    u128 cur = (u128)t[6] + carry;
    t[6] = (u64)cur;
    t[7] = (u64)(cur >> 64);

    u64 m = t[0] * PINV;
    u128 cur2 = (u128)m * P_LIMBS[0] + t[0];
    carry = (u64)(cur2 >> 64);
    for (int j = 1; j < 6; j++) {
      u128 c3 = (u128)m * P_LIMBS[j] + t[j] + carry;
      t[j - 1] = (u64)c3;
      carry = (u64)(c3 >> 64);
    }
    u128 c4 = (u128)t[6] + carry;
    t[5] = (u64)c4;
    t[6] = t[7] + (u64)(c4 >> 64);
    t[7] = 0;
  }
  // t[0..5] < 2p (t[6] == 0 for BLS12-381's 381-bit p).
  sub_p_if_ge(t);
  memcpy(z.v, t, 48);
}

static inline void fp_mul(Fp &z, const Fp &a, const Fp &b) {
#ifdef LT_HAVE_ADX_BUILD
  if (HAVE_ADX) {
    lt_fp_mul_adx(z.v, a.v, b.v);
    return;
  }
#endif
  fp_mul_c(z, a, b);
}

static inline void fp_sqr(Fp &z, const Fp &a) { fp_mul(z, a, a); }

static inline void fp_dbl(Fp &z, const Fp &a) { fp_add(z, a, a); }

// Binary extended GCD inversion on the plain (non-Montgomery) value.
static void limbs_rshift1(u64 *a, int n) {
  for (int i = 0; i < n - 1; i++) a[i] = (a[i] >> 1) | (a[i + 1] << 63);
  a[n - 1] >>= 1;
}

static void limbs_add(u64 *a, const u64 *b, int n) {
  u128 carry = 0;
  for (int i = 0; i < n; i++) {
    u128 cur = (u128)a[i] + b[i] + (u64)carry;
    a[i] = (u64)cur;
    carry = cur >> 64;
  }
}

static bool limbs_sub(u64 *a, const u64 *b, int n) {  // a -= b, ret borrow
  u128 borrow = 0;
  for (int i = 0; i < n; i++) {
    u128 cur = (u128)a[i] - b[i] - (u64)borrow;
    a[i] = (u64)cur;
    borrow = (cur >> 64) ? 1 : 0;
  }
  return borrow != 0;
}

static bool limbs_is_zero(const u64 *a, int n) {
  u64 acc = 0;
  for (int i = 0; i < n; i++) acc |= a[i];
  return acc == 0;
}

// a^{-1} mod p for plain a (not Montgomery); result plain.
static void fp_inv_plain(u64 *out, const u64 *a_in) {
  u64 u[6], v[6], b[6], c[6];
  memcpy(u, a_in, 48);
  memcpy(v, P_LIMBS, 48);
  memset(b, 0, 48);
  b[0] = 1;
  memset(c, 0, 48);
  while (!limbs_is_zero(u, 6) && !limbs_is_zero(v, 6)) {
    while (!(u[0] & 1)) {
      limbs_rshift1(u, 6);
      if (b[0] & 1) limbs_add(b, P_LIMBS, 6);
      limbs_rshift1(b, 6);
    }
    while (!(v[0] & 1)) {
      limbs_rshift1(v, 6);
      if (c[0] & 1) limbs_add(c, P_LIMBS, 6);
      limbs_rshift1(c, 6);
    }
    if (cmp_limbs(u, v, 6) >= 0) {
      limbs_sub(u, v, 6);
      if (limbs_sub(b, c, 6)) limbs_add(b, P_LIMBS, 6);
    } else {
      limbs_sub(v, u, 6);
      if (limbs_sub(c, b, 6)) limbs_add(c, P_LIMBS, 6);
    }
  }
  if (limbs_is_zero(u, 6))
    memcpy(out, c, 48);
  else
    memcpy(out, b, 48);
}

// Montgomery-form inversion: inv(aR) = a^{-1} R.
static void fp_inv(Fp &z, const Fp &a) {
  Fp plain_inv;
  // a.v is aR (plain number). egcd gives (aR)^{-1} = a^{-1} R^{-1}.
  fp_inv_plain(plain_inv.v, a.v);
  fp_mul(z, plain_inv, MONT_R3);  // * R^3 * R^{-1} => a^{-1} R
}

static void fp_from_bytes_be(Fp &z, const uint8_t *in) {  // 48 bytes
  Fp plain;
  for (int i = 0; i < 6; i++) {
    u64 limb = 0;
    for (int j = 0; j < 8; j++) limb = (limb << 8) | in[(5 - i) * 8 + j];
    plain.v[i] = limb;
  }
  fp_mul(z, plain, MONT_R2);  // to Montgomery
}

static void fp_to_bytes_be(uint8_t *out, const Fp &a) {
  Fp one;
  memset(one.v, 0, 48);
  one.v[0] = 1;
  Fp plain;
  fp_mul(plain, a, one);  // from Montgomery
  for (int i = 0; i < 6; i++) {
    u64 limb = plain.v[5 - i];
    for (int j = 0; j < 8; j++) out[i * 8 + j] = (uint8_t)(limb >> (56 - 8 * j));
  }
}

static void fp_set_u64(Fp &z, u64 x) {
  Fp plain;
  memset(plain.v, 0, 48);
  plain.v[0] = x;
  fp_mul(z, plain, MONT_R2);
}

// z = a^e where e is nbits-wide big-endian limb array (plain integer exponent)
static void fp_pow_limbs(Fp &z, const Fp &a, const u64 *e, int nlimbs) {
  Fp result = MONT_ONE, base = a;
  int top = nlimbs * 64 - 1;
  while (top >= 0 && !((e[top / 64] >> (top % 64)) & 1)) top--;
  for (int i = 0; i <= top; i++) {
    if ((e[i / 64] >> (i % 64)) & 1) fp_mul(result, result, base);
    fp_sqr(base, base);
  }
  z = result;
}

// sqrt via a^((p+1)/4); returns false if not a QR.
static u64 P_PLUS1_DIV4[6];

static bool fp_sqrt(Fp &z, const Fp &a) {
  Fp s;
  fp_pow_limbs(s, a, P_PLUS1_DIV4, 6);
  Fp chk;
  fp_sqr(chk, s);
  if (!fp_eq(chk, a)) return false;
  z = s;
  return true;
}

// ===========================================================================
// Fp2 = Fp[u]/(u^2+1)
// ===========================================================================

struct Fp2 {
  Fp c0, c1;
};

static Fp2 FP2_ZERO_, FP2_ONE_;

static inline void fp2_add(Fp2 &z, const Fp2 &a, const Fp2 &b) {
  fp_add(z.c0, a.c0, b.c0);
  fp_add(z.c1, a.c1, b.c1);
}
static inline void fp2_sub(Fp2 &z, const Fp2 &a, const Fp2 &b) {
  fp_sub(z.c0, a.c0, b.c0);
  fp_sub(z.c1, a.c1, b.c1);
}
static inline void fp2_neg(Fp2 &z, const Fp2 &a) {
  fp_neg(z.c0, a.c0);
  fp_neg(z.c1, a.c1);
}
static inline void fp2_conj(Fp2 &z, const Fp2 &a) {
  z.c0 = a.c0;
  fp_neg(z.c1, a.c1);
}
static void fp2_mul(Fp2 &z, const Fp2 &a, const Fp2 &b) {
  Fp t0, t1, t2, t3, s0, s1;
  fp_mul(t0, a.c0, b.c0);
  fp_mul(t1, a.c1, b.c1);
  fp_add(t2, a.c0, a.c1);
  fp_add(t3, b.c0, b.c1);
  fp_mul(t2, t2, t3);
  fp_sub(s0, t0, t1);
  fp_sub(t2, t2, t0);
  fp_sub(s1, t2, t1);
  z.c0 = s0;
  z.c1 = s1;
}
static void fp2_sqr(Fp2 &z, const Fp2 &a) {
  Fp t0, t1, s0, s1;
  fp_add(t0, a.c0, a.c1);
  fp_sub(t1, a.c0, a.c1);
  fp_mul(s0, t0, t1);
  fp_mul(t0, a.c0, a.c1);
  fp_add(s1, t0, t0);
  z.c0 = s0;
  z.c1 = s1;
}
static void fp2_muls(Fp2 &z, const Fp2 &a, u64 s) {
  Fp fs;
  fp_set_u64(fs, s);
  fp_mul(z.c0, a.c0, fs);
  fp_mul(z.c1, a.c1, fs);
}
static void fp2_inv(Fp2 &z, const Fp2 &a) {
  Fp n, t, i;
  fp_sqr(n, a.c0);
  fp_sqr(t, a.c1);
  fp_add(n, n, t);
  fp_inv(i, n);
  fp_mul(z.c0, a.c0, i);
  Fp negc1;
  fp_neg(negc1, a.c1);
  fp_mul(z.c1, negc1, i);
}
static inline bool fp2_is_zero(const Fp2 &a) {
  return fp_is_zero(a.c0) && fp_is_zero(a.c1);
}
static inline bool fp2_eq(const Fp2 &a, const Fp2 &b) {
  return fp_eq(a.c0, b.c0) && fp_eq(a.c1, b.c1);
}
// multiply by xi = 1 + u
static inline void fp2_mul_xi(Fp2 &z, const Fp2 &a) {
  Fp t0, t1;
  fp_sub(t0, a.c0, a.c1);
  fp_add(t1, a.c0, a.c1);
  z.c0 = t0;
  z.c1 = t1;
}

static void fp2_pow_limbs(Fp2 &z, const Fp2 &a, const u64 *e, int nlimbs) {
  Fp2 result = FP2_ONE_, base = a;
  int top = nlimbs * 64 - 1;
  while (top >= 0 && !((e[top / 64] >> (top % 64)) & 1)) top--;
  for (int i = 0; i <= top; i++) {
    if ((e[i / 64] >> (i % 64)) & 1) fp2_mul(result, result, base);
    fp2_sqr(base, base);
  }
  z = result;
}

// Mirrors the oracle's fp2_sqrt (norm trick) — root choice must match Python.
static bool fp2_sqrt(Fp2 &z, const Fp2 &a) {
  if (fp_is_zero(a.c1)) {
    Fp s;
    if (fp_sqrt(s, a.c0)) {
      z.c0 = s;
      z.c1 = FP_ZERO;
      return true;
    }
    Fp na;
    fp_neg(na, a.c0);
    if (fp_sqrt(s, na)) {
      z.c0 = FP_ZERO;
      z.c1 = s;
      return true;
    }
    return false;
  }
  Fp n, t, s;
  fp_sqr(n, a.c0);
  fp_sqr(t, a.c1);
  fp_add(n, n, t);
  if (!fp_sqrt(s, n)) return false;
  Fp inv2, two;
  fp_set_u64(two, 2);
  fp_inv(inv2, two);
  Fp lam;
  fp_add(t, a.c0, s);
  fp_mul(t, t, inv2);
  if (!fp_sqrt(lam, t)) {
    fp_sub(t, a.c0, s);
    fp_mul(t, t, inv2);
    if (!fp_sqrt(lam, t)) return false;
  }
  Fp two_lam, inv_2lam;
  fp_add(two_lam, lam, lam);
  fp_inv(inv_2lam, two_lam);
  z.c0 = lam;
  fp_mul(z.c1, a.c1, inv_2lam);
  Fp2 chk;
  fp2_sqr(chk, z);
  return fp2_eq(chk, a);
}

// ===========================================================================
// Fp6 = Fp2[v]/(v^3 - xi), Fp12 = Fp6[w]/(w^2 - v)
// ===========================================================================

struct Fp6 {
  Fp2 c0, c1, c2;
};
struct Fp12 {
  Fp6 c0, c1;
};

static Fp6 FP6_ZERO_, FP6_ONE_;
static Fp12 FP12_ONE_, FP12_ZERO_;

static inline void fp6_add(Fp6 &z, const Fp6 &a, const Fp6 &b) {
  fp2_add(z.c0, a.c0, b.c0);
  fp2_add(z.c1, a.c1, b.c1);
  fp2_add(z.c2, a.c2, b.c2);
}
static inline void fp6_sub(Fp6 &z, const Fp6 &a, const Fp6 &b) {
  fp2_sub(z.c0, a.c0, b.c0);
  fp2_sub(z.c1, a.c1, b.c1);
  fp2_sub(z.c2, a.c2, b.c2);
}
static inline void fp6_neg(Fp6 &z, const Fp6 &a) {
  fp2_neg(z.c0, a.c0);
  fp2_neg(z.c1, a.c1);
  fp2_neg(z.c2, a.c2);
}
static void fp6_mul(Fp6 &z, const Fp6 &a, const Fp6 &b) {
  Fp2 t00, t11, t22, x, y, c0, c1, c2;
  fp2_mul(t00, a.c0, b.c0);
  fp2_mul(t11, a.c1, b.c1);
  fp2_mul(t22, a.c2, b.c2);
  fp2_mul(x, a.c1, b.c2);
  fp2_mul(y, a.c2, b.c1);
  fp2_add(x, x, y);
  fp2_mul_xi(x, x);
  fp2_add(c0, t00, x);
  fp2_mul(x, a.c0, b.c1);
  fp2_mul(y, a.c1, b.c0);
  fp2_add(x, x, y);
  fp2_mul_xi(y, t22);
  fp2_add(c1, x, y);
  fp2_mul(x, a.c0, b.c2);
  fp2_mul(y, a.c2, b.c0);
  fp2_add(x, x, y);
  fp2_add(c2, x, t11);
  z.c0 = c0;
  z.c1 = c1;
  z.c2 = c2;
}
static inline void fp6_sqr(Fp6 &z, const Fp6 &a) { fp6_mul(z, a, a); }
static void fp6_mul_by_v(Fp6 &z, const Fp6 &a) {
  Fp2 t;
  fp2_mul_xi(t, a.c2);
  Fp2 old0 = a.c0, old1 = a.c1;
  z.c0 = t;
  z.c1 = old0;
  z.c2 = old1;
}
static void fp6_inv(Fp6 &z, const Fp6 &a) {
  Fp2 t0, t1, t2, x, y, f, finv;
  fp2_sqr(t0, a.c0);
  fp2_mul(x, a.c1, a.c2);
  fp2_mul_xi(x, x);
  fp2_sub(t0, t0, x);
  fp2_sqr(t1, a.c2);
  fp2_mul_xi(t1, t1);
  fp2_mul(x, a.c0, a.c1);
  fp2_sub(t1, t1, x);
  fp2_sqr(t2, a.c1);
  fp2_mul(x, a.c0, a.c2);
  fp2_sub(t2, t2, x);
  fp2_mul(f, a.c0, t0);
  fp2_mul(x, a.c2, t1);
  fp2_mul(y, a.c1, t2);
  fp2_add(x, x, y);
  fp2_mul_xi(x, x);
  fp2_add(f, f, x);
  fp2_inv(finv, f);
  fp2_mul(z.c0, t0, finv);
  fp2_mul(z.c1, t1, finv);
  fp2_mul(z.c2, t2, finv);
}

static void fp12_mul(Fp12 &z, const Fp12 &a, const Fp12 &b) {
  Fp6 t0, t1, x, y;
  fp6_mul(t0, a.c0, b.c0);
  fp6_mul(t1, a.c1, b.c1);
  fp6_add(x, a.c0, a.c1);
  fp6_add(y, b.c0, b.c1);
  fp6_mul(x, x, y);
  fp6_sub(x, x, t0);
  Fp6 c1;
  fp6_sub(c1, x, t1);
  Fp6 vt1;
  fp6_mul_by_v(vt1, t1);
  fp6_add(z.c0, t0, vt1);
  z.c1 = c1;
}
static inline void fp12_sqr(Fp12 &z, const Fp12 &a) { fp12_mul(z, a, a); }

// complex squaring for Fp12 = Fp6[w]/(w^2 - v): 2 fp6_mul instead of 3
static void fp12_sqr_fast(Fp12 &z, const Fp12 &a) {
  Fp6 t, s0, s1, vt;
  fp6_mul(t, a.c0, a.c1);
  fp6_add(s0, a.c0, a.c1);
  fp6_mul_by_v(vt, a.c1);
  fp6_add(s1, a.c0, vt);
  fp6_mul(s1, s0, s1);  // (a0+a1)(a0+v a1) = a0^2 + v a1^2 + (1+v) a0 a1
  fp6_sub(s1, s1, t);
  fp6_mul_by_v(vt, t);
  fp6_sub(z.c0, s1, vt);
  fp6_add(z.c1, t, t);
}
static inline void fp12_conj(Fp12 &z, const Fp12 &a) {
  z.c0 = a.c0;
  fp6_neg(z.c1, a.c1);
}
static void fp12_inv(Fp12 &z, const Fp12 &a) {
  Fp6 t0, t1, f, finv;
  fp6_sqr(t0, a.c0);
  fp6_sqr(t1, a.c1);
  fp6_mul_by_v(t1, t1);
  fp6_sub(f, t0, t1);
  fp6_inv(finv, f);
  fp6_mul(z.c0, a.c0, finv);
  Fp6 n;
  fp6_mul(n, a.c1, finv);
  fp6_neg(z.c1, n);
}
static void fp12_sub(Fp12 &z, const Fp12 &a, const Fp12 &b) {
  fp6_sub(z.c0, a.c0, b.c0);
  fp6_sub(z.c1, a.c1, b.c1);
}
static bool fp12_is_one(const Fp12 &a) {
  return fp2_eq(a.c0.c0, FP2_ONE_) && fp2_is_zero(a.c0.c1) &&
         fp2_is_zero(a.c0.c2) && fp2_is_zero(a.c1.c0) &&
         fp2_is_zero(a.c1.c1) && fp2_is_zero(a.c1.c2);
}
static bool fp12_is_zero(const Fp12 &a) {
  return fp2_is_zero(a.c0.c0) && fp2_is_zero(a.c0.c1) &&
         fp2_is_zero(a.c0.c2) && fp2_is_zero(a.c1.c0) &&
         fp2_is_zero(a.c1.c1) && fp2_is_zero(a.c1.c2);
}
static bool fp12_eq(const Fp12 &a, const Fp12 &b) {
  Fp12 d;
  fp12_sub(d, a, b);
  return fp12_is_zero(d);
}

// Frobenius coefficients gamma_i = xi^((p-1)*i/6), computed at init.
static Fp2 GAMMA[6];

static void fp12_frobenius(Fp12 &z, const Fp12 &a) {
  Fp2 t;
  fp2_conj(z.c0.c0, a.c0.c0);
  fp2_conj(t, a.c0.c1);
  fp2_mul(z.c0.c1, t, GAMMA[2]);
  fp2_conj(t, a.c0.c2);
  fp2_mul(z.c0.c2, t, GAMMA[4]);
  fp2_conj(t, a.c1.c0);
  fp2_mul(z.c1.c0, t, GAMMA[1]);
  fp2_conj(t, a.c1.c1);
  fp2_mul(z.c1.c1, t, GAMMA[3]);
  fp2_conj(t, a.c1.c2);
  fp2_mul(z.c1.c2, t, GAMMA[5]);
}

// ===========================================================================
// G1 (Jacobian over Fp) and G2 (Jacobian over Fp2)
// ===========================================================================

struct G1 {
  Fp x, y, z;
};
struct G2 {
  Fp2 x, y, z;
};

static G1 G1_INF_;
static G2 G2_INF_;

static inline bool g1_is_inf(const G1 &p) { return fp_is_zero(p.z); }
static inline bool g2_is_inf(const G2 &p) { return fp2_is_zero(p.z); }

static void g1_dbl(G1 &r, const G1 &p) {
  if (g1_is_inf(p) || fp_is_zero(p.y)) {
    r = G1_INF_;
    return;
  }
  Fp a, b, c, d, e, f, t;
  fp_sqr(a, p.x);
  fp_sqr(b, p.y);
  fp_sqr(c, b);
  fp_add(d, p.x, b);
  fp_sqr(d, d);
  fp_sub(d, d, a);
  fp_sub(d, d, c);
  fp_dbl(d, d);
  fp_add(e, a, a);
  fp_add(e, e, a);
  fp_sqr(f, e);
  Fp x3, y3, z3;
  fp_sub(x3, f, d);
  fp_sub(x3, x3, d);
  fp_sub(t, d, x3);
  fp_mul(y3, e, t);
  Fp c8;
  fp_dbl(c8, c);
  fp_dbl(c8, c8);
  fp_dbl(c8, c8);
  fp_sub(y3, y3, c8);
  fp_mul(z3, p.y, p.z);
  fp_dbl(z3, z3);
  r.x = x3;
  r.y = y3;
  r.z = z3;
}

static void g1_add(G1 &r, const G1 &p, const G1 &q) {
  if (g1_is_inf(p)) {
    r = q;
    return;
  }
  if (g1_is_inf(q)) {
    r = p;
    return;
  }
  Fp z1z1, z2z2, u1, u2, s1, s2, t;
  fp_sqr(z1z1, p.z);
  fp_sqr(z2z2, q.z);
  fp_mul(u1, p.x, z2z2);
  fp_mul(u2, q.x, z1z1);
  fp_mul(t, p.y, q.z);
  fp_mul(s1, t, z2z2);
  fp_mul(t, q.y, p.z);
  fp_mul(s2, t, z1z1);
  if (fp_eq(u1, u2)) {
    if (fp_eq(s1, s2)) {
      g1_dbl(r, p);
      return;
    }
    r = G1_INF_;
    return;
  }
  Fp h, i, j, rr, v;
  fp_sub(h, u2, u1);
  fp_dbl(i, h);
  fp_sqr(i, i);
  fp_mul(j, h, i);
  fp_sub(rr, s2, s1);
  fp_dbl(rr, rr);
  fp_mul(v, u1, i);
  Fp x3, y3, z3;
  fp_sqr(x3, rr);
  fp_sub(x3, x3, j);
  fp_sub(x3, x3, v);
  fp_sub(x3, x3, v);
  fp_sub(t, v, x3);
  fp_mul(y3, rr, t);
  Fp s1j;
  fp_mul(s1j, s1, j);
  fp_dbl(s1j, s1j);
  fp_sub(y3, y3, s1j);
  fp_mul(z3, p.z, q.z);
  fp_mul(z3, z3, h);
  fp_dbl(z3, z3);
  r.x = x3;
  r.y = y3;
  r.z = z3;
}

static void g1_neg(G1 &r, const G1 &p) {
  r.x = p.x;
  fp_neg(r.y, p.y);
  r.z = p.z;
}

static void g2_dbl(G2 &r, const G2 &p) {
  if (g2_is_inf(p) || fp2_is_zero(p.y)) {
    r = G2_INF_;
    return;
  }
  Fp2 a, b, c, d, e, f, t;
  fp2_sqr(a, p.x);
  fp2_sqr(b, p.y);
  fp2_sqr(c, b);
  fp2_add(d, p.x, b);
  fp2_sqr(d, d);
  fp2_sub(d, d, a);
  fp2_sub(d, d, c);
  fp2_add(d, d, d);
  fp2_add(e, a, a);
  fp2_add(e, e, a);
  fp2_sqr(f, e);
  Fp2 x3, y3, z3;
  fp2_sub(x3, f, d);
  fp2_sub(x3, x3, d);
  fp2_sub(t, d, x3);
  fp2_mul(y3, e, t);
  Fp2 c8;
  fp2_add(c8, c, c);
  fp2_add(c8, c8, c8);
  fp2_add(c8, c8, c8);
  fp2_sub(y3, y3, c8);
  fp2_mul(z3, p.y, p.z);
  fp2_add(z3, z3, z3);
  r.x = x3;
  r.y = y3;
  r.z = z3;
}

static void g2_add(G2 &r, const G2 &p, const G2 &q) {
  if (g2_is_inf(p)) {
    r = q;
    return;
  }
  if (g2_is_inf(q)) {
    r = p;
    return;
  }
  Fp2 z1z1, z2z2, u1, u2, s1, s2, t;
  fp2_sqr(z1z1, p.z);
  fp2_sqr(z2z2, q.z);
  fp2_mul(u1, p.x, z2z2);
  fp2_mul(u2, q.x, z1z1);
  fp2_mul(t, p.y, q.z);
  fp2_mul(s1, t, z2z2);
  fp2_mul(t, q.y, p.z);
  fp2_mul(s2, t, z1z1);
  if (fp2_eq(u1, u2)) {
    if (fp2_eq(s1, s2)) {
      g2_dbl(r, p);
      return;
    }
    r = G2_INF_;
    return;
  }
  Fp2 h, i, j, rr, v;
  fp2_sub(h, u2, u1);
  fp2_add(i, h, h);
  fp2_sqr(i, i);
  fp2_mul(j, h, i);
  fp2_sub(rr, s2, s1);
  fp2_add(rr, rr, rr);
  fp2_mul(v, u1, i);
  Fp2 x3, y3, z3;
  fp2_sqr(x3, rr);
  fp2_sub(x3, x3, j);
  fp2_sub(x3, x3, v);
  fp2_sub(x3, x3, v);
  fp2_sub(t, v, x3);
  fp2_mul(y3, rr, t);
  Fp2 s1j;
  fp2_mul(s1j, s1, j);
  fp2_add(s1j, s1j, s1j);
  fp2_sub(y3, y3, s1j);
  fp2_mul(z3, p.z, q.z);
  fp2_mul(z3, z3, h);
  fp2_add(z3, z3, z3);
  r.x = x3;
  r.y = y3;
  r.z = z3;
}

static void g2_neg(G2 &r, const G2 &p) {
  r.x = p.x;
  fp2_neg(r.y, p.y);
  r.z = p.z;
}

// scalar = big-endian byte string, arbitrary length
static void g1_mul_scalar(G1 &r, const G1 &p, const uint8_t *scalar,
                          size_t len) {
  G1 acc = G1_INF_;
  bool started = false;
  for (size_t i = 0; i < len; i++) {
    for (int b = 7; b >= 0; b--) {
      if (started) g1_dbl(acc, acc);
      if ((scalar[i] >> b) & 1) {
        g1_add(acc, acc, p);
        started = true;
      }
    }
  }
  r = acc;
}

static void g2_mul_scalar(G2 &r, const G2 &p, const uint8_t *scalar,
                          size_t len) {
  G2 acc = G2_INF_;
  bool started = false;
  for (size_t i = 0; i < len; i++) {
    for (int b = 7; b >= 0; b--) {
      if (started) g2_dbl(acc, acc);
      if ((scalar[i] >> b) & 1) {
        g2_add(acc, acc, p);
        started = true;
      }
    }
  }
  r = acc;
}

static void g1_to_affine(Fp &ax, Fp &ay, const G1 &p) {
  Fp zi, zi2;
  fp_inv(zi, p.z);
  fp_sqr(zi2, zi);
  fp_mul(ax, p.x, zi2);
  fp_mul(zi2, zi2, zi);
  fp_mul(ay, p.y, zi2);
}

static void g2_to_affine(Fp2 &ax, Fp2 &ay, const G2 &p) {
  Fp2 zi, zi2;
  fp2_inv(zi, p.z);
  fp2_sqr(zi2, zi);
  fp2_mul(ax, p.x, zi2);
  fp2_mul(zi2, zi2, zi);
  fp2_mul(ay, p.y, zi2);
}

// ===========================================================================
// GLV + Straus small-MSM machinery (the Lagrange-combine hot path)
//
// The binary egcd inversion costs ~16us on this box, so EVERY to-affine
// conversion in batch paths goes through Montgomery's batch-inversion trick
// (one egcd + 3 muls/element) — g1_to_affine above is for singletons only.
// ===========================================================================

// |z| for BLS12-381 (z = -0xd201000000010000), Hamming weight 6: a scalar
// ladder over it costs 64 doublings + 5 additions
static const uint8_t Z_ABS_BE[8] = {0xd2, 0x01, 0x00, 0x00,
                                    0x00, 0x01, 0x00, 0x00};
// beta: the cube root of unity in Fp whose GLV endomorphism
// phi(x, y) = (beta*x, y) acts as multiplication by lambda = z^2 - 1 on
// G1 (beta = (2^((p-1)/3))^2; the OTHER root pairs with the other
// eigenvalue — resolved empirically and pinned by the soundness
// certificate, tests/test_subgroup_fast.py)
static const uint8_t BETA_G1_BE[48] = {
    0x1a, 0x01, 0x11, 0xea, 0x39, 0x7f, 0xe6, 0x99, 0xec, 0x02, 0x40, 0x86,
    0x63, 0xd4, 0xde, 0x85, 0xaa, 0x0d, 0x85, 0x7d, 0x89, 0x75, 0x9a, 0xd4,
    0x89, 0x7d, 0x29, 0x65, 0x0f, 0xb8, 0x5f, 0x9b, 0x40, 0x94, 0x27, 0xeb,
    0x4f, 0x49, 0xff, 0xfd, 0x8b, 0xfd, 0x00, 0x00, 0x00, 0x00, 0xaa, 0xac};

// Montgomery batch inversion: zs[i] <- zs[i]^{-1}; zero entries stay zero
// (callers use Z==0 as the point-at-infinity marker).
static void fp_batch_inv(Fp *zs, size_t n) {
  if (n == 0) return;
  std::vector<Fp> pre(n);
  Fp acc = MONT_ONE;
  for (size_t i = 0; i < n; i++) {
    pre[i] = acc;
    if (!fp_is_zero(zs[i])) fp_mul(acc, acc, zs[i]);
  }
  Fp inv;
  fp_inv(inv, acc);
  for (size_t i = n; i-- > 0;) {
    if (fp_is_zero(zs[i])) continue;
    Fp t;
    fp_mul(t, inv, pre[i]);
    fp_mul(inv, inv, zs[i]);
    zs[i] = t;
  }
}

// Batch Jacobian -> affine for n points with ONE field inversion; on
// return (xs[i], ys[i]) is affine and valid[i]=false marks infinity.
static void g1_batch_to_affine(const G1 *pts, Fp *xs, Fp *ys,
                               uint8_t *valid, size_t n) {
  std::vector<Fp> zs(n);
  for (size_t i = 0; i < n; i++) zs[i] = pts[i].z;
  fp_batch_inv(zs.data(), n);
  for (size_t i = 0; i < n; i++) {
    if (fp_is_zero(zs[i])) {
      xs[i] = FP_ZERO;
      ys[i] = FP_ZERO;
      valid[i] = 0;
      continue;
    }
    Fp zi2, zi3;
    fp_sqr(zi2, zs[i]);
    fp_mul(zi3, zi2, zs[i]);
    fp_mul(xs[i], pts[i].x, zi2);
    fp_mul(ys[i], pts[i].y, zi3);
    valid[i] = 1;
  }
}

// mixed addition r = p + (qx, qy) [affine q, q != inf] — madd-2007-bl
// (7M + 4S vs the 11M + 5S full Jacobian add); handles p == +-q.
static void g1_madd(G1 &r, const G1 &p, const Fp &qx, const Fp &qy) {
  if (g1_is_inf(p)) {
    r.x = qx;
    r.y = qy;
    r.z = MONT_ONE;
    return;
  }
  Fp z1z1, u2, s2, t;
  fp_sqr(z1z1, p.z);
  fp_mul(u2, qx, z1z1);
  fp_mul(t, qy, p.z);
  fp_mul(s2, t, z1z1);
  if (fp_eq(p.x, u2)) {
    if (fp_eq(p.y, s2)) {
      g1_dbl(r, p);
      return;
    }
    r = G1_INF_;
    return;
  }
  Fp h, hh, i, j, rr, v, x3, y3, z3;
  fp_sub(h, u2, p.x);
  fp_sqr(hh, h);
  fp_dbl(i, hh);
  fp_dbl(i, i);
  fp_mul(j, h, i);
  fp_sub(rr, s2, p.y);
  fp_dbl(rr, rr);
  fp_mul(v, p.x, i);
  fp_sqr(x3, rr);
  fp_sub(x3, x3, j);
  fp_sub(x3, x3, v);
  fp_sub(x3, x3, v);
  fp_sub(t, v, x3);
  fp_mul(y3, rr, t);
  fp_mul(t, p.y, j);
  fp_dbl(t, t);
  fp_sub(y3, y3, t);
  fp_add(z3, p.z, h);
  fp_sqr(z3, z3);
  fp_sub(z3, z3, z1z1);
  fp_sub(z3, z3, hh);
  r.x = x3;
  r.y = y3;
  r.z = z3;
}

// LE-limb schoolbook multiply, out must hold na+nb limbs
static void limbs_mul(u64 *out, const u64 *a, int na, const u64 *b, int nb) {
  memset(out, 0, 8 * (size_t)(na + nb));
  for (int i = 0; i < na; i++) {
    u64 carry = 0;
    for (int j = 0; j < nb; j++) {
      u128 cur = (u128)a[i] * b[j] + out[i + j] + carry;
      out[i + j] = (u64)cur;
      carry = (u64)(cur >> 64);
    }
    out[i + nb] = carry;  // untouched by earlier rounds
  }
}

// GLV decomposition constants (filled in by Init)
static u64 MU384[3];      // floor(2^384 / r) — Barrett
static u64 Z2_LIMBS[2];   // z^2      (lambda + 1)
static u64 LAM_LIMBS[2];  // lambda = z^2 - 1 (phi eigenvalue on G1)

// reduce a 32-byte BE scalar mod r into 4 LE limbs (k < 2^256 < 4r)
static void scalar_mod_r(u64 k[4], const uint8_t be[32]) {
  for (int i = 0; i < 4; i++) {
    u64 l = 0;
    for (int j = 0; j < 8; j++) l = (l << 8) | be[(3 - i) * 8 + j];
    k[i] = l;
  }
  for (int rep = 0; rep < 3; rep++) {
    u64 t[4];
    memcpy(t, k, 32);
    if (!limbs_sub(t, R_LIMBS, 4)) memcpy(k, t, 32);  // k >= r: keep k-r
  }
}

// k (mod r) ->  s1*a1 + lambda * s2*a2  with |ai| < 2^131.
// Unconditionally SOUND: the split is re-verified against k mod r and falls
// back to the trivial (k, 0) decomposition on any Barrett corner case, so
// callers never depend on the rounding-error analysis.
static void glv_split_g1(int &s1, u64 a1[4], int &s2, u64 a2[4],
                         const u64 k[4]) {
  // c1 ~= k*z^2/r, c2 ~= k/r (both floor approximations, error <= 2)
  u64 kz2[6], t9[9], t7[7];
  limbs_mul(kz2, k, 4, Z2_LIMBS, 2);
  limbs_mul(t9, kz2, 6, MU384, 3);
  u64 c1[3] = {t9[6], t9[7], t9[8]};
  limbs_mul(t7, k, 4, MU384, 3);
  u64 c2 = t7[6];  // k/r < 4
  // k1 = k - c1*lambda - c2 (5-limb two's complement)
  u64 c1l[5], k1[5] = {k[0], k[1], k[2], k[3], 0};
  limbs_mul(c1l, c1, 3, LAM_LIMBS, 2);
  bool neg1 = limbs_sub(k1, c1l, 5);
  u64 c2w[5] = {c2, 0, 0, 0, 0};
  if (limbs_sub(k1, c2w, 5)) neg1 = true;
  if (neg1) {  // negate two's complement
    for (int i = 0; i < 5; i++) k1[i] = ~k1[i];
    u64 one[5] = {1, 0, 0, 0, 0};
    limbs_add(k1, one, 5);
  }
  // k2 = c1 - c2*z^2 (5-limb two's complement)
  u64 k2[5] = {c1[0], c1[1], c1[2], 0, 0}, c2z[5];
  u64 c2l[1] = {c2};
  limbs_mul(c2z, c2l, 1, Z2_LIMBS, 2);
  c2z[3] = c2z[4] = 0;
  bool neg2 = limbs_sub(k2, c2z, 5);
  if (neg2) {
    for (int i = 0; i < 5; i++) k2[i] = ~k2[i];
    u64 one[5] = {1, 0, 0, 0, 0};
    limbs_add(k2, one, 5);
  }
  s1 = neg1 ? -1 : 1;
  s2 = neg2 ? -1 : 1;
  memcpy(a1, k1, 32);
  memcpy(a2, k2, 32);
  // soundness re-check: s1*a1 + lambda*s2*a2 == k (mod r)?
  // rhs = a1*?; work mod r via repeated conditional subtraction after
  // reducing the 6-limb lambda*a2 product with the generic path.
  bool ok = k1[4] == 0 && k2[4] == 0 && (a1[3] >> 8) == 0 && (a2[3] >> 8) == 0;
  if (ok) {
    // r1 = a1 mod r, r2 = (lambda * a2) mod r  (product < 2^128 * 2^131)
    u64 la2[6];
    limbs_mul(la2, a2, 4, LAM_LIMBS, 2);
    // reduce la2 (6 limbs) mod r by Barrett with MU384: q = (la2*MU)>>384
    u64 q9[9];
    limbs_mul(q9, la2, 6, MU384, 3);
    u64 q[3] = {q9[6], q9[7], q9[8]};
    u64 qr[7];
    limbs_mul(qr, q, 3, R_LIMBS, 4);
    u64 la2w[7] = {la2[0], la2[1], la2[2], la2[3], la2[4], la2[5], 0};
    limbs_sub(la2w, qr, 7);
    for (int rep = 0; rep < 4; rep++) {
      u64 t[7];
      memcpy(t, la2w, 56);
      u64 rw[7] = {R_LIMBS[0], R_LIMBS[1], R_LIMBS[2], R_LIMBS[3], 0, 0, 0};
      if (!limbs_sub(t, rw, 7)) memcpy(la2w, t, 56);
    }
    // acc = s1*a1 + s2*la2w mod r, then compare against k
    u64 acc[5] = {0, 0, 0, 0, 0};
    u64 a1w[5] = {a1[0], a1[1], a1[2], a1[3], 0};
    u64 l2w[5] = {la2w[0], la2w[1], la2w[2], la2w[3], 0};
    u64 rw[5] = {R_LIMBS[0], R_LIMBS[1], R_LIMBS[2], R_LIMBS[3], 0};
    if (s1 > 0) limbs_add(acc, a1w, 5);
    else if (limbs_sub(acc, a1w, 5)) limbs_add(acc, rw, 5), limbs_add(acc, rw, 5);
    if (s2 > 0) limbs_add(acc, l2w, 5);
    else if (limbs_sub(acc, l2w, 5)) limbs_add(acc, rw, 5), limbs_add(acc, rw, 5);
    for (int rep = 0; rep < 4; rep++) {
      u64 t[5];
      memcpy(t, acc, 40);
      if (!limbs_sub(t, rw, 5)) memcpy(acc, t, 40);
    }
    ok = acc[4] == 0 && acc[0] == k[0] && acc[1] == k[1] && acc[2] == k[2] &&
         acc[3] == k[3];
  }
  if (!ok) {  // fall back to the trivial decomposition (always correct)
    s1 = 1;
    s2 = 1;
    memcpy(a1, k, 32);
    memset(a2, 0, 32);
  }
}

// width-4 NAF of a (LE limbs, destructive); digits odd in {+-1,+-3,+-5,+-7};
// returns digit count (<= 64*nlimbs + 1)
static int wnaf4(int8_t *digits, u64 *a, int nlimbs) {
  int len = 0;
  while (!limbs_is_zero(a, nlimbs)) {
    int d = 0;
    if (a[0] & 1) {
      d = (int)(a[0] & 15);
      if (d > 8) d -= 16;
      if (d > 0) {
        u64 borrow = (u64)d;
        for (int i = 0; i < nlimbs && borrow; i++) {
          u64 prev = a[i];
          a[i] -= borrow;
          borrow = a[i] > prev ? 1 : 0;
        }
      } else {
        u64 carry = (u64)(-d);
        for (int i = 0; i < nlimbs && carry; i++) {
          u64 prev = a[i];
          a[i] += carry;
          carry = a[i] < prev ? 1 : 0;
        }
      }
    }
    digits[len++] = (int8_t)d;
    limbs_rshift1(a, nlimbs);
  }
  return len;
}

// Straus/GLV MSM over G1 for SMALL n (the Lagrange-combine shape: t+1
// points). Each 255-bit scalar splits into two ~129-bit GLV halves (the
// phi half's affine table is the base table with x scaled by beta — phi is
// a homomorphism, so phi(mP) = m*phi(P)); both halves run width-4 NAF over
// a batch-normalized affine table with mixed additions. ~4x over the
// bucket method at n=22 (which cannot amortize buckets at this size).
static void g1_msm_straus(G1 &out, const G1 *points, const uint8_t *scalars,
                          size_t n) {
  const int TBL = 4;  // odd multiples 1,3,5,7
  struct Half {
    int tbl;      // index into the affine tables (j*TBL)
    bool phi;     // use the beta-scaled x
    int8_t digits[260];  // split halves are ~132; the sound fallback
    int len;             // decomposition runs the full 256-bit scalar
  };
  std::vector<Fp> tx(n * TBL), ty(n * TBL), phix(n * TBL);
  std::vector<uint8_t> tvalid(n * TBL);
  std::vector<Half> halves(2 * n);
  // Jacobian odd-multiple tables
  std::vector<G1> jt(n * TBL);
  for (size_t j = 0; j < n; j++) {
    const G1 &p = points[j];
    jt[j * TBL] = p;
    G1 twop;
    g1_dbl(twop, p);
    g1_add(jt[j * TBL + 1], twop, p);
    g1_add(jt[j * TBL + 2], jt[j * TBL + 1], twop);
    g1_add(jt[j * TBL + 3], jt[j * TBL + 2], twop);
  }
  g1_batch_to_affine(jt.data(), tx.data(), ty.data(), tvalid.data(),
                     n * TBL);
  Fp beta;
  fp_from_bytes_be(beta, BETA_G1_BE);
  for (size_t i = 0; i < n * TBL; i++)
    if (tvalid[i]) fp_mul(phix[i], tx[i], beta);
  // scalar split + wNAF
  int maxlen = 0;
  for (size_t j = 0; j < n; j++) {
    u64 k[4];
    scalar_mod_r(k, scalars + j * 32);
    int s1, s2;
    u64 a1[4], a2[4];
    glv_split_g1(s1, a1, s2, a2, k);
    Half &h1 = halves[2 * j], &h2 = halves[2 * j + 1];
    h1.tbl = (int)(j * TBL);
    h1.phi = false;
    h1.len = wnaf4(h1.digits, a1, 4);
    if (s1 < 0)
      for (int i = 0; i < h1.len; i++) h1.digits[i] = -h1.digits[i];
    h2.tbl = (int)(j * TBL);
    h2.phi = true;
    h2.len = wnaf4(h2.digits, a2, 4);
    if (s2 < 0)
      for (int i = 0; i < h2.len; i++) h2.digits[i] = -h2.digits[i];
    if (h1.len > maxlen) maxlen = h1.len;
    if (h2.len > maxlen) maxlen = h2.len;
  }
  G1 acc = G1_INF_;
  for (int pos = maxlen - 1; pos >= 0; pos--) {
    g1_dbl(acc, acc);
    for (size_t h = 0; h < 2 * n; h++) {
      const Half &hf = halves[h];
      if (pos >= hf.len) continue;
      int d = hf.digits[pos];
      if (!d) continue;
      int idx = hf.tbl + (d > 0 ? d - 1 : -d - 1) / 2;
      if (!tvalid[idx]) continue;  // infinity entry
      const Fp &qx = hf.phi ? phix[idx] : tx[idx];
      if (d > 0) {
        g1_madd(acc, acc, qx, ty[idx]);
      } else {
        Fp ny;
        fp_neg(ny, ty[idx]);
        g1_madd(acc, acc, qx, ny);
      }
    }
  }
  out = acc;
}

// --- wire format (matches the Python oracle: BE uncompressed, zero == inf) --

static bool g1_from_bytes(G1 &p, const uint8_t *in) {  // 96 bytes
  bool allz = true;
  for (int i = 0; i < 96; i++)
    if (in[i]) {
      allz = false;
      break;
    }
  if (allz) {
    p = G1_INF_;
    return true;
  }
  fp_from_bytes_be(p.x, in);
  fp_from_bytes_be(p.y, in + 48);
  p.z = MONT_ONE;
  // on-curve: y^2 == x^3 + 4
  Fp y2, x3, four;
  fp_sqr(y2, p.y);
  fp_sqr(x3, p.x);
  fp_mul(x3, x3, p.x);
  fp_set_u64(four, 4);
  fp_add(x3, x3, four);
  return fp_eq(y2, x3);
}

static void g1_to_bytes(uint8_t *out, const G1 &p) {
  if (g1_is_inf(p)) {
    memset(out, 0, 96);
    return;
  }
  Fp ax, ay;
  g1_to_affine(ax, ay, p);
  fp_to_bytes_be(out, ax);
  fp_to_bytes_be(out + 48, ay);
}

static bool g2_from_bytes(G2 &p, const uint8_t *in) {  // 192 bytes
  bool allz = true;
  for (int i = 0; i < 192; i++)
    if (in[i]) {
      allz = false;
      break;
    }
  if (allz) {
    p = G2_INF_;
    return true;
  }
  fp_from_bytes_be(p.x.c0, in);
  fp_from_bytes_be(p.x.c1, in + 48);
  fp_from_bytes_be(p.y.c0, in + 96);
  fp_from_bytes_be(p.y.c1, in + 144);
  p.z = FP2_ONE_;
  Fp2 y2, x3, b2;
  fp2_sqr(y2, p.y);
  fp2_sqr(x3, p.x);
  fp2_mul(x3, x3, p.x);
  Fp four;
  fp_set_u64(four, 4);
  b2.c0 = four;
  b2.c1 = four;  // 4*(1+u)
  fp2_add(x3, x3, b2);
  return fp2_eq(y2, x3);
}

static void g2_to_bytes(uint8_t *out, const G2 &p) {
  if (g2_is_inf(p)) {
    memset(out, 0, 192);
    return;
  }
  Fp2 ax, ay;
  g2_to_affine(ax, ay, p);
  fp_to_bytes_be(out, ax.c0);
  fp_to_bytes_be(out + 48, ax.c1);
  fp_to_bytes_be(out + 96, ay.c0);
  fp_to_bytes_be(out + 144, ay.c1);
}

static const uint8_t R_BYTES_BE[32] = {
    0x73, 0xed, 0xa7, 0x53, 0x29, 0x9d, 0x7d, 0x48, 0x33, 0x39, 0xd8,
    0x08, 0x09, 0xa1, 0xd8, 0x05, 0x53, 0xbd, 0xa4, 0x02, 0xff, 0xfe,
    0x5b, 0xfe, 0xff, 0xff, 0xff, 0xff, 0x00, 0x00, 0x00, 0x01};

// projective equality: X1*Z2^2 == X2*Z1^2 and Y1*Z2^3 == Y2*Z1^3
static bool g1_eq_proj(const G1 &p, const G1 &q) {
  bool pi = g1_is_inf(p), qi = g1_is_inf(q);
  if (pi || qi) return pi == qi;
  Fp z1z1, z2z2, a, b;
  fp_sqr(z1z1, p.z);
  fp_sqr(z2z2, q.z);
  fp_mul(a, p.x, z2z2);
  fp_mul(b, q.x, z1z1);
  if (!fp_eq(a, b)) return false;
  Fp z1c, z2c;
  fp_mul(z1c, z1z1, p.z);
  fp_mul(z2c, z2z2, q.z);
  fp_mul(a, p.y, z2c);
  fp_mul(b, q.y, z1c);
  return fp_eq(a, b);
}

static bool g1_in_subgroup(const G1 &p) {
  // Certified fast membership test: P is in the prime-order subgroup iff
  // phi(P) == [z^2 - 1]P. Soundness: phi - [lambda] is an endomorphism
  // whose kernel intersects every prime-power torsion component of the
  // cofactor trivially — machine-checked over h1 = 3*11^2*10177^2*
  // 859267^2*52437899^2 by tests/test_subgroup_fast.py, which also
  // differentially pins this routine against the full-order [r]P check.
  // Cost: two 64-bit ladders (~130 dbl + 12 add) vs [r]P's 255 dbl +
  // ~127 add — ~2.4x faster, on the wire-deserialization hot path.
  if (g1_is_inf(p)) return true;
  // no lazy caching: decoding beta is one fp_mul, negligible next to the
  // ~130 point doublings below, and a guarded static would race when two
  // GIL-released ctypes calls deserialize concurrently
  Fp beta;
  fp_from_bytes_be(beta, BETA_G1_BE);
  G1 t, t2, pneg, lam, ph;
  g1_mul_scalar(t, p, Z_ABS_BE, 8);   // [|z|]P
  g1_mul_scalar(t2, t, Z_ABS_BE, 8);  // [z^2]P (signs cancel)
  g1_neg(pneg, p);
  g1_add(lam, t2, pneg);  // [z^2 - 1]P
  ph = p;                 // phi: Jacobian (beta*X, Y, Z)
  fp_mul(ph.x, p.x, beta);
  return g1_eq_proj(ph, lam);
}
static bool g2_eq_proj(const G2 &p, const G2 &q) {
  bool pi = g2_is_inf(p), qi = g2_is_inf(q);
  if (pi || qi) return pi == qi;
  Fp2 z1z1, z2z2, a, b;
  fp2_sqr(z1z1, p.z);
  fp2_sqr(z2z2, q.z);
  fp2_mul(a, p.x, z2z2);
  fp2_mul(b, q.x, z1z1);
  if (!fp2_eq(a, b)) return false;
  Fp2 z1c, z2c;
  fp2_mul(z1c, z1z1, p.z);
  fp2_mul(z2c, z2z2, q.z);
  fp2_mul(a, p.y, z2c);
  fp2_mul(b, q.y, z1c);
  return fp2_eq(a, b);
}

// untwist-Frobenius-twist constants: A = 1/xi^((p-1)/3),
// B = 1/xi^((p-1)/2) with xi = 1 + i (derived numerically and pinned
// structurally by tests/test_subgroup_fast_g2.py)
static const uint8_t PSI_AX_C1[48] = {
    0x1a, 0x01, 0x11, 0xea, 0x39, 0x7f, 0xe6, 0x99, 0xec, 0x02, 0x40, 0x86,
    0x63, 0xd4, 0xde, 0x85, 0xaa, 0x0d, 0x85, 0x7d, 0x89, 0x75, 0x9a, 0xd4,
    0x89, 0x7d, 0x29, 0x65, 0x0f, 0xb8, 0x5f, 0x9b, 0x40, 0x94, 0x27, 0xeb,
    0x4f, 0x49, 0xff, 0xfd, 0x8b, 0xfd, 0x00, 0x00, 0x00, 0x00, 0xaa, 0xad,
};
static const uint8_t PSI_BY_C0[48] = {
    0x13, 0x52, 0x03, 0xe6, 0x01, 0x80, 0xa6, 0x8e, 0xe2, 0xe9, 0xc4, 0x48,
    0xd7, 0x7a, 0x2c, 0xd9, 0x1c, 0x3d, 0xed, 0xd9, 0x30, 0xb1, 0xcf, 0x60,
    0xef, 0x39, 0x64, 0x89, 0xf6, 0x1e, 0xb4, 0x5e, 0x30, 0x44, 0x66, 0xcf,
    0x3e, 0x67, 0xfa, 0x0a, 0xf1, 0xee, 0x7b, 0x04, 0x12, 0x1b, 0xde, 0xa2,
};
static const uint8_t PSI_BY_C1[48] = {
    0x06, 0xaf, 0x0e, 0x04, 0x37, 0xff, 0x40, 0x0b, 0x68, 0x31, 0xe3, 0x6d,
    0x6b, 0xd1, 0x7f, 0xfe, 0x48, 0x39, 0x5d, 0xab, 0xc2, 0xd3, 0x43, 0x5e,
    0x77, 0xf7, 0x6e, 0x17, 0x00, 0x92, 0x41, 0xc5, 0xee, 0x67, 0x99, 0x2f,
    0x72, 0xec, 0x05, 0xf4, 0xc8, 0x10, 0x84, 0xfb, 0xed, 0xe3, 0xcc, 0x09,
};

static bool g2_in_subgroup(const G2 &p) {
  // Certified fast membership test: Q in G2 iff psi(Q) == [z]Q, psi the
  // untwist-Frobenius-twist endomorphism psi(x, y) =
  // (A * conj(x), B * conj(y)). Soundness (deterministic, machine-checked
  // by tests/test_subgroup_fast_g2.py): psi satisfies
  // psi^2 - [t]psi + [p] = 0, so a torsion kernel element of order m | h2
  // would force m | z^2 - t*z + p == p - z — and gcd(p - z, h2) == 1.
  // On Jacobian coords conj is a field automorphism: psi(X, Y, Z) =
  // (A*conj(X), B*conj(Y), conj(Z)). Cost: one 64-bit ladder (~64 G2
  // doublings) vs [r]Q's 255 — ~3.5x faster.
  if (g2_is_inf(p)) return true;
  Fp2 ax, by;
  ax.c0 = FP_ZERO;
  fp_from_bytes_be(ax.c1, PSI_AX_C1);
  fp_from_bytes_be(by.c0, PSI_BY_C0);
  fp_from_bytes_be(by.c1, PSI_BY_C1);
  G2 ph, conj;
  conj = p;
  fp_neg(conj.x.c1, p.x.c1);
  fp_neg(conj.y.c1, p.y.c1);
  fp_neg(conj.z.c1, p.z.c1);
  ph = conj;
  fp2_mul(ph.x, conj.x, ax);
  fp2_mul(ph.y, conj.y, by);
  // [z]Q = -[|z|]Q (z is negative)
  G2 t, lam;
  g2_mul_scalar(t, p, Z_ABS_BE, 8);
  g2_neg(lam, t);
  return g2_eq_proj(ph, lam);
}

// ===========================================================================
// Pairing — same structure as the oracle: affine Miller loop on E(Fp12).
// ===========================================================================

static const u64 ATE_LOOP = 0xd201000000010000ull;  // |X_PARAM|

// --- fast Miller loop: affine coordinates ON THE TWIST (Fp2 slopes, one
// cheap Fp2 inversion per step) with sparse line multiplication. Each line
// is scaled by v*w, which is killed by the final exponentiation
// ((vw)^2 = xi in Fp2, so (vw)^(p^6-1) has order <= 2 and dies under
// (p^2+1)*hard). Replaces the reference-shaped affine-E(Fp12) loop whose
// per-step Fp12 inversions made a pairing ~15 ms.

// f *= (A + B*v) + (C*v)*w   [slots c0.c0 = A, c0.c1 = B, c1.c1 = C]
static void fp12_mul_sparse(Fp12 &f, const Fp2 &A, const Fp2 &B,
                            const Fp2 &C) {
  const Fp6 &a = f.c0, &b = f.c1;
  Fp6 r0, r1;
  Fp2 t;
  // a * (A + Bv): (a0*A + xi*a2*B, a1*A + a0*B, a2*A + a1*B)
  Fp2 a0A, a1A, a2A, a0B, a1B, a2B;
  fp2_mul(a0A, a.c0, A);
  fp2_mul(a1A, a.c1, A);
  fp2_mul(a2A, a.c2, A);
  fp2_mul(a0B, a.c0, B);
  fp2_mul(a1B, a.c1, B);
  fp2_mul(a2B, a.c2, B);
  fp2_mul_xi(t, a2B);
  fp2_add(r0.c0, a0A, t);
  fp2_add(r0.c1, a1A, a0B);
  fp2_add(r0.c2, a2A, a1B);
  // + v * (b * Cv) = b*C*v^2 = (xi*b1C, xi*b2C, b0C)
  Fp2 b0C, b1C, b2C;
  fp2_mul(b0C, b.c0, C);
  fp2_mul(b1C, b.c1, C);
  fp2_mul(b2C, b.c2, C);
  fp2_mul_xi(t, b1C);
  fp2_add(r0.c0, r0.c0, t);
  fp2_mul_xi(t, b2C);
  fp2_add(r0.c1, r0.c1, t);
  fp2_add(r0.c2, r0.c2, b0C);
  // c1' = a*(Cv) + b*(A + Bv)
  // a*Cv = (xi*a2C, a0C, a1C)
  Fp2 a0C, a1C, a2C;
  fp2_mul(a0C, a.c0, C);
  fp2_mul(a1C, a.c1, C);
  fp2_mul(a2C, a.c2, C);
  fp2_mul_xi(t, a2C);
  r1.c0 = t;
  r1.c1 = a0C;
  r1.c2 = a1C;
  Fp2 b0A, b1A, b2A, b0B, b1B, b2B;
  fp2_mul(b0A, b.c0, A);
  fp2_mul(b1A, b.c1, A);
  fp2_mul(b2A, b.c2, A);
  fp2_mul(b0B, b.c0, B);
  fp2_mul(b1B, b.c1, B);
  fp2_mul(b2B, b.c2, B);
  fp2_mul_xi(t, b2B);
  fp2_add(r1.c0, r1.c0, b0A);
  fp2_add(r1.c0, r1.c0, t);
  fp2_add(r1.c1, r1.c1, b1A);
  fp2_add(r1.c1, r1.c1, b0B);
  fp2_add(r1.c2, r1.c2, b2A);
  fp2_add(r1.c2, r1.c2, b1B);
  f.c0 = r0;
  f.c1 = r1;
}

struct MLState {
  Fp px, py;
  Fp2 xQ, yQ, X, Y, Z;
  bool inf;
};

static void ml_init(MLState &s, const G1 &p, const G2 &q) {
  s.inf = g1_is_inf(p) || g2_is_inf(q);
  if (s.inf) return;
  g1_to_affine(s.px, s.py, p);
  g2_to_affine(s.xQ, s.yQ, q);
  s.X = s.xQ;
  s.Y = s.yQ;
  s.Z = FP2_ONE_;
}

// Batch variant for the era-sized grand products: to-affine needs a field
// inversion per point (~16us egcd each on this box — 4ms of pure inversion
// at 128 pairs); Montgomery's trick folds ALL of them (G1 z's and the Fp
// norms of G2 z's alike) into ONE egcd + 3 muls per element.
static void ml_init_batch(MLState *states, const G1 *ps, const G2 *qs,
                          size_t n) {
  std::vector<Fp> invs(2 * n);
  for (size_t i = 0; i < n; i++) {
    states[i].inf = g1_is_inf(ps[i]) || g2_is_inf(qs[i]);
    if (states[i].inf) {
      invs[2 * i] = FP_ZERO;
      invs[2 * i + 1] = FP_ZERO;
      continue;
    }
    invs[2 * i] = ps[i].z;
    // norm(z2) = c0^2 + c1^2; its inverse gives fp2 inverse via conjugate
    Fp n0, n1;
    fp_sqr(n0, qs[i].z.c0);
    fp_sqr(n1, qs[i].z.c1);
    fp_add(invs[2 * i + 1], n0, n1);
  }
  fp_batch_inv(invs.data(), 2 * n);
  for (size_t i = 0; i < n; i++) {
    MLState &s = states[i];
    if (s.inf) continue;
    Fp zi2;
    fp_sqr(zi2, invs[2 * i]);
    fp_mul(s.px, ps[i].x, zi2);
    fp_mul(zi2, zi2, invs[2 * i]);
    fp_mul(s.py, ps[i].y, zi2);
    Fp2 z2i;  // (conj z) * norm^{-1}
    fp_mul(z2i.c0, qs[i].z.c0, invs[2 * i + 1]);
    fp_mul(z2i.c1, qs[i].z.c1, invs[2 * i + 1]);
    fp_neg(z2i.c1, z2i.c1);
    Fp2 zi2q;
    fp2_sqr(zi2q, z2i);
    fp2_mul(s.xQ, qs[i].x, zi2q);
    fp2_mul(zi2q, zi2q, z2i);
    fp2_mul(s.yQ, qs[i].y, zi2q);
    s.X = s.xQ;
    s.Y = s.yQ;
    s.Z = FP2_ONE_;
  }
}

// one doubling step of the shared-squaring Miller loop: accumulate this
// pair's line into f (caller has already squared f ONCE for all pairs)
static void ml_dbl_step(MLState &s, Fp12 &f) {
  if (s.inf) return;
  const Fp &px = s.px, &py = s.py;
  Fp2 &X = s.X, &Y = s.Y, &Z = s.Z;
  Fp2 A, B, C, t, t2;
  // --- doubling step: line scaled by 2YZ^2 ---
  Fp2 XX, YY, X3c, YZ, YYZ;
  fp2_sqr(XX, X);
  fp2_sqr(YY, Y);
  fp2_mul(X3c, X, XX);  // X^3
  fp2_mul(YZ, Y, Z);
  fp2_mul(YYZ, YY, Z);
  // A = 3X^3 - 2Y^2Z
  fp2_add(t, X3c, X3c);
  fp2_add(A, t, X3c);
  fp2_add(t, YYZ, YYZ);
  fp2_sub(A, A, t);
  // B = -3*X^2*Z*px
  Fp2 XXZ;
  fp2_mul(XXZ, XX, Z);
  fp2_add(t, XXZ, XXZ);
  fp2_add(t, t, XXZ);
  fp_mul(B.c0, t.c0, px);
  fp_mul(B.c1, t.c1, px);
  fp2_neg(B, B);
  // C = 2*Y*Z^2*py
  Fp2 YZZ;
  fp2_mul(YZZ, YZ, Z);
  fp2_add(t, YZZ, YZZ);
  fp_mul(C.c0, t.c0, py);
  fp_mul(C.c1, t.c1, py);
  fp12_mul_sparse(f, A, B, C);
  // T = 2T:  X3 = 2XYZ(9X^3 - 8Y^2Z); Y3 = 36X^3*YYZ - 27X^6 - 8(YYZ)^2;
  //          Z3 = 8(YZ)^3
  Fp2 XYZ, nine_x3, eight_yyz, X3n, Y3n, Z3n, x3sq, yyzsq, yz2;
  fp2_mul(XYZ, X, YZ);
  fp2_add(t, X3c, X3c);          // 2X^3
  fp2_add(t2, t, t);             // 4X^3
  fp2_add(t2, t2, t2);           // 8X^3
  fp2_add(nine_x3, t2, X3c);     // 9X^3
  fp2_add(t, YYZ, YYZ);          // 2YYZ
  fp2_add(t2, t, t);             // 4YYZ
  fp2_add(eight_yyz, t2, t2);    // 8YYZ
  fp2_sub(t, nine_x3, eight_yyz);
  fp2_mul(X3n, XYZ, t);
  fp2_add(X3n, X3n, X3n);
  fp2_sqr(x3sq, X3c);            // X^6
  fp2_sqr(yyzsq, YYZ);
  fp2_mul(t, X3c, YYZ);          // X^3*Y^2*Z
  Fp2 acc;
  fp2_add(acc, t, t);            // 2
  fp2_add(acc, acc, acc);        // 4
  fp2_add(acc, acc, acc);        // 8
  fp2_add(acc, acc, t);          // 9
  fp2_add(t2, acc, acc);         // 18
  fp2_add(Y3n, t2, t2);          // 36*X^3*YYZ
  {
    // 27*X^6 = 16 + 8 + 2 + 1
    Fp2 two, four, eight, sixteen;
    fp2_add(two, x3sq, x3sq);
    fp2_add(four, two, two);
    fp2_add(eight, four, four);
    fp2_add(sixteen, eight, eight);
    fp2_add(t, sixteen, eight);
    fp2_add(t, t, two);
    fp2_add(t, t, x3sq);
  }
  fp2_sub(Y3n, Y3n, t);
  fp2_add(t, yyzsq, yyzsq);
  fp2_add(t2, t, t);
  fp2_add(t, t2, t2);  // 8 (YYZ)^2
  fp2_sub(Y3n, Y3n, t);
  fp2_sqr(yz2, YZ);
  fp2_mul(Z3n, yz2, YZ);  // (YZ)^3
  fp2_add(Z3n, Z3n, Z3n);
  fp2_add(t, Z3n, Z3n);
  fp2_add(Z3n, t, t);  // 8 (YZ)^3
  X = X3n;
  Y = Y3n;
  Z = Z3n;
}

static void ml_add_step(MLState &s, Fp12 &f) {
  if (s.inf) return;
  const Fp &px = s.px, &py = s.py;
  const Fp2 &xQ = s.xQ, &yQ = s.yQ;
  Fp2 &X = s.X, &Y = s.Y, &Z = s.Z;
  Fp2 A, B, C, t, t2, X3n, Y3n;
  // --- mixed addition step (Q affine): line through Q, scaled by D ---
  Fp2 N, D, NN, DD, DDZ, xqz, yqz;
  fp2_mul(xqz, xQ, Z);
  fp2_mul(yqz, yQ, Z);
  fp2_sub(N, Y, yqz);
  fp2_sub(D, X, xqz);
  // A = N*xQ - yQ*D ; B = -N*px ; C = D*py
  fp2_mul(A, N, xQ);
  fp2_mul(t, yQ, D);
  fp2_sub(A, A, t);
  fp_mul(B.c0, N.c0, px);
  fp_mul(B.c1, N.c1, px);
  fp2_neg(B, B);
  fp_mul(C.c0, D.c0, py);
  fp_mul(C.c1, D.c1, py);
  fp12_mul_sparse(f, A, B, C);
  // T = T + Q: t = N^2*Z - D^2*(X + xQ*Z);
  //            X3 = D*t; Z3 = D^3*Z; Y3 = N*(xQ*D^2*Z - t) - yQ*D^3*Z
  fp2_sqr(NN, N);
  fp2_sqr(DD, D);
  fp2_mul(DDZ, DD, Z);
  Fp2 u_;
  fp2_mul(u_, NN, Z);
  fp2_mul(t2, DD, X);
  fp2_sub(u_, u_, t2);
  fp2_mul(t2, xQ, DDZ);
  fp2_sub(u_, u_, t2);  // u_ = t
  fp2_mul(X3n, D, u_);
  Fp2 D3Z;
  fp2_mul(D3Z, DD, D);
  fp2_mul(D3Z, D3Z, Z);
  fp2_mul(t, xQ, DDZ);
  fp2_sub(t, t, u_);
  fp2_mul(Y3n, N, t);
  fp2_mul(t, yQ, D3Z);
  fp2_sub(Y3n, Y3n, t);
  X = X3n;
  Y = Y3n;
  Z = D3Z;
}

static void miller_loop(Fp12 &f, const G1 &p, const G2 &q) {
  // Homogeneous-projective twist coordinates: ZERO field inversions in the
  // loop (the affine variant spent ~10us/step in fp_inv). Lines are scaled
  // by per-step Fp2 factors, which the final exponentiation kills.
  MLState s;
  ml_init(s, p, q);
  f = FP12_ONE_;
  if (s.inf) return;
  int top = 63;
  while (!((ATE_LOOP >> top) & 1)) top--;
  for (int i = top - 1; i >= 0; i--) {
    fp12_sqr_fast(f, f);
    ml_dbl_step(s, f);
    if ((ATE_LOOP >> i) & 1) ml_add_step(s, f);
  }
  Fp12 fc;
  fp12_conj(fc, f);  // X_PARAM < 0
  f = fc;
}

// Shared-squaring multi-Miller loop: ONE f^2 per iteration for the whole
// product (the per-pair Miller loops each spent ~30% of their time in
// fp12_sqr_fast; a 2S-pair era product shares all of them). Equal to
// Prod_i miller_loop(p_i, q_i) because fp12_conj is a ring homomorphism.
static void miller_loop_multi(Fp12 &f, MLState *states, size_t n) {
  f = FP12_ONE_;
  int top = 63;
  while (!((ATE_LOOP >> top) & 1)) top--;
  for (int i = top - 1; i >= 0; i--) {
    fp12_sqr_fast(f, f);
    bool add = (ATE_LOOP >> i) & 1;
    for (size_t j = 0; j < n; j++) {
      ml_dbl_step(states[j], f);
      if (add) ml_add_step(states[j], f);
    }
  }
  Fp12 fc;
  fp12_conj(fc, f);  // X_PARAM < 0
  f = fc;
}

// --- cyclotomic arithmetic for the final exponentiation -------------------

// Fp4 = Fp2[sigma]/(sigma^2 - xi) squaring: (a + b sigma)^2
static inline void fp4_sqr(Fp2 &ra, Fp2 &rb, const Fp2 &a, const Fp2 &b) {
  Fp2 t0, t1, t2;
  fp2_sqr(t0, a);
  fp2_sqr(t1, b);
  fp2_add(t2, a, b);
  fp2_sqr(t2, t2);
  fp2_mul_xi(ra, t1);
  fp2_add(ra, ra, t0);  // a^2 + xi b^2
  fp2_sub(rb, t2, t0);
  fp2_sub(rb, rb, t1);  // 2ab
}

static bool CYC_OK = false;  // init self-check gates the fast path

// Granger-Scott squaring for unitary elements. Fp4 pairs in this tower:
// A = (c0.c0, c1.c1), B = (c1.c0, c0.c2), C = (c0.c1, c1.c2).
//   A' = 3*A^2 - 2*conj(A); B' = 3*sigma*C^2 + 2*conj(B);
//   C' = 3*B^2 - 2*conj(C);   sigma*(x + y*sigma) = xi*y + x*sigma.
static void fp12_sqr_cyc(Fp12 &z, const Fp12 &a) {
  if (!CYC_OK) {
    fp12_sqr_fast(z, a);
    return;
  }
  Fp2 sa_a, sa_b, sb_a, sb_b, sc_a, sc_b, t;
  fp4_sqr(sa_a, sa_b, a.c0.c0, a.c1.c1);
  fp4_sqr(sb_a, sb_b, a.c1.c0, a.c0.c2);
  fp4_sqr(sc_a, sc_b, a.c0.c1, a.c1.c2);
  // A' -> (c0.c0, c1.c1): re = 3*sa_a - 2*re; im = 3*sa_b + 2*im
  Fp2 r;
  fp2_sub(r, sa_a, a.c0.c0);
  fp2_add(r, r, r);
  fp2_add(z.c0.c0, r, sa_a);
  fp2_add(r, sa_b, a.c1.c1);
  fp2_add(r, r, r);
  fp2_add(z.c1.c1, r, sa_b);
  // B' -> (c1.c0, c0.c2): sigma*C^2 = (xi*sc_b, sc_a)
  fp2_mul_xi(t, sc_b);
  fp2_add(r, t, a.c1.c0);
  fp2_add(r, r, r);
  fp2_add(z.c1.c0, r, t);
  fp2_sub(r, sc_a, a.c0.c2);
  fp2_add(r, r, r);
  fp2_add(z.c0.c2, r, sc_a);
  // C' -> (c0.c1, c1.c2): re = 3*sb_a - 2*re; im = 3*sb_b + 2*im
  fp2_sub(r, sb_a, a.c0.c1);
  fp2_add(r, r, r);
  fp2_add(z.c0.c1, r, sb_a);
  fp2_add(r, sb_b, a.c1.c2);
  fp2_add(r, r, r);
  fp2_add(z.c1.c2, r, sb_b);
}

// g^|x| for cyclotomic g (|x| = ATE_LOOP), then conjugate for g^x (x < 0)
static void cyc_exp_x(Fp12 &out, const Fp12 &g) {
  Fp12 acc = g;
  for (int i = 62; i >= 0; i--) {
    fp12_sqr_cyc(acc, acc);
    if ((ATE_LOOP >> i) & 1) fp12_mul(acc, acc, g);
  }
  fp12_conj(out, acc);  // x negative
}

static void final_exponentiation(Fp12 &out, const Fp12 &f) {
  // easy part
  Fp12 t, finv, g;
  fp12_conj(t, f);
  fp12_inv(finv, f);
  fp12_mul(t, t, finv);  // f^(p^6-1)
  fp12_frobenius(g, t);
  fp12_frobenius(g, g);
  fp12_mul(t, g, t);  // ^(p^2+1) — now in the cyclotomic subgroup
  // hard part: exponent 3h, h = (p^4-p^2+1)/r, via the
  // Hayashida-Hayasaka-Teruya lambda chain (verified symbolically:
  // lambda0 + lambda1*p + lambda2*p^2 + lambda3*p^3 == 3h with
  // l3=(x-1)^2, l2=x*l3, l1=x^4-2x^3+2x-1, l0=x^5-2x^4+2x^2-x+3).
  // The framework's GT convention is this CUBED ate pairing — matching
  // crypto/bls12381.py final_exponentiation; gcd(3, r) = 1 so every
  // pairing equality check is unaffected.
  Fp12 t0, t1, t3, t4, t5, t6, t6b, tmp, accA, accB, accC, accD;
  cyc_exp_x(t3, t);  // t^x
  fp12_sqr_cyc(t1, t);
  fp12_conj(t1, t1);     // t^-2
  fp12_mul(t5, t3, t1);  // t^(x-2)
  cyc_exp_x(t1, t5);     // t^(x^2-2x)
  cyc_exp_x(t0, t1);     // t^(x^3-2x^2)
  cyc_exp_x(t6, t0);     // t^(x^4-2x^3)
  fp12_sqr_cyc(t4, t3);  // t^(2x)
  fp12_mul(t6, t6, t4);  // t^(x^4-2x^3+2x)
  fp12_conj(tmp, t);
  fp12_mul(t6b, t6, tmp);  // ^lambda1
  cyc_exp_x(t4, t6);       // t^(x^5-2x^4+2x^2)
  fp12_conj(tmp, t5);
  fp12_mul(accA, t4, tmp);
  fp12_mul(accA, accA, t);  // ^lambda0
  fp12_mul(accC, t0, t3);   // ^lambda2
  fp12_mul(accD, t1, t);    // ^lambda3
  fp12_frobenius(accB, t6b);
  fp12_frobenius(accC, accC);
  fp12_frobenius(accC, accC);
  fp12_frobenius(accD, accD);
  fp12_frobenius(accD, accD);
  fp12_frobenius(accD, accD);
  fp12_mul(out, accA, accB);
  fp12_mul(out, out, accC);
  fp12_mul(out, out, accD);
}

// init-time self-check for the Granger-Scott squaring sign conventions:
// build a cyclotomic element, compare fp12_sqr_cyc against the always-
// correct fp12_sqr_fast; on mismatch the slow-but-correct path stays.
// Called from the _init constructor AFTER field constants exist.
static void cyc_selfcheck() {
  Fp12 e = FP12_ONE_;
  e.c0.c1.c0 = MONT_ONE;
  e.c1.c0.c1 = MONT_ONE;
  e.c1.c2.c0 = MONT_ONE;
  Fp12 c, inv, u, fr;
  fp12_conj(c, e);
  fp12_inv(inv, e);
  fp12_mul(u, c, inv);
  fp12_frobenius(fr, u);
  fp12_frobenius(fr, fr);
  fp12_mul(u, fr, u);  // cyclotomic
  Fp12 a, b;
  CYC_OK = true;
  fp12_sqr_cyc(a, u);
  fp12_sqr_fast(b, u);
  CYC_OK = fp12_eq(a, b);
}

// ===========================================================================
// Keccak / SHAKE-256 (for the XOF-based hash-to-curve, oracle-compatible)
// ===========================================================================

static const u64 KECCAK_RC[24] = {
    0x0000000000000001ull, 0x0000000000008082ull, 0x800000000000808aull,
    0x8000000080008000ull, 0x000000000000808bull, 0x0000000080000001ull,
    0x8000000080008081ull, 0x8000000000008009ull, 0x000000000000008aull,
    0x0000000000000088ull, 0x0000000080008009ull, 0x000000008000000aull,
    0x000000008000808bull, 0x800000000000008bull, 0x8000000000008089ull,
    0x8000000000008003ull, 0x8000000000008002ull, 0x8000000000000080ull,
    0x000000000000800aull, 0x800000008000000aull, 0x8000000080008081ull,
    0x8000000000008080ull, 0x0000000080000001ull, 0x8000000080008008ull};

static const int KECCAK_ROT[5][5] = {{0, 36, 3, 41, 18},
                                     {1, 44, 10, 45, 2},
                                     {62, 6, 43, 15, 61},
                                     {28, 55, 25, 21, 56},
                                     {27, 20, 39, 8, 14}};

static inline u64 rol64(u64 v, int s) {
  return s == 0 ? v : (v << s) | (v >> (64 - s));
}

static void keccak_f(u64 a[5][5]) {
  for (int rnd = 0; rnd < 24; rnd++) {
    u64 c[5], d[5];
    for (int x = 0; x < 5; x++)
      c[x] = a[x][0] ^ a[x][1] ^ a[x][2] ^ a[x][3] ^ a[x][4];
    for (int x = 0; x < 5; x++)
      d[x] = c[(x + 4) % 5] ^ rol64(c[(x + 1) % 5], 1);
    for (int x = 0; x < 5; x++)
      for (int y = 0; y < 5; y++) a[x][y] ^= d[x];
    u64 b[5][5];
    for (int x = 0; x < 5; x++)
      for (int y = 0; y < 5; y++)
        b[y][(2 * x + 3 * y) % 5] = rol64(a[x][y], KECCAK_ROT[x][y]);
    for (int x = 0; x < 5; x++)
      for (int y = 0; y < 5; y++)
        a[x][y] = b[x][y] ^ ((~b[(x + 1) % 5][y]) & b[(x + 2) % 5][y]);
    a[0][0] ^= KECCAK_RC[rnd];
  }
}

// sponge with given rate and domain-pad byte
static void keccak_sponge(uint8_t *out, size_t outlen, const uint8_t *in,
                          size_t inlen, size_t rate, uint8_t pad) {
  u64 st[5][5];
  memset(st, 0, sizeof(st));
  std::vector<uint8_t> buf(in, in + inlen);
  buf.push_back(pad);
  while (buf.size() % rate) buf.push_back(0);
  buf[buf.size() - 1] |= 0x80;
  for (size_t off = 0; off < buf.size(); off += rate) {
    for (size_t i = 0; i < rate / 8; i++) {
      u64 lane = 0;
      for (int j = 7; j >= 0; j--) lane = (lane << 8) | buf[off + i * 8 + j];
      st[i % 5][i / 5] ^= lane;
    }
    keccak_f(st);
  }
  size_t produced = 0;
  while (produced < outlen) {
    for (size_t i = 0; i < rate / 8 && produced < outlen; i++) {
      u64 lane = st[i % 5][i / 5];
      for (int j = 0; j < 8 && produced < outlen; j++) {
        out[produced++] = (uint8_t)(lane >> (8 * j));
      }
    }
    if (produced < outlen) keccak_f(st);
  }
}

static void shake256(uint8_t *out, size_t outlen, const uint8_t *in,
                     size_t inlen) {
  keccak_sponge(out, outlen, in, inlen, 136, 0x1f);
}

extern "C" void lt_keccak256(const uint8_t *in, size_t inlen,
                             uint8_t out[32]) {
  keccak_sponge(out, 32, in, inlen, 136, 0x01);
}

// n keccak256 digests in one crossing: item i is data[offsets[i],
// offsets[i+1]) (offsets has n+1 entries), out is n*32 bytes. The trie
// commit hashes ~100k node encodings per 10k-tx block and per-call ctypes
// dispatch dominates; same partitioning discipline as lt_g1_mul_batch,
// GIL released by ctypes so worker threads overlap. returns 0 ok.
extern "C" int lt_keccak256_batch(const uint8_t *data, const uint64_t *offsets,
                                  size_t n, int nthreads, uint8_t *out) {
  if (!data && n > 0 && offsets[n] > 0) return 1;
  if (nthreads <= 1 || n < 64) {
    for (size_t i = 0; i < n; i++)
      keccak_sponge(out + i * 32, 32, data + offsets[i],
                    (size_t)(offsets[i + 1] - offsets[i]), 136, 0x01);
    return 0;
  }
  if ((size_t)nthreads > n / 2) nthreads = (int)(n / 2);
  std::vector<std::thread> ts;
  ts.reserve(nthreads);
  for (int t = 0; t < nthreads; t++) {
    size_t lo = n * t / nthreads, hi = n * (t + 1) / nthreads;
    ts.emplace_back([&, lo, hi]() {
      for (size_t i = lo; i < hi; i++)
        keccak_sponge(out + i * 32, 32, data + offsets[i],
                      (size_t)(offsets[i + 1] - offsets[i]), 136, 0x01);
    });
  }
  for (auto &th : ts) th.join();
  return 0;
}

// xof(domain, data, n) — must match the oracle: shake256(len(dom)||dom||data)
static void xof(uint8_t *out, size_t outlen, const uint8_t *dom, size_t domlen,
                const uint8_t *data, size_t datalen) {
  std::vector<uint8_t> buf;
  buf.push_back((uint8_t)domlen);
  buf.insert(buf.end(), dom, dom + domlen);
  buf.insert(buf.end(), data, data + datalen);
  shake256(out, outlen, buf.data(), buf.size());
}

// ===========================================================================
// Hash-to-curve (try-and-increment, identical control flow to the oracle)
// ===========================================================================

// big-endian bytes -> Fp via mod p (generic width)
static Fp make_mont_u64(u64 x) {
  Fp z;
  fp_set_u64(z, x);
  return z;
}

static void fp_from_wide_be(Fp &z, const uint8_t *in, size_t len) {
  // Horner in base 2^8 over Montgomery field elements: digit-by-digit.
  // mont(256) precomputed once — as a magic static (guarded init): the
  // hand-rolled `bool init256` latch here was a data race when two
  // threads hash-to-curve concurrently (lt_g2_hash from the verify pool)
  static const Fp mont256 = make_mont_u64(256);
  Fp acc;
  memset(acc.v, 0, 48);
  for (size_t i = 0; i < len; i++) {
    fp_mul(acc, acc, mont256);
    Fp d;
    fp_set_u64(d, in[i]);
    fp_add(acc, acc, d);
  }
  z = acc;
}

static const char H_G1_HEX[] = "396c8c005555e1568c00aaab0000aaab";
static const char H_G2_HEX[] =
    "5d543a95414e7f1091d50792876a202cd91de4547085abaa68a205b2e5a7ddfa628f1cb4"
    "d9e82ef21537e293a6691ae1616ec6e786f0c70cf1c38e31c7238e5";

static std::vector<uint8_t> hex_to_bytes(const char *hex) {
  size_t n = strlen(hex);
  std::vector<uint8_t> out;
  size_t i = 0;
  if (n % 2) {  // odd-length: first nibble alone
    char c = hex[0];
    out.push_back((uint8_t)(c <= '9' ? c - '0' : c - 'a' + 10));
    i = 1;
  }
  for (; i < n; i += 2) {
    auto nib = [](char c) -> uint8_t {
      return c <= '9' ? c - '0' : c - 'a' + 10;
    };
    out.push_back((uint8_t)((nib(hex[i]) << 4) | nib(hex[i + 1])));
  }
  return out;
}

static std::vector<uint8_t> H_G1_BYTES, H_G2_BYTES;

// compare y > p - y  (plain form comparison on byte serialization)
static bool fp_gt_neg(const Fp &y) {
  Fp ny;
  fp_neg(ny, y);
  uint8_t yb[48], nyb[48];
  fp_to_bytes_be(yb, y);
  fp_to_bytes_be(nyb, ny);
  return memcmp(yb, nyb, 48) > 0;
}

extern "C" int lt_hash_to_g1(const uint8_t *msg, size_t msglen,
                             const uint8_t *dom, size_t domlen,
                             uint8_t out[96]) {
  for (uint32_t ctr = 0;; ctr++) {
    std::vector<uint8_t> d(dom, dom + domlen);
    d.push_back('|');
    for (int i = 3; i >= 0; i--) d.push_back((uint8_t)(ctr >> (8 * i)));
    uint8_t xb[64];
    xof(xb, 64, d.data(), d.size(), msg, msglen);
    Fp x;
    fp_from_wide_be(x, xb, 64);
    Fp rhs, four;
    fp_sqr(rhs, x);
    fp_mul(rhs, rhs, x);
    fp_set_u64(four, 4);
    fp_add(rhs, rhs, four);
    Fp y;
    if (fp_sqrt(y, rhs)) {
      if (fp_gt_neg(y)) fp_neg(y, y);
      G1 p;
      p.x = x;
      p.y = y;
      p.z = MONT_ONE;
      G1 cleared;
      g1_mul_scalar(cleared, p, H_G1_BYTES.data(), H_G1_BYTES.size());
      g1_to_bytes(out, cleared);
      return 0;
    }
  }
}

// lexicographic comparison matching the oracle: (y1, y0) > (p-y1, p-y0)
static bool fp2_gt_neg(const Fp2 &y) {
  Fp ny0, ny1;
  fp_neg(ny0, y.c0);
  fp_neg(ny1, y.c1);
  uint8_t a1[48], b1[48];
  fp_to_bytes_be(a1, y.c1);
  fp_to_bytes_be(b1, ny1);
  int c = memcmp(a1, b1, 48);
  if (c != 0) return c > 0;
  uint8_t a0[48], b0[48];
  fp_to_bytes_be(a0, y.c0);
  fp_to_bytes_be(b0, ny0);
  return memcmp(a0, b0, 48) > 0;
}

extern "C" int lt_hash_to_g2(const uint8_t *msg, size_t msglen,
                             const uint8_t *dom, size_t domlen,
                             uint8_t out[192]) {
  Fp four;
  fp_set_u64(four, 4);
  Fp2 b2;
  b2.c0 = four;
  b2.c1 = four;
  for (uint32_t ctr = 0;; ctr++) {
    std::vector<uint8_t> d(dom, dom + domlen);
    d.push_back('|');
    for (int i = 3; i >= 0; i--) d.push_back((uint8_t)(ctr >> (8 * i)));
    uint8_t xb[128];
    xof(xb, 128, d.data(), d.size(), msg, msglen);
    Fp2 x;
    fp_from_wide_be(x.c0, xb, 64);
    fp_from_wide_be(x.c1, xb + 64, 64);
    Fp2 rhs;
    fp2_sqr(rhs, x);
    fp2_mul(rhs, rhs, x);
    fp2_add(rhs, rhs, b2);
    Fp2 y;
    if (fp2_sqrt(y, rhs)) {
      if (fp2_gt_neg(y)) fp2_neg(y, y);
      G2 p;
      p.x = x;
      p.y = y;
      p.z = FP2_ONE_;
      G2 cleared;
      g2_mul_scalar(cleared, p, H_G2_BYTES.data(), H_G2_BYTES.size());
      g2_to_bytes(out, cleared);
      return 0;
    }
  }
}

// ===========================================================================
// Initialization
// ===========================================================================

static void compute_pinv() {
  u64 x = 1;
  for (int i = 0; i < 6; i++) x *= 2 - P_LIMBS[0] * x;  // Newton, 2^64
  PINV = (u64)(0 - x);
}

// Differential self-check for the ADX multiplication: drive both paths over
// a pseudorandom walk plus the edge values (0, 1, R, p-1 in Montgomery
// form); ANY mismatch keeps the portable path. Also pins the asm's baked-in
// pinv constant against the computed one.
static void adx_selfcheck() {
#ifdef LT_HAVE_ADX_BUILD
  if (PINV != 0x89f3fffcfffcfffdull) return;  // asm constant would be wrong
  Fp pm1;  // p - 1 (a valid residue; Montgomery form irrelevant for check)
  for (int i = 0; i < 6; i++) pm1.v[i] = P_LIMBS[i];
  pm1.v[0] -= 1;
  Fp cases[4] = {FP_ZERO, MONT_ONE, MONT_R2, pm1};
  u64 seed = 0x9e3779b97f4a7c15ull;
  Fp a = MONT_R2, b = MONT_ONE;
  for (int iter = 0; iter < 64; iter++) {
    if (iter < 16) {
      a = cases[iter % 4];
      b = cases[(iter / 4) % 4];
    } else {  // xorshift walk keeps values "random" but reproducible
      for (int i = 0; i < 6; i++) {
        seed ^= seed << 13;
        seed ^= seed >> 7;
        seed ^= seed << 17;
        a.v[i] ^= seed & 0x7fffffffffffffffull;
      }
      // reduce below p by clearing the top limb's high bits
      a.v[5] &= 0x0fffffffffffffffull;
    }
    Fp zc, za;
    fp_mul_c(zc, a, b);
    lt_fp_mul_adx(za.v, a.v, b.v);
    if (!fp_eq(zc, za)) return;
    b = zc;  // feed results forward
  }
  HAVE_ADX = true;
#endif
}

static struct Init {
  Init() {
    compute_pinv();
    memset(FP_ZERO.v, 0, 48);
    // MONT_ONE = 2^384 mod p by repeated doubling of 1 (plain)
    u64 one[6] = {1, 0, 0, 0, 0, 0};
    u64 acc[6];
    memcpy(acc, one, 48);
    for (int i = 0; i < 384; i++) {
      u64 t[6];
      memcpy(t, acc, 48);
      u128 carry = 0;
      for (int j = 0; j < 6; j++) {
        u128 cur = ((u128)t[j] << 1) | (u64)carry;
        t[j] = (u64)cur;
        carry = cur >> 64;
      }
      // t might exceed p: subtract until < p (carry can be 1: value < 2^385,
      // p > 2^380 so at most 16 subtractions; loop for safety)
      while (carry || cmp_limbs(t, P_LIMBS, 6) >= 0) {
        u128 borrow = 0;
        for (int j = 0; j < 6; j++) {
          u128 cur = (u128)t[j] - P_LIMBS[j] - (u64)borrow;
          t[j] = (u64)cur;
          borrow = (cur >> 64) ? 1 : 0;
        }
        if (carry && !borrow) {
        }
        if (borrow && carry) carry = 0;  // consumed the overflow bit
        else if (borrow && !carry) {     // went negative — undo (can't happen)
          u128 c2 = 0;
          for (int j = 0; j < 6; j++) {
            u128 cur = (u128)t[j] + P_LIMBS[j] + (u64)c2;
            t[j] = (u64)cur;
            c2 = cur >> 64;
          }
          break;
        }
      }
      memcpy(acc, t, 48);
    }
    memcpy(MONT_ONE.v, acc, 48);
    // MONT_R2 = mont_one "squared" as plain mult needs montmul(R,R)=R^2*R^-1=R
    // Instead: compute R2 = 2^768 mod p by doubling MONT_ONE 384 more times.
    for (int i = 0; i < 384; i++) {
      u64 t[6];
      memcpy(t, acc, 48);
      u128 carry = 0;
      for (int j = 0; j < 6; j++) {
        u128 cur = ((u128)t[j] << 1) | (u64)carry;
        t[j] = (u64)cur;
        carry = cur >> 64;
      }
      while (carry || cmp_limbs(t, P_LIMBS, 6) >= 0) {
        u128 borrow = 0;
        for (int j = 0; j < 6; j++) {
          u128 cur = (u128)t[j] - P_LIMBS[j] - (u64)borrow;
          t[j] = (u64)cur;
          borrow = (cur >> 64) ? 1 : 0;
        }
        if (borrow && carry)
          carry = 0;
        else if (borrow && !carry) {
          u128 c2 = 0;
          for (int j = 0; j < 6; j++) {
            u128 cur = (u128)t[j] + P_LIMBS[j] + (u64)c2;
            t[j] = (u64)cur;
            c2 = cur >> 64;
          }
          break;
        }
      }
      memcpy(acc, t, 48);
    }
    memcpy(MONT_R2.v, acc, 48);
    fp_mul(MONT_R3, MONT_R2, MONT_R2);  // R2*R2*R^-1 = R^3

    // (p+1)/4
    u64 pp1[6];
    memcpy(pp1, P_LIMBS, 48);
    u128 carry = (u128)pp1[0] + 1;
    pp1[0] = (u64)carry;
    for (int j = 1; carry >> 64 && j < 6; j++) {
      carry = (u128)pp1[j] + 1;
      pp1[j] = (u64)carry;
    }
    limbs_rshift1(pp1, 6);
    limbs_rshift1(pp1, 6);
    memcpy(P_PLUS1_DIV4, pp1, 48);

    FP2_ZERO_.c0 = FP_ZERO;
    FP2_ZERO_.c1 = FP_ZERO;
    FP2_ONE_.c0 = MONT_ONE;
    FP2_ONE_.c1 = FP_ZERO;
    FP6_ZERO_.c0 = FP2_ZERO_;
    FP6_ZERO_.c1 = FP2_ZERO_;
    FP6_ZERO_.c2 = FP2_ZERO_;
    FP6_ONE_ = FP6_ZERO_;
    FP6_ONE_.c0 = FP2_ONE_;
    FP12_ZERO_.c0 = FP6_ZERO_;
    FP12_ZERO_.c1 = FP6_ZERO_;
    FP12_ONE_ = FP12_ZERO_;
    FP12_ONE_.c0 = FP6_ONE_;

    G1_INF_.x = FP_ZERO;
    G1_INF_.y = MONT_ONE;
    G1_INF_.z = FP_ZERO;
    G2_INF_.x = FP2_ZERO_;
    G2_INF_.y = FP2_ONE_;
    G2_INF_.z = FP2_ZERO_;

    // gammas: xi^((p-1)/6 * i).  (p-1)/6 via limb division by 6.
    u64 pm1[6];
    memcpy(pm1, P_LIMBS, 48);
    pm1[0] -= 1;  // p is odd, no borrow
    // divide by 6
    u64 quot[6];
    u128 rem = 0;
    for (int i = 5; i >= 0; i--) {
      u128 cur = (rem << 64) | pm1[i];
      quot[i] = (u64)(cur / 6);
      rem = cur % 6;
    }
    Fp2 xi;
    xi.c0 = MONT_ONE;
    xi.c1 = MONT_ONE;
    GAMMA[0] = FP2_ONE_;
    Fp2 g1x;
    fp2_pow_limbs(g1x, xi, quot, 6);
    GAMMA[1] = g1x;
    for (int i = 2; i < 6; i++) fp2_mul(GAMMA[i], GAMMA[i - 1], GAMMA[1]);

    H_G1_BYTES = hex_to_bytes(H_G1_HEX);
    H_G2_BYTES = hex_to_bytes(H_G2_HEX);

    // GLV constants: z^2, lambda = z^2 - 1, and Barrett MU = floor(2^384/r)
    {
      const u64 zabs = 0xd201000000010000ull;
      u128 z2 = (u128)zabs * zabs;
      Z2_LIMBS[0] = (u64)z2;
      Z2_LIMBS[1] = (u64)(z2 >> 64);
      u128 lam = z2 - 1;
      LAM_LIMBS[0] = (u64)lam;
      LAM_LIMBS[1] = (u64)(lam >> 64);
      // binary long division of 2^384 by r: 385 shift-subtract steps
      u64 rem[5] = {0, 0, 0, 0, 0}, q[7] = {0, 0, 0, 0, 0, 0, 0};
      u64 rw[5] = {R_LIMBS[0], R_LIMBS[1], R_LIMBS[2], R_LIMBS[3], 0};
      for (int bit = 384; bit >= 0; bit--) {
        // rem = rem*2 + numerator_bit (numerator = 2^384)
        u64 carry = bit == 384 ? 1 : 0;
        for (int i = 0; i < 5; i++) {
          u64 hi = rem[i] >> 63;
          rem[i] = (rem[i] << 1) | carry;
          carry = hi;
        }
        u64 t[5];
        memcpy(t, rem, 40);
        if (!limbs_sub(t, rw, 5)) {
          memcpy(rem, t, 40);
          q[bit / 64] |= 1ull << (bit % 64);
        }
      }
      MU384[0] = q[0];
      MU384[1] = q[1];
      MU384[2] = q[2];  // MU < 2^130: limbs 3+ are zero
    }

    adx_selfcheck();
    cyc_selfcheck();
  }
} _init;

// ===========================================================================
// Exported API (ctypes-friendly, byte-buffer based)
// ===========================================================================

extern "C" {

// returns 0 ok; 1 bad point encoding
int lt_g1_mul(const uint8_t in[96], const uint8_t scalar[32],
              uint8_t out[96]) {
  G1 p;
  if (!g1_from_bytes(p, in)) return 1;
  G1 r;
  g1_mul_scalar(r, p, scalar, 32);
  g1_to_bytes(out, r);
  return 0;
}

int lt_g2_mul(const uint8_t in[192], const uint8_t scalar[32],
              uint8_t out[192]) {
  G2 p;
  if (!g2_from_bytes(p, in)) return 1;
  G2 r;
  g2_mul_scalar(r, p, scalar, 32);
  g2_to_bytes(out, r);
  return 0;
}

// n independent G1 scalar muls (out[i] = pts[i] * scalars[i]) partitioned
// across threads — the TPKE decrypt-share shape: one node emits U^{x_i} for
// every ready ACS slot in one era tick, and per-call ctypes+spawn overhead
// would eat the win mul-by-mul. nthreads <= 1 or tiny n stays serial.
// returns 0 ok; 1 bad point encoding.
int lt_g1_mul_batch(const uint8_t *pts, const uint8_t *scalars, size_t n,
                    int nthreads, uint8_t *out) {
  if (nthreads <= 1 || n < 8) {
    for (size_t i = 0; i < n; i++) {
      G1 p;
      if (!g1_from_bytes(p, pts + i * 96)) return 1;
      G1 r;
      g1_mul_scalar(r, p, scalars + i * 32, 32);
      g1_to_bytes(out + i * 96, r);
    }
    return 0;
  }
  if ((size_t)nthreads > n / 2) nthreads = (int)(n / 2);
  std::vector<int> bad(nthreads, 0);
  std::vector<std::thread> ts;
  ts.reserve(nthreads);
  for (int t = 0; t < nthreads; t++) {
    size_t lo = n * t / nthreads, hi = n * (t + 1) / nthreads;
    ts.emplace_back([&, t, lo, hi]() {
      for (size_t i = lo; i < hi; i++) {
        G1 p;
        if (!g1_from_bytes(p, pts + i * 96)) {
          bad[t] = 1;
          return;
        }
        G1 r;
        g1_mul_scalar(r, p, scalars + i * 32, 32);
        g1_to_bytes(out + i * 96, r);
      }
    });
  }
  for (auto &th : ts) th.join();
  for (int t = 0; t < nthreads; t++)
    if (bad[t]) return 1;
  return 0;
}

int lt_g1_add(const uint8_t a[96], const uint8_t b[96], uint8_t out[96]) {
  G1 pa, pb;
  if (!g1_from_bytes(pa, a) || !g1_from_bytes(pb, b)) return 1;
  G1 r;
  g1_add(r, pa, pb);
  g1_to_bytes(out, r);
  return 0;
}

int lt_g2_add(const uint8_t a[192], const uint8_t b[192], uint8_t out[192]) {
  G2 pa, pb;
  if (!g2_from_bytes(pa, a) || !g2_from_bytes(pb, b)) return 1;
  G2 r;
  g2_add(r, pa, pb);
  g2_to_bytes(out, r);
  return 0;
}

// MSM over G1. pts: n*96 bytes, scalars: n*32 bytes BE.
// Small/medium n (every consensus shape: Lagrange combines at t+1, era
// aggregates at N) takes the Straus/GLV path; huge n falls back to
// Pippenger, whose shared buckets only win once n outgrows the GLV
// window tables.
//
// CONTRACT: points must be members of the prime-order subgroup. The GLV
// path reduces scalars mod r and uses the phi endomorphism, both of which
// are only multiplication-compatible on the subgroup — an on-curve point
// outside it gets an n-DEPENDENT answer (Straus vs Pippenger disagree).
// Every production caller enforces this at wire-parse time
// (native_backend.py routes deserialization through lt_g1_check == 2).
int lt_g1_msm(const uint8_t *pts, const uint8_t *scalars, size_t n,
              uint8_t out[96]) {
  std::vector<G1> points(n);
  for (size_t i = 0; i < n; i++)
    if (!g1_from_bytes(points[i], pts + i * 96)) return 1;
  if (n >= 1 && n <= 256) {
    G1 total;
    g1_msm_straus(total, points.data(), scalars, n);
    g1_to_bytes(out, total);
    return 0;
  }
  const int c = n < 32 ? 4 : (n < 512 ? 8 : 12);
  const int nbuckets = (1 << c) - 1;
  const int nwindows = (256 + c - 1) / c;
  G1 total = G1_INF_;
  std::vector<G1> buckets(nbuckets);
  for (int w = nwindows - 1; w >= 0; w--) {
    for (int i = 0; i < c; i++) g1_dbl(total, total);
    for (int b = 0; b < nbuckets; b++) buckets[b] = G1_INF_;
    for (size_t i = 0; i < n; i++) {
      int bitpos = w * c;
      // extract c bits starting at bitpos (LSB order) from BE scalar
      u64 frag = 0;
      for (int b = 0; b < c; b++) {
        int bit = bitpos + b;
        if (bit >= 256) break;
        int byte_idx = 31 - bit / 8;
        if ((scalars[i * 32 + byte_idx] >> (bit % 8)) & 1) frag |= 1ull << b;
      }
      if (frag) g1_add(buckets[frag - 1], buckets[frag - 1], points[i]);
    }
    G1 run = G1_INF_, sum = G1_INF_;
    for (int b = nbuckets - 1; b >= 0; b--) {
      g1_add(run, run, buckets[b]);
      g1_add(sum, sum, run);
    }
    g1_add(total, total, sum);
  }
  g1_to_bytes(out, total);
  return 0;
}

int lt_g2_msm(const uint8_t *pts, const uint8_t *scalars, size_t n,
              uint8_t out[192]) {
  std::vector<G2> points(n);
  for (size_t i = 0; i < n; i++)
    if (!g2_from_bytes(points[i], pts + i * 192)) return 1;
  const int c = n < 32 ? 4 : 8;
  const int nbuckets = (1 << c) - 1;
  const int nwindows = (256 + c - 1) / c;
  G2 total = G2_INF_;
  std::vector<G2> buckets(nbuckets);
  for (int w = nwindows - 1; w >= 0; w--) {
    for (int i = 0; i < c; i++) g2_dbl(total, total);
    for (int b = 0; b < nbuckets; b++) buckets[b] = G2_INF_;
    for (size_t i = 0; i < n; i++) {
      int bitpos = w * c;
      u64 frag = 0;
      for (int b = 0; b < c; b++) {
        int bit = bitpos + b;
        if (bit >= 256) break;
        int byte_idx = 31 - bit / 8;
        if ((scalars[i * 32 + byte_idx] >> (bit % 8)) & 1) frag |= 1ull << b;
      }
      if (frag) g2_add(buckets[frag - 1], buckets[frag - 1], points[i]);
    }
    G2 run = G2_INF_, sum = G2_INF_;
    for (int b = nbuckets - 1; b >= 0; b--) {
      g2_add(run, run, buckets[b]);
      g2_add(sum, sum, run);
    }
    g2_add(total, total, sum);
  }
  g2_to_bytes(out, total);
  return 0;
}

// Prod e(Pi, Qi) == 1?  returns 1 yes, 0 no, -1 bad encoding.
int lt_pairing_check(const uint8_t *g1s, const uint8_t *g2s, size_t n) {
  std::vector<MLState> states(n);
  std::vector<G1> ps(n);
  std::vector<G2> qs(n);
  for (size_t i = 0; i < n; i++) {
    if (!g1_from_bytes(ps[i], g1s + i * 96)) return -1;
    if (!g2_from_bytes(qs[i], g2s + i * 192)) return -1;
  }
  ml_init_batch(states.data(), ps.data(), qs.data(), n);
  Fp12 f;
  miller_loop_multi(f, states.data(), n);
  Fp12 e;
  final_exponentiation(e, f);
  return fp12_is_one(e) ? 1 : 0;
}

// Threaded variant for the era-sized grand product (2S pairs at N=64):
// Miller loops are independent, so partition them across threads, multiply
// the partial Fp12 products, and run ONE shared final exponentiation.
// nthreads <= 1 falls back to the serial loop above.
int lt_pairing_check_mt(const uint8_t *g1s, const uint8_t *g2s, size_t n,
                        int nthreads) {
  if (nthreads <= 1 || n < 8) return lt_pairing_check(g1s, g2s, n);
  if ((size_t)nthreads > n / 2) nthreads = (int)(n / 2);
  std::vector<Fp12> partial(nthreads, FP12_ONE_);
  std::vector<int> bad(nthreads, 0);
  std::vector<std::thread> ts;
  ts.reserve(nthreads);
  for (int t = 0; t < nthreads; t++) {
    size_t lo = n * t / nthreads, hi = n * (t + 1) / nthreads;
    ts.emplace_back([&, t, lo, hi]() {
      std::vector<MLState> states(hi - lo);
      std::vector<G1> ps(hi - lo);
      std::vector<G2> qs(hi - lo);
      for (size_t i = lo; i < hi; i++) {
        if (!g1_from_bytes(ps[i - lo], g1s + i * 96) ||
            !g2_from_bytes(qs[i - lo], g2s + i * 192)) {
          bad[t] = 1;
          return;
        }
      }
      ml_init_batch(states.data(), ps.data(), qs.data(), hi - lo);
      Fp12 f;
      miller_loop_multi(f, states.data(), hi - lo);
      partial[t] = f;
    });
  }
  for (auto &th : ts) th.join();
  for (int t = 0; t < nthreads; t++)
    if (bad[t]) return -1;
  Fp12 f = FP12_ONE_;
  for (int t = 0; t < nthreads; t++) {
    Fp12 tmp;
    fp12_mul(tmp, f, partial[t]);
    f = tmp;
  }
  Fp12 e;
  final_exponentiation(e, f);
  return fp12_is_one(e) ? 1 : 0;
}

// GT output for conformance tests: 576 bytes (12 x 48, oracle order)
int lt_multi_pairing(const uint8_t *g1s, const uint8_t *g2s, size_t n,
                     uint8_t out[576]) {
  Fp12 f = FP12_ONE_;
  for (size_t i = 0; i < n; i++) {
    G1 p;
    G2 q;
    if (!g1_from_bytes(p, g1s + i * 96)) return -1;
    if (!g2_from_bytes(q, g2s + i * 192)) return -1;
    Fp12 m;
    miller_loop(m, p, q);
    Fp12 t;
    fp12_mul(t, f, m);
    f = t;
  }
  Fp12 e;
  final_exponentiation(e, f);
  const Fp2 *cs[6] = {&e.c0.c0, &e.c0.c1, &e.c0.c2,
                      &e.c1.c0, &e.c1.c1, &e.c1.c2};
  for (int i = 0; i < 6; i++) {
    fp_to_bytes_be(out + i * 96, cs[i]->c0);
    fp_to_bytes_be(out + i * 96 + 48, cs[i]->c1);
  }
  return 0;
}

// point validation: 1 valid-on-curve, 2 also-in-subgroup, 0 invalid
int lt_g1_check(const uint8_t in[96]) {
  G1 p;
  if (!g1_from_bytes(p, in)) return 0;
  return g1_in_subgroup(p) ? 2 : 1;
}
int lt_g2_check(const uint8_t in[192]) {
  G2 p;
  if (!g2_from_bytes(p, in)) return 0;
  return g2_in_subgroup(p) ? 2 : 1;
}

// Reference-style SERIAL per-share verification loop (the baseline we beat):
// for each i: e(U_i, H) == e(Y_i, W). Writes 0/1 into results[i].
// Mirrors the per-message verify in the reference's HoneyBadger
// (HoneyBadger.cs:205-217) — 2 pairings per share, no batching.
int lt_tpke_verify_shares_serial(const uint8_t *uis, const uint8_t *yis,
                                 size_t n, const uint8_t h[192],
                                 const uint8_t w[192], uint8_t *results) {
  G2 H, W;
  if (!g2_from_bytes(H, h) || !g2_from_bytes(W, w)) return -1;
  for (size_t i = 0; i < n; i++) {
    G1 u, y;
    if (!g1_from_bytes(u, uis + i * 96)) return -1;
    if (!g1_from_bytes(y, yis + i * 96)) return -1;
    G1 yneg;
    g1_neg(yneg, y);
    Fp12 m1, m2, f, e;
    miller_loop(m1, u, H);
    miller_loop(m2, yneg, W);
    fp12_mul(f, m1, m2);
    final_exponentiation(e, f);
    results[i] = fp12_is_one(e) ? 1 : 0;
  }
  return 0;
}

int lt_version() { return 1; }
}

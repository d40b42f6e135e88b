// Native consensus runtime: message router + flood-protocol state machines.
//
// The port's copy of lachain_tpu/consensus/native/consensus_rt.cpp, its
// engine unchanged: the delivery RNG and queue, the flood state machines,
// the message layers of the crypto protocols, the keccak and RS codec, the
// XO_* / PO_* / RQ_* enums, OwnMask, the opaque kinds and the C API are the
// reference's, so that one seed gives the same execution in both packages
// (tests/test_torch_native_rt.py). Built by lachain_tpu_torch/ops/_build.py
// consensus_library() and bound by lachain_tpu_torch/consensus/native_rt.py,
// which drains the flight recorder (rt_trace_*) into utils/tracing.py.
//
// Role: the C# reference runs one OS thread + one queue per protocol
// instance (src/Lachain.Consensus/AbstractProtocol.cs:11-168) and a central
// test DeliveryService (test/Lachain.ConsensusTest/DeliverySerivce.cs).
// This engine runs the HOT 90% of consensus traffic: BinaryBroadcast
// (BVAL/AUX/CONF), ReliableBroadcast (VAL/ECHO/READY, with GF(2^8)
// Reed-Solomon + keccak Merkle commitments), BinaryAgreement and
// CommonSubset natively; it owns the message state machines of the
// crypto-bearing protocols (CommonCoin, HoneyBadger, RootProtocol), whose
// cryptography stays in Python host shims (native_hosts.py) reached through
// batched crossings; a protocol that a validator keeps in Python transits
// this engine as opaque payloads.
//
// The logic mirrors the Python protocols statement-for-statement
// (consensus/{binary_broadcast,binary_agreement,reliable_broadcast,
// common_subset}.py) so that a TAKE_FIRST run is bit-identical to the
// Python simulator.
//
// Single-threaded by design: determinism (same seed -> same execution,
// including adversarial reorderings) is the property the reference's
// thread-based harness only approximates.
#include <algorithm>
#include <array>
#include <chrono>
#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <deque>
#include <map>
#include <set>
#include <string>
#include <unordered_map>
#include <unordered_set>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// Keccak-256 (legacy 0x01 padding — Ethereum style, matches
// crypto/hashes.py::keccak256)
// ---------------------------------------------------------------------------

static const uint64_t KC_RC[24] = {
    0x0000000000000001ULL, 0x0000000000008082ULL, 0x800000000000808AULL,
    0x8000000080008000ULL, 0x000000000000808BULL, 0x0000000080000001ULL,
    0x8000000080008081ULL, 0x8000000000008009ULL, 0x000000000000008AULL,
    0x0000000000000088ULL, 0x0000000080008009ULL, 0x000000008000000AULL,
    0x000000008000808BULL, 0x800000000000008BULL, 0x8000000000008089ULL,
    0x8000000000008003ULL, 0x8000000000008002ULL, 0x8000000000000080ULL,
    0x000000000000800AULL, 0x800000008000000AULL, 0x8000000080008081ULL,
    0x8000000000008080ULL, 0x0000000080000001ULL, 0x8000000080008008ULL,
};
static const int KC_ROT[5][5] = {
    {0, 36, 3, 41, 18},
    {1, 44, 10, 45, 2},
    {62, 6, 43, 15, 61},
    {28, 55, 25, 21, 56},
    {27, 20, 39, 8, 14},
};

static inline uint64_t rol64(uint64_t v, int s) {
  return s == 0 ? v : (v << s) | (v >> (64 - s));
}

static void keccak_f(uint64_t a[5][5]) {
  uint64_t b[5][5], c[5], d[5];
  for (int rnd = 0; rnd < 24; rnd++) {
    for (int x = 0; x < 5; x++)
      c[x] = a[x][0] ^ a[x][1] ^ a[x][2] ^ a[x][3] ^ a[x][4];
    for (int x = 0; x < 5; x++)
      d[x] = c[(x + 4) % 5] ^ rol64(c[(x + 1) % 5], 1);
    for (int x = 0; x < 5; x++)
      for (int y = 0; y < 5; y++) a[x][y] ^= d[x];
    for (int x = 0; x < 5; x++)
      for (int y = 0; y < 5; y++)
        b[y][(2 * x + 3 * y) % 5] = rol64(a[x][y], KC_ROT[x][y]);
    for (int x = 0; x < 5; x++)
      for (int y = 0; y < 5; y++)
        a[x][y] = b[x][y] ^ ((~b[(x + 1) % 5][y]) & b[(x + 2) % 5][y]);
    a[0][0] ^= KC_RC[rnd];
  }
}

static void keccak256(const uint8_t* in, size_t inlen, uint8_t out[32]) {
  const size_t rate = 136;
  uint64_t st[5][5];
  std::memset(st, 0, sizeof(st));
  // absorb full blocks, then the padded tail
  size_t off = 0;
  uint8_t block[136];
  while (true) {
    size_t take = inlen - off >= rate ? rate : inlen - off;
    std::memcpy(block, in + off, take);
    bool last = take < rate;
    if (last) {
      std::memset(block + take, 0, rate - take);
      block[take] = 0x01;
      block[rate - 1] |= 0x80;
    }
    for (size_t i = 0; i < rate / 8; i++) {
      uint64_t lane;
      std::memcpy(&lane, block + i * 8, 8);  // little-endian host assumed
      st[i % 5][i / 5] ^= lane;
    }
    keccak_f(st);
    off += take;
    if (last) break;
    if (off == inlen) {
      // input length is an exact multiple of rate: one more padding-only block
      std::memset(block, 0, rate);
      block[0] = 0x01;
      block[rate - 1] |= 0x80;
      for (size_t i = 0; i < rate / 8; i++) {
        uint64_t lane;
        std::memcpy(&lane, block + i * 8, 8);
        st[i % 5][i / 5] ^= lane;
      }
      keccak_f(st);
      break;
    }
  }
  for (int i = 0; i < 4; i++) std::memcpy(out + i * 8, &st[i % 5][i / 5], 8);
}

static std::string keccak_s(const std::string& s) {
  uint8_t h[32];
  keccak256(reinterpret_cast<const uint8_t*>(s.data()), s.size(), h);
  return std::string(reinterpret_cast<char*>(h), 32);
}

// ---------------------------------------------------------------------------
// Merkle tree (crypto/hashes.py::merkle_root/proof/verify — odd leaf promoted
// unchanged, "" sentinel for missing sibling)
// ---------------------------------------------------------------------------

static std::string merkle_root(std::vector<std::string> level) {
  if (level.empty()) return std::string();
  while (level.size() > 1) {
    std::vector<std::string> nxt;
    for (size_t i = 0; i + 1 < level.size(); i += 2)
      nxt.push_back(keccak_s(level[i] + level[i + 1]));
    if (level.size() % 2) nxt.push_back(level.back());
    level.swap(nxt);
  }
  return level[0];
}

static std::vector<std::string> merkle_proof(std::vector<std::string> level,
                                             size_t index) {
  std::vector<std::string> proof;
  size_t idx = index;
  while (level.size() > 1) {
    std::vector<std::string> nxt;
    for (size_t i = 0; i + 1 < level.size(); i += 2)
      nxt.push_back(keccak_s(level[i] + level[i + 1]));
    if (level.size() % 2) nxt.push_back(level.back());
    size_t sib = idx ^ 1;
    proof.push_back(sib < level.size() ? level[sib] : std::string());
    idx /= 2;
    level.swap(nxt);
  }
  return proof;
}

static bool merkle_verify(const std::string& leaf, size_t index,
                          const std::vector<std::string>& proof,
                          const std::string& root) {
  std::string node = leaf;
  size_t idx = index;
  for (const auto& sib : proof) {
    if (sib.empty()) {
      // promoted unchanged
    } else if (idx % 2 == 0) {
      node = keccak_s(node + sib);
    } else {
      node = keccak_s(sib + node);
    }
    idx /= 2;
  }
  return node == root;
}

// ---------------------------------------------------------------------------
// GF(2^8) Reed-Solomon, poly 0x11D — exact mirror of ops/rs.py
// (Vandermonde evaluation at x = 1..n, 4-byte BE length prefix, first-k
// reconstruction) so native and Python validators compute identical shards
// and Merkle roots.
// ---------------------------------------------------------------------------

static uint8_t GF_EXP[512];
static int GF_LOG[256];
static uint8_t GF_MUL[256][256];

static void gf_init() {
  static bool done = false;
  if (done) return;
  done = true;
  int x = 1;
  for (int i = 0; i < 255; i++) {
    GF_EXP[i] = (uint8_t)x;
    GF_LOG[x] = i;
    x <<= 1;
    if (x & 0x100) x ^= 0x11D;
  }
  for (int i = 255; i < 512; i++) GF_EXP[i] = GF_EXP[i - 255];
  for (int a = 0; a < 256; a++)
    for (int b = 0; b < 256; b++)
      GF_MUL[a][b] =
          (a == 0 || b == 0) ? 0 : GF_EXP[GF_LOG[a] + GF_LOG[b]];
}

static inline uint8_t gf_inv(uint8_t a) { return GF_EXP[255 - GF_LOG[a]]; }

static std::vector<std::string> rs_encode(const std::string& data, int k,
                                          int n) {
  // 4-byte BE length prefix, zero-pad to k * shard_size (rs.py::encode)
  std::string prefixed;
  uint32_t len = (uint32_t)data.size();
  prefixed.push_back((char)(len >> 24));
  prefixed.push_back((char)(len >> 16));
  prefixed.push_back((char)(len >> 8));
  prefixed.push_back((char)len);
  prefixed += data;
  if (n > 255) {
    // GF(2^8) RS has only 255 distinct evaluation points; past that the
    // RBC degrades to whole-payload replication — every shard carries the
    // full length-prefixed payload (bandwidth n x |v| instead of the coded
    // optimum; ECHO/READY thresholds and the Merkle commitment are
    // unchanged). Mirrors ops/rs.py::encode; a GF(2^16) codec is the
    // planned upgrade (ROADMAP item 1).
    return std::vector<std::string>((size_t)n, prefixed);
  }
  size_t shard_size = (prefixed.size() + k - 1) / k;
  if (shard_size == 0) shard_size = 1;
  prefixed.resize((size_t)k * shard_size, '\0');
  std::vector<std::string> shards(n);
  std::vector<uint8_t> acc(shard_size);
  for (int xi = 1; xi <= n; xi++) {
    std::fill(acc.begin(), acc.end(), 0);
    const uint8_t* mulx = GF_MUL[xi];
    for (int j = k - 1; j >= 0; j--) {
      const uint8_t* coeff =
          reinterpret_cast<const uint8_t*>(prefixed.data()) + (size_t)j * shard_size;
      for (size_t b = 0; b < shard_size; b++)
        acc[b] = mulx[acc[b]] ^ coeff[b];
    }
    shards[xi - 1].assign(reinterpret_cast<char*>(acc.data()), shard_size);
  }
  return shards;
}

// Gauss-Jordan inverse over GF(2^8); returns false if singular.
static bool gf_mat_inv(std::vector<uint8_t>& a, std::vector<uint8_t>& inv,
                       int k) {
  inv.assign((size_t)k * k, 0);
  for (int i = 0; i < k; i++) inv[(size_t)i * k + i] = 1;
  for (int col = 0; col < k; col++) {
    int piv = -1;
    for (int r = col; r < k; r++)
      if (a[(size_t)r * k + col]) { piv = r; break; }
    if (piv < 0) return false;
    if (piv != col) {
      for (int c = 0; c < k; c++) {
        std::swap(a[(size_t)col * k + c], a[(size_t)piv * k + c]);
        std::swap(inv[(size_t)col * k + c], inv[(size_t)piv * k + c]);
      }
    }
    uint8_t pinv = gf_inv(a[(size_t)col * k + col]);
    const uint8_t* mp = GF_MUL[pinv];
    for (int c = 0; c < k; c++) {
      a[(size_t)col * k + c] = mp[a[(size_t)col * k + c]];
      inv[(size_t)col * k + c] = mp[inv[(size_t)col * k + c]];
    }
    for (int r = 0; r < k; r++) {
      if (r == col) continue;
      uint8_t fct = a[(size_t)r * k + col];
      if (!fct) continue;
      const uint8_t* mf = GF_MUL[fct];
      for (int c = 0; c < k; c++) {
        a[(size_t)r * k + c] ^= mf[a[(size_t)col * k + c]];
        inv[(size_t)r * k + c] ^= mf[inv[(size_t)col * k + c]];
      }
    }
  }
  return true;
}

// shards: n entries, empty string == missing. Mirrors rs.py::decode.
static bool rs_decode(const std::vector<std::string>& shards, int k,
                      std::string& out) {
  int n = (int)shards.size();
  std::vector<int> have_idx;
  for (int i = 0; i < n && (int)have_idx.size() < k; i++)
    if (!shards[i].empty()) have_idx.push_back(i);
  if ((int)have_idx.size() < k) return false;
  size_t size = shards[have_idx[0]].size();
  // adversarial-input guard (mirrors rs.py::decode): a malicious proposer
  // can commit a Merkle root over DIFFERENT-SIZED shards, each carrying a
  // valid branch — without this check the XOR loop below reads past the
  // end of the shorter shard's buffer
  for (int i = 1; i < k; i++)
    if (shards[have_idx[i]].size() != size) return false;
  if (n > 255) {
    // replication mode (see rs_encode): every shard IS the prefixed
    // payload; decode from the first one. Shards that disagree with the
    // committed Merkle root are rejected at receive time, and the
    // re-encode check in try_decode catches a root over mixed payloads.
    const std::string& flat = shards[have_idx[0]];
    if (flat.size() < 4) return false;
    uint32_t length = ((uint32_t)(uint8_t)flat[0] << 24) |
                      ((uint32_t)(uint8_t)flat[1] << 16) |
                      ((uint32_t)(uint8_t)flat[2] << 8) |
                      (uint32_t)(uint8_t)flat[3];
    if (length > flat.size() - 4) return false;
    out = flat.substr(4, length);
    return true;
  }
  // Vandermonde rows [x^0 .. x^{k-1}] at x = idx+1
  std::vector<uint8_t> mat((size_t)k * k);
  for (int r = 0; r < k; r++) {
    uint8_t x = (uint8_t)(have_idx[r] + 1), v = 1;
    for (int c = 0; c < k; c++) {
      mat[(size_t)r * k + c] = v;
      v = GF_MUL[v][x];
    }
  }
  std::vector<uint8_t> inv;
  if (!gf_mat_inv(mat, inv, k)) return false;
  std::string flat((size_t)k * size, '\0');
  std::vector<uint8_t> acc(size);
  for (int r = 0; r < k; r++) {
    std::fill(acc.begin(), acc.end(), 0);
    for (int c = 0; c < k; c++) {
      uint8_t f = inv[(size_t)r * k + c];
      if (!f) continue;
      const uint8_t* mf = GF_MUL[f];
      const uint8_t* src =
          reinterpret_cast<const uint8_t*>(shards[have_idx[c]].data());
      for (size_t b = 0; b < size; b++) acc[b] ^= mf[src[b]];
    }
    std::memcpy(&flat[(size_t)r * size], acc.data(), size);
  }
  if (flat.size() < 4) return false;
  uint32_t length = ((uint32_t)(uint8_t)flat[0] << 24) |
                    ((uint32_t)(uint8_t)flat[1] << 16) |
                    ((uint32_t)(uint8_t)flat[2] << 8) | (uint32_t)(uint8_t)flat[3];
  if (length > flat.size() - 4) return false;
  out = flat.substr(4, length);
  return true;
}

}  // namespace

namespace {

// ---------------------------------------------------------------------------
// Messages + queue
// ---------------------------------------------------------------------------

enum MsgType : uint8_t {
  MT_BVAL = 0,
  MT_AUX = 1,
  MT_CONF = 2,
  MT_VAL = 3,
  MT_ECHO = 4,
  MT_READY = 5,
  MT_OPAQUE = 6,
};

struct Msg {
  int refs = 0;
  uint8_t type = 0;
  int32_t era = 0;
  int32_t agreement = 0;   // BB/opaque: agreement; VAL/ECHO/READY: rbc slot
  int32_t epoch = 0;       // BB/opaque epoch
  uint8_t value = 0;       // BVAL/AUX: bool; CONF: 2-bit set
  uint8_t opq_kind = 0;    // opaque payload kind (Python-defined)
  int32_t shard_index = 0; // VAL/ECHO
  std::string root;        // VAL/ECHO/READY: 32-byte merkle root
  std::vector<std::string> branch;  // VAL/ECHO ("" = odd-promotion sentinel)
  std::string data;        // VAL/ECHO shard bytes; opaque payload
};

static inline void msg_release(Msg* m) {
  if (--m->refs <= 0) delete m;
}

struct Entry {
  int32_t sender;
  int32_t target;
  Msg* m;
};

struct Bits {
  // 512-bit membership mask — sized for the engine's N <= 512 hard cap
  // (rt_new rejects larger). Bits::set past the array end was silent
  // memory corruption for any validator index >= 256 (the old w[4]),
  // which is where N=512 eras crashed.
  uint64_t w[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  inline void set(int i) { w[i >> 6] |= 1ULL << (i & 63); }
  inline void clr(int i) { w[i >> 6] &= ~(1ULL << (i & 63)); }
  inline bool test(int i) const { return (w[i >> 6] >> (i & 63)) & 1; }
  inline int count() const {
    int c = 0;
    for (int i = 0; i < 8; i++) c += __builtin_popcountll(w[i]);
    return c;
  }
};

// Callback signatures (implemented in Python via ctypes):
//  opaque delivery, ACS result, coin request for a native BinaryAgreement.
typedef void (*opaque_cb_t)(int32_t target, int32_t sender, int32_t era,
                            int32_t kind, int32_t agreement, int32_t epoch,
                            const uint8_t* data, size_t len);
typedef void (*acs_cb_t)(int32_t target, int32_t era, int32_t nslots,
                         const int32_t* slots, const uint8_t* const* datas,
                         const size_t* lens);
typedef void (*coinreq_cb_t)(int32_t target, int32_t era, int32_t agreement,
                             int32_t epoch);
// Generic batched crossing for the natively-hosted crypto protocols
// (HoneyBadger / CommonCoin / RootProtocol). One crossing carries one crypto
// work item — often covering MANY messages (all pending coin shares, all
// ready decrypt-share slots, all unverified header signatures) — replacing
// the per-message cb_opaque round-trip on the era hot path.
typedef void (*cross_cb_t)(int32_t target, int32_t era, int32_t op, int32_t a,
                           int32_t b, const uint8_t* data, size_t len);

// Per-validator native-ownership mask (set from Python at request time; a
// validator with a Python override factory keeps the bit clear and its
// messages keep flowing through cb_opaque).
enum OwnMask { OWN_HB = 1, OWN_COIN = 2, OWN_ROOT = 4 };

// Opaque payload kinds — must match native_rt.py KIND_*.
enum OpqKind { K_DECRYPTED = 0, K_SIGNED_HEADER = 1, K_COIN = 2 };

// Engine -> Python crossing ops (cross_cb_t `op`).
enum CrossOp {
  XO_COIN_SIGN = 1,      // a=agreement b=epoch: sign + post own share
  XO_COIN_COMBINE = 2,   // blob [(u32 sender,u32 len,share)...]: add + combine
  XO_COIN_RESULT = 3,    // a=agreement b=epoch data[0]=parity: Python parent
  XO_HB_ACS = 4,         // blob [(u32 slot,u32 len,ciphertext)...]
  XO_HB_QUEUE = 5,       // queue one lazy batcher build for the ready slots
  XO_HB_DONE = 6,        // a=1 when a Python parent awaits the result
  XO_ROOT_INPUT = 7,     // propose txs, encrypt, post PO_HB_ACS_INPUT
  XO_ROOT_SIGN = 8,      // a=nonce parity: build + sign header
  XO_ROOT_VERIFY = 9,    // blob [(u32 sender,u32 len,sig)...]: ECDSA verify
  XO_ROOT_PRODUCE = 10,  // assemble multisig + produce the block
  XO_EVIDENCE = 11,      // a=offender b=opq_kind blob=be32 agreement+epoch:
                         // conflicting payloads in one first-seen slot
  XO_RBC_ENCODE = 12,    // a=slot blob=proposal: host RS-encodes + merkles,
                         // answers PO_RBC_VALS (batched RBC host shim)
  XO_RBC_NEED = 13,      // a=slot blob=root(32)+[(u32 idx,u32 len,shard)...]:
                         // host interpolates + rechecks, answers PO_RBC_RESULT
};

// Python -> engine post ops (rt_post `op`).
enum PostOp {
  PO_COIN_SHARE = 1,        // a=agreement b=epoch data=own share bytes
  PO_COIN_RESULT = 2,       // a=agreement b=epoch data[0]=parity
  PO_HB_ACS_INPUT = 3,      // data = encrypted proposal (starts native ACS)
  PO_HB_DECRYPTED = 4,      // a=slot data=own decrypt-share payload
  PO_HB_ACS_DONE = 5,       // ciphertexts registered: replay stash
  PO_HB_RESOLVED = 6,       // a=slot: plaintext (or garbage) settled
  PO_HB_REJECT = 7,         // a=slot b=sender: share failed verification
  PO_HB_SET_INFLIGHT = 8,   // a=slot: owned by an in-flight batcher build
  PO_HB_CLEAR_INFLIGHT = 9, // a=slot
  PO_HB_CLEAR_QUEUED = 10,
  PO_HB_REQUEUE_CHECK = 11,
  PO_ROOT_HEADER = 12,  // blob = be32 own_len | own bytes | broadcast bytes
  PO_ROOT_ACCEPT = 13,  // a=sender: header signature verified
  PO_ROOT_REJECT = 14,  // a=sender: invalid signature (sender may retry)
  PO_RBC_VALS = 15,     // a=slot blob = be32 era | root(32) | be32 n |
                        //   per-i (be32 nbranch | (be32 len|hash)* |
                        //   be32 shard_len | shard): engine builds VAL fan-out
  PO_RBC_RESULT = 16,   // a=slot b=ok blob = be32 era | root(32) | payload:
                        //   host interpolation verdict (ok=0 -> bad root)
};

// rt_request kinds (Python-side divert of era.py::internal_request).
enum ReqKind { RQ_HB = 1, RQ_COIN = 2, RQ_ROOT = 3 };

// Parent routing for native protocol results.
enum ParentKind { PK_NONE = 0, PK_BA = 1, PK_ROOT = 2, PK_PY = 3 };

static const size_t G1_BYTES = 96, G2_BYTES = 192;

static inline void put_be32(std::string& s, uint32_t v) {
  s.push_back((char)(v >> 24));
  s.push_back((char)(v >> 16));
  s.push_back((char)(v >> 8));
  s.push_back((char)v);
}
static inline uint32_t get_be32(const uint8_t* p) {
  return ((uint32_t)p[0] << 24) | ((uint32_t)p[1] << 16) |
         ((uint32_t)p[2] << 8) | (uint32_t)p[3];
}

struct Engine;

static const int EXTRA_ROUNDS = 3;  // binary_agreement.py::EXTRA_ROUNDS

// coin_schedule(epoch) for odd epochs: 0/1 deterministic, -1 = real coin
// (binary_agreement.py; reference CoinToss.cs:3-33)
static inline int coin_schedule(int epoch) {
  int k = (epoch / 2) % 3;
  return k == 0 ? 0 : (k == 1 ? 1 : -1);
}

// --- BinaryBroadcast (binary_broadcast.py; BinaryBroadcast.cs:111-239) -----
struct BB {
  Engine* E;
  int vid, agreement, epoch;
  Bits bval_recv[2];
  uint8_t bval_sent = 0;   // bit v: BVAL(v) broadcast already
  uint8_t bin_values = 0;  // bit v: v accepted at 2F+1
  Bits aux_seen;
  int aux_cnt[2] = {0, 0};
  Bits conf_seen;
  int conf_cnt[4] = {0, 0, 0, 0};  // indexed by 2-bit conf set
  bool aux_bcast = false, conf_bcast = false;
  bool done = false, parented = false, terminated = false;
  uint8_t result = 0;

  void on_request(int est);
  void on_bval(int sender, int v);
  void on_aux(int sender, int v);
  void on_conf(int sender, uint8_t set);
  void progress();
  void bcast_small(uint8_t type, uint8_t value);
  void emit();
};

// --- BinaryAgreement (binary_agreement.py; BinaryAgreement.cs:52-143) ------
struct BA {
  Engine* E;
  int vid, agreement;
  int epoch = 0;
  int8_t est = -1;
  bool started = false;
  std::unordered_map<int, uint8_t> bin_values;  // even epoch -> 2-bit set
  std::unordered_map<int, int8_t> coins;        // odd epoch -> coin
  int8_t decided = -1;
  int decide_epoch = -1;
  std::unordered_set<int> req_bb, req_coin;
  bool done = false, parented = false, terminated = false;
  bool result = false;

  void on_request(int est_in);
  void on_bb_result(int ep, uint8_t set);
  void on_coin_result(int ep, bool v);
  void advance();
  void finish_round(int coin);
  void emit();
};

// --- ReliableBroadcast (reliable_broadcast.py; ReliableBroadcast.cs) -------
struct RBC {
  Engine* E;
  int vid, slot;
  bool echo_sent = false, ready_sent = false, delivered = false,
       val_seen = false;
  bool done = false, parented = false, terminated = false;
  struct PerRoot {
    std::vector<std::string> shards;  // n entries, empty = missing
    int have = 0;
    Bits ready;
    // host-shim mode: an interpolation for this root crossed to the host
    // batcher and its PO_RBC_RESULT has not landed yet (suppresses
    // re-submission while more echoes arrive)
    bool interp_pending = false;
  };
  std::unordered_map<std::string, PerRoot> roots;
  std::vector<std::pair<std::string, std::string>> payloads;  // insertion order
  std::unordered_set<std::string> bad_roots;
  std::string result;

  int k() const;
  PerRoot& per_root(const std::string& root);
  void on_request(bool has_value, const std::string& value);
  void on_val(int sender, const Msg& m);
  void on_echo(int sender, const Msg& m);
  void on_ready(int sender, const Msg& m);
  bool check_branch(const Msg& m);
  void try_interpolate(const std::string& root);
  void try_deliver();
  const std::string* payload_of(const std::string& root) const {
    for (auto& pr : payloads)
      if (pr.first == root) return &pr.second;
    return nullptr;
  }
  void emit();
};

// --- CommonSubset (common_subset.py; CommonSubset.cs) ----------------------
struct ACS {
  Engine* E;
  int vid;
  std::unordered_map<int, std::string> rbc_results;
  std::unordered_map<int, int8_t> ba_results;
  std::unordered_set<int> ba_inputs;
  bool filled_zeros = false;
  bool done = false, parented = false, terminated = false;

  void on_request(const std::string& data);
  void on_rbc_result(int j, const std::string& v);
  void on_ba_result(int j, bool v);
  void vote(int j, bool v);
  void try_complete();
};

// --- Native hosts for the crypto-bearing protocols -------------------------
// CommonCoin / HoneyBadger / RootProtocol run their MESSAGE state machines
// here, mirroring common_coin.py / honey_badger.py / root_protocol.py
// statement-for-statement; every cryptographic operation (BLS combine, TPKE
// verify/combine, ECDSA sign/verify) crosses to Python in BATCHES via
// cross_cb_t, where host shims (native_hosts.py) drive the same crypto code
// the pinned oracle classes use.

struct NCoin {  // common_coin.py::CommonCoin message layer
  Engine* E;
  int vid, agreement, epoch;
  int parent = PK_NONE;
  bool requested = false, done = false;
  int result = -1;
  std::map<int, std::string> raw;    // sender -> share bytes (sorted)
  std::unordered_set<int> shipped;   // senders already crossed to the signer
  void on_request(int parent_kind);
  void on_share(int sender, const std::string& data);
  void on_own_share(const std::string& data);
  void on_result(int parity);
  void try_combine();
  void route_result();
};

struct NHB {  // honey_badger.py::HoneyBadger message layer
  Engine* E;
  int vid;
  int parent = PK_NONE;
  bool have_cts = false, done = false, queued = false;
  int total_slots = 0;
  std::set<int> ct_slots;            // valid ciphertext slots (sorted)
  std::unordered_set<int> resolved;  // slots with settled plaintexts
  std::unordered_set<int> inflight;  // slots owned by an in-flight build
  std::unordered_map<int, std::map<int, std::string>> shares;
  std::unordered_map<int, std::unordered_set<int>> rejected;
  std::vector<std::pair<std::pair<int, int>, std::string>> stash;  // pre-ACS
  std::set<std::pair<int, int>> stash_keys;
  void on_decrypted(int sender, int slot, const std::string& data);
  void apply_share(int sender, int slot, const std::string& data, bool defer);
  void on_acs(const std::vector<int32_t>& slots,
              std::unordered_map<int, std::string>& results);
  void on_acs_done();
  bool slot_ready(int slot) const;
  bool any_ready() const;
  void queue_check();
  void check_done();
  void export_ready(std::string& out) const;
};

struct NRoot {  // root_protocol.py::RootProtocol message layer
  Engine* E;
  int vid;
  bool requested = false, hb_done = false, header_posted = false,
       produced = false;
  int nonce_parity = -1;
  std::string own_data;  // be32 header-len | header bytes | own signature
  Bits verified, pending_bits;
  int verified_count = 0;
  std::vector<std::pair<int, std::string>> pending;  // (sender, unverified sig)
  std::vector<std::pair<int, std::string>> early;    // pre-header stash
  void on_request();
  void on_header(int sender, const std::string& data);
  void on_hb_done();
  void on_nonce(int parity);
  void on_own_header(const std::string& blob);
  void try_sign();
  void maybe_verify();
};

struct Validator {
  int era = 0;
  std::unordered_map<uint64_t, BB*> bb;   // key (agreement+1)<<32 | epoch
  std::unordered_map<int, BA*> ba;
  std::unordered_map<int, RBC*> rbc;
  ACS* acs = nullptr;
  uint8_t own_mask = 0;    // OwnMask bits: which crypto protocols run native
  bool acs_to_hb = false;  // route the ACS result to the native HB host
  std::unordered_map<uint64_t, NCoin*> ncoin;  // key (agreement+1)<<32 | epoch
  NHB* nhb = nullptr;
  NRoot* nroot = nullptr;
  std::vector<Entry> postponed;
  std::unordered_map<int, int> postponed_per_sender;
  // first-seen opaque payload per (kind, sender, agreement, epoch): the
  // equivocation latch (era.py::_latch_first_seen mirror). A conflicting
  // second payload is reported via XO_EVIDENCE and dropped pre-delivery.
  std::unordered_map<uint64_t, std::string> opq_seen;
  std::unordered_map<int, int> opq_seen_count;

  void clear_protocols();  // defined after Engine (touches hb_queued_count)
};

// ---------------------------------------------------------------------------
// Flight-recorder trace ring (shared record layout with storage/native/lsm.cpp
// and utils/tracing.py: 32-byte big-endian records, see trace_put_event).
// Timestamps are raw CLOCK_MONOTONIC (steady_clock) nanoseconds; the Python
// binding measures the offset to time.monotonic() once per engine via
// rt_monotonic_ns (clock handshake) so merged traces share one epoch.
// Recording must never perturb protocol logic — events are written only to
// this side ring, and a full ring overwrites the oldest record (dropped++).
// ---------------------------------------------------------------------------

static inline uint64_t trace_now_ns() {
  return (uint64_t)std::chrono::duration_cast<std::chrono::nanoseconds>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

struct TraceEvent {
  uint64_t ts_ns;   // steady_clock ns at event start
  uint64_t dur_ns;  // 0 for instants
  uint32_t kind;    // TK_* below
  uint32_t tid;     // validator id (lane in the merged trace)
  uint32_t a, b;    // kind-specific args (b is usually the era)
};

enum TraceKind : uint32_t {
  TK_ERA_ADVANCE = 1,  // a = new era
  TK_CROSS = 2,        // a = XO_* op, dur = time inside the Python callback
  TK_POST = 3,         // a = PO_* op (coarse ops only; per-slot ops skipped)
  TK_STAGE = 4,        // a = TS_* stage code
  TK_PHASE = 5,        // a = TP_* phase, dur = accumulated dispatch ns
  TK_WAIT = 6,         // a = WR_* resource, b = min live era; dur = the gap
                       // the dispatch loop sat starved (queue empty between
                       // two rt_run calls — host-side flush/IO time)
};

// Waited-on resource tags shared with the Python wait spans
// (utils/tracing.WAIT_RESOURCES); the engine itself only ever emits
// WR_SCHED — it cannot know WHAT the host was doing while the queue was
// empty, only that it was starved. Higher-priority Python wait spans
// (crypto_flush/device/fsync/net) claim their share of the same gap in
// the era-report sweep; WR_SCHED owns the remainder.
enum TraceWaitResource : uint32_t {
  WR_NET = 1,
  WR_CRYPTO_FLUSH = 2,
  WR_DEVICE = 3,
  WR_FSYNC = 4,
  WR_SCHED = 5,
};

enum TraceStage : uint32_t {
  TS_ACS_RESULT = 1,  // CommonSubset delivered its slot set
};

// Dispatch-phase buckets: per-message deliver() time (minus any time spent
// inside Python crossings) accumulated by protocol family, flushed as one
// TK_PHASE record per (era, phase). This is what gives the era report its
// rbc/ba split on native runs, where no per-protocol Python spans exist.
enum TracePhase : uint32_t {
  TP_RBC = 1,     // VAL/ECHO/READY (RS decode + Merkle checks live here)
  TP_BA = 2,      // BVAL/AUX/CONF + BA bookkeeping
  TP_COIN = 3,    // coin-share opaque dispatch
  TP_TPKE = 4,    // decrypt-share opaque dispatch
  TP_COMMIT = 5,  // signed-header opaque dispatch
  TP_OTHER = 6,
};

struct TraceRing {
  std::vector<TraceEvent> buf;
  size_t cap = 16384;  // LACHAIN_TRACE_CAPACITY overrides via *_configure
  size_t w = 0;        // next write slot
  size_t count = 0;    // live records (<= cap)
  uint64_t dropped = 0;
  bool enabled = true;

  void configure(size_t capacity) {
    buf.clear();
    w = count = 0;
    cap = capacity;
    enabled = capacity > 0;
  }
  inline void push(uint64_t ts, uint64_t dur, uint32_t kind, uint32_t tid,
                   uint32_t a, uint32_t b) {
    if (!enabled) return;
    if (buf.size() != cap) buf.resize(cap);  // lazy, first push only
    buf[w] = {ts, dur, kind, tid, a, b};
    w = (w + 1) % cap;
    if (count < cap)
      count++;
    else
      dropped++;  // overwrote the oldest unread record
  }
};

static inline void trace_put32(std::string& out, uint32_t v) {
  char b[4] = {(char)(v >> 24), (char)(v >> 16), (char)(v >> 8), (char)v};
  out.append(b, 4);
}

static inline void trace_put64(std::string& out, uint64_t v) {
  trace_put32(out, (uint32_t)(v >> 32));
  trace_put32(out, (uint32_t)v);
}

static inline void trace_put_event(std::string& out, const TraceEvent& e) {
  trace_put64(out, e.ts_ns);
  trace_put64(out, e.dur_ns);
  trace_put32(out, e.kind);
  trace_put32(out, e.tid);
  trace_put32(out, e.a);
  trace_put32(out, e.b);
}

struct Engine {
  int n, f;
  int mode;               // 0 FIFO, 1 LIFO, 2 RANDOM
  uint32_t repeat_ppm;    // duplicate-injection probability, parts/million
  uint64_t rng_state;
  std::deque<Entry> q;
  std::vector<Validator> vals;
  Bits muted;
  uint64_t delivered = 0;
  uint64_t opq_pending[8] = {0};  // queued opaque entries per kind (flush cue)
  bool stop_req = false;  // pulsed by Python on top-level protocol completion
  int postponed_sender_cap = 256;  // era.py::_postponed_sender_cap
  int opq_latch_cap = 2048;        // era.py::first_seen_sender_cap
  int coin_need = 0;               // ts_keys.t + 1 (set from Python)
  uint64_t native_handled = 0;     // opaque deliveries handled without Python
  int hb_queued_count = 0;         // native HBs with a queued batcher build
  bool rbc_host = false;  // RBC RS+Merkle math diverted to the host shim
                          // (XO_RBC_* / PO_RBC_*); engine-internal
                          // rs_encode/rs_decode stay the no-host fallback
  opaque_cb_t cb_opaque = nullptr;
  acs_cb_t cb_acs = nullptr;
  coinreq_cb_t cb_coinreq = nullptr;
  cross_cb_t cb_cross = nullptr;

  // -- flight recorder ------------------------------------------------------
  TraceRing trace;
  // per-era exclusive dispatch time by protocol family (TP_*); std::map so
  // flush order is deterministic across identically-seeded runs
  std::map<uint32_t, std::array<uint64_t, 8>> phase_acc;
  uint64_t cross_ns = 0;  // crossing time inside the current deliver()
  // queue-empty starvation tracking: set when run() exits with nothing to
  // dispatch, resolved into one TK_WAIT record when the host pumps again
  uint64_t idle_since_ns = 0;

  static inline uint32_t phase_of(const Msg* m) {
    switch (m->type) {
      case MT_VAL:
      case MT_ECHO:
      case MT_READY:
        return TP_RBC;
      case MT_BVAL:
      case MT_AUX:
      case MT_CONF:
        return TP_BA;
      case MT_OPAQUE:
        switch (m->opq_kind) {
          case K_COIN:
            return TP_COIN;
          case K_DECRYPTED:
            return TP_TPKE;
          case K_SIGNED_HEADER:
            return TP_COMMIT;
        }
        return TP_OTHER;
    }
    return TP_OTHER;
  }

  // flush finished-era dispatch accumulators into the ring (an era is
  // finished once every validator has advanced past it: stale-era messages
  // are dropped on delivery, so its accumulators can no longer grow)
  void trace_flush_phases() {
    if (!trace.enabled || phase_acc.empty()) return;
    int min_era = vals[0].era;
    for (auto& v : vals) min_era = v.era < min_era ? v.era : min_era;
    uint64_t now = trace_now_ns();
    for (auto it = phase_acc.begin(); it != phase_acc.end();) {
      if ((int)it->first >= min_era) {
        ++it;
        continue;
      }
      for (uint32_t ph = 1; ph < 8; ph++)
        if (it->second[ph])
          trace.push(now, it->second[ph], TK_PHASE, 0xFFFFFFFFu, ph,
                     it->first);
      it = phase_acc.erase(it);
    }
  }

  Engine(int n_, int f_, int mode_, uint32_t ppm, uint64_t seed, int era0)
      : n(n_), f(f_), mode(mode_), repeat_ppm(ppm) {
    rng_state = seed * 0x9E3779B97F4A7C15ULL + 1;
    vals.resize(n);
    for (auto& v : vals) v.era = era0;
    gf_init();
  }
  ~Engine() {
    for (auto& v : vals) {
      v.clear_protocols();
      for (auto& e : v.postponed) msg_release(e.m);
    }
    while (!q.empty()) {
      msg_release(q.front().m);
      q.pop_front();
    }
  }

  inline uint64_t rng_next() {
    // xorshift64*: deterministic, seed-replayable
    uint64_t x = rng_state;
    x ^= x >> 12;
    x ^= x << 25;
    x ^= x >> 27;
    rng_state = x;
    return x * 0x2545F4914F6CDD1DULL;
  }

  // -- emission (simulator.py::_make_send ordering: targets 0..n-1) ---------
  void bcast(int sender, Msg* m) {
    if (muted.test(sender)) {
      if (m->refs == 0) delete m;
      return;
    }
    if (m->type == MT_OPAQUE) opq_pending[m->opq_kind & 7] += n;
    for (int t = 0; t < n; t++) {
      m->refs++;
      q.push_back({sender, t, m});
    }
  }
  void sendto(int sender, int target, Msg* m) {
    if (muted.test(sender)) {
      if (m->refs == 0) delete m;
      return;
    }
    if (m->type == MT_OPAQUE) opq_pending[m->opq_kind & 7]++;
    m->refs++;
    q.push_back({sender, target, m});
  }

  // -- adversarial pop (simulator.py::_pop) ---------------------------------
  Entry pop() {
    Entry item;
    if (mode == 0) {
      item = q.front();
      q.pop_front();
    } else if (mode == 1) {
      item = q.back();
      q.pop_back();
    } else {
      size_t idx = (size_t)(rng_next() % q.size());
      Entry last = q.back();
      q.pop_back();
      if (idx < q.size()) {
        item = q[idx];
        q[idx] = last;
      } else {
        item = last;
      }
    }
    if (item.m->type == MT_OPAQUE) opq_pending[item.m->opq_kind & 7]--;
    if (repeat_ppm > 0 && (uint32_t)(rng_next() % 1000000u) < repeat_ppm) {
      item.m->refs++;
      if (item.m->type == MT_OPAQUE) opq_pending[item.m->opq_kind & 7]++;
      q.push_back(item);  // duplicate injection
    }
    return item;
  }

  // -- protocol lookup/create (era.py::_ensure_protocol + _validate_id) -----
  BB* get_bb(Validator& V, int agreement, int epoch, bool create) {
    if (!((agreement >= 0 && agreement < n) || agreement == -1) || epoch < 0)
      return nullptr;
    uint64_t key = ((uint64_t)(uint32_t)(agreement + 1) << 32) |
                   (uint32_t)epoch;
    auto it = V.bb.find(key);
    if (it != V.bb.end())
      return it->second->terminated ? nullptr : it->second;
    if (!create) return nullptr;
    BB* b = new BB();
    b->E = this;
    b->vid = (int)(&V - vals.data());
    b->agreement = agreement;
    b->epoch = epoch;
    V.bb[key] = b;
    return b;
  }
  BA* get_ba(Validator& V, int agreement, bool create) {
    if (agreement < 0 || agreement >= n) return nullptr;
    auto it = V.ba.find(agreement);
    if (it != V.ba.end())
      return it->second->terminated ? nullptr : it->second;
    if (!create) return nullptr;
    BA* b = new BA();
    b->E = this;
    b->vid = (int)(&V - vals.data());
    b->agreement = agreement;
    V.ba[agreement] = b;
    return b;
  }
  RBC* get_rbc(Validator& V, int slot, bool create) {
    if (slot < 0 || slot >= n) return nullptr;
    auto it = V.rbc.find(slot);
    if (it != V.rbc.end())
      return it->second->terminated ? nullptr : it->second;
    if (!create) return nullptr;
    RBC* r = new RBC();
    r->E = this;
    r->vid = (int)(&V - vals.data());
    r->slot = slot;
    V.rbc[slot] = r;
    return r;
  }

  // -- equivocation latch (era.py::_latch_first_seen mirror) ----------------
  // Returns false when the message must be dropped: either a conflicting
  // payload in an already-latched slot (reported to Python as XO_EVIDENCE so
  // both engines build identical evidence records) or a per-sender latch
  // budget overflow (spam shed). Exact duplicates pass through — protocol
  // state machines dedupe them, same as the Python path.
  bool opq_latch(Validator& V, const Entry& e) {
    Msg* m = e.m;
    int agreement = m->agreement, epoch = m->epoch;
    // mirror era.py::_validate_id bounds: out-of-range ids never reach a
    // protocol, so they are not worth a latch slot
    switch (m->opq_kind) {
      case K_DECRYPTED:
        if (agreement < 0 || agreement >= n) return true;
        epoch = 0;  // unused by decrypt shares; one slot per share id
        break;
      case K_COIN:
        if (!((agreement >= 0 && agreement < n) || agreement == -1) ||
            epoch < 0)
          return true;
        break;
      case K_SIGNED_HEADER:
        agreement = 0;  // one header slot per sender per era
        epoch = 0;
        break;
      default:
        return true;
    }
    uint64_t key = ((uint64_t)(m->opq_kind & 3) << 62) |
                   ((uint64_t)(uint32_t)(e.sender & 0x3FF) << 52) |
                   ((uint64_t)((uint32_t)(agreement + 1) & 0x3FFFFFF) << 26) |
                   (uint64_t)((uint32_t)epoch & 0x3FFFFFF);
    auto it = V.opq_seen.find(key);
    if (it == V.opq_seen.end()) {
      int& cnt = V.opq_seen_count[e.sender];
      if (cnt >= opq_latch_cap) return false;  // budget shed (spam defense)
      cnt++;
      V.opq_seen.emplace(key, m->data);
      return true;
    }
    if (it->second == m->data) return true;  // duplicate: pass through
    uint8_t blob[8];
    uint32_t ua = (uint32_t)agreement, ue = (uint32_t)epoch;
    blob[0] = (uint8_t)(ua >> 24); blob[1] = (uint8_t)(ua >> 16);
    blob[2] = (uint8_t)(ua >> 8);  blob[3] = (uint8_t)ua;
    blob[4] = (uint8_t)(ue >> 24); blob[5] = (uint8_t)(ue >> 16);
    blob[6] = (uint8_t)(ue >> 8);  blob[7] = (uint8_t)ue;
    cross(e.target, XO_EVIDENCE, e.sender, m->opq_kind,
          std::string(reinterpret_cast<const char*>(blob), 8));
    return false;
  }

  // -- delivery (simulator.py::run + era.py::dispatch_external) -------------
  void deliver(const Entry& e) {
    Validator& V = vals[e.target];
    Msg* m = e.m;
    if (m->era != V.era) {
      if (m->era > V.era) {
        int& cnt = V.postponed_per_sender[e.sender];
        if (cnt < postponed_sender_cap) {
          cnt++;
          m->refs++;
          V.postponed.push_back(e);
        }
      }
      return;  // stale era: drop
    }
    switch (m->type) {
      case MT_BVAL: {
        BB* b = get_bb(V, m->agreement, m->epoch, true);
        if (b) b->on_bval(e.sender, m->value);
        break;
      }
      case MT_AUX: {
        BB* b = get_bb(V, m->agreement, m->epoch, true);
        if (b) b->on_aux(e.sender, m->value);
        break;
      }
      case MT_CONF: {
        BB* b = get_bb(V, m->agreement, m->epoch, true);
        if (b) b->on_conf(e.sender, m->value);
        break;
      }
      case MT_VAL: {
        RBC* r = get_rbc(V, m->agreement, true);
        if (r) r->on_val(e.sender, *m);
        break;
      }
      case MT_ECHO: {
        RBC* r = get_rbc(V, m->agreement, true);
        if (r) r->on_echo(e.sender, *m);
        break;
      }
      case MT_READY: {
        RBC* r = get_rbc(V, m->agreement, true);
        if (r) r->on_ready(e.sender, *m);
        break;
      }
      case MT_OPAQUE:
        if (!opq_latch(V, e)) break;  // equivocation (reported) or shed
        if (deliver_native_opaque(V, e)) {
          native_handled++;
          break;
        }
        if (cb_opaque)
          cb_opaque(e.target, e.sender, m->era, m->opq_kind, m->agreement,
                    m->epoch, reinterpret_cast<const uint8_t*>(m->data.data()),
                    m->data.size());
        break;
    }
  }

  size_t run(size_t max_msgs) {
    // stop_req lets the Python run loop re-evaluate its done() condition the moment a
    // top-level Python protocol completes, instead of draining the rest of
    // the chunk — the Python simulator checks done() before every pop
    // (simulator.py::run), and overshooting past completion is not just
    // wasted work: extra BinaryAgreement lag rounds spawn real common coins
    // (threshold BLS sign/verify per validator) that a prompt stop avoids.
    size_t processed = 0;
    stop_req = false;
    if (trace.enabled && idle_since_ns) {
      // the previous run() left the queue empty: the gap until this pump
      // is host-side time the dispatch loop spent starved. Emitted even
      // for a zero-width gap so the record SEQUENCE stays deterministic
      // across identically-seeded runs (durations are wall-clock anyway).
      int min_era = vals[0].era;
      for (auto& v : vals) min_era = v.era < min_era ? v.era : min_era;
      uint64_t now = trace_now_ns();
      trace.push(idle_since_ns, now > idle_since_ns ? now - idle_since_ns : 0,
                 TK_WAIT, 0xFFFFFFFFu, WR_SCHED, (uint32_t)min_era);
      idle_since_ns = 0;
    }
    while (processed < max_msgs && !q.empty() && !stop_req) {
      Entry e = pop();
      delivered++;
      processed++;
      if (!muted.test(e.target)) {
        if (trace.enabled) {
          // exclusive dispatch time: crossings triggered by this message
          // are timed separately (TK_CROSS) and subtracted here
          uint32_t ph = phase_of(e.m);
          uint32_t era = (uint32_t)e.m->era;
          uint64_t t0 = trace_now_ns();
          cross_ns = 0;
          deliver(e);
          uint64_t dt = trace_now_ns() - t0;
          if (dt > cross_ns) phase_acc[era][ph] += dt - cross_ns;
        } else {
          deliver(e);
        }
      }
      msg_release(e.m);
    }
    stop_req = false;
    if (trace.enabled && q.empty()) idle_since_ns = trace_now_ns();
    return processed;
  }

  void advance_era(int vid, int new_era) {
    Validator& V = vals[vid];
    if (new_era <= V.era) return;  // eras never regress (era.py:122-132)
    trace.push(trace_now_ns(), 0, TK_ERA_ADVANCE, (uint32_t)vid,
               (uint32_t)new_era, (uint32_t)V.era);
    V.era = new_era;
    V.clear_protocols();
    trace_flush_phases();
    std::vector<Entry> pending;
    pending.swap(V.postponed);
    V.postponed_per_sender.clear();
    for (auto& e : pending) {
      deliver(e);  // re-postpones still-future messages
      msg_release(e.m);
    }
  }

  // -- results plumbing -----------------------------------------------------
  void deliver_bb_result(int vid, int agreement, int epoch, uint8_t set) {
    auto it = vals[vid].ba.find(agreement);
    if (it != vals[vid].ba.end()) it->second->on_bb_result(epoch, set);
  }
  void deliver_ba_result(int vid, int agreement, bool v) {
    ACS* a = vals[vid].acs;
    if (a) a->on_ba_result(agreement, v);
  }
  void deliver_rbc_result(int vid, int slot, const std::string& v) {
    ACS* a = vals[vid].acs;
    if (a) a->on_rbc_result(slot, v);
  }
  void deliver_acs_result(int vid, ACS* a);  // routes to NHB or cb_acs

  // requests from native parents (synchronous, like era.py::internal_request)
  void request_bb(int vid, int agreement, int epoch, int est) {
    BB* b = get_bb(vals[vid], agreement, epoch, true);
    if (b) b->on_request(est);
  }
  void request_ba(int vid, int agreement, int est) {
    BA* b = get_ba(vals[vid], agreement, true);
    if (b) b->on_request(est);
  }
  void request_rbc(int vid, int slot, bool has_value,
                   const std::string& value) {
    RBC* r = get_rbc(vals[vid], slot, true);
    if (r) r->on_request(has_value, value);
  }
  void request_coin(int vid, int agreement, int epoch);  // NCoin or cb_coinreq

  // -- native crypto-protocol hosting (implementations after the protocol
  //    bodies; they touch NCoin/NHB/NRoot) --------------------------------
  void cross(int vid, int op, int a, int b, const std::string& blob);
  NCoin* get_ncoin(Validator& V, int agreement, int epoch, bool create);
  NHB* get_nhb(Validator& V, bool create);
  NRoot* get_nroot(Validator& V, bool create);
  bool deliver_native_opaque(Validator& V, const Entry& e);
  void native_request(int vid, int kind, int a, int b);
  void native_post(int vid, int op, int a, int b, const uint8_t* data,
                   size_t len);
};

}  // namespace

namespace {

// ---------------------------------------------------------------------------
// BinaryBroadcast implementation (mirrors binary_broadcast.py line order)
// ---------------------------------------------------------------------------

void BB::bcast_small(uint8_t type, uint8_t value) {
  Msg* m = new Msg();
  m->type = type;
  m->era = E->vals[vid].era;
  m->agreement = agreement;
  m->epoch = epoch;
  m->value = value;
  E->bcast(vid, m);
}

void BB::emit() {
  if (parented) E->deliver_bb_result(vid, agreement, epoch, result);
}

void BB::on_request(int est) {
  parented = true;
  if (done) {  // protocol.py::receive Request-replay path
    emit();
    return;
  }
  int v = est ? 1 : 0;
  if (!(bval_sent & (1 << v))) {
    bval_sent |= 1 << v;
    bcast_small(MT_BVAL, (uint8_t)v);
  }
}

void BB::on_bval(int sender, int v) {
  v = v ? 1 : 0;
  bval_recv[v].set(sender);
  int cnt = bval_recv[v].count();
  if (cnt >= E->f + 1 && !(bval_sent & (1 << v))) {
    bval_sent |= 1 << v;
    bcast_small(MT_BVAL, (uint8_t)v);
  }
  if (cnt >= 2 * E->f + 1 && !(bin_values & (1 << v))) {
    bin_values |= 1 << v;
    if (!aux_bcast) {
      aux_bcast = true;
      bcast_small(MT_AUX, (uint8_t)v);
    }
    progress();
  }
}

void BB::on_aux(int sender, int v) {
  if (aux_seen.test(sender)) return;
  aux_seen.set(sender);
  aux_cnt[v ? 1 : 0]++;
  progress();
}

void BB::on_conf(int sender, uint8_t set) {
  if (conf_seen.test(sender)) return;
  conf_seen.set(sender);
  conf_cnt[set & 3]++;
  progress();
}

void BB::progress() {
  if (done || !bin_values) return;
  if (!conf_bcast) {
    int aux_ok = ((bin_values & 1) ? aux_cnt[0] : 0) +
                 ((bin_values & 2) ? aux_cnt[1] : 0);
    if (aux_ok >= E->n - E->f) {
      conf_bcast = true;
      bcast_small(MT_CONF, bin_values);
    }
  }
  if (conf_bcast) {
    int conf_ok = 0;
    for (int s = 0; s < 4; s++)
      if ((s & ~bin_values) == 0) conf_ok += conf_cnt[s];  // subset test
    if (conf_ok >= E->n - E->f) {
      done = true;
      result = bin_values;
      emit();
    }
  }
}

// ---------------------------------------------------------------------------
// BinaryAgreement implementation (mirrors binary_agreement.py)
// ---------------------------------------------------------------------------

void BA::emit() {
  if (parented) E->deliver_ba_result(vid, agreement, result);
}

void BA::on_request(int est_in) {
  parented = true;
  if (done) {
    emit();
    return;
  }
  if (started) return;
  started = true;
  est = est_in ? 1 : 0;
  advance();
}

void BA::on_bb_result(int ep, uint8_t set) {
  if (terminated) return;
  if (!bin_values.count(ep)) {
    bin_values[ep] = set;
    advance();
  }
}

void BA::on_coin_result(int ep, bool v) {
  if (terminated) return;
  if (!coins.count(ep)) {
    coins[ep] = v ? 1 : 0;
    advance();
  }
}

void BA::advance() {
  while (!terminated) {
    if (epoch % 2 == 0) {
      if (!req_bb.count(epoch)) {
        req_bb.insert(epoch);
        E->request_bb(vid, agreement, epoch, est);  // may re-enter advance()
      }
      if (!bin_values.count(epoch)) return;  // waiting on BB result
      epoch++;
    } else {
      int sched = coin_schedule(epoch);
      int coin;
      if (E->f == 0) {
        coin = sched == -1 ? 1 : sched;
      } else if (sched != -1) {
        coin = sched;
      } else {
        if (!req_coin.count(epoch)) {
          req_coin.insert(epoch);
          E->request_coin(vid, agreement, epoch);  // Python CommonCoin
        }
        if (!coins.count(epoch)) return;  // waiting on coin
        coin = coins[epoch];
      }
      finish_round(coin);
    }
  }
}

void BA::finish_round(int coin) {
  uint8_t w = bin_values[epoch - 1];
  if (w == 1 || w == 2) {  // singleton bin_values
    int b = (w == 2) ? 1 : 0;
    est = (int8_t)b;
    if (b == coin && decided == -1) {
      decided = (int8_t)b;
      decide_epoch = epoch;
      done = true;
      result = b != 0;
      emit();
    }
  } else {
    est = (int8_t)coin;
  }
  epoch++;
  if (decide_epoch != -1 && epoch > decide_epoch + 2 * EXTRA_ROUNDS)
    terminated = true;
}

// ---------------------------------------------------------------------------
// ReliableBroadcast implementation (mirrors reliable_broadcast.py)
// ---------------------------------------------------------------------------

int RBC::k() const {
  int kk = E->n - 2 * E->f;
  return kk > 1 ? kk : 1;
}

RBC::PerRoot& RBC::per_root(const std::string& root) {
  PerRoot& pr = roots[root];
  if (pr.shards.empty()) pr.shards.resize(E->n);
  return pr;
}

void RBC::emit() {
  if (parented) E->deliver_rbc_result(vid, slot, result);
}

void RBC::on_request(bool has_value, const std::string& value) {
  parented = true;
  if (done) {
    emit();
    return;
  }
  if (!has_value) return;  // participant-only instance
  if (slot != vid) {
    terminated = true;  // Python raises ValueError -> protocol terminated
    return;
  }
  if (E->rbc_host) {
    // host shim owns the RS math: queue the encode with the era batcher;
    // the VAL fan-out arrives back as one PO_RBC_VALS post
    E->cross(vid, XO_RBC_ENCODE, slot, 0, value);
    return;
  }
  std::vector<std::string> shards = rs_encode(value, k(), E->n);
  std::vector<std::string> leaves(E->n);
  for (int i = 0; i < E->n; i++) leaves[i] = keccak_s(shards[i]);
  std::string root = merkle_root(leaves);
  for (int i = 0; i < E->n; i++) {
    Msg* m = new Msg();
    m->type = MT_VAL;
    m->era = E->vals[vid].era;
    m->agreement = slot;
    m->root = root;
    m->branch = merkle_proof(leaves, i);
    m->data = shards[i];
    m->shard_index = i;
    E->sendto(vid, i, m);
  }
}

bool RBC::check_branch(const Msg& m) {
  return merkle_verify(keccak_s(m.data), (size_t)m.shard_index, m.branch,
                       m.root);
}

void RBC::on_val(int sender, const Msg& m) {
  if (sender != slot || val_seen) return;
  if (m.shard_index != vid) return;
  if (!check_branch(m)) return;
  val_seen = true;
  if (!echo_sent) {
    echo_sent = true;
    Msg* e = new Msg();
    e->type = MT_ECHO;
    e->era = E->vals[vid].era;
    e->agreement = slot;
    e->root = m.root;
    e->branch = m.branch;
    e->data = m.data;
    e->shard_index = m.shard_index;
    E->bcast(vid, e);
  }
}

void RBC::on_echo(int sender, const Msg& m) {
  if (m.shard_index != sender) return;  // each validator echoes its own shard
  // duplicate check BEFORE the branch proof: re-delivered echoes must not
  // pay keccak + Merkle verification again (find, not per_root, so bogus
  // roots allocate nothing pre-verification)
  auto it = roots.find(m.root);
  if (it != roots.end() && !it->second.shards[sender].empty()) return;
  if (!check_branch(m)) return;
  PerRoot& pr = per_root(m.root);
  if (!pr.shards[sender].empty()) return;
  pr.shards[sender] = m.data;
  pr.have++;
  try_interpolate(m.root);
  try_deliver();
}

void RBC::on_ready(int sender, const Msg& m) {
  PerRoot& pr = per_root(m.root);
  if (pr.ready.test(sender)) return;
  pr.ready.set(sender);
  if (pr.ready.count() >= E->f + 1 && !ready_sent) {
    ready_sent = true;
    Msg* r = new Msg();
    r->type = MT_READY;
    r->era = E->vals[vid].era;
    r->agreement = slot;
    r->root = m.root;
    E->bcast(vid, r);
  }
  try_deliver();
}

void RBC::try_interpolate(const std::string& root) {
  if (payload_of(root) || bad_roots.count(root)) return;
  PerRoot& pr = per_root(root);
  if (pr.have < E->n - 2 * E->f) return;
  if (E->rbc_host) {
    // host shim owns the interpolate + re-encode + Merkle recheck: ship the
    // first-k present shards (the same selection rs_decode makes) and wait
    // for the PO_RBC_RESULT verdict. Later echoes cannot change it.
    if (pr.interp_pending) return;
    pr.interp_pending = true;
    std::string blob = root;
    int need = k(), taken = 0;
    for (int i = 0; i < E->n && taken < need; i++) {
      if (pr.shards[i].empty()) continue;
      put_be32(blob, (uint32_t)i);
      put_be32(blob, (uint32_t)pr.shards[i].size());
      blob += pr.shards[i];
      taken++;
    }
    E->cross(vid, XO_RBC_NEED, slot, 0, blob);
    return;
  }
  std::string payload;
  if (!rs_decode(pr.shards, k(), payload)) {
    bad_roots.insert(root);
    return;
  }
  // malicious-sender check: re-encode and recompute the Merkle root
  std::vector<std::string> reencoded = rs_encode(payload, k(), E->n);
  std::vector<std::string> leaves(E->n);
  for (int i = 0; i < E->n; i++) leaves[i] = keccak_s(reencoded[i]);
  if (merkle_root(leaves) != root) {
    bad_roots.insert(root);  // equivocated shards: never deliver
    return;
  }
  payloads.emplace_back(root, payload);
  if (!ready_sent) {
    ready_sent = true;
    Msg* r = new Msg();
    r->type = MT_READY;
    r->era = E->vals[vid].era;
    r->agreement = slot;
    r->root = root;
    E->bcast(vid, r);
  }
  try_deliver();
}

void RBC::try_deliver() {
  if (delivered) return;
  for (auto& rp : payloads) {
    auto it = roots.find(rp.first);
    if (it != roots.end() && it->second.ready.count() >= 2 * E->f + 1) {
      delivered = true;
      done = true;
      result = rp.second;
      emit();
      return;
    }
  }
}

// ---------------------------------------------------------------------------
// CommonSubset implementation (mirrors common_subset.py)
// ---------------------------------------------------------------------------

void ACS::on_request(const std::string& data) {
  parented = true;
  if (done) {
    E->deliver_acs_result(vid, this);
    return;
  }
  for (int j = 0; j < E->n; j++)
    E->request_rbc(vid, j, j == vid, j == vid ? data : std::string());
}

void ACS::on_rbc_result(int j, const std::string& v) {
  if (terminated) return;
  if (rbc_results.count(j)) return;
  rbc_results[j] = v;
  vote(j, true);
  try_complete();
}

void ACS::on_ba_result(int j, bool v) {
  if (terminated) return;
  if (ba_results.count(j)) return;
  ba_results[j] = v ? 1 : 0;
  int ones = 0;
  for (auto& kv : ba_results)
    if (kv.second) ones++;
  if (ones >= E->n - E->f && !filled_zeros) {
    filled_zeros = true;
    for (int kk = 0; kk < E->n; kk++)
      if (!ba_results.count(kk)) vote(kk, false);
  }
  try_complete();
}

void ACS::vote(int j, bool v) {
  if (ba_inputs.count(j)) return;
  ba_inputs.insert(j);
  E->request_ba(vid, j, v ? 1 : 0);
}

void ACS::try_complete() {
  if (done || (int)ba_results.size() < E->n) return;
  for (auto& kv : ba_results)
    if (kv.second && !rbc_results.count(kv.first)) return;  // value pending
  done = true;
  E->deliver_acs_result(vid, this);
}

// ---------------------------------------------------------------------------
// Native crypto-protocol hosting (engine plumbing + NCoin/NHB/NRoot)
// ---------------------------------------------------------------------------

void Validator::clear_protocols() {
  for (auto& kv : bb) delete kv.second;
  bb.clear();
  for (auto& kv : ba) delete kv.second;
  ba.clear();
  for (auto& kv : rbc) delete kv.second;
  rbc.clear();
  delete acs;
  acs = nullptr;
  for (auto& kv : ncoin) delete kv.second;
  ncoin.clear();
  if (nhb && nhb->queued) nhb->E->hb_queued_count--;
  delete nhb;
  nhb = nullptr;
  delete nroot;
  nroot = nullptr;
  acs_to_hb = false;
  opq_seen.clear();
  opq_seen_count.clear();
}

void Engine::cross(int vid, int op, int a, int b, const std::string& blob) {
  if (!cb_cross) return;
  if (!trace.enabled) {
    cb_cross(vid, vals[vid].era, op, a, b,
             reinterpret_cast<const uint8_t*>(blob.data()), blob.size());
    return;
  }
  uint64_t t0 = trace_now_ns();
  cb_cross(vid, vals[vid].era, op, a, b,
           reinterpret_cast<const uint8_t*>(blob.data()), blob.size());
  uint64_t dt = trace_now_ns() - t0;
  // nested crossings (a callback posting back can trigger another cross)
  // over-accumulate here; run() guards with dt > cross_ns before subtracting
  cross_ns += dt;
  trace.push(t0, dt, TK_CROSS, (uint32_t)vid, (uint32_t)op,
             (uint32_t)vals[vid].era);
}

NCoin* Engine::get_ncoin(Validator& V, int agreement, int epoch, bool create) {
  // era.py::_validate_id for CoinId (NONCE_AGREEMENT = -1 allowed)
  if (!((agreement >= 0 && agreement < n) || agreement == -1) || epoch < 0)
    return nullptr;
  uint64_t key = ((uint64_t)(uint32_t)(agreement + 1) << 32) | (uint32_t)epoch;
  auto it = V.ncoin.find(key);
  if (it != V.ncoin.end()) return it->second;
  if (!create) return nullptr;
  NCoin* c = new NCoin();
  c->E = this;
  c->vid = (int)(&V - vals.data());
  c->agreement = agreement;
  c->epoch = epoch;
  V.ncoin[key] = c;
  return c;
}

NHB* Engine::get_nhb(Validator& V, bool create) {
  if (!V.nhb && create) {
    V.nhb = new NHB();
    V.nhb->E = this;
    V.nhb->vid = (int)(&V - vals.data());
  }
  return V.nhb;
}

NRoot* Engine::get_nroot(Validator& V, bool create) {
  if (!V.nroot && create) {
    V.nroot = new NRoot();
    V.nroot->E = this;
    V.nroot->vid = (int)(&V - vals.data());
  }
  return V.nroot;
}

void Engine::request_coin(int vid, int agreement, int epoch) {
  Validator& V = vals[vid];
  if (V.own_mask & OWN_COIN) {
    NCoin* c = get_ncoin(V, agreement, epoch, true);
    if (c) c->on_request(PK_BA);
    return;
  }
  if (cb_coinreq) cb_coinreq(vid, V.era, agreement, epoch);
}

void Engine::deliver_acs_result(int vid, ACS* a) {
  std::vector<int32_t> slots;
  for (auto& kv : a->ba_results)
    if (kv.second) slots.push_back(kv.first);
  std::sort(slots.begin(), slots.end());
  Validator& V = vals[vid];
  trace.push(trace_now_ns(), 0, TK_STAGE, (uint32_t)vid, TS_ACS_RESULT,
             (uint32_t)V.era);
  if (V.acs_to_hb && (V.own_mask & OWN_HB)) {
    NHB* hb = get_nhb(V, true);
    hb->on_acs(slots, a->rbc_results);
    return;
  }
  std::vector<const uint8_t*> ptrs;
  std::vector<size_t> lens;
  for (int32_t s : slots) {
    const std::string& d = a->rbc_results[s];
    ptrs.push_back(reinterpret_cast<const uint8_t*>(d.data()));
    lens.push_back(d.size());
  }
  if (cb_acs)
    cb_acs(vid, V.era, (int32_t)slots.size(), slots.data(), ptrs.data(),
           lens.data());
}

bool Engine::deliver_native_opaque(Validator& V, const Entry& e) {
  Msg* m = e.m;
  switch (m->opq_kind) {
    case K_DECRYPTED: {
      if (!(V.own_mask & OWN_HB)) return false;
      NHB* hb = get_nhb(V, true);
      hb->on_decrypted(e.sender, m->agreement, m->data);
      // Flush cue, mirroring the Python simulator's per-pop check
      // (`crypto_batcher.pending and _decrypted_in_queue == 0`): the moment
      // the last queued decrypt-share is delivered while some native HB has
      // a batcher build queued, pulse stop so the run loop flushes.
      if (hb_queued_count > 0 && opq_pending[K_DECRYPTED] == 0)
        stop_req = true;
      return true;
    }
    case K_COIN: {
      if (!(V.own_mask & OWN_COIN)) return false;
      NCoin* c = get_ncoin(V, m->agreement, m->epoch, true);
      if (c) c->on_share(e.sender, m->data);
      return true;
    }
    case K_SIGNED_HEADER: {
      if (!(V.own_mask & OWN_ROOT)) return false;
      NRoot* r = get_nroot(V, true);
      r->on_header(e.sender, m->data);
      return true;
    }
  }
  return false;
}

void Engine::native_request(int vid, int kind, int a, int b) {
  Validator& V = vals[vid];
  switch (kind) {
    case RQ_COIN: {
      NCoin* c = get_ncoin(V, a, b, true);
      if (c) c->on_request(PK_PY);
      break;
    }
    case RQ_HB: {
      NHB* hb = get_nhb(V, true);
      hb->parent = PK_PY;
      if (hb->done)  // protocol.py::receive Request-replay path
        cross(vid, XO_HB_DONE, 1, 0, std::string());
      break;
    }
    case RQ_ROOT: {
      NRoot* r = get_nroot(V, true);
      r->on_request();
      break;
    }
  }
}

void Engine::native_post(int vid, int op, int a, int b, const uint8_t* data,
                         size_t len) {
  Validator& V = vals[vid];
  // record the coarse once-per-stage posts only — the per-slot/per-sender
  // ops (decrypted shares, accept/reject votes) would flood the ring
  if (trace.enabled &&
      (op == PO_COIN_RESULT || op == PO_HB_ACS_INPUT ||
       op == PO_HB_ACS_DONE || op == PO_ROOT_HEADER))
    trace.push(trace_now_ns(), 0, TK_POST, (uint32_t)vid, (uint32_t)op,
               (uint32_t)V.era);
  std::string blob(reinterpret_cast<const char*>(data), len);
  switch (op) {
    case PO_COIN_SHARE: {
      NCoin* c = get_ncoin(V, a, b, true);
      if (c) c->on_own_share(blob);
      break;
    }
    case PO_COIN_RESULT: {
      NCoin* c = get_ncoin(V, a, b, false);
      if (c) c->on_result(len ? (int)(uint8_t)blob[0] : 0);
      break;
    }
    case PO_HB_ACS_INPUT: {
      V.acs_to_hb = true;
      if (!V.acs) {
        V.acs = new ACS();
        V.acs->E = this;
        V.acs->vid = vid;
      }
      V.acs->on_request(blob);
      break;
    }
    case PO_HB_DECRYPTED: {
      // own decrypt share: register the ciphertext slot, broadcast FIRST,
      // then record (honey_badger.py::handle_child_result statement order)
      NHB* hb = get_nhb(V, true);
      hb->ct_slots.insert(a);
      Msg* m = new Msg();
      m->type = MT_OPAQUE;
      m->era = V.era;
      m->opq_kind = K_DECRYPTED;
      m->agreement = a;
      m->epoch = 0;
      m->data = blob;
      bcast(vid, m);
      hb->shares[a][vid] = blob;
      break;
    }
    case PO_HB_ACS_DONE: {
      NHB* hb = get_nhb(V, true);
      hb->on_acs_done();
      break;
    }
    case PO_HB_RESOLVED: {
      NHB* hb = get_nhb(V, true);
      hb->resolved.insert(a);
      hb->check_done();
      break;
    }
    case PO_HB_REJECT: {
      NHB* hb = get_nhb(V, false);
      if (!hb) break;
      auto it = hb->shares.find(a);
      if (it != hb->shares.end()) it->second.erase(b);
      hb->rejected[a].insert(b);
      break;
    }
    case PO_HB_SET_INFLIGHT: {
      NHB* hb = get_nhb(V, false);
      if (hb) hb->inflight.insert(a);
      break;
    }
    case PO_HB_CLEAR_INFLIGHT: {
      NHB* hb = get_nhb(V, false);
      if (hb) hb->inflight.erase(a);
      break;
    }
    case PO_HB_CLEAR_QUEUED: {
      NHB* hb = get_nhb(V, false);
      if (hb && hb->queued) {
        hb->queued = false;
        hb_queued_count--;
      }
      break;
    }
    case PO_HB_REQUEUE_CHECK: {
      NHB* hb = get_nhb(V, false);
      if (hb) hb->queue_check();
      break;
    }
    case PO_ROOT_HEADER: {
      NRoot* r = get_nroot(V, true);
      r->on_own_header(blob);
      break;
    }
    case PO_ROOT_ACCEPT: {
      NRoot* r = get_nroot(V, false);
      if (!r) break;
      if (!r->verified.test(a)) {
        r->verified.set(a);
        r->verified_count++;
      }
      r->pending_bits.clr(a);
      break;
    }
    case PO_ROOT_REJECT: {
      NRoot* r = get_nroot(V, false);
      if (r) r->pending_bits.clr(a);  // sender may retry (oracle re-verifies)
      break;
    }
    case PO_RBC_VALS: {
      // host shim answered XO_RBC_ENCODE: build the VAL fan-out exactly as
      // RBC::on_request would. The be32 era prefix drops posts that raced
      // an era advance (the flush runs outside the dispatch loop).
      if (len < 40) break;
      if ((int)get_be32(data) != V.era) break;  // stale era: drop
      std::string root = blob.substr(4, 32);
      size_t off = 36;
      uint32_t n_sh = get_be32(data + off);
      off += 4;
      if ((int)n_sh != n) break;
      for (uint32_t i = 0; i < n_sh; i++) {
        if (off + 4 > len) return;
        uint32_t nbranch = get_be32(data + off);
        off += 4;
        std::vector<std::string> branch(nbranch);
        for (uint32_t j = 0; j < nbranch; j++) {
          if (off + 4 > len) return;
          uint32_t bl = get_be32(data + off);
          off += 4;
          if (off + bl > len) return;
          branch[j] = blob.substr(off, bl);
          off += bl;
        }
        if (off + 4 > len) return;
        uint32_t sl = get_be32(data + off);
        off += 4;
        if (off + sl > len) return;
        Msg* m = new Msg();
        m->type = MT_VAL;
        m->era = V.era;
        m->agreement = a;
        m->root = root;
        m->branch = std::move(branch);
        m->data = blob.substr(off, sl);
        off += sl;
        m->shard_index = (int)i;
        sendto(vid, (int)i, m);
      }
      break;
    }
    case PO_RBC_RESULT: {
      // host shim answered XO_RBC_NEED: settle the interpolation verdict
      // exactly as the tail of RBC::try_interpolate would (b=0 -> bad root)
      if (len < 36) break;
      if ((int)get_be32(data) != V.era) break;  // stale era: drop
      std::string root = blob.substr(4, 32);
      RBC* r = get_rbc(V, a, false);
      if (!r) break;
      r->per_root(root).interp_pending = false;
      if (r->payload_of(root) || r->bad_roots.count(root)) break;
      if (!b) {
        r->bad_roots.insert(root);
        break;
      }
      r->payloads.emplace_back(root, blob.substr(36));
      if (!r->ready_sent) {
        r->ready_sent = true;
        Msg* m = new Msg();
        m->type = MT_READY;
        m->era = V.era;
        m->agreement = a;
        m->root = root;
        bcast(vid, m);
      }
      r->try_deliver();
      break;
    }
  }
}

// --- NCoin (common_coin.py) ------------------------------------------------

void NCoin::on_request(int parent_kind) {
  parent = parent_kind;
  if (done) {  // protocol.py::receive Request-replay path
    route_result();
    return;
  }
  if (requested) return;
  requested = true;
  E->cross(vid, XO_COIN_SIGN, agreement, epoch, std::string());
  // Python signed and posted the own share synchronously (PO_COIN_SHARE).
}

void NCoin::on_own_share(const std::string& data) {
  // common_coin.py::handle_input: broadcast FIRST, then record + combine
  Msg* m = new Msg();
  m->type = MT_OPAQUE;
  m->era = E->vals[vid].era;
  m->opq_kind = K_COIN;
  m->agreement = agreement;
  m->epoch = epoch;
  m->data = data;
  E->bcast(vid, m);
  raw[vid] = data;
  shipped.insert(vid);  // the Python signer already holds its own share
  try_combine();
}

void NCoin::on_share(int sender, const std::string& data) {
  // common_coin.py::handle_external
  if (done || raw.count(sender)) return;
  if (data.size() != G2_BYTES + 4) return;
  if (get_be32(reinterpret_cast<const uint8_t*>(data.data()) + G2_BYTES) !=
      (uint32_t)sender)
    return;
  raw[sender] = data;
  try_combine();
}

void NCoin::try_combine() {
  // common_coin.py::_try_combine: the need check counts ALL stored shares;
  // only not-yet-shipped ones cross (the Python signer keeps the rest), and
  // the crossing happens even with an empty delta — the oracle re-evaluates
  // the combined signature on every call past the threshold.
  if (done || (int)raw.size() < E->coin_need) return;
  std::string blob;
  for (auto& kv : raw) {
    if (shipped.count(kv.first)) continue;
    put_be32(blob, (uint32_t)kv.first);
    put_be32(blob, (uint32_t)kv.second.size());
    blob += kv.second;
  }
  for (auto& kv : raw) shipped.insert(kv.first);
  E->cross(vid, XO_COIN_COMBINE, agreement, epoch, blob);
  // Python posted PO_COIN_RESULT re-entrantly if the signature completed.
}

void NCoin::on_result(int parity) {
  if (done) return;
  done = true;
  result = parity ? 1 : 0;
  route_result();
}

void NCoin::route_result() {
  if (result < 0) return;
  if (parent == PK_BA) {
    auto it = E->vals[vid].ba.find(agreement);
    if (it != E->vals[vid].ba.end())
      it->second->on_coin_result(epoch, result != 0);
  } else if (parent == PK_ROOT) {
    NRoot* r = E->vals[vid].nroot;
    if (r) r->on_nonce(result);
  } else if (parent == PK_PY) {
    std::string blob(1, (char)result);
    E->cross(vid, XO_COIN_RESULT, agreement, epoch, blob);
  }
}

// --- NHB (honey_badger.py) -------------------------------------------------

void NHB::on_acs(const std::vector<int32_t>& slots,
                 std::unordered_map<int, std::string>& results) {
  if (have_cts || done) return;
  total_slots = (int)slots.size();
  std::string blob;
  for (int32_t s : slots) {
    const std::string& d = results[s];
    put_be32(blob, (uint32_t)s);
    put_be32(blob, (uint32_t)d.size());
    blob += d;
  }
  E->cross(vid, XO_HB_ACS, total_slots, 0, blob);
  // Python decoded + batch-verified the ciphertexts, posted PO_HB_RESOLVED
  // for garbage slots and PO_HB_DECRYPTED per valid slot (in sorted slot
  // order, preserving the oracle's broadcast order), then PO_HB_ACS_DONE.
}

void NHB::on_acs_done() {
  have_cts = true;
  auto st = std::move(stash);
  stash.clear();
  stash_keys.clear();
  // honey_badger.py::handle_child_result: replay the early stash with
  // deferred batching, then one ready check and one completion check
  for (auto& e : st) apply_share(e.first.first, e.first.second, e.second, true);
  queue_check();
  check_done();
}

void NHB::on_decrypted(int sender, int slot, const std::string& data) {
  if (!have_cts) {
    // honey_badger.py::handle_external pre-ACS stash (bounded slot, deduped)
    if (slot < 0 || slot >= E->n) return;
    auto key = std::make_pair(sender, slot);
    if (stash_keys.count(key)) return;
    stash_keys.insert(key);
    stash.emplace_back(key, data);
    return;
  }
  apply_share(sender, slot, data, false);
}

void NHB::apply_share(int sender, int slot, const std::string& data,
                      bool defer) {
  // honey_badger.py::_on_decrypted
  if (!ct_slots.count(slot)) return;  // unknown or invalid ciphertext slot
  if (resolved.count(slot)) return;   // plaintext already settled
  if (data.size() != G1_BYTES + 8) return;
  const uint8_t* p = reinterpret_cast<const uint8_t*>(data.data());
  if (get_be32(p + G1_BYTES) != (uint32_t)sender) return;
  if (get_be32(p + G1_BYTES + 4) != (uint32_t)slot) return;
  auto rj = rejected.find(slot);
  if (rj != rejected.end() && rj->second.count(sender)) return;
  auto& m = shares[slot];
  if (m.count(sender)) return;
  m[sender] = data;
  if (defer) return;
  if (!queued && !inflight.count(slot) && (int)m.size() >= E->f + 1) {
    queued = true;
    E->hb_queued_count++;
    E->cross(vid, XO_HB_QUEUE, 0, 0, std::string());
  }
}

bool NHB::slot_ready(int slot) const {
  if (resolved.count(slot) || inflight.count(slot)) return false;
  auto it = shares.find(slot);
  return it != shares.end() && (int)it->second.size() >= E->f + 1;
}

bool NHB::any_ready() const {
  for (int s : ct_slots)
    if (slot_ready(s)) return true;
  return false;
}

void NHB::queue_check() {
  if (done || queued || !any_ready()) return;
  queued = true;
  E->hb_queued_count++;
  E->cross(vid, XO_HB_QUEUE, 0, 0, std::string());
}

void NHB::check_done() {
  if (done || !have_cts) return;
  if ((int)resolved.size() < total_slots) return;
  done = true;
  E->cross(vid, XO_HB_DONE, parent == PK_PY ? 1 : 0, 0, std::string());
  if (parent == PK_ROOT) {
    NRoot* r = E->vals[vid].nroot;
    if (r) r->on_hb_done();
  }
}

void NHB::export_ready(std::string& out) const {
  // [(u32 slot, u32 nsenders, (u32 sender, u32 len, share)*)*], slots and
  // senders ascending — matches the oracle's sorted candidate iteration
  for (int s : ct_slots) {
    if (!slot_ready(s)) continue;
    const auto& m = shares.at(s);
    put_be32(out, (uint32_t)s);
    put_be32(out, (uint32_t)m.size());
    for (auto& kv : m) {
      put_be32(out, (uint32_t)kv.first);
      put_be32(out, (uint32_t)kv.second.size());
      out += kv.second;
    }
  }
}

// --- NRoot (root_protocol.py) ----------------------------------------------

void NRoot::on_request() {
  if (requested) return;
  requested = true;
  // root_protocol.py::handle_input order: the HoneyBadger request (RBC VAL
  // sends) must hit the queue before the nonce-coin share broadcast
  Validator& V = E->vals[vid];
  NHB* hb = E->get_nhb(V, true);
  hb->parent = PK_ROOT;
  E->cross(vid, XO_ROOT_INPUT, 0, 0, std::string());
  NCoin* c = E->get_ncoin(V, -1, 0, true);
  if (c) c->on_request(PK_ROOT);
}

void NRoot::on_hb_done() {
  hb_done = true;
  try_sign();
}

void NRoot::on_nonce(int parity) {
  if (nonce_parity < 0) nonce_parity = parity ? 1 : 0;
  try_sign();
}

void NRoot::try_sign() {
  if (header_posted || produced || !hb_done || nonce_parity < 0) return;
  E->cross(vid, XO_ROOT_SIGN, nonce_parity, 0, std::string());
  // Python built + signed the header and posted PO_ROOT_HEADER.
}

void NRoot::on_own_header(const std::string& blob) {
  // blob = be32 L | own bytes (L) | broadcast bytes. The broadcast segment
  // may be journal-substituted recorded bytes; header matching always uses
  // the freshly derived own bytes, exactly like the Python oracle.
  if (header_posted || blob.size() < 4) return;
  const uint8_t* p = reinterpret_cast<const uint8_t*>(blob.data());
  uint32_t own_len = get_be32(p);
  if (blob.size() < 4 + (size_t)own_len) return;
  own_data = blob.substr(4, own_len);
  std::string wire = blob.substr(4 + (size_t)own_len);
  header_posted = true;
  Msg* m = new Msg();
  m->type = MT_OPAQUE;
  m->era = E->vals[vid].era;
  m->opq_kind = K_SIGNED_HEADER;
  m->agreement = 0;
  m->epoch = 0;
  m->data = wire;
  E->bcast(vid, m);
  verified.set(vid);
  verified_count = 1;
  // early-header replay in stash order (root_protocol.py dict order)
  auto st = std::move(early);
  early.clear();
  for (auto& e : st) on_header(e.first, e.second);
  maybe_verify();
}

void NRoot::on_header(int sender, const std::string& data) {
  if (produced) return;  // post-production headers have no observable effect
  if (!header_posted) {
    // root_protocol.py: one stashed header per sender; a later arrival
    // replaces the payload but keeps the original stash position
    for (auto& e : early)
      if (e.first == sender) {
        e.second = data;
        return;
      }
    early.emplace_back(sender, data);
    return;
  }
  if (verified.test(sender) || pending_bits.test(sender)) return;
  if (data.size() < 4 || own_data.size() < 4) return;
  const uint8_t* p = reinterpret_cast<const uint8_t*>(data.data());
  const uint8_t* q = reinterpret_cast<const uint8_t*>(own_data.data());
  uint32_t hlen = get_be32(p);
  if (hlen != get_be32(q)) return;
  if (data.size() < 4 + (size_t)hlen) return;
  if (std::memcmp(p + 4, q + 4, hlen) != 0) return;  // header mismatch: drop
  pending.emplace_back(sender, data.substr(4 + (size_t)hlen));
  pending_bits.set(sender);
  maybe_verify();
}

void NRoot::maybe_verify() {
  // Deferred batch verification: the crossing triggers exactly when
  // verified + pending first reaches n-f — the same arrival at which the
  // per-message oracle's _signatures reaches n-f when all pending pass, and
  // re-triggers on each later arrival otherwise, so the production point is
  // positionally identical in both engines.
  if (produced || !header_posted) return;
  if (verified_count + (int)pending.size() < E->n - E->f) return;
  if (!pending.empty()) {
    std::string blob;
    for (auto& pr : pending) {
      put_be32(blob, (uint32_t)pr.first);
      put_be32(blob, (uint32_t)pr.second.size());
      blob += pr.second;
    }
    pending.clear();  // accept/reject posts update the bits re-entrantly
    E->cross(vid, XO_ROOT_VERIFY, 0, 0, blob);
  }
  if (!produced && verified_count >= E->n - E->f) {
    produced = true;
    E->cross(vid, XO_ROOT_PRODUCE, 0, 0, std::string());
  }
}

}  // namespace

// ---------------------------------------------------------------------------
// C API (ctypes binding: lachain_tpu_torch/consensus/native_rt.py)
// ---------------------------------------------------------------------------

extern "C" {

int lt_crt_version() { return 7; }

// Engines are single-threaded by contract: one engine = one queue = one
// dispatch loop. The pipelined era window (native_rt.py) therefore runs ONE
// ENGINE PER IN-FLIGHT ERA, each pumped by exactly one thread at a time —
// never this engine from two threads. The only cross-thread calls the
// binding makes are rt_request_stop (a plain bool store: worst case the
// running engine finishes its current chunk) and the read-only aggregate
// accessors. NOTE: construct engines on ONE thread only — the GF(256)
// table bootstrap (gf_init) is guarded by a non-atomic static flag.
void* rt_new(int n, int f, int mode, uint32_t repeat_ppm, uint64_t seed,
             int era0) {
  // hard cap: Bits membership masks are 512-bit. A too-large N must be a
  // clean construction failure, not silent mask corruption mid-era.
  if (n < 1 || n > 512 || f < 0) return nullptr;
  return new Engine(n, f, mode, repeat_ppm, seed, era0);
}

void rt_free(void* h) { delete static_cast<Engine*>(h); }

void rt_set_callbacks(void* h, opaque_cb_t o, acs_cb_t a, coinreq_cb_t c,
                      cross_cb_t x) {
  Engine* E = static_cast<Engine*>(h);
  E->cb_opaque = o;
  E->cb_acs = a;
  E->cb_coinreq = c;
  E->cb_cross = x;
}

// -- native crypto-protocol hosting ----------------------------------------

void rt_set_owned(void* h, int vid, int mask) {
  static_cast<Engine*>(h)->vals[vid].own_mask = (uint8_t)mask;
}

void rt_set_coin_need(void* h, int need) {
  static_cast<Engine*>(h)->coin_need = need;
}

// Divert RBC's RS+Merkle math to the host shim (XO_RBC_ENCODE/XO_RBC_NEED
// crossings answered by PO_RBC_VALS/PO_RBC_RESULT posts). Added in version
// 7; without it the engine runs its own per-message codec.
void rt_set_rbc_host(void* h, int enabled) {
  static_cast<Engine*>(h)->rbc_host = enabled != 0;
}

void rt_request(void* h, int vid, int kind, int a, int b) {
  static_cast<Engine*>(h)->native_request(vid, kind, a, b);
}

void rt_post(void* h, int vid, int op, int a, int b, const uint8_t* data,
             size_t len) {
  static_cast<Engine*>(h)->native_post(vid, op, a, b, data, len);
}

// Two-call export of a native HB's ready decrypt-share slots: size query
// with buf == NULL, then the copying call (single-threaded, so no race).
size_t rt_hb_ready_export(void* h, int vid, uint8_t* buf, size_t cap) {
  Engine* E = static_cast<Engine*>(h);
  NHB* hb = E->vals[vid].nhb;
  if (!hb) return 0;
  std::string out;
  hb->export_ready(out);
  if (!buf || out.size() > cap) return out.size();
  std::memcpy(buf, out.data(), out.size());
  return out.size();
}

uint64_t rt_native_handled(void* h) {
  return static_cast<Engine*>(h)->native_handled;
}

// Watchdog introspection: render one validator's native crypto-protocol
// state so a stall report can name where a natively-owned id is stuck.
// Under the pipelined window the binding calls this once per in-flight
// era's engine and joins the strings era-labeled, so the report spans the
// whole window; q/delivered give the engine-level delivery picture.
size_t rt_debug_state(void* h, int vid, char* buf, size_t cap) {
  Engine* E = static_cast<Engine*>(h);
  Validator& V = E->vals[vid];
  std::string s = "era=" + std::to_string(V.era) +
                  " own_mask=" + std::to_string((int)V.own_mask) +
                  " q=" + std::to_string(E->q.size()) +
                  " delivered=" + std::to_string(E->delivered);
  if (V.nhb) {
    NHB* hb = V.nhb;
    s += " hb{slots=" + std::to_string(hb->ct_slots.size()) + "/" +
         std::to_string(hb->total_slots) +
         " resolved=" + std::to_string(hb->resolved.size()) +
         " inflight=" + std::to_string(hb->inflight.size()) +
         " stash=" + std::to_string(hb->stash.size()) +
         " queued=" + std::to_string((int)hb->queued) +
         " done=" + std::to_string((int)hb->done) + "}";
  }
  int coins_open = 0;
  for (auto& kv : V.ncoin)
    if (!kv.second->done) coins_open++;
  s += " coins=" + std::to_string(V.ncoin.size()) +
       " coins_open=" + std::to_string(coins_open);
  if (V.nroot) {
    NRoot* r = V.nroot;
    s += " root{hb_done=" + std::to_string((int)r->hb_done) +
         " nonce=" + std::to_string(r->nonce_parity) +
         " header=" + std::to_string((int)r->header_posted) +
         " verified=" + std::to_string(r->verified_count) +
         " pending=" + std::to_string(r->pending.size()) +
         " early=" + std::to_string(r->early.size()) +
         " produced=" + std::to_string((int)r->produced) + "}";
  }
  if (!buf || !cap) return s.size();
  size_t ncopy = s.size() < cap ? s.size() : cap;
  std::memcpy(buf, s.data(), ncopy);
  return ncopy;
}

void rt_mute(void* h, int vid) { static_cast<Engine*>(h)->muted.set(vid); }

void rt_advance_era(void* h, int vid, int era) {
  static_cast<Engine*>(h)->advance_era(vid, era);
}

void rt_post_acs_input(void* h, int vid, const uint8_t* data, size_t len) {
  Engine* E = static_cast<Engine*>(h);
  Validator& V = E->vals[vid];
  if (!V.acs) {
    V.acs = new ACS();
    V.acs->E = E;
    V.acs->vid = vid;
  }
  V.acs->on_request(std::string(reinterpret_cast<const char*>(data), len));
}

void rt_post_coin_result(void* h, int vid, int agreement, int epoch,
                         int value) {
  Engine* E = static_cast<Engine*>(h);
  auto it = E->vals[vid].ba.find(agreement);
  if (it != E->vals[vid].ba.end())
    it->second->on_coin_result(epoch, value != 0);
}

void rt_broadcast_opaque(void* h, int vid, int kind, int agreement, int epoch,
                         const uint8_t* data, size_t len) {
  Engine* E = static_cast<Engine*>(h);
  Msg* m = new Msg();
  m->type = MT_OPAQUE;
  m->era = E->vals[vid].era;
  m->opq_kind = (uint8_t)kind;
  m->agreement = agreement;
  m->epoch = epoch;
  m->data.assign(reinterpret_cast<const char*>(data), len);
  E->bcast(vid, m);
}

// Unicast variant: one recipient instead of all n. The adversary layer uses
// this (with a caller-supplied vid) for per-recipient equivocation and
// replay — the engine itself never needed unicast opaques before.
void rt_send_opaque(void* h, int vid, int target, int kind, int agreement,
                    int epoch, const uint8_t* data, size_t len) {
  Engine* E = static_cast<Engine*>(h);
  if (target < 0 || target >= E->n) return;
  Msg* m = new Msg();
  m->type = MT_OPAQUE;
  m->era = E->vals[vid].era;
  m->opq_kind = (uint8_t)kind;
  m->agreement = agreement;
  m->epoch = epoch;
  m->data.assign(reinterpret_cast<const char*>(data), len);
  E->sendto(vid, target, m);  // deletes m itself when the sender is muted
}

size_t rt_run(void* h, size_t max_msgs) {
  return static_cast<Engine*>(h)->run(max_msgs);
}

void rt_request_stop(void* h) { static_cast<Engine*>(h)->stop_req = true; }

uint64_t rt_opaque_pending(void* h, int kind) {
  return static_cast<Engine*>(h)->opq_pending[kind & 7];
}

size_t rt_queue_len(void* h) { return static_cast<Engine*>(h)->q.size(); }

uint64_t rt_delivered(void* h) { return static_cast<Engine*>(h)->delivered; }

// -- flight recorder --------------------------------------------------------

// Raw CLOCK_MONOTONIC now, for the Python clock-offset handshake: the binding
// samples time.monotonic() around this call and keeps the tightest bracket.
uint64_t rt_monotonic_ns() { return trace_now_ns(); }

// capacity 0 disables recording entirely (no clock reads on the hot path)
void rt_trace_configure(void* h, size_t capacity) {
  static_cast<Engine*>(h)->trace.configure(capacity);
}

uint64_t rt_trace_dropped(void* h) {
  return static_cast<Engine*>(h)->trace.dropped;
}

// Two-call drain (pattern of rt_debug_state): size query with buf == NULL,
// then the copying call, which CONSUMES the ring. Output is 32-byte
// big-endian records (u64 ts_ns, u64 dur_ns, u32 kind, u32 tid, u32 a,
// u32 b); the tail carries a snapshot of the still-accumulating per-era
// dispatch-phase totals (TK_PHASE, cumulative — the merge layer keeps the
// latest record per (era, phase)).
size_t rt_trace_drain(void* h, uint8_t* buf, size_t cap) {
  Engine* E = static_cast<Engine*>(h);
  TraceRing& r = E->trace;
  std::string out;
  out.reserve((r.count + 8 * E->phase_acc.size()) * 32);
  size_t start = (r.w + r.cap - r.count) % (r.cap ? r.cap : 1);
  for (size_t i = 0; i < r.count; i++)
    trace_put_event(out, r.buf[(start + i) % r.cap]);
  uint64_t now = trace_now_ns();
  for (auto& kv : E->phase_acc)
    for (uint32_t ph = 1; ph < 8; ph++)
      if (kv.second[ph])
        trace_put_event(out, {now, kv.second[ph], TK_PHASE, 0xFFFFFFFFu, ph,
                              kv.first});
  if (!buf || out.size() > cap) return out.size();
  std::memcpy(buf, out.data(), out.size());
  r.count = 0;  // consumed (w stays: the ring keeps filling from there)
  return out.size();
}

// test/fuzz hook: drive rs_decode with arbitrary shard vectors (lens[i]==0
// marks a missing shard). Returns 1 + writes out/out_len on success, 0 on
// clean decode failure. out must hold k * max(lens) bytes.
int rt_test_rs_decode(const uint8_t* const* shard_ptrs, const size_t* lens,
                      int n, int k, uint8_t* out, size_t* out_len) {
  gf_init();  // harness may call this before any Engine exists
  std::vector<std::string> shards(n);
  for (int i = 0; i < n; i++)
    if (lens[i])
      shards[i].assign(reinterpret_cast<const char*>(shard_ptrs[i]), lens[i]);
  std::string payload;
  if (!rs_decode(shards, k, payload)) return 0;
  std::memcpy(out, payload.data(), payload.size());
  *out_len = payload.size();
  return 1;
}

}  // extern "C"

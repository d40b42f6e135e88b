// Native LSM storage engine of the port: a copy of the JAX package's
// lachain_tpu/storage/native/lsm.cpp (format v2, engine version 6), with
// only comments changed, so that either package opens the other's store
// directory. It takes the role of the C# reference's RocksDB context (one
// KV store, WAL-synced writes, atomic batches), designed small:
//
//   * memtable: arena-backed skiplist. A batch payload is copied into the
//     arena ONCE; ops are sorted views into that copy and merge into the
//     skiplist with an ascending splice (the search for key i+1 resumes
//     from key i's update path), so bulk trie batches skip the
//     per-key-from-the-top search a std::map paid.
//   * WAL: a dedicated writer thread owns the segment fd. write_batch
//     enqueues the CRC-framed record and applies the memtable while the
//     writer write()+fsync()s concurrently; the ack fires only once the
//     record is durable (persist-before-ack, which the crash
//     tests hold). Records enqueued while an fsync is
//     in flight share the next one — group commit for concurrent callers.
//   * flush: the active memtable seals into an immutable queue and a
//     background flusher streams it into an SST; the WAL rotates to a new
//     segment at each seal, and a segment is unlinked only after every
//     batch in it is durable in an SST + manifest. Replay after a crash
//     may re-apply already-flushed records — harmless, the memtable layer
//     shadows the tables with identical values.
//   * compaction: a rate-limited background worker merges ALL tables
//     (newest wins, tombstones drop — nothing older can resurrect) via
//     streaming cursors; the swap is tmp+rename+manifest-rewrite, and a
//     kill -9 at any point leaves either the old set or the new set
//     manifest-reachable with at most orphan files, which open() removes.
//   * reads: per-SSTable bloom filter + block index live in the table
//     footer; point lookups consult the filter, binary-search the block
//     index and fetch one CRC-checked ~4 KiB block through a shared LRU
//     block cache instead of paying a full per-table key index in memory.
//
// Durability contract (matches SqliteKV's synchronous=FULL batches):
//   * write_batch returns only after its WAL record is fsynced — a batch
//     is all-or-nothing across kill -9 (CRC framing; torn tail of the
//     ACTIVE segment is discarded AND truncated on open).
//   * SST + manifest land via tmp+rename+dir-fsync before any WAL segment
//     covering them is unlinked.
//
// Python binding: lachain_tpu_torch/storage/lsm.py (ctypes), built by
// ops/_build.lsm_library(). The batch wire format Python
// sends IS the WAL payload format, so the engine appends it verbatim.
// Debug-only crash surface for the torn-state matrix:
// lsm_write_batch_partial (stop after WAL encode / after fsync, never
// apply) and lsm_compact_partial (merge + rename, no manifest swap).
#include <algorithm>
#include <atomic>
#include <cerrno>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <dirent.h>
#include <fcntl.h>
#include <list>
#include <map>
#include <memory>
#include <mutex>
#include <string>
#include <string_view>
#include <sys/stat.h>
#include <thread>
#include <unistd.h>
#include <unordered_map>
#include <vector>

namespace {

typedef uint8_t u8;
typedef uint32_t u32;
typedef uint64_t u64;

// CRC32 (IEEE, table-driven)
static u32 CRC_TAB[256];
static void crc_init() {
  static bool done = false;
  if (done) return;
  done = true;
  for (u32 i = 0; i < 256; i++) {
    u32 c = i;
    for (int k = 0; k < 8; k++) c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
    CRC_TAB[i] = c;
  }
}
static u32 crc32(const u8* p, size_t n) {
  u32 c = 0xFFFFFFFFu;
  for (size_t i = 0; i < n; i++) c = CRC_TAB[(c ^ p[i]) & 0xFF] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

static void put_u32(std::string& s, u32 v) {
  for (int i = 0; i < 4; i++) s.push_back((char)((v >> (8 * i)) & 0xFF));
}
static u32 get_u32(const u8* p) {
  return (u32)p[0] | ((u32)p[1] << 8) | ((u32)p[2] << 16) | ((u32)p[3] << 24);
}
static void put_u64(std::string& s, u64 v) {
  for (int i = 0; i < 8; i++) s.push_back((char)((v >> (8 * i)) & 0xFF));
}
static u64 get_u64(const u8* p) {
  u64 v = 0;
  for (int i = 7; i >= 0; i--) v = (v << 8) | p[i];
  return v;
}

static bool write_all(int fd, const char* p, size_t n) {
  size_t done = 0;
  while (done < n) {
    ssize_t w = ::write(fd, p + done, n - done);
    if (w <= 0) return false;
    done += (size_t)w;
  }
  return true;
}

static bool fsync_path(const std::string& path) {
  int fd = ::open(path.c_str(), O_RDONLY);
  if (fd < 0) return false;
  bool ok = ::fsync(fd) == 0;
  ::close(fd);
  return ok;
}

// 64-bit mix hash (splitmix-style avalanche over FNV accumulation) for the
// bloom filter's double hashing: g_i = h1 + i*h2.
static u64 hash64(const void* data, size_t n, u64 seed) {
  const u8* p = (const u8*)data;
  u64 h = seed ^ 0xcbf29ce484222325ull;
  for (size_t i = 0; i < n; i++) {
    h ^= p[i];
    h *= 0x100000001b3ull;
  }
  h ^= h >> 33;
  h *= 0xff51afd7ed558ccdull;
  h ^= h >> 33;
  h *= 0xc4ceb9fe1a85ec53ull;
  h ^= h >> 33;
  return h;
}

constexpr int BLOOM_BITS_PER_KEY = 10;
constexpr u32 BLOOM_K = 6;
constexpr size_t BLOCK_TARGET = 4096;     // data block payload target
constexpr size_t WRITE_BUF = 1u << 20;    // table builder write coalescing
constexpr size_t IMM_QUEUE_STALL = 4;     // write-path backpressure bound

// batch payload: u32 count, then per op u8 type(0 put/1 del), u32 klen,
// key, u32 vlen, val (vlen=0 for deletes)
struct OpView {
  std::string_view key, val;
  bool del;
  u32 order;  // batch position — ties between equal keys resolve last-wins
};

static bool parse_batch_views(const u8* p, size_t n, std::vector<OpView>& out) {
  if (n < 4) return false;
  u32 count = get_u32(p);
  size_t off = 4;
  out.clear();
  out.reserve(count);
  for (u32 i = 0; i < count; i++) {
    if (off + 5 > n) return false;
    u8 type = p[off];
    off += 1;
    u32 klen = get_u32(p + off);
    off += 4;
    if (klen > n || off + klen + 4 > n) return false;
    std::string_view key((const char*)p + off, klen);
    off += klen;
    u32 vlen = get_u32(p + off);
    off += 4;
    if (vlen > n || off + vlen > n) return false;
    std::string_view val((const char*)p + off, vlen);
    off += vlen;
    out.push_back(OpView{key, val, type == 1, i});
  }
  return off == n;
}

// ---------------------------------------------------------------------------
// Memtable: arena-backed skiplist
// ---------------------------------------------------------------------------

constexpr int SKIP_MAX_HEIGHT = 12;

struct SkipNode {
  std::string_view key, val;
  bool del;
  int height;
  SkipNode* next[1];  // over-allocated to `height`
};

struct Memtable {
  SkipNode* head;
  size_t bytes = 0;
  size_t count = 0;
  u64 wal_segment = 0;  // segment whose records this memtable holds
  std::vector<std::string*> arena;  // owned batch payload copies
  u64 rnd = 0x9E3779B97F4A7C15ull;
  SkipNode* prev[SKIP_MAX_HEIGHT];

  Memtable() {
    head = alloc_node(SKIP_MAX_HEIGHT);
    for (int i = 0; i < SKIP_MAX_HEIGHT; i++) head->next[i] = nullptr;
  }
  ~Memtable() {
    SkipNode* n = head;
    while (n) {
      SkipNode* nx = n->next[0];
      free(n);
      n = nx;
    }
    for (auto* s : arena) delete s;
  }
  Memtable(const Memtable&) = delete;
  Memtable& operator=(const Memtable&) = delete;

  static SkipNode* alloc_node(int h) {
    SkipNode* n = (SkipNode*)malloc(sizeof(SkipNode) +
                                    (size_t)(h - 1) * sizeof(SkipNode*));
    n->height = h;
    return n;
  }

  int random_height() {
    rnd ^= rnd << 13;
    rnd ^= rnd >> 7;
    rnd ^= rnd << 17;
    int h = 1;
    u64 r = rnd;
    while (h < SKIP_MAX_HEIGHT && (r & 3) == 0) {
      h++;
      r >>= 2;
    }
    return h;
  }

  // Fill prev[] with the update path for `key`, starting the search at
  // `start` (head, or the previous insert's path when keys ascend — the
  // sorted-batch splice that makes bulk ingest near-linear).
  void find_path(std::string_view key, SkipNode* start) {
    SkipNode* x = start;
    for (int lvl = SKIP_MAX_HEIGHT - 1; lvl >= 0; lvl--) {
      while (x->next[lvl] && x->next[lvl]->key < key) x = x->next[lvl];
      prev[lvl] = x;
    }
  }

  // prev[] must hold the update path for `key` (find_path). Last-wins.
  void insert_at_path(std::string_view key, std::string_view val, bool del) {
    SkipNode* cur = prev[0]->next[0];
    if (cur && cur->key == key) {
      bytes += val.size() - cur->val.size();
      cur->val = val;
      cur->del = del;
      return;
    }
    int h = random_height();
    SkipNode* n = alloc_node(h);
    n->key = key;
    n->val = val;
    n->del = del;
    for (int i = 0; i < h; i++) {
      n->next[i] = prev[i]->next[i];
      prev[i]->next[i] = n;
    }
    bytes += key.size() + val.size() + sizeof(SkipNode) +
             (size_t)h * sizeof(SkipNode*);
    count++;
  }

  // Ingest one parsed batch: sort the views, then splice in ascending
  // order. `payload_copy` ownership transfers to the arena.
  void ingest(std::string* payload_copy, std::vector<OpView>& ops) {
    arena.push_back(payload_copy);
    std::sort(ops.begin(), ops.end(), [](const OpView& a, const OpView& b) {
      if (a.key != b.key) return a.key < b.key;
      return a.order < b.order;
    });
    SkipNode* start = head;
    std::string_view last_key;
    bool have_last = false;
    for (auto& op : ops) {
      if (have_last && op.key == last_key) {
        // duplicate within the batch: overwrite in place (path still valid)
        insert_at_path(op.key, op.val, op.del);
        continue;
      }
      find_path(op.key, start);
      insert_at_path(op.key, op.val, op.del);
      // every prev[] node keys < op.key <= next keys: resume from the
      // highest-level predecessor instead of head
      start = prev[SKIP_MAX_HEIGHT - 1];
      last_key = op.key;
      have_last = true;
    }
  }

  // 1 found (val/del out), 0 absent
  int find(std::string_view key, std::string_view& val, bool& del) const {
    SkipNode* x = head;
    for (int lvl = SKIP_MAX_HEIGHT - 1; lvl >= 0; lvl--) {
      while (x->next[lvl] && x->next[lvl]->key < key) x = x->next[lvl];
    }
    SkipNode* cur = x->next[0];
    if (cur && cur->key == key) {
      val = cur->val;
      del = cur->del;
      return 1;
    }
    return 0;
  }

  SkipNode* lower_bound(std::string_view key) const {
    SkipNode* x = head;
    for (int lvl = SKIP_MAX_HEIGHT - 1; lvl >= 0; lvl--) {
      while (x->next[lvl] && x->next[lvl]->key < key) x = x->next[lvl];
    }
    return x->next[0];
  }

  SkipNode* first() const { return head->next[0]; }
  bool empty() const { return head->next[0] == nullptr; }
};

// ---------------------------------------------------------------------------
// SSTable v2:
//   "LSS2" | data blocks | bloom filter | index | footer "2SSL"
// data block: entries (u8 type, u32 klen, key, u32 vlen, val)*, ~4 KiB
// index: u32 min_klen, min_key, then per block
//        (u32 last_klen, last_key, u64 off, u32 len, u32 crc)
// footer (44 bytes): u64 filter_off, u64 index_off, u32 filter_len,
//        u32 block_count, u32 bloom_k, u64 entry_count,
//        u32 crc(filter+index), "2SSL"
// ---------------------------------------------------------------------------

constexpr size_t FOOTER_LEN = 44;

struct BlockMeta {
  std::string last_key;
  u64 off;
  u32 len;
  u32 crc;
};

struct Table {
  std::string path;
  int fd = -1;
  u64 id = 0;  // process-unique block-cache namespace
  u64 entry_count = 0;
  u32 bloom_k = BLOOM_K;
  std::string bloom;  // bit array
  std::string min_key, max_key;
  std::vector<BlockMeta> blocks;

  ~Table() {
    if (fd >= 0) ::close(fd);
  }

  bool bloom_may_contain(std::string_view key) const {
    if (bloom.empty()) return true;
    u64 h1 = hash64(key.data(), key.size(), 0x6c736d31);
    u64 h2 = hash64(key.data(), key.size(), 0x6c736d32) | 1;
    u64 nbits = (u64)bloom.size() * 8;
    for (u32 i = 0; i < bloom_k; i++) {
      u64 bit = (h1 + i * h2) % nbits;
      if (!((u8)bloom[bit / 8] & (1u << (bit % 8)))) return false;
    }
    return true;
  }
};

// Streaming SST writer: data blocks coalesced through a write buffer, key
// hashes collected for the bloom filter sized at finish(). The optional
// throttle (compaction rate limiting) runs per flushed buffer OFF the
// engine lock.
struct TableBuilder {
  std::string path, tmp;
  int fd = -1;
  std::string buf;      // pending file bytes
  std::string block;    // current data block
  std::string last_key;
  std::string first_key;
  bool has_first = false;
  u64 file_off = 4;     // past magic
  u64 entries = 0;
  std::vector<BlockMeta> metas;
  std::vector<std::pair<u64, u64>> hashes;
  u64 (*throttle)(void*, u64) = nullptr;  // (ctx, bytes) -> ignored
  void* throttle_ctx = nullptr;

  bool open(const std::string& p) {
    path = p;
    tmp = p + ".tmp";
    fd = ::open(tmp.c_str(), O_WRONLY | O_CREAT | O_TRUNC, 0644);
    if (fd < 0) return false;
    buf = "LSS2";
    return true;
  }

  bool spill() {
    if (buf.empty()) return true;
    if (!write_all(fd, buf.data(), buf.size())) return false;
    if (throttle) throttle(throttle_ctx, buf.size());
    buf.clear();
    return true;
  }

  void emit_block() {
    if (block.empty()) return;
    BlockMeta m;
    m.last_key = last_key;
    m.off = file_off;
    m.len = (u32)block.size();
    m.crc = crc32((const u8*)block.data(), block.size());
    metas.push_back(std::move(m));
    file_off += block.size();
    buf += block;
    block.clear();
  }

  bool add(std::string_view key, std::string_view val, bool del) {
    if (!has_first) {
      first_key.assign(key.data(), key.size());
      has_first = true;
    }
    block.push_back(del ? 1 : 0);
    put_u32(block, (u32)key.size());
    block.append(key.data(), key.size());
    put_u32(block, (u32)val.size());
    block.append(val.data(), val.size());
    last_key.assign(key.data(), key.size());
    hashes.emplace_back(hash64(key.data(), key.size(), 0x6c736d31),
                        hash64(key.data(), key.size(), 0x6c736d32) | 1);
    entries++;
    if (block.size() >= BLOCK_TARGET) {
      emit_block();
      if (buf.size() >= WRITE_BUF && !spill()) return false;
    }
    return true;
  }

  void abandon() {
    if (fd >= 0) ::close(fd);
    fd = -1;
    ::unlink(tmp.c_str());
  }

  bool finish() {
    emit_block();
    // bloom filter sized to the final entry count
    std::string filter;
    if (entries) {
      u64 nbits = entries * BLOOM_BITS_PER_KEY;
      filter.assign((nbits + 7) / 8, '\0');
      nbits = (u64)filter.size() * 8;
      for (auto& h : hashes)
        for (u32 i = 0; i < BLOOM_K; i++) {
          u64 bit = (h.first + i * h.second) % nbits;
          filter[bit / 8] = (char)((u8)filter[bit / 8] | (1u << (bit % 8)));
        }
    }
    u64 filter_off = file_off;
    std::string index;
    put_u32(index, (u32)first_key.size());
    index += first_key;
    for (auto& m : metas) {
      put_u32(index, (u32)m.last_key.size());
      index += m.last_key;
      put_u64(index, m.off);
      put_u32(index, m.len);
      put_u32(index, m.crc);
    }
    u64 index_off = filter_off + filter.size();
    std::string tail = filter + index;
    u32 crc = crc32((const u8*)tail.data(), tail.size());
    std::string footer;
    put_u64(footer, filter_off);
    put_u64(footer, index_off);
    put_u32(footer, (u32)filter.size());
    put_u32(footer, (u32)metas.size());
    put_u32(footer, BLOOM_K);
    put_u64(footer, entries);
    put_u32(footer, crc);
    footer += "2SSL";
    buf += tail;
    buf += footer;
    if (!spill() || ::fsync(fd) != 0) {
      abandon();
      return false;
    }
    ::close(fd);
    fd = -1;
    if (::rename(tmp.c_str(), path.c_str()) != 0) {
      ::unlink(tmp.c_str());
      return false;
    }
    return true;
  }
};

static bool load_table_inner(Table& t) {
  t.fd = ::open(t.path.c_str(), O_RDONLY);
  if (t.fd < 0) return false;
  off_t size = ::lseek(t.fd, 0, SEEK_END);
  if (size < (off_t)(4 + FOOTER_LEN)) return false;
  u8 footer[FOOTER_LEN];
  if (::pread(t.fd, footer, FOOTER_LEN, size - FOOTER_LEN) !=
      (ssize_t)FOOTER_LEN)
    return false;
  if (memcmp(footer + FOOTER_LEN - 4, "2SSL", 4) != 0) return false;
  u64 filter_off = get_u64(footer);
  u64 index_off = get_u64(footer + 8);
  u32 filter_len = get_u32(footer + 16);
  u32 block_count = get_u32(footer + 20);
  t.bloom_k = get_u32(footer + 24);
  t.entry_count = get_u64(footer + 28);
  u32 want_crc = get_u32(footer + 36);
  u64 tail_end = (u64)size - FOOTER_LEN;
  if (filter_off > tail_end || index_off < filter_off ||
      index_off > tail_end || index_off - filter_off != filter_len ||
      t.bloom_k == 0 || t.bloom_k > 32)
    return false;
  size_t tail_len = (size_t)(tail_end - filter_off);
  std::vector<u8> tail(tail_len);
  if (tail_len && ::pread(t.fd, tail.data(), tail_len, (off_t)filter_off) !=
                      (ssize_t)tail_len)
    return false;
  if (crc32(tail.data(), tail_len) != want_crc) return false;
  t.bloom.assign((const char*)tail.data(), filter_len);
  const u8* idx = tail.data() + filter_len;
  size_t ilen = tail_len - filter_len;
  size_t off = 0;
  if (off + 4 > ilen) return false;
  u32 minklen = get_u32(idx + off);
  off += 4;
  if (minklen > ilen || off + minklen > ilen) return false;
  t.min_key.assign((const char*)idx + off, minklen);
  off += minklen;
  t.blocks.clear();
  t.blocks.reserve(block_count);
  for (u32 i = 0; i < block_count; i++) {
    if (off + 4 > ilen) return false;
    u32 klen = get_u32(idx + off);
    off += 4;
    if (klen > ilen || off + klen + 16 > ilen) return false;
    BlockMeta m;
    m.last_key.assign((const char*)idx + off, klen);
    off += klen;
    m.off = get_u64(idx + off);
    off += 8;
    m.len = get_u32(idx + off);
    off += 4;
    m.crc = get_u32(idx + off);
    off += 4;
    if (m.off < 4 || m.off + m.len > filter_off) return false;
    t.blocks.push_back(std::move(m));
  }
  if (off != ilen) return false;
  t.max_key = t.blocks.empty() ? t.min_key : t.blocks.back().last_key;
  return true;
}

static bool load_table(Table& t) {
  // on ANY failure the fd must close here: a corrupted store is retried by
  // operators, and a long-lived process probing bad dirs must not leak fds
  if (!load_table_inner(t)) {
    if (t.fd >= 0) ::close(t.fd);
    t.fd = -1;
    return false;
  }
  return true;
}

// entry parse within a loaded block; returns false on structural overrun
struct BlockParse {
  const u8* p = nullptr;
  size_t n = 0, off = 0;
  std::string_view key{}, val{};
  bool del = false;
  bool next() {
    if (off >= n) return false;
    if (off + 9 > n) return false;
    del = p[off] == 1;
    u32 klen = get_u32(p + off + 1);
    size_t o = off + 5;
    if (klen > n || o + klen + 4 > n) return false;
    key = std::string_view((const char*)p + o, klen);
    o += klen;
    u32 vlen = get_u32(p + o);
    o += 4;
    if (vlen > n || o + vlen > n) return false;
    val = std::string_view((const char*)p + o, vlen);
    off = o + vlen;
    return true;
  }
};

// ---------------------------------------------------------------------------
// Shared LRU block cache (point reads only; scans and compaction stream
// past it to avoid pollution)
// ---------------------------------------------------------------------------

struct BlockCache {
  struct Key {
    u64 tid, off;
    bool operator==(const Key& o) const { return tid == o.tid && off == o.off; }
  };
  struct KeyHash {
    size_t operator()(const Key& k) const {
      return (size_t)(k.tid * 0x9E3779B97F4A7C15ull ^ k.off);
    }
  };
  struct Entry {
    std::shared_ptr<std::string> data;
    std::list<Key>::iterator lru_it;
  };
  size_t cap = 32u << 20;
  size_t size = 0;
  std::unordered_map<Key, Entry, KeyHash> map;
  std::list<Key> lru;  // front = most recent

  std::shared_ptr<std::string> get(u64 tid, u64 off) {
    auto it = map.find(Key{tid, off});
    if (it == map.end()) return nullptr;
    lru.splice(lru.begin(), lru, it->second.lru_it);
    return it->second.data;
  }

  void put(u64 tid, u64 off, std::shared_ptr<std::string> data) {
    Key k{tid, off};
    if (map.count(k)) return;
    lru.push_front(k);
    size += data->size();
    map.emplace(k, Entry{std::move(data), lru.begin()});
    while (size > cap && !lru.empty()) {
      Key victim = lru.back();
      auto vit = map.find(victim);
      size -= vit->second.data->size();
      map.erase(vit);
      lru.pop_back();
    }
  }

  void drop_table(u64 tid) {
    for (auto it = map.begin(); it != map.end();) {
      if (it->first.tid == tid) {
        size -= it->second.data->size();
        lru.erase(it->second.lru_it);
        it = map.erase(it);
      } else {
        ++it;
      }
    }
  }
};

// Streaming cursor over one table (scan/compaction path, no cache)
struct TableCursor {
  const Table* t = nullptr;
  size_t bi = 0;
  std::string block;
  BlockParse bp{nullptr, 0};
  bool valid = false;
  bool io_error = false;

  bool load_block(size_t i) {
    if (i >= t->blocks.size()) {
      valid = false;
      return false;
    }
    const BlockMeta& m = t->blocks[i];
    block.resize(m.len);
    if (m.len && ::pread(t->fd, &block[0], m.len, (off_t)m.off) !=
                     (ssize_t)m.len) {
      io_error = true;
      valid = false;
      return false;
    }
    if (crc32((const u8*)block.data(), block.size()) != m.crc) {
      io_error = true;
      valid = false;
      return false;
    }
    bi = i;
    bp = BlockParse{(const u8*)block.data(), block.size()};
    return true;
  }

  void start(const Table* table) {
    t = table;
    valid = false;
    io_error = false;
    if (t->blocks.empty()) return;
    if (load_block(0)) step();
  }

  void seek(const Table* table, std::string_view key) {
    t = table;
    valid = false;
    io_error = false;
    // first block whose last_key >= key
    size_t lo = 0, hi = t->blocks.size();
    while (lo < hi) {
      size_t mid = (lo + hi) / 2;
      if (std::string_view(t->blocks[mid].last_key) < key)
        lo = mid + 1;
      else
        hi = mid;
    }
    if (lo >= t->blocks.size()) return;
    if (!load_block(lo)) return;
    step();
    while (valid && bp.key < key) {
      // advance within the block; BlockParse::key points into `block`
      step();
    }
    // cursor fields (key/val) are bp's views
  }

  void step() {
    if (bp.next()) {
      valid = true;
      return;
    }
    if (bp.off != bp.n) {  // structural damage inside the block
      io_error = true;
      valid = false;
      return;
    }
    if (bi + 1 < t->blocks.size()) {
      if (load_block(bi + 1)) step();
      return;
    }
    valid = false;
  }

  std::string_view key() const { return bp.key; }
  std::string_view val() const { return bp.val; }
  bool del() const { return bp.del; }
};

// ---------------------------------------------------------------------------
// Flight-recorder trace ring (shared 32-byte big-endian record layout with
// consensus/native/consensus_rt.cpp and utils/tracing.py). Unlike the
// consensus engine this store is multi-threaded, so the ring takes its own
// leaf mutex and every record carries the emitting thread's role as its tid
// — the merge layer renders those as named threads (wal writer / flusher /
// compactor) in the Chrome trace. Timestamps are raw CLOCK_MONOTONIC ns;
// lsm_monotonic_ns anchors the Python clock-offset handshake.
// ---------------------------------------------------------------------------

static inline u64 trace_now_ns() {
  return (u64)std::chrono::duration_cast<std::chrono::nanoseconds>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

enum LsmTraceKind : u32 {
  LK_WAL_ENQ = 20,    // span: record encode (crc+frame); a=payload bytes
  LK_WAL_FSYNC = 21,  // span: write+fsync; a=group-commit records, b=bytes
  LK_SEAL = 22,       // instant: memtable sealed; a=bytes, b=new segment
  LK_FLUSH = 23,      // span: memtable -> SST; a=bytes, b=sst seq
  LK_COMPACT = 24,    // span: full merge; a=input tables, b=output seq
  LK_WAIT = 25,       // span: caller blocked; a=wait resource (4=fsync)
};

enum LsmTraceTid : u32 {
  LT_CALLER = 0,  // API caller thread (write/seal path)
  LT_WAL = 1,
  LT_FLUSHER = 2,
  LT_COMPACTOR = 3,
};

struct TraceEvent {
  u64 ts_ns, dur_ns;
  u32 kind, tid, a, b;
};

struct TraceRing {
  std::mutex mu;  // leaf lock: push/drain only, never acquires another
  std::vector<TraceEvent> buf;
  size_t cap = 16384;
  size_t w = 0, count = 0;
  u64 dropped = 0;
  std::atomic<bool> enabled{true};

  void configure(size_t capacity) {
    std::lock_guard<std::mutex> g(mu);
    buf.clear();
    w = count = 0;
    cap = capacity;
    enabled.store(capacity > 0, std::memory_order_relaxed);
  }
  void push(u64 ts, u64 dur, u32 kind, u32 tid, u32 a, u32 b) {
    if (!enabled.load(std::memory_order_relaxed)) return;
    std::lock_guard<std::mutex> g(mu);
    if (!cap) return;
    if (buf.size() != cap) buf.resize(cap);
    buf[w] = {ts, dur, kind, tid, a, b};
    w = (w + 1) % cap;
    if (count < cap)
      count++;
    else
      dropped++;  // overwrote the oldest unread record
  }
};

static inline void trace_put32(std::string& out, u32 v) {
  char b[4] = {(char)(v >> 24), (char)(v >> 16), (char)(v >> 8), (char)v};
  out.append(b, 4);
}

static inline void trace_put64(std::string& out, u64 v) {
  trace_put32(out, (u32)(v >> 32));
  trace_put32(out, (u32)v);
}

static inline u32 trace_clamp32(u64 v) {
  return v > 0xFFFFFFFFull ? 0xFFFFFFFFu : (u32)v;
}

// ---------------------------------------------------------------------------
// Engine
// ---------------------------------------------------------------------------

struct Stats {
  u64 bloom_neg = 0;    // filter ruled a table out (saved a block fetch)
  u64 bloom_pass = 0;   // filter passed; block consulted
  u64 cache_hit = 0;
  u64 cache_miss = 0;
  u64 wal_fsyncs = 0;
  u64 wal_records = 0;
  u64 compactions = 0;
};

struct Lsm {
  std::string dir;
  size_t flush_threshold = 32u << 20;  // active-memtable seal point
  size_t compact_tables = 6;           // full-compact beyond this many
  u64 compact_rate_mbps = 0;           // 0 = unthrottled
  u64 next_seq = 1;                    // SST file sequence
  u64 next_segment = 1;                // WAL segment id
  u64 oldest_segment = 1;              // lowest segment possibly on disk
  u64 next_table_id = 1;               // block-cache namespace

  // db state (memtables, tables, manifest) — guarded by mu/db_cv
  std::mutex mu;
  std::condition_variable db_cv;
  std::unique_ptr<Memtable> mem;
  std::deque<std::unique_ptr<Memtable>> imm;  // oldest..newest, sealed
  std::vector<std::unique_ptr<Table>> tables;  // oldest..newest
  BlockCache cache;
  Stats stats;
  TraceRing trace;  // flight recorder (own leaf mutex, see TraceRing)
  bool io_failed = false;  // a background flush failed: fail fast, loudly

  // WAL writer — guarded by wal_mu
  std::mutex wal_mu;
  std::condition_variable wal_work, wal_done;
  std::string wal_pending;
  u64 wal_enqueued = 0, wal_durable = 0;
  int wal_fd = -1;
  bool wal_stop = false, wal_error = false;
  std::thread wal_thr;

  // flusher / compactor control — guarded by bg_mu
  std::mutex bg_mu;
  std::condition_variable bg_cv;
  bool flush_stop = false;
  std::thread flush_thr;
  bool compact_requested = false, compact_running = false,
       compact_stop = false;
  std::thread compact_thr;

  std::string manifest_path() const { return dir + "/MANIFEST"; }
  std::string table_path(u64 seq) const {
    char buf[40];
    snprintf(buf, sizeof buf, "/sst_%012llu.dat", (unsigned long long)seq);
    return dir + buf;
  }
  std::string segment_path(u64 id) const {
    char buf[32];
    snprintf(buf, sizeof buf, "/wal_%06llu.log", (unsigned long long)id);
    return dir + buf;
  }

  // ---- manifest ------------------------------------------------------------

  bool write_manifest_locked() {
    std::string body;
    for (auto& t : tables) {
      size_t slash = t->path.rfind('/');
      body += t->path.substr(slash + 1);
      body.push_back('\n');
    }
    std::string tmp = manifest_path() + ".tmp";
    int fd = ::open(tmp.c_str(), O_WRONLY | O_CREAT | O_TRUNC, 0644);
    if (fd < 0) return false;
    if (!write_all(fd, body.data(), body.size()) || ::fsync(fd) != 0) {
      ::close(fd);
      return false;
    }
    ::close(fd);
    if (::rename(tmp.c_str(), manifest_path().c_str()) != 0) return false;
    return fsync_path(dir);
  }

  // ---- open / recovery -----------------------------------------------------

  bool open_dirs() {
    crc_init();
    ::mkdir(dir.c_str(), 0755);
    // a v1-era store (single wal.log + "LSST" tables) predates the segment
    // format: refuse loudly rather than silently ignoring its WAL
    struct stat st;
    if (::stat((dir + "/wal.log").c_str(), &st) == 0 && st.st_size > 0)
      return false;
    // manifest -> tables
    tables.clear();
    FILE* mf = fopen(manifest_path().c_str(), "r");
    std::vector<std::string> manifest_names;
    if (mf) {
      char line[256];
      while (fgets(line, sizeof line, mf)) {
        size_t n = strlen(line);
        while (n && (line[n - 1] == '\n' || line[n - 1] == '\r')) line[--n] = 0;
        if (!n) continue;
        manifest_names.push_back(line);
        auto t = std::make_unique<Table>();
        t->path = dir + "/" + line;
        t->id = next_table_id++;
        if (!load_table(*t)) {
          fclose(mf);
          tables.clear();
          return false;
        }
        unsigned long long seq = 0;
        sscanf(line, "sst_%012llu.dat", &seq);
        if (seq >= next_seq) next_seq = seq + 1;
        tables.push_back(std::move(t));
      }
      fclose(mf);
    }
    // directory sweep: orphan SSTs (flush/compaction output whose manifest
    // swap never landed — their data is still WAL- or manifest-reachable),
    // stale .tmp files, and the WAL segment inventory
    std::vector<u64> segments;
    DIR* d = opendir(dir.c_str());
    if (!d) {
      tables.clear();
      return false;
    }
    while (dirent* e = readdir(d)) {
      std::string name = e->d_name;
      unsigned long long num = 0;
      if (name.size() > 4 &&
          name.compare(name.size() - 4, 4, ".tmp") == 0) {
        ::unlink((dir + "/" + name).c_str());
      } else if (sscanf(name.c_str(), "sst_%012llu.dat", &num) == 1) {
        if (num >= next_seq) next_seq = num + 1;
        bool in_manifest = false;
        for (auto& m : manifest_names)
          if (m == name) {
            in_manifest = true;
            break;
          }
        if (!in_manifest) ::unlink((dir + "/" + name).c_str());
      } else if (sscanf(name.c_str(), "wal_%06llu.log", &num) == 1) {
        segments.push_back(num);
      }
    }
    closedir(d);
    std::sort(segments.begin(), segments.end());

    // WAL replay, oldest segment first. Only the LAST (active) segment may
    // carry a torn tail — it is discarded AND truncated on disk (garbage
    // ahead of future appends would strand every later record). A bad
    // record in an earlier, sealed segment is corruption: refuse.
    mem = std::make_unique<Memtable>();
    for (size_t si = 0; si < segments.size(); si++) {
      bool is_last = si + 1 == segments.size();
      std::string path = segment_path(segments[si]);
      int rfd = ::open(path.c_str(), O_RDONLY);
      if (rfd < 0) {
        tables.clear();
        return false;
      }
      off_t size = ::lseek(rfd, 0, SEEK_END);
      std::vector<u8> buf((size_t)size);
      if (size > 0 &&
          ::pread(rfd, buf.data(), (size_t)size, 0) != (ssize_t)size) {
        ::close(rfd);
        tables.clear();
        return false;
      }
      ::close(rfd);
      size_t off = 0;
      while (off + 8 <= buf.size()) {
        u32 crc = get_u32(buf.data() + off);
        u32 len = get_u32(buf.data() + off + 4);
        if (len > buf.size() || off + 8 + len > buf.size()) break;
        if (crc32(buf.data() + off + 8, len) != crc) break;
        auto* copy = new std::string((const char*)buf.data() + off + 8, len);
        std::vector<OpView> ops;
        if (!parse_batch_views((const u8*)copy->data(), copy->size(), ops)) {
          delete copy;
          break;
        }
        mem->ingest(copy, ops);
        off += 8 + len;
      }
      if (off < buf.size()) {
        if (!is_last) {
          tables.clear();
          return false;
        }
        int tfd = ::open(path.c_str(), O_WRONLY);
        bool ok = tfd >= 0 && ::ftruncate(tfd, (off_t)off) == 0 &&
                  ::fsync(tfd) == 0;
        if (tfd >= 0) ::close(tfd);
        if (!ok) {
          tables.clear();
          return false;
        }
      }
    }
    u64 active = segments.empty() ? 1 : segments.back();
    next_segment = active + 1;
    oldest_segment = segments.empty() ? 1 : segments.front();
    mem->wal_segment = active;
    wal_fd = ::open(segment_path(active).c_str(),
                    O_WRONLY | O_CREAT | O_APPEND, 0644);
    if (wal_fd < 0) {
      tables.clear();
      return false;
    }
    // workers only start once recovery is committed
    wal_thr = std::thread([this] { wal_loop(); });
    flush_thr = std::thread([this] { flush_loop(); });
    compact_thr = std::thread([this] { compact_loop(); });
    // a replayed memtable over the seal point flushes like any other
    std::unique_lock<std::mutex> lk(mu);
    if (mem->bytes >= flush_threshold) seal_memtable(lk);
    return true;
  }

  // ---- WAL writer ----------------------------------------------------------

  void wal_loop() {
    std::unique_lock<std::mutex> lk(wal_mu);
    for (;;) {
      wal_work.wait(lk, [&] { return wal_stop || !wal_pending.empty(); });
      if (wal_pending.empty() && wal_stop) break;
      std::string buf;
      buf.swap(wal_pending);
      u64 through = wal_enqueued;
      u64 batch = through - wal_durable;  // group-commit size (records)
      int fd = wal_fd;
      lk.unlock();
      u64 t0 = trace_now_ns();
      bool ok = write_all(fd, buf.data(), buf.size()) && ::fsync(fd) == 0;
      if (ok)
        trace.push(t0, trace_now_ns() - t0, LK_WAL_FSYNC, LT_WAL,
                   trace_clamp32(batch), trace_clamp32(buf.size()));
      lk.lock();
      if (!ok) {
        wal_error = true;
      } else {
        wal_durable = through;
        stats_wal_fsyncs++;
      }
      wal_done.notify_all();
    }
  }
  u64 stats_wal_fsyncs = 0;  // wal_mu

  // caller holds mu (ordering: mu -> wal_mu). Returns the record's seq.
  u64 wal_enqueue_locked(const u8* payload, size_t len) {
    u64 t0 = trace_now_ns();
    std::string rec;
    rec.reserve(len + 8);
    put_u32(rec, crc32(payload, len));
    put_u32(rec, (u32)len);
    rec.append((const char*)payload, len);
    trace.push(t0, trace_now_ns() - t0, LK_WAL_ENQ, LT_CALLER,
               trace_clamp32(len), 0);
    std::lock_guard<std::mutex> g(wal_mu);
    wal_pending += rec;
    u64 seq = ++wal_enqueued;
    wal_work.notify_one();
    return seq;
  }

  // block until `seq` is durable (or the writer failed). No locks held on
  // entry — this is the post-apply ack wait.
  bool wal_wait(u64 seq) {
    std::unique_lock<std::mutex> lk(wal_mu);
    if (wal_error || wal_durable >= seq) return !wal_error;
    // the caller genuinely blocks on durability: record the wait so the
    // era report can attribute it to the fsync bucket
    bool timed = trace.enabled.load(std::memory_order_relaxed);
    u64 t0 = timed ? trace_now_ns() : 0;
    wal_done.wait(lk, [&] { return wal_error || wal_durable >= seq; });
    if (timed)
      trace.push(t0, trace_now_ns() - t0, LK_WAIT, LT_CALLER, 4, 0);
    return !wal_error;
  }

  // drain the writer completely (rotation/flush/debug). Caller holds mu.
  bool wal_drain_locked() {
    std::unique_lock<std::mutex> lk(wal_mu);
    wal_done.wait(lk, [&] {
      return wal_error || (wal_pending.empty() && wal_durable == wal_enqueued);
    });
    return !wal_error;
  }

  // ---- write path ----------------------------------------------------------

  // Seal the active memtable into the immutable queue and rotate the WAL
  // to a fresh segment. Caller holds mu (as unique_lock, for backpressure).
  bool seal_memtable(std::unique_lock<std::mutex>& lk) {
    if (mem->empty()) return true;
    // every record of this memtable must be on disk before the segment is
    // considered sealed (a sealed segment is never torn)
    if (!wal_drain_locked()) return false;
    u64 seg = next_segment++;
    int nfd = ::open(segment_path(seg).c_str(),
                     O_WRONLY | O_CREAT | O_APPEND, 0644);
    if (nfd < 0) return false;
    {
      std::lock_guard<std::mutex> g(wal_mu);
      ::close(wal_fd);
      wal_fd = nfd;
    }
    trace.push(trace_now_ns(), 0, LK_SEAL, LT_CALLER,
               trace_clamp32(mem->bytes), trace_clamp32(seg));
    imm.push_back(std::move(mem));
    mem = std::make_unique<Memtable>();
    mem->wal_segment = seg;
    db_cv.notify_all();  // the flusher waits on db_cv
    // backpressure: a writer outrunning the flusher stalls here instead of
    // queueing unbounded sealed memtables
    db_cv.wait(lk, [&] {
      return imm.size() < IMM_QUEUE_STALL || io_failed || flush_stop;
    });
    return !io_failed;
  }

  int write_batch(const u8* payload, size_t len) {
    auto* copy = new std::string((const char*)payload, len);
    std::vector<OpView> ops;
    if (!parse_batch_views((const u8*)copy->data(), copy->size(), ops)) {
      delete copy;
      return -1;
    }
    u64 seq;
    {
      std::unique_lock<std::mutex> lk(mu);
      if (io_failed) {
        delete copy;
        return -1;
      }
      // enqueue first: the writer thread overlaps the write()+fsync() with
      // the memtable splice below
      seq = wal_enqueue_locked(payload, len);
      {
        std::lock_guard<std::mutex> g(wal_mu);
        stats.wal_records++;
      }
      mem->ingest(copy, ops);
      if (mem->bytes >= flush_threshold) {
        if (!seal_memtable(lk)) return -1;
      }
    }
    // ack strictly after the WAL fsync (persist-before-ack)
    return wal_wait(seq) ? 0 : -1;
  }

  // write_batch minus the durability wait: enqueue onto the writer thread,
  // splice the memtable, return the WAL seq as an async ticket. The caller
  // overlaps its next work (more trie hashing, the next batch's encode)
  // with this record's write()+fsync(), then collects durability via
  // write_barrier before acking anything that references the batch. The
  // WAL is append-ordered, so a later record's fsync implies this one's.
  // Returns 0 on failure (seqs start at 1).
  u64 write_batch_async(const u8* payload, size_t len) {
    auto* copy = new std::string((const char*)payload, len);
    std::vector<OpView> ops;
    if (!parse_batch_views((const u8*)copy->data(), copy->size(), ops)) {
      delete copy;
      return 0;
    }
    u64 seq;
    {
      std::unique_lock<std::mutex> lk(mu);
      if (io_failed) {
        delete copy;
        return 0;
      }
      seq = wal_enqueue_locked(payload, len);
      {
        std::lock_guard<std::mutex> g(wal_mu);
        stats.wal_records++;
      }
      mem->ingest(copy, ops);
      if (mem->bytes >= flush_threshold) {
        if (!seal_memtable(lk)) return 0;
      }
    }
    return seq;
  }

  int write_barrier(u64 seq) { return wal_wait(seq) ? 0 : -1; }

  // Debug crash surface: run the write pipeline only up to `stage`, never
  // applying the memtable — the torn windows the crash matrix needs.
  //   stage 0 ("encoded, not fsynced"): a PREFIX of the record reaches the
  //     segment (last byte dropped, no fsync) — the torn-tail image an
  //     unflushed page cache can leave; replay must discard+truncate it.
  //   stage 1 ("fsynced, not applied/acked"): the full record is durable
  //     but the caller never got its ack; replay must apply it (the
  //     contract is acked => durable, not the converse).
  // Deterministic in BOTH harness modes (in-process raise and SIGKILL):
  // the bytes on disk are identical either way. The engine must be closed
  // afterwards (its memtable no longer matches the replay state).
  int write_batch_partial(const u8* payload, size_t len, int stage) {
    std::vector<OpView> ops;
    if (!parse_batch_views(payload, len, ops)) return -1;
    std::unique_lock<std::mutex> lk(mu);
    if (!wal_drain_locked()) return -1;
    std::string rec;
    put_u32(rec, crc32(payload, len));
    put_u32(rec, (u32)len);
    rec.append((const char*)payload, len);
    if (stage == 0 && !rec.empty()) rec.pop_back();  // torn tail
    std::lock_guard<std::mutex> g(wal_mu);  // writer idle: fd is ours
    if (!write_all(wal_fd, rec.data(), rec.size())) return -1;
    if (stage >= 1 && ::fsync(wal_fd) != 0) return -1;
    return 0;
  }

  // ---- flusher -------------------------------------------------------------

  void flush_loop() {
    std::unique_lock<std::mutex> lk(mu);
    for (;;) {
      db_cv.wait(lk, [&] { return flush_stop || !imm.empty(); });
      if (flush_stop) break;
      Memtable* m = imm.front().get();  // stays visible to readers
      u64 seq = next_seq++;
      u64 tid = next_table_id++;
      // tombstones must persist unless this becomes the ONLY table
      bool only = tables.empty();
      lk.unlock();
      // the sealed memtable is immutable: stream it without the lock
      u64 t0 = trace_now_ns();
      auto table = flush_memtable_to_sst(m, seq, tid, only);
      if (table)
        trace.push(t0, trace_now_ns() - t0, LK_FLUSH, LT_FLUSHER,
                   trace_clamp32(m->bytes), trace_clamp32(seq));
      lk.lock();
      if (!table) {
        // an unflushable memtable is a hard fault: writers fail fast
        // rather than silently queueing data that can never become tables
        io_failed = true;
        db_cv.notify_all();
        continue;
      }
      tables.push_back(std::move(table));
      if (!write_manifest_locked()) {
        io_failed = true;
        db_cv.notify_all();
        continue;
      }
      u64 seg = m->wal_segment;
      imm.pop_front();
      db_cv.notify_all();  // backpressure waiters + lsm_flush
      maybe_schedule_compaction_locked();
      lk.unlock();
      // every batch in segments <= seg is now SST+manifest-durable
      for (u64 s = oldest_segment; s <= seg; s++)
        ::unlink(segment_path(s).c_str());
      oldest_segment = seg + 1;  // only this thread advances it
      lk.lock();
    }
  }

  std::unique_ptr<Table> flush_memtable_to_sst(Memtable* m, u64 seq, u64 tid,
                                               bool drop_tombstones) {
    TableBuilder b;
    if (!b.open(table_path(seq))) return nullptr;
    for (SkipNode* n = m->first(); n; n = n->next[0]) {
      if (n->del && drop_tombstones) continue;
      if (!b.add(n->key, n->val, n->del)) {
        b.abandon();
        return nullptr;
      }
    }
    if (!b.finish()) return nullptr;
    auto t = std::make_unique<Table>();
    t->path = table_path(seq);
    t->id = tid;
    if (!load_table(*t)) return nullptr;
    return t;
  }

  // ---- compaction ----------------------------------------------------------

  void maybe_schedule_compaction_locked() {
    if (tables.size() > compact_tables) {
      std::lock_guard<std::mutex> g(bg_mu);
      compact_requested = true;
      bg_cv.notify_all();
    }
  }

  void compact_loop() {
    std::unique_lock<std::mutex> lk(bg_mu);
    for (;;) {
      // only one compaction at a time anywhere — the swap logic assumes
      // the first n_in tables are still exactly its inputs
      bg_cv.wait(lk, [&] {
        return compact_stop || (compact_requested && !compact_running);
      });
      if (compact_stop) break;
      compact_requested = false;
      compact_running = true;
      lk.unlock();
      compact_once(/*swap=*/true);
      lk.lock();
      compact_running = false;
      bg_cv.notify_all();
    }
  }

  // serialize a manual (CLI/debug) compaction against the background one
  bool begin_manual_compaction() {
    std::unique_lock<std::mutex> lk(bg_mu);
    bg_cv.wait(lk, [&] {
      return compact_stop || (!compact_running && !compact_requested);
    });
    if (compact_stop) return false;
    compact_running = true;
    return true;
  }
  void end_manual_compaction() {
    std::lock_guard<std::mutex> g(bg_mu);
    compact_running = false;
    bg_cv.notify_all();
  }

  struct Throttle {
    u64 rate_mbps;
    std::chrono::steady_clock::time_point start;
    u64 written = 0;
    static u64 hook(void* ctx, u64 bytes) {
      auto* t = (Throttle*)ctx;
      t->written += bytes;
      if (!t->rate_mbps) return 0;
      double budget_s = (double)t->written / (t->rate_mbps * 1048576.0);
      double spent_s = std::chrono::duration<double>(
                           std::chrono::steady_clock::now() - t->start)
                           .count();
      if (budget_s > spent_s)
        std::this_thread::sleep_for(
            std::chrono::duration<double>(budget_s - spent_s));
      return 0;
    }
  };

  // Full merge of the table set present at entry, newest wins, tombstones
  // drop (the inputs include the oldest table, so nothing below can
  // resurrect). With swap=false (lsm_compact_partial) the merged output is
  // written and renamed but the manifest swap is SKIPPED — the on-disk
  // image a mid-compaction kill -9 leaves, which open() must absorb.
  bool compact_once(bool swap) {
    std::vector<const Table*> inputs;
    size_t n_in;
    u64 seq, tid;
    {
      std::lock_guard<std::mutex> g(mu);
      if (tables.size() < 2 && swap) return true;
      if (tables.empty()) return false;
      n_in = tables.size();
      for (auto& t : tables) inputs.push_back(t.get());
      seq = next_seq++;
      tid = next_table_id++;
    }
    u64 trace_t0 = trace_now_ns();
    Throttle th{compact_rate_mbps, std::chrono::steady_clock::now()};
    TableBuilder b;
    if (!b.open(table_path(seq))) return false;
    b.throttle = Throttle::hook;
    b.throttle_ctx = &th;
    std::vector<TableCursor> cur(n_in);
    for (size_t i = 0; i < n_in; i++) cur[i].start(inputs[i]);
    for (;;) {
      {
        std::lock_guard<std::mutex> g(bg_mu);
        if (compact_stop) {  // engine closing: abandon, WAL/manifest intact
          b.abandon();
          return false;
        }
      }
      // pick the smallest live key; among equals the newest table wins
      int best = -1;
      for (size_t i = 0; i < n_in; i++) {
        if (cur[i].io_error) {
          b.abandon();
          return false;
        }
        if (!cur[i].valid) continue;
        if (best < 0 || cur[i].key() < cur[best].key() ||
            cur[i].key() == cur[best].key())
          best = (int)i;  // later index = newer table
      }
      if (best < 0) break;
      std::string key(cur[best].key());
      if (!cur[best].del()) {
        if (!b.add(key, cur[best].val(), false)) {
          b.abandon();
          return false;
        }
      }  // tombstone: drop (full merge)
      for (size_t i = 0; i < n_in; i++)
        while (cur[i].valid && cur[i].key() == key) cur[i].step();
    }
    if (!b.finish()) return false;
    if (!swap) {  // debug: orphan output left for open() to eat
      trace.push(trace_t0, trace_now_ns() - trace_t0, LK_COMPACT,
                 LT_COMPACTOR, (u32)n_in, trace_clamp32(seq));
      return true;
    }
    auto t = std::make_unique<Table>();
    t->path = table_path(seq);
    t->id = tid;
    if (!load_table(*t)) return false;
    {
      std::lock_guard<std::mutex> g(mu);
      // only compaction removes tables and only one runs: the first n_in
      // entries are exactly our inputs; tables flushed meanwhile stay newer
      std::vector<std::unique_ptr<Table>> next;
      next.push_back(std::move(t));
      for (size_t i = n_in; i < tables.size(); i++)
        next.push_back(std::move(tables[i]));
      std::vector<std::unique_ptr<Table>> old;
      for (size_t i = 0; i < n_in; i++) old.push_back(std::move(tables[i]));
      tables.swap(next);
      if (!write_manifest_locked()) {
        io_failed = true;
        return false;
      }
      for (auto& o : old) {
        cache.drop_table(o->id);
        std::string path = o->path;
        o.reset();  // closes fd
        ::unlink(path.c_str());
      }
      stats.compactions++;
    }
    trace.push(trace_t0, trace_now_ns() - trace_t0, LK_COMPACT, LT_COMPACTOR,
               (u32)n_in, trace_clamp32(seq));
    return true;
  }

  bool wait_compaction() {
    std::unique_lock<std::mutex> lk(bg_mu);
    bg_cv.wait(lk, [&] {
      return (!compact_requested && !compact_running) || compact_stop;
    });
    return true;
  }

  // ---- read path -----------------------------------------------------------

  // 1 found, 0 missing, -1 I/O error (a failed/corrupt block read must NOT
  // read as "key absent" — the state layer would proceed on wrong state)
  int table_find_locked(Table& t, std::string_view key, std::string& out,
                        bool& del) {
    if (t.blocks.empty()) return 0;
    if (key < std::string_view(t.min_key) ||
        std::string_view(t.max_key) < key)
      return 0;
    if (!t.bloom_may_contain(key)) {
      stats.bloom_neg++;
      return 0;
    }
    stats.bloom_pass++;
    size_t lo = 0, hi = t.blocks.size();
    while (lo < hi) {
      size_t mid = (lo + hi) / 2;
      if (std::string_view(t.blocks[mid].last_key) < key)
        lo = mid + 1;
      else
        hi = mid;
    }
    if (lo >= t.blocks.size()) return 0;
    const BlockMeta& m = t.blocks[lo];
    std::shared_ptr<std::string> block = cache.get(t.id, m.off);
    if (block) {
      stats.cache_hit++;
    } else {
      stats.cache_miss++;
      auto fresh = std::make_shared<std::string>();
      fresh->resize(m.len);
      if (m.len && ::pread(t.fd, &(*fresh)[0], m.len, (off_t)m.off) !=
                       (ssize_t)m.len)
        return -1;
      if (crc32((const u8*)fresh->data(), fresh->size()) != m.crc) return -1;
      cache.put(t.id, m.off, fresh);
      block = std::move(fresh);
    }
    BlockParse bp{(const u8*)block->data(), block->size()};
    while (bp.next()) {
      if (bp.key == key) {
        del = bp.del;
        out.assign(bp.val.data(), bp.val.size());
        return 1;
      }
      if (bp.key > key) return 0;
    }
    if (bp.off != bp.n) return -1;  // structural damage mid-block
    return 0;
  }

  int get(std::string_view key, std::string& out) {
    std::lock_guard<std::mutex> g(mu);
    std::string_view val;
    bool del;
    if (mem->find(key, val, del)) {
      if (del) return 0;
      out.assign(val.data(), val.size());
      return 1;
    }
    for (auto it = imm.rbegin(); it != imm.rend(); ++it) {
      if ((*it)->find(key, val, del)) {
        if (del) return 0;
        out.assign(val.data(), val.size());
        return 1;
      }
    }
    for (auto t = tables.rbegin(); t != tables.rend(); ++t) {
      bool tdel = false;
      int r = table_find_locked(**t, key, out, tdel);
      if (r < 0) return -1;
      if (r == 1) return tdel ? 0 : 1;
    }
    return 0;
  }

  bool scan_prefix(std::string_view prefix, std::string& out) {
    std::lock_guard<std::mutex> g(mu);
    std::map<std::string, std::pair<bool, std::string>, std::less<>> found;
    for (auto& t : tables) {  // oldest -> newest: later overwrites earlier
      TableCursor c;
      c.seek(t.get(), prefix);
      while (c.valid &&
             c.key().substr(0, prefix.size()) == prefix) {
        found[std::string(c.key())] = {c.del(), std::string(c.val())};
        c.step();
      }
      if (c.io_error) return false;
    }
    auto overlay = [&](const Memtable& m) {
      for (SkipNode* n = m.lower_bound(prefix); n; n = n->next[0]) {
        if (n->key.substr(0, prefix.size()) != prefix) break;
        found[std::string(n->key)] = {n->del, std::string(n->val)};
      }
    };
    for (auto& m : imm) overlay(*m);
    overlay(*mem);
    out.clear();
    u32 count = 0;
    std::string body;
    for (auto& kv : found) {
      if (kv.second.first) continue;  // tombstone
      put_u32(body, (u32)kv.first.size());
      body += kv.first;
      put_u32(body, (u32)kv.second.second.size());
      body += kv.second.second;
      count++;
    }
    put_u32(out, count);
    out += body;
    return true;
  }

  // Bounded cursor page: the first `limit` LIVE rows under `prefix` whose
  // key is strictly greater than `start` (exclusive=false makes `start`
  // itself eligible — the "from the front" page). K-way merge over seeked
  // SSTable cursors and memtable skiplist iterators, newest level winning
  // key ties, tombstones consuming their key. A fast-sync snapshot page
  // costs O(seek + page), not the O(keyspace) materialization scan_prefix
  // pays.
  bool scan_from(std::string_view prefix, std::string_view start,
                 bool exclusive, u64 limit, std::string& out) {
    std::lock_guard<std::mutex> g(mu);
    size_t n_tab = tables.size();
    std::vector<TableCursor> tc(n_tab);
    for (size_t i = 0; i < n_tab; i++) {
      tc[i].seek(tables[i].get(), start);
      if (tc[i].io_error) return false;
    }
    // oldest -> newest so the LAST holder of a key in this list is the
    // freshest version: imm is a seal queue (front = oldest), mem newest
    std::vector<SkipNode*> mc;
    for (auto& m : imm) mc.push_back(m->lower_bound(start));
    mc.push_back(mem->lower_bound(start));
    out.clear();
    u32 count = 0;
    std::string body, key;
    while (count < limit) {
      bool any = false;
      std::string_view min_key;
      for (auto& c : tc)
        if (c.valid && (!any || c.key() < min_key)) {
          min_key = c.key();
          any = true;
        }
      for (auto* n : mc)
        if (n && (!any || n->key < min_key)) {
          min_key = n->key;
          any = true;
        }
      if (!any || min_key.substr(0, prefix.size()) != prefix) break;
      key.assign(min_key.data(), min_key.size());
      bool del = false;
      std::string_view val;
      for (auto& c : tc)
        if (c.valid && c.key() == std::string_view(key)) {
          del = c.del();
          val = c.val();
        }
      for (auto* n : mc)
        if (n && n->key == std::string_view(key)) {
          del = n->del;
          val = n->val;
        }
      if (!del && !(exclusive && std::string_view(key) == start)) {
        put_u32(body, (u32)key.size());
        body += key;
        put_u32(body, (u32)val.size());
        body.append(val.data(), val.size());
        count++;
      }
      // advance every holder past this key (views into cursor blocks die
      // here, which is why `key` was copied and `val` already appended)
      for (auto& c : tc) {
        while (c.valid && c.key() == std::string_view(key)) {
          c.step();
          if (c.io_error) return false;
        }
      }
      for (auto*& n : mc)
        while (n && n->key == std::string_view(key)) n = n->next[0];
    }
    put_u32(out, count);
    out += body;
    return true;
  }

  // ---- flush / shutdown ----------------------------------------------------

  // Explicit flush: seal the active memtable and wait until every sealed
  // memtable is a table (tests + clean handover points).
  int flush() {
    std::unique_lock<std::mutex> lk(mu);
    if (io_failed) return -1;
    if (!mem->empty() && !seal_memtable(lk)) return -1;
    db_cv.wait(lk, [&] { return imm.empty() || io_failed || flush_stop; });
    return io_failed ? -1 : 0;
  }

  void close_all() {
    // stop order: WAL writer first (drains pending, so every acked record
    // is durable), then flusher/compactor (whatever they didn't finish is
    // re-coverable from WAL + manifest on the next open)
    {
      std::lock_guard<std::mutex> g(wal_mu);
      wal_stop = true;
      wal_work.notify_all();
    }
    if (wal_thr.joinable()) wal_thr.join();
    {
      std::lock_guard<std::mutex> g(mu);
      flush_stop = true;
      db_cv.notify_all();
    }
    {
      std::lock_guard<std::mutex> g(bg_mu);
      compact_stop = true;
      bg_cv.notify_all();
    }
    if (flush_thr.joinable()) flush_thr.join();
    if (compact_thr.joinable()) compact_thr.join();
    std::lock_guard<std::mutex> g(mu);
    if (wal_fd >= 0) ::close(wal_fd);
    wal_fd = -1;
    tables.clear();
    imm.clear();
    mem.reset();
  }

  void fill_stats(u64* out, int n) {
    u64 v[12] = {0};
    {
      std::lock_guard<std::mutex> g(mu);
      v[0] = stats.bloom_neg;
      v[1] = stats.bloom_pass;
      v[2] = stats.cache_hit;
      v[3] = stats.cache_miss;
      v[6] = stats.compactions;
      v[7] = tables.size();
      v[8] = mem ? mem->bytes : 0;
      v[9] = imm.size();
      // compaction backlog: tables beyond the trigger point — a sustained
      // non-zero value with compactions flat means the compactor is starved
      v[10] = tables.size() > compact_tables
                  ? tables.size() - compact_tables
                  : 0;
    }
    {
      std::lock_guard<std::mutex> g(wal_mu);
      v[4] = stats_wal_fsyncs;
      v[5] = stats.wal_records;
    }
    {
      std::lock_guard<std::mutex> g(trace.mu);
      v[11] = trace.dropped;
    }
    for (int i = 0; i < n && i < 12; i++) out[i] = v[i];
  }
};

}  // namespace

extern "C" {

void* lsm_open2(const char* dir, u64 flush_threshold, u64 cache_bytes,
                u64 compact_tables, u64 compact_rate_mbps) {
  Lsm* db = new Lsm();
  db->dir = dir;
  if (flush_threshold) db->flush_threshold = (size_t)flush_threshold;
  if (cache_bytes) db->cache.cap = (size_t)cache_bytes;
  if (compact_tables) db->compact_tables = (size_t)compact_tables;
  db->compact_rate_mbps = compact_rate_mbps;
  if (!db->open_dirs()) {
    delete db;
    return nullptr;
  }
  return db;
}

void* lsm_open(const char* dir, u64 flush_threshold) {
  return lsm_open2(dir, flush_threshold, 0, 0, 0);
}

void lsm_close(void* h) {
  Lsm* db = static_cast<Lsm*>(h);
  db->close_all();
  delete db;
}

int lsm_write_batch(void* h, const u8* payload, size_t len) {
  return static_cast<Lsm*>(h)->write_batch(payload, len);
}

u64 lsm_write_batch_async(void* h, const u8* payload, size_t len) {
  return static_cast<Lsm*>(h)->write_batch_async(payload, len);
}

int lsm_write_barrier(void* h, u64 seq) {
  return static_cast<Lsm*>(h)->write_barrier(seq);
}

int lsm_write_batch_partial(void* h, const u8* payload, size_t len,
                            int stage) {
  return static_cast<Lsm*>(h)->write_batch_partial(payload, len, stage);
}

int lsm_get(void* h, const u8* key, size_t klen, u8** val, size_t* vlen) {
  std::string out;
  int r = static_cast<Lsm*>(h)->get(
      std::string_view((const char*)key, klen), out);
  if (r != 1) return r;
  *val = (u8*)malloc(out.size() ? out.size() : 1);
  memcpy(*val, out.data(), out.size());
  *vlen = out.size();
  return 1;
}

int lsm_scan_prefix(void* h, const u8* prefix, size_t plen, u8** buf,
                    size_t* len) {
  std::string out;
  if (!static_cast<Lsm*>(h)->scan_prefix(
          std::string_view((const char*)prefix, plen), out))
    return -1;
  *buf = (u8*)malloc(out.size() ? out.size() : 1);
  memcpy(*buf, out.data(), out.size());
  *len = out.size();
  return 0;
}

int lsm_scan_from(void* h, const u8* prefix, size_t plen, const u8* after,
                  size_t alen, u64 limit, u8** buf, size_t* len) {
  std::string start((const char*)prefix, plen);
  if (alen) start.append((const char*)after, alen);
  std::string out;
  if (!static_cast<Lsm*>(h)->scan_from(
          std::string_view((const char*)prefix, plen), start,
          /*exclusive=*/alen > 0, limit, out))
    return -1;
  *buf = (u8*)malloc(out.size() ? out.size() : 1);
  memcpy(*buf, out.data(), out.size());
  *len = out.size();
  return 0;
}

int lsm_flush(void* h) { return static_cast<Lsm*>(h)->flush(); }

int lsm_compact_now(void* h) {
  Lsm* db = static_cast<Lsm*>(h);
  if (db->flush() != 0) return -1;
  if (!db->begin_manual_compaction()) return -1;
  bool ok = db->compact_once(/*swap=*/true);
  db->end_manual_compaction();
  return ok ? 0 : -1;
}

int lsm_compact_partial(void* h) {
  Lsm* db = static_cast<Lsm*>(h);
  if (db->flush() != 0) return -1;
  if (!db->begin_manual_compaction()) return -1;
  bool ok = db->compact_once(/*swap=*/false);
  db->end_manual_compaction();
  return ok ? 0 : -1;
}

int lsm_wait_compaction(void* h) {
  static_cast<Lsm*>(h)->wait_compaction();
  return 0;
}

void lsm_free(u8* p) { free(p); }

void lsm_stats(void* h, u64* out, int n) {
  static_cast<Lsm*>(h)->fill_stats(out, n);
}

// introspection for tests
u64 lsm_table_count(void* h) {
  Lsm* db = static_cast<Lsm*>(h);
  std::lock_guard<std::mutex> g(db->mu);
  return (u64)db->tables.size();
}

// -- flight recorder ---------------------------------------------------------

// Raw CLOCK_MONOTONIC now, for the Python clock-offset handshake.
u64 lsm_monotonic_ns() { return trace_now_ns(); }

// capacity 0 disables recording
void lsm_trace_configure(void* h, u64 capacity) {
  static_cast<Lsm*>(h)->trace.configure((size_t)capacity);
}

u64 lsm_trace_dropped(void* h) {
  Lsm* db = static_cast<Lsm*>(h);
  std::lock_guard<std::mutex> g(db->trace.mu);
  return db->trace.dropped;
}

// Two-call drain: size query with buf == NULL, then the copying call, which
// CONSUMES the ring. Same 32-byte big-endian record layout as the consensus
// engine's rt_trace_drain (u64 ts_ns, u64 dur_ns, u32 kind/tid/a/b).
// Background threads keep appending between the two calls, so callers
// should over-allocate; a too-small buffer returns the new size needed.
u64 lsm_trace_drain(void* h, u8* buf, u64 cap) {
  Lsm* db = static_cast<Lsm*>(h);
  TraceRing& r = db->trace;
  std::lock_guard<std::mutex> g(r.mu);
  std::string out;
  out.reserve(r.count * 32);
  if (r.count) {
    size_t start = (r.w + r.cap - r.count) % r.cap;
    for (size_t i = 0; i < r.count; i++) {
      const TraceEvent& e = r.buf[(start + i) % r.cap];
      trace_put64(out, e.ts_ns);
      trace_put64(out, e.dur_ns);
      trace_put32(out, e.kind);
      trace_put32(out, e.tid);
      trace_put32(out, e.a);
      trace_put32(out, e.b);
    }
  }
  if (!buf || out.size() > cap) return out.size();
  std::memcpy(buf, out.data(), out.size());
  r.count = 0;  // consumed (w stays: the ring keeps filling from there)
  return out.size();
}

int lsm_version() { return 6; }

}  // extern "C"

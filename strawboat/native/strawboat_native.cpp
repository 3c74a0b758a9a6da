// Native host runtime for strawboat.
//
// Provides the byte-stream-sequential work that neither numpy nor the
// device can vectorize well:
//   - batched general-codec page decompression (LZ4 block / Zstd / Snappy)
//     over a std::thread pool — the host-side feeder for device scans
//   - PATAS float decode/encode (xor-chain with ring-buffer references;
//     reference src/compression/double/patas.rs:36-202)
//
// Built as a plain C ABI shared library, loaded with ctypes.

#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <atomic>
#include <thread>
#include <vector>
#include <unordered_map>

// liblz4 / libzstd / libsnappy (C ABI).  Declared weak: the loader links
// only the libraries the host has, and a missing library's functions are
// null here, so its codec fails with kNoLib instead of failing the build.
#define SB_WEAK __attribute__((weak))
extern "C" {
SB_WEAK int LZ4_compressBound(int inputSize);
SB_WEAK int LZ4_compress_default(const char* src, char* dst, int srcSize, int dstCapacity);
SB_WEAK int LZ4_decompress_safe(const char* src, char* dst, int compressedSize, int dstCapacity);
SB_WEAK size_t ZSTD_compressBound(size_t srcSize);
SB_WEAK size_t ZSTD_compress(void* dst, size_t dstCapacity, const void* src, size_t srcSize, int level);
SB_WEAK size_t ZSTD_decompress(void* dst, size_t dstCapacity, const void* src, size_t srcSize);
SB_WEAK unsigned ZSTD_isError(size_t code);
SB_WEAK int snappy_compress(const char* input, size_t input_length, char* compressed, size_t* compressed_length);
SB_WEAK int snappy_uncompress(const char* compressed, size_t compressed_length, char* uncompressed, size_t* uncompressed_length);
SB_WEAK size_t snappy_max_compressed_length(size_t source_length);
}

namespace {

enum Codec : int { kNone = 0, kLz4 = 1, kZstd = 2, kSnappy = 3 };
constexpr int kNoLib = -6;  // the codec's library is not on this host

bool codec_linked(int codec) {
  switch (codec) {
    case kLz4: return LZ4_decompress_safe != nullptr;
    case kZstd: return ZSTD_decompress != nullptr;
    case kSnappy: return snappy_uncompress != nullptr;
  }
  return true;
}

int decompress_one(int codec, const uint8_t* in, int64_t in_len, uint8_t* out,
                   int64_t out_len) {
  if (!codec_linked(codec)) return kNoLib;
  switch (codec) {
    case kNone:
      if (in_len != out_len) return -1;
      std::memcpy(out, in, (size_t)out_len);
      return 0;
    case kLz4: {
      int n = LZ4_decompress_safe((const char*)in, (char*)out, (int)in_len,
                                  (int)out_len);
      return n == (int)out_len ? 0 : -2;
    }
    case kZstd: {
      size_t n = ZSTD_decompress(out, (size_t)out_len, in, (size_t)in_len);
      return (!ZSTD_isError(n) && n == (size_t)out_len) ? 0 : -3;
    }
    case kSnappy: {
      size_t n = (size_t)out_len;
      int rc = snappy_uncompress((const char*)in, (size_t)in_len, (char*)out, &n);
      return (rc == 0 && n == (size_t)out_len) ? 0 : -4;
    }
  }
  return -5;
}

}  // namespace

extern "C" {

// Decompress n pages in parallel.  Arrays of pointers/sizes; returns 0 or the
// first nonzero per-page error code.
int sb_decompress_batch(int codec, int64_t n, const uint8_t** inputs,
                        const int64_t* in_lens, uint8_t** outputs,
                        const int64_t* out_lens, int n_threads) {
  if (n <= 0) return 0;
  if (n_threads <= 0) n_threads = (int)std::thread::hardware_concurrency();
  if (n_threads > n) n_threads = (int)n;
  std::atomic<int64_t> next(0);
  std::atomic<int> err(0);
  auto worker = [&]() {
    for (;;) {
      int64_t i = next.fetch_add(1);
      if (i >= n) break;
      int rc = decompress_one(codec, inputs[i], in_lens[i], outputs[i], out_lens[i]);
      if (rc != 0) err.store(rc);
    }
  };
  if (n_threads <= 1) {
    worker();
  } else {
    std::vector<std::thread> pool;
    pool.reserve(n_threads);
    for (int t = 0; t < n_threads; ++t) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
  }
  return err.load();
}

// Single-shot compress into caller buffer; returns compressed size or <0.
int64_t sb_compress(int codec, const uint8_t* in, int64_t in_len, uint8_t* out,
                    int64_t out_cap) {
  if (!codec_linked(codec)) return kNoLib;
  switch (codec) {
    case kNone:
      if (out_cap < in_len) return -1;
      std::memcpy(out, in, (size_t)in_len);
      return in_len;
    case kLz4: {
      int n = LZ4_compress_default((const char*)in, (char*)out, (int)in_len,
                                   (int)out_cap);
      return n > 0 ? n : -2;
    }
    case kZstd: {
      size_t n = ZSTD_compress(out, (size_t)out_cap, in, (size_t)in_len, 0);
      return ZSTD_isError(n) ? -3 : (int64_t)n;
    }
    case kSnappy: {
      size_t n = (size_t)out_cap;
      int rc = snappy_compress((const char*)in, (size_t)in_len, (char*)out, &n);
      return rc == 0 ? (int64_t)n : -4;
    }
  }
  return -5;
}

int64_t sb_compress_bound(int codec, int64_t in_len) {
  if (!codec_linked(codec)) return kNoLib;
  switch (codec) {
    case kNone: return in_len;
    case kLz4: return LZ4_compressBound((int)in_len);
    case kZstd: return (int64_t)ZSTD_compressBound((size_t)in_len);
    case kSnappy: return (int64_t)snappy_max_compressed_length((size_t)in_len);
  }
  return -1;
}

// ---------------------------------------------------------------------------
// PATAS (f64/f32 via width parameter; semantics mirror patas.rs + the f32
// equal-marker fix described in codecs/double.py)

int sb_patas_decode(const uint8_t* in, int64_t in_len, int64_t length,
                    int width, uint64_t* out) {
  if (length <= 0) return 0;
  if (in_len < width) return -1;
  const int wbits = width * 8;
  const int equal_tz = wbits - 1;
  const uint64_t mask = width == 8 ? ~0ull : ((1ull << wbits) - 1);
  int64_t p = 0;
  uint64_t first = 0;
  std::memcpy(&first, in, (size_t)width);
  out[0] = first;
  p += width;
  for (int64_t i = 1; i < length; ++i) {
    if (p + 2 > in_len) return -2;
    uint16_t packed;
    std::memcpy(&packed, in + p, 2);
    p += 2;
    int diff = (packed >> 9) & 0x7F;
    int sig = (packed >> 6) & 0x7;
    int tz = packed & 0x3F;
    if (tz < equal_tz && sig == 0) sig = 8;
    if (sig > width && tz < 8) sig = width;
    uint64_t val = 0;
    if (sig > width) {
      p += sig;  // reference read_value_custom returns default
    } else {
      if (p + sig > in_len) return -3;
      std::memcpy(&val, in + p, (size_t)sig);
      p += sig;
    }
    uint64_t prev = out[i - diff];
    out[i] = ((val << tz) & mask) ^ prev;
  }
  return 0;
}

// Encode: out must have capacity length*(width+2)+width; returns bytes written.
//
// Reference-index lookup uses a windowed 8-way bucket table instead of the
// reference's full hashmap: only references within the last 128 positions are
// usable (patas.rs:63-66 falls back to i-1 otherwise), so entries older than
// the window are semantically dead and their slots reusable.  In the
// (astronomically unlikely) case a bucket overflows with live entries, we
// fall back to i-1 — still a valid stream, identical on decode.
namespace {
struct PatasSlot { uint64_t val; int64_t idx; };
constexpr int kPatasBuckets = 128;  // x8 slots = 1024 for a 128-entry window
constexpr int kPatasWays = 8;

static inline uint64_t patas_hash(uint64_t x) {
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ull;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBull;
  return x ^ (x >> 31);
}
}  // namespace

int64_t sb_patas_encode(const uint64_t* bits, int64_t length, int width,
                        uint8_t* out) {
  if (length <= 0) return 0;
  const int wbits = width * 8;
  const uint64_t mask = width == 8 ? ~0ull : ((1ull << wbits) - 1);
  PatasSlot table[kPatasBuckets][kPatasWays];
  for (auto& b : table)
    for (auto& s : b) s.idx = INT64_MIN;
  auto lookup = [&](uint64_t v) -> int64_t {
    auto& b = table[patas_hash(v) & (kPatasBuckets - 1)];
    for (auto& s : b)
      if (s.idx != INT64_MIN && s.val == v) return s.idx;
    return 0;  // reference: indices.get(&val).unwrap_or(0)
  };
  auto insert = [&](uint64_t v, int64_t i) {
    auto& b = table[patas_hash(v) & (kPatasBuckets - 1)];
    PatasSlot* dead = nullptr;
    PatasSlot* oldest = &b[0];
    for (auto& s : b) {
      if (s.idx != INT64_MIN && s.val == v) { s.idx = i; return; }
      if (s.idx == INT64_MIN || s.idx < i - 128) dead = &s;
      if (s.idx < oldest->idx) oldest = &s;
    }
    PatasSlot* slot = dead ? dead : oldest;
    slot->val = v;
    slot->idx = i;
  };
  int64_t p = 0;
  std::memcpy(out + p, &bits[0], (size_t)width);
  p += width;
  insert(bits[0], 0);
  for (int64_t i = 1; i < length; ++i) {
    uint64_t val = bits[i];
    int64_t ref_idx = lookup(val);
    if (ref_idx > i || (i - ref_idx) >= 128) ref_idx = i - 1;
    int diff = (int)(i - ref_idx);
    uint64_t refer = bits[i - diff];
    uint64_t x = val ^ refer;
    int tz, lz;
    if (x == 0) {
      tz = wbits;
      lz = wbits;
    } else {
      tz = __builtin_ctzll(x);
      lz = __builtin_clzll(x) - (64 - wbits);
    }
    int is_equal = (tz == wbits) ? 1 : 0;
    int sig_bits = is_equal ? 0 : wbits - tz - lz;
    int sig_bytes = (sig_bits >> 3) + ((sig_bits & 7) ? 1 : 0);
    uint16_t packed = (uint16_t)(((diff & 0x7F) << 9) | ((sig_bytes & 7) << 6) |
                                 (tz - is_equal));
    std::memcpy(out + p, &packed, 2);
    p += 2;
    if (sig_bytes) {
      uint64_t payload = (x >> (tz - is_equal)) & mask;
      std::memcpy(out + p, &payload, (size_t)sig_bytes);
      p += sig_bytes;
    }
    insert(val, i);
  }
  return p;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Integer page stats (reference integer/mod.rs:179-229 gen_stats): one pass
// min/max/run/sorted + distinct hashmap.  out layout (i64 x8):
// [min, max, null_count, run_count, is_sorted, unique_count, top_value, max_count]

template <typename T>
static void int_stats_impl(const T* vals, const uint8_t* validity, int64_t n,
                           int64_t* out) {
  T vmin = n ? vals[0] : T(0), vmax = n ? vals[0] : T(0);
  int64_t nulls = 0, runs = 0;
  bool sorted = true;
  T last = T(0);
  // open-addressing distinct counter (std::unordered_map's per-insert
  // allocation + chaining made this the write path's hottest loop).
  // The table is THREAD-LOCAL and epoch-tagged: a fresh 2n-slot table per
  // page cost a 2 MB alloc+memset per call (the dominant stats cost at
  // 65,536-row pages — ~0.7 ms/page); tagging slots with an epoch makes
  // reset O(1) and keeps the table hot in cache across a column's pages.
  int64_t cap = 64;
  while (cap < 2 * n) cap <<= 1;
  static thread_local std::vector<T> keys;
  static thread_local std::vector<int64_t> cnts;
  static thread_local std::vector<uint32_t> tags;
  static thread_local uint32_t epoch = 0;
  if ((int64_t)keys.size() < cap) {
    keys.resize((size_t)cap);
    cnts.resize((size_t)cap);
    tags.assign((size_t)cap, 0);
    epoch = 0;
  }
  const int64_t hmask = (int64_t)keys.size() - 1;  // pow2 by construction
  if (++epoch == 0) {
    std::fill(tags.begin(), tags.end(), 0u);
    epoch = 1;
  }
  int64_t n_distinct = 0;
  T top = n ? vals[0] : T(0);
  int64_t max_count = 0;
  auto bump = [&](T v) {
    uint64_t h = (uint64_t)v;
    h = (h ^ (h >> 30)) * 0xBF58476D1CE4E5B9ull;
    h = (h ^ (h >> 27)) * 0x94D049BB133111EBull;
    h ^= h >> 31;
    int64_t i = (int64_t)(h & (uint64_t)hmask);
    for (;;) {
      if (tags[i] != epoch) {
        tags[i] = epoch;
        keys[i] = v;
        cnts[i] = 1;
        ++n_distinct;
        if (max_count < 1) { max_count = 1; top = v; }
        return;
      }
      if (keys[i] == v) {
        int64_t c = ++cnts[i];
        if (c > max_count) { max_count = c; top = v; }
        return;
      }
      i = (i + 1) & hmask;
    }
  };
  for (int64_t i = 0; i < n; ++i) {
    T v = vals[i];
    bool ok = validity == nullptr || validity[i];
    if (ok) {
      if (v < last) sorted = false;
      if (last != v) {
        ++runs;
        last = v;
      }
    } else {
      ++nulls;
    }
    if (v < vmin) vmin = v;
    if (v > vmax) vmax = v;
    bump(v);
  }
  out[0] = (int64_t)vmin;
  out[1] = (int64_t)vmax;
  out[2] = nulls;
  out[3] = runs;
  out[4] = sorted ? 1 : 0;
  out[5] = n_distinct;
  out[6] = (int64_t)top;
  out[7] = max_count;
}

// Encode 128-value blocks as [u8 num_bits][BitPacker4x packed] in one pass
// (reference integer/bp.rs:36-86 layout: 4 interleaved 32-value lanes,
// LSB-first).  Width per block comes from OR-reducing width_vals (equals
// vals for plain pages; differs for delta pages where the width domain is
// the deltas).  Returns bytes written.
extern "C" int64_t sb_bp_encode(const uint32_t* vals, int64_t n_blocks,
                                const uint32_t* width_vals, uint8_t* out) {
  int64_t p = 0;
  for (int64_t blk = 0; blk < n_blocks; ++blk) {
    const uint32_t* v = vals + blk * 128;
    const uint32_t* wv = width_vals + blk * 128;
    uint32_t acc = 0;
    for (int i = 0; i < 128; ++i) acc |= wv[i];
    uint32_t nb = acc ? 32 - __builtin_clz(acc) : 0;
    out[p++] = (uint8_t)nb;
    if (!nb) continue;
    uint32_t words[32 * 4];
    std::memset(words, 0, sizeof(uint32_t) * nb * 4);
    for (uint32_t t = 0; t < 32; ++t) {
      const uint32_t s = t * nb;
      const uint32_t w0 = s >> 5, sh = s & 31;
      for (uint32_t l = 0; l < 4; ++l) {
        uint32_t x = v[t * 4 + l];
        words[w0 * 4 + l] |= x << sh;
        if (sh + nb > 32) words[(w0 + 1) * 4 + l] |= x >> (32 - sh);
      }
    }
    std::memcpy(out + p, words, (size_t)nb * 16);
    p += (int64_t)nb * 16;
  }
  return p;
}

// First-occurrence factorization (DictEncoder interning, integer/dict.rs
// raw-entry hashmap): codes[i] = index of vals[i] in uniq (first-occurrence
// order).  Returns the unique count, or -1 when it would exceed max_uniq
// (caller falls back / rejects Dict).
template <typename T>
static int64_t factorize_impl(const T* vals, int64_t n, uint32_t* codes,
                              T* uniq, int64_t max_uniq) {
  int64_t cap = 64;
  while (cap < 2 * n) cap <<= 1;
  // thread-local epoch-tagged table — see int_stats_impl (same per-call
  // alloc+memset cost, same fix)
  static thread_local std::vector<T> keys;
  static thread_local std::vector<int32_t> slot_code;
  static thread_local std::vector<uint32_t> tags;
  static thread_local uint32_t epoch = 0;
  if ((int64_t)keys.size() < cap) {
    keys.resize((size_t)cap);
    slot_code.resize((size_t)cap);
    tags.assign((size_t)cap, 0);
    epoch = 0;
  }
  const int64_t hmask = (int64_t)keys.size() - 1;
  if (++epoch == 0) {
    std::fill(tags.begin(), tags.end(), 0u);
    epoch = 1;
  }
  int64_t n_uniq = 0;
  for (int64_t i = 0; i < n; ++i) {
    T v = vals[i];
    uint64_t h = (uint64_t)v;
    h = (h ^ (h >> 30)) * 0xBF58476D1CE4E5B9ull;
    h = (h ^ (h >> 27)) * 0x94D049BB133111EBull;
    h ^= h >> 31;
    int64_t s = (int64_t)(h & (uint64_t)hmask);
    for (;;) {
      if (tags[s] != epoch) {
        if (n_uniq >= max_uniq) return -1;
        tags[s] = epoch;
        keys[s] = v;
        slot_code[s] = (int32_t)n_uniq;
        uniq[n_uniq] = v;
        codes[i] = (uint32_t)n_uniq;
        ++n_uniq;
        break;
      }
      if (keys[s] == v) {
        codes[i] = (uint32_t)slot_code[s];
        break;
      }
      s = (s + 1) & hmask;
    }
  }
  return n_uniq;
}

extern "C" int64_t sb_factorize_u64(const uint64_t* vals, int64_t n,
                                    uint32_t* codes, uint64_t* uniq,
                                    int64_t max_uniq) {
  return factorize_impl<uint64_t>(vals, n, codes, uniq, max_uniq);
}

extern "C" int64_t sb_factorize_u32(const uint32_t* vals, int64_t n,
                                    uint32_t* codes, uint32_t* uniq,
                                    int64_t max_uniq) {
  return factorize_impl<uint32_t>(vals, n, codes, uniq, max_uniq);
}

extern "C" int sb_int_stats_i64(const int64_t* vals, const uint8_t* validity,
                                int64_t n, int64_t* out) {
  int_stats_impl<int64_t>(vals, validity, n, out);
  return 0;
}

extern "C" int sb_int_stats_u64(const uint64_t* vals, const uint8_t* validity,
                                int64_t n, int64_t* out) {
  int_stats_impl<uint64_t>(vals, validity, n, out);
  return 0;
}

// 32/16/8-bit entries: stats straight off the storage width (the python
// wrapper's astype(int64) copied every narrow page before this pass)
extern "C" int sb_int_stats_i32(const int32_t* vals, const uint8_t* validity,
                                int64_t n, int64_t* out) {
  int_stats_impl<int32_t>(vals, validity, n, out);
  return 0;
}

extern "C" int sb_int_stats_u32(const uint32_t* vals, const uint8_t* validity,
                                int64_t n, int64_t* out) {
  int_stats_impl<uint32_t>(vals, validity, n, out);
  return 0;
}

extern "C" int sb_int_stats_i16(const int16_t* vals, const uint8_t* validity,
                                int64_t n, int64_t* out) {
  int_stats_impl<int16_t>(vals, validity, n, out);
  return 0;
}

extern "C" int sb_int_stats_u16(const uint16_t* vals, const uint8_t* validity,
                                int64_t n, int64_t* out) {
  int_stats_impl<uint16_t>(vals, validity, n, out);
  return 0;
}

extern "C" int sb_int_stats_i8(const int8_t* vals, const uint8_t* validity,
                               int64_t n, int64_t* out) {
  int_stats_impl<int8_t>(vals, validity, n, out);
  return 0;
}

extern "C" int sb_int_stats_u8(const uint8_t* vals, const uint8_t* validity,
                               int64_t n, int64_t* out) {
  int_stats_impl<uint8_t>(vals, validity, n, out);
  return 0;
}
// Walk bitpacked block headers: per 128-value block [u8 num_bits][nb*16 bytes].
// Writes each block's num_bits and returns the end offset (or -1 if the walk
// runs past buf_len — corrupt input).
extern "C" int64_t sb_bp_walk(const uint8_t* buf, int64_t buf_len, int64_t body,
                              int64_t n_blocks, uint8_t* nbs_out) {
  int64_t p = body;
  for (int64_t i = 0; i < n_blocks; i++) {
    if (p >= buf_len) return -1;
    uint8_t nb = buf[p];
    nbs_out[i] = nb;
    p += 1 + (int64_t)nb * 16;
  }
  return p <= buf_len ? p : -1;
}

// Fused DICT-column decode: per page, decode the u32 index codes
// (bitpacked / bitpacked-delta / raw) and gather out[row] = dict[code + base]
// at the output element width, pages spread over a thread pool.  This is the
// whole hot loop of an all-DICT fixed-width column read in one call — no
// per-page Python, no materialized global codes array.
//
// kinds: 0 = bitpacked codes at bodies[i]; 1 = raw u32 codes (page_bufs[i]
// points AT the codes, bodies[i] unused); 2 = bitpacked deltas (prefix-sum,
// reference delta_bp.rs whole-page carry).
// Returns 0, or a negative error (truncated page / code out of range).
extern "C" int64_t sb_bp_decode(const uint8_t*, int64_t, int64_t, int64_t,
                                uint32_t*);

extern "C" int sb_dict_column_decode(
    const uint8_t** page_bufs, const int64_t* buf_lens, const int64_t* bodies,
    const int64_t* n_values, const int64_t* row_offsets, const int64_t* bases,
    const uint8_t* kinds, int64_t n_pages, const void* dict, int64_t dict_len,
    int width, void* out, int n_threads) {
  if (n_pages <= 0) return 0;
  if (n_threads <= 0) n_threads = (int)std::thread::hardware_concurrency();
  if (n_threads > n_pages) n_threads = (int)n_pages;
  std::atomic<int64_t> next(0);
  std::atomic<int> err(0);
  auto worker = [&]() {
    std::vector<uint32_t> codes;
    for (;;) {
      int64_t i = next.fetch_add(1);
      if (i >= n_pages) break;
      const int64_t nv = n_values[i];
      const int64_t n_blocks = (nv + 127) / 128;
      const uint32_t* cp;
      if (kinds[i] == 1) {
        if (buf_lens[i] < nv * 4) { err.store(-1); continue; }
        cp = (const uint32_t*)page_bufs[i];
      } else {
        codes.resize((size_t)n_blocks * 128);
        int64_t end = sb_bp_decode(page_bufs[i], buf_lens[i], bodies[i],
                                   n_blocks, codes.data());
        if (end < 0) { err.store(-2); continue; }
        if (kinds[i] == 2) {  // sequential deltas, whole-page carry
          uint32_t acc = 0;
          for (int64_t k = 0; k < nv; ++k) { acc += codes[k]; codes[k] = acc; }
        }
        cp = codes.data();
      }
      const int64_t base = bases[i];
      if (width == 8) {
        const uint64_t* d = (const uint64_t*)dict;
        uint64_t* o = (uint64_t*)out + row_offsets[i];
        for (int64_t k = 0; k < nv; ++k) {
          int64_t idx = (int64_t)cp[k] + base;
          if ((uint64_t)idx >= (uint64_t)dict_len) { err.store(-3); break; }
          o[k] = d[idx];
        }
      } else if (width == 4) {
        const uint32_t* d = (const uint32_t*)dict;
        uint32_t* o = (uint32_t*)out + row_offsets[i];
        for (int64_t k = 0; k < nv; ++k) {
          int64_t idx = (int64_t)cp[k] + base;
          if ((uint64_t)idx >= (uint64_t)dict_len) { err.store(-3); break; }
          o[k] = d[idx];
        }
      } else if (width == 2) {
        const uint16_t* d = (const uint16_t*)dict;
        uint16_t* o = (uint16_t*)out + row_offsets[i];
        for (int64_t k = 0; k < nv; ++k) {
          int64_t idx = (int64_t)cp[k] + base;
          if ((uint64_t)idx >= (uint64_t)dict_len) { err.store(-3); break; }
          o[k] = d[idx];
        }
      } else if (width == 1) {
        const uint8_t* d = (const uint8_t*)dict;
        uint8_t* o = (uint8_t*)out + row_offsets[i];
        for (int64_t k = 0; k < nv; ++k) {
          int64_t idx = (int64_t)cp[k] + base;
          if ((uint64_t)idx >= (uint64_t)dict_len) { err.store(-3); break; }
          o[k] = d[idx];
        }
      } else {
        err.store(-4);
      }
    }
  };
  if (n_threads <= 1) {
    worker();
  } else {
    std::vector<std::thread> pool;
    pool.reserve(n_threads);
    for (int t = 0; t < n_threads; ++t) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
  }
  return err.load();
}

// Decode a whole bitpacked page (BitPacker4x layout: per block
// [u8 num_bits][num_bits*16 bytes], 4 interleaved 32-value lanes, LSB-first)
// into out[n_blocks*128] u32.  Handles mixed widths in one pass.  Returns the
// end offset, or -1 on truncated input.
extern "C" int64_t sb_bp_decode(const uint8_t* buf, int64_t buf_len,
                                int64_t pos, int64_t n_blocks, uint32_t* out) {
  int64_t p = pos;
  for (int64_t blk = 0; blk < n_blocks; ++blk) {
    if (p >= buf_len) return -1;
    const uint32_t b = buf[p];
    p += 1;
    uint32_t* o = out + blk * 128;
    if (b == 0) {
      std::memset(o, 0, 128 * sizeof(uint32_t));
      continue;
    }
    if (b > 32 || p + (int64_t)b * 16 > buf_len) return -1;
    uint32_t words[32 * 4];
    std::memcpy(words, buf + p, (size_t)b * 16);
    p += (int64_t)b * 16;
    const uint32_t mask = b < 32 ? ((1u << b) - 1u) : 0xFFFFFFFFu;
    for (uint32_t t = 0; t < 32; ++t) {
      const uint32_t s = t * b;
      const uint32_t w0 = s >> 5, sh = s & 31;
      // word w of lane l sits at u32 index w*4 + l
      for (uint32_t l = 0; l < 4; ++l) {
        uint32_t v = words[w0 * 4 + l] >> sh;
        if (sh + b > 32) v |= words[(w0 + 1) * 4 + l] << (32 - sh);
        o[t * 4 + l] = v & mask;
      }
    }
  }
  return p;
}

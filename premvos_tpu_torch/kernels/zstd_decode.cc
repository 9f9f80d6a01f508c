// Zstandard decoder (RFC 8878) for the port's checkpoint reader: host code,
// built with the host C++ compiler and bound by ctypes
// (premvos_tpu_torch/io_compat/zstd.py).
//
// The JAX package's orbax checkpoints compress every OCDBT manifest, every
// B+tree and version-tree node and every zarr chunk as a zstd frame; the
// machine the port runs on has no zstd for Python, so the reader decodes
// them here. It decodes:
//   * several frames back to back, and skippable frames between them;
//   * frames with and without a content size, with or without the
//     single-segment flag; a frame's XXH64 content checksum is verified
//     when the frame carries one;
//   * raw, RLE and compressed blocks;
//   * raw, RLE, compressed and treeless literals, with 1 or 4 Huffman
//     streams (Huffman weights direct or FSE-compressed);
//   * sequences whose literal-length, offset and match-length codes come in
//     predefined, RLE, FSE-compressed or repeat mode, with the three repeat
//     offsets carried from block to block.
// A frame that names a dictionary is refused (no dictionary is known here),
// as is a corrupt or truncated frame and output past the caller's bound.
// Nothing partial is returned: an error leaves no count of written bytes.
//
// C interface (declared in premvos_kernels.h): premvos_zstd_content_size
// sums the frames' stated sizes; premvos_zstd_decode decodes into the
// caller's buffer; premvos_crc32c is the CRC-32C of OCDBT's footers.

#define PREMVOS_HOST_ONLY
#include "premvos_kernels.h"

#include <cstdarg>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <memory>
#include <string>

namespace {

// Error kinds, as io_compat/zstd.py names them.
enum Kind { kCorrupt = 1, kTruncated = 2, kDictionary = 3, kBound = 4, kChecksum = 5 };

struct Failure {
  int kind;
  std::string msg;
};

[[noreturn]] void fail(int kind, const char* fmt, ...) {
  char buf[256];
  va_list ap;
  va_start(ap, fmt);
  vsnprintf(buf, sizeof buf, fmt, ap);
  va_end(ap);
  throw Failure{kind, buf};
}

inline int highest_bit(uint64_t v) { return 63 - __builtin_clzll(v); }  // v > 0

inline uint32_t rd16(const uint8_t* p) { return p[0] | (uint32_t)p[1] << 8; }
inline uint32_t rd24(const uint8_t* p) { return rd16(p) | (uint32_t)p[2] << 16; }
inline uint32_t rd32(const uint8_t* p) { return rd24(p) | (uint32_t)p[3] << 24; }
inline uint64_t rd64(const uint8_t* p) { return rd32(p) | (uint64_t)rd32(p + 4) << 32; }

// ------------------------------------------------------------- XXH64

constexpr uint64_t P1 = 0x9E3779B185EBCA87ULL, P2 = 0xC2B2AE3D27D4EB4FULL,
                   P3 = 0x165667B19E3779F9ULL, P4 = 0x85EBCA77C2B2AE63ULL,
                   P5 = 0x27D4EB2F165667C5ULL;

inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
inline uint64_t xround(uint64_t acc, uint64_t in) { return rotl(acc + in * P2, 31) * P1; }
inline uint64_t xmerge(uint64_t acc, uint64_t v) { return (acc ^ xround(0, v)) * P1 + P4; }

uint64_t xxh64(const uint8_t* p, size_t n) {
  const uint8_t* end = p + n;
  uint64_t h;
  if (n >= 32) {
    uint64_t v1 = P1 + P2, v2 = P2, v3 = 0, v4 = 0 - P1;
    for (; end - p >= 32; p += 32) {
      v1 = xround(v1, rd64(p));
      v2 = xround(v2, rd64(p + 8));
      v3 = xround(v3, rd64(p + 16));
      v4 = xround(v4, rd64(p + 24));
    }
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    h = xmerge(xmerge(xmerge(xmerge(h, v1), v2), v3), v4);
  } else {
    h = P5;
  }
  h += n;
  for (; end - p >= 8; p += 8) h = rotl(h ^ xround(0, rd64(p)), 27) * P1 + P4;
  if (end - p >= 4) {
    h = rotl(h ^ (uint64_t)rd32(p) * P1, 23) * P2 + P3;
    p += 4;
  }
  for (; p < end; ++p) h = rotl(h ^ *p * P5, 11) * P1;
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  return h ^ (h >> 32);
}

// ------------------------------------------------------------- bit streams

// bits [off, off + n) of src, little-endian, n <= 56.
inline uint64_t bits_at(const uint8_t* src, int64_t off, int n) {
  if (n == 0) return 0;
  const uint8_t* p = src + (off >> 3);
  int shift = (int)(off & 7), need = (shift + n + 7) >> 3;
  uint64_t v = 0;
  for (int i = 0; i < need; ++i) v |= (uint64_t)p[i] << (8 * i);
  return (v >> shift) & ((1ULL << n) - 1);
}

// A stream read from its end towards its start (FSE and Huffman). Its last
// byte holds a 1 bit above the first bit read; bits asked for past the
// start read as 0 and leave `off` negative.
struct BackStream {
  const uint8_t* src;
  int64_t off;

  BackStream(const uint8_t* s, size_t n, const char* what) : src(s) {
    if (n == 0) fail(kCorrupt, "%s: empty bitstream", what);
    if (s[n - 1] == 0) fail(kCorrupt, "%s: bitstream has no end marker", what);
    off = (int64_t)n * 8 - (8 - highest_bit(s[n - 1]));
  }
  uint64_t read(int n) {
    off -= n;
    if (off >= 0) return bits_at(src, off, n);
    int64_t have = n + off;
    if (have <= 0) return 0;
    return bits_at(src, 0, (int)have) << (-off);
  }
};

// A forward stream of little-endian bits (FSE table descriptions).
struct FwdStream {
  const uint8_t* src;
  size_t n;
  int64_t off = 0;
  uint32_t read(int k, const char* what) {
    if (off + k > (int64_t)n * 8) fail(kCorrupt, "%s: table description past its end", what);
    uint32_t v = (uint32_t)bits_at(src, off, k);
    off += k;
    return v;
  }
};

// ------------------------------------------------------------- FSE

constexpr int kMaxAccuracy = 9;

struct FseTable {
  int log = -1;  // -1: not set (repeat mode refused)
  uint8_t symbol[1 << kMaxAccuracy];
  uint8_t nbits[1 << kMaxAccuracy];
  uint16_t base[1 << kMaxAccuracy];

  void build(const int16_t* norm, int nsym, int accuracy, const char* what) {
    const int size = 1 << accuracy;
    uint16_t next[256];
    int high = size;
    for (int s = 0; s < nsym; ++s) {
      if (norm[s] == -1) {
        symbol[--high] = (uint8_t)s;
        next[s] = 1;
      }
    }
    const int step = (size >> 1) + (size >> 3) + 3, mask = size - 1;
    int pos = 0;
    for (int s = 0; s < nsym; ++s) {
      if (norm[s] <= 0) continue;
      next[s] = (uint16_t)norm[s];
      for (int i = 0; i < norm[s]; ++i) {
        symbol[pos] = (uint8_t)s;
        do pos = (pos + step) & mask; while (pos >= high);
      }
    }
    if (pos != 0) fail(kCorrupt, "%s: FSE distribution does not fill its table", what);
    for (int i = 0; i < size; ++i) {
      int d = next[symbol[i]]++;
      nbits[i] = (uint8_t)(accuracy - highest_bit(d));
      base[i] = (uint16_t)((d << nbits[i]) - size);
    }
    log = accuracy;
  }

  void rle(uint8_t s) {
    symbol[0] = s;
    nbits[0] = 0;
    base[0] = 0;
    log = 0;
  }

  // Reads a table description; returns the bytes it took.
  size_t read(const uint8_t* src, size_t n, int max_accuracy, int max_symbol, const char* what) {
    FwdStream in{src, n};
    const int accuracy = 5 + (int)in.read(4, what);
    if (accuracy > max_accuracy) fail(kCorrupt, "%s: FSE accuracy %d too large", what, accuracy);
    int remaining = 1 << accuracy, nsym = 0;
    int16_t norm[256];
    while (remaining > 0) {
      if (nsym > max_symbol) fail(kCorrupt, "%s: FSE table has too many symbols", what);
      const int bits = highest_bit((uint64_t)remaining + 1) + 1;
      int64_t at = in.off;
      if (at + bits - 1 > (int64_t)n * 8) fail(kCorrupt, "%s: table description past its end", what);
      // The top bit may lie past the end when the value fits in bits - 1.
      uint32_t val = (uint32_t)bits_at(src, at, bits - 1);
      const uint32_t lower_mask = (1u << (bits - 1)) - 1;
      const uint32_t threshold = (1u << bits) - 1 - (uint32_t)(remaining + 1);
      if (val < threshold) {
        in.off = at + bits - 1;
      } else {
        val = in.read(bits, what);
        if (val > lower_mask) val -= threshold;
      }
      const int proba = (int)val - 1;
      remaining -= proba < 0 ? -proba : proba;
      norm[nsym++] = (int16_t)proba;
      if (proba == 0) {
        for (;;) {
          int repeat = (int)in.read(2, what);
          for (int i = 0; i < repeat; ++i) {
            if (nsym > max_symbol) fail(kCorrupt, "%s: FSE table has too many symbols", what);
            norm[nsym++] = 0;
          }
          if (repeat != 3) break;
        }
      }
    }
    if (remaining != 0) fail(kCorrupt, "%s: FSE probabilities do not sum to the table", what);
    build(norm, nsym, accuracy, what);
    return (size_t)((in.off + 7) >> 3);
  }

  uint32_t init(BackStream& s) const { return (uint32_t)s.read(log); }
  void update(uint32_t& state, BackStream& s) const {
    state = base[state] + (uint32_t)s.read(nbits[state]);
  }
};

// ------------------------------------------------------------- Huffman

constexpr int kMaxHufBits = 11;

struct HufTable {
  int max_bits = 0;  // 0: not set (treeless literals refused)
  uint8_t symbol[1 << kMaxHufBits];
  uint8_t nbits[1 << kMaxHufBits];

  // Reads a tree description; returns the bytes it took.
  size_t read(const uint8_t* src, size_t n) {
    const char* what = "Huffman tree";
    if (n < 1) fail(kCorrupt, "%s: missing", what);
    uint8_t weights[256];
    int nw;
    size_t used;
    const int hb = src[0];
    if (hb < 128) {
      if ((size_t)hb + 1 > n) fail(kCorrupt, "%s: weights past the literals", what);
      FseTable fse;
      size_t head = fse.read(src + 1, hb, 6, 255, what);
      if (head >= (size_t)hb) fail(kCorrupt, "%s: no weights after the FSE table", what);
      BackStream s(src + 1 + head, hb - head, what);
      // Two interleaved states, until a state update reads past the start.
      uint32_t st[2] = {fse.init(s), fse.init(s)};
      nw = 0;
      for (int k = 0;; k ^= 1) {
        if (nw == 255) fail(kCorrupt, "%s: more than 255 weights", what);
        weights[nw++] = fse.symbol[st[k]];
        fse.update(st[k], s);
        if (s.off < 0) {
          if (nw == 255) fail(kCorrupt, "%s: more than 255 weights", what);
          weights[nw++] = fse.symbol[st[k ^ 1]];
          break;
        }
      }
      used = 1 + (size_t)hb;
    } else {
      nw = hb - 127;
      used = 1 + (size_t)(nw + 1) / 2;
      if (used > n) fail(kCorrupt, "%s: weights past the literals", what);
      for (int i = 0; i < nw; ++i) {
        uint8_t b = src[1 + i / 2];
        weights[i] = (i & 1) ? (b & 15) : (b >> 4);
      }
    }
    uint32_t sum = 0;
    for (int i = 0; i < nw; ++i) {
      if (weights[i] > kMaxHufBits) fail(kCorrupt, "%s: weight above %d", what, kMaxHufBits);
      if (weights[i]) sum += 1u << (weights[i] - 1);
    }
    if (sum == 0) fail(kCorrupt, "%s: all weights 0", what);
    const int mb = highest_bit(sum) + 1;
    if (mb > kMaxHufBits) fail(kCorrupt, "%s: codes longer than %d bits", what, kMaxHufBits);
    const uint32_t left = (1u << mb) - sum;
    if (left & (left - 1)) fail(kCorrupt, "%s: weights leave no power of 2", what);
    weights[nw] = (uint8_t)(highest_bit(left) + 1);
    const int nsym = nw + 1;
    int bits[256], count[kMaxHufBits + 2] = {0};
    for (int i = 0; i < nsym; ++i) {
      bits[i] = weights[i] ? mb + 1 - weights[i] : 0;
      count[bits[i]]++;
    }
    int start[kMaxHufBits + 2];
    start[mb] = 0;
    for (int l = mb; l >= 1; --l) {
      start[l - 1] = start[l] + count[l] * (1 << (mb - l));
      for (int i = start[l]; i < start[l - 1]; ++i) nbits[i] = (uint8_t)l;
    }
    if (start[0] != (1 << mb)) fail(kCorrupt, "%s: codes do not fill the table", what);
    for (int i = 0; i < nsym; ++i) {
      if (!bits[i]) continue;
      int len = 1 << (mb - bits[i]);
      memset(symbol + start[bits[i]], i, len);
      start[bits[i]] += len;
    }
    max_bits = mb;
    return used;
  }

  void decode_stream(const uint8_t* src, size_t n, uint8_t* out, size_t count) const {
    BackStream s(src, n, "Huffman stream");
    const uint32_t mask = (1u << max_bits) - 1;
    uint32_t state = (uint32_t)s.read(max_bits);
    size_t i = 0;
    while (s.off > -max_bits) {
      if (i == count) fail(kCorrupt, "Huffman stream: more literals than stated");
      out[i++] = symbol[state];
      int nb = nbits[state];
      state = ((state << nb) & mask) | (uint32_t)s.read(nb);
    }
    if (s.off != -max_bits || i != count)
      fail(kCorrupt, "Huffman stream: %zu literals where %zu were stated", i, count);
  }
};

// ------------------------------------------------------------- sequences

constexpr uint32_t kLLBase[36] = {0,  1,  2,   3,   4,   5,    6,    7,    8,    9,     10,    11,
                                  12, 13, 14,  15,  16,  18,   20,   22,   24,   28,    32,    40,
                                  48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
constexpr uint8_t kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  0,  0,  0,  0,  1,  1,
                                 1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
constexpr uint32_t kMLBase[53] = {3,  4,  5,  6,  7,  8,  9,   10,  11,  12,  13,   14,   15,   16,
                                  17, 18, 19, 20, 21, 22, 23,  24,  25,  26,  27,   28,   29,   30,
                                  31, 32, 33, 34, 35, 37, 39,  41,  43,  47,  51,   59,   67,   83,
                                  99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
constexpr uint8_t kMLBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                                 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1,
                                 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
constexpr int16_t kLLDefault[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2,
                                    2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
constexpr int16_t kMLDefault[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
constexpr int16_t kOFDefault[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                                    1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};

constexpr size_t kMaxBlock = 128 * 1024;

// ------------------------------------------------------------- frames

struct Decoder {
  const uint8_t* src;
  size_t n;
  uint8_t* dst;  // nullptr: only sizes are read
  size_t cap;
  size_t pos = 0;  // in src
  size_t out = 0;  // in dst

  // Per-frame state.
  size_t frame_start = 0;
  size_t block_max = 0;
  uint64_t reps[3];
  FseTable ll, of, ml;
  HufTable huf;
  uint8_t literals[kMaxBlock];

  Decoder(const uint8_t* s, size_t len, uint8_t* d, size_t c) : src(s), n(len), dst(d), cap(c) {}

  const uint8_t* take(size_t k, const char* what) {
    if (k > n - pos) fail(kTruncated, "truncated frame: %s needs %zu bytes, %zu left", what, k, n - pos);
    const uint8_t* p = src + pos;
    pos += k;
    return p;
  }

  void emit_check(size_t k) {
    if (k > cap - out)
      fail(kBound, "output past the bound of %zu bytes", cap);
  }

  // Returns the frame's stated content size, or -1 if it states none.
  int64_t frame(bool decode) {
    const uint32_t magic = rd32(take(4, "the magic number"));
    if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {
      take(rd32(take(4, "a skippable frame's size")), "a skippable frame");
      return 0;
    }
    if (magic != 0xFD2FB528u) fail(kCorrupt, "not a zstd frame (magic %08x)", magic);
    const uint8_t fhd = *take(1, "the frame header");
    const int fcs_flag = fhd >> 6, single = (fhd >> 5) & 1, checksum = (fhd >> 2) & 1,
              did_flag = fhd & 3;
    if (fhd & 8) fail(kCorrupt, "frame header: reserved bit set");
    uint64_t window = 0;
    if (!single) {
      const uint8_t wd = *take(1, "the window descriptor");
      const int log = 10 + (wd >> 3);
      if (log > 31) fail(kCorrupt, "window of 2^%d bytes", log);
      window = (1ULL << log) + ((1ULL << log) >> 3) * (wd & 7);
    }
    static const int did_size[4] = {0, 1, 2, 4};
    const uint8_t* didp = take(did_size[did_flag], "the dictionary ID");
    uint32_t did = 0;
    for (int i = 0; i < did_size[did_flag]; ++i) did |= (uint32_t)didp[i] << (8 * i);
    if (did != 0) fail(kDictionary, "frame needs dictionary %u, and no dictionary is known", did);
    static const int fcs_size[4] = {0, 2, 4, 8};
    const int fs = fcs_flag == 0 ? (single ? 1 : 0) : fcs_size[fcs_flag];
    const uint8_t* fcsp = take(fs, "the content size");
    int64_t content = -1;
    if (fs) {
      uint64_t v = 0;
      for (int i = 0; i < fs; ++i) v |= (uint64_t)fcsp[i] << (8 * i);
      if (fs == 2) v += 256;
      if (v > (uint64_t)INT64_MAX) fail(kCorrupt, "content size too large");
      content = (int64_t)v;
    }
    if (single) window = (uint64_t)content;
    block_max = window < kMaxBlock ? (size_t)window : kMaxBlock;
    frame_start = out;
    reps[0] = 1, reps[1] = 4, reps[2] = 8;
    ll.log = of.log = ml.log = -1;
    huf.max_bits = 0;
    for (bool last = false; !last;) {
      const uint32_t bh = rd24(take(3, "a block header"));
      last = bh & 1;
      const int type = (bh >> 1) & 3;
      const size_t size = bh >> 3;
      if (type == 3) fail(kCorrupt, "reserved block type");
      if (size > block_max) fail(kCorrupt, "block of %zu bytes above the frame's maximum %zu", size, block_max);
      if (type == 1) {
        const uint8_t b = *take(1, "an RLE block");
        if (decode) {
          emit_check(size);
          memset(dst + out, b, size);
        }
        out += size;
      } else {
        const uint8_t* p = take(size, "a block");
        if (!decode) continue;
        if (type == 0) {
          emit_check(size);
          memcpy(dst + out, p, size);
          out += size;
        } else {
          compressed_block(p, size);
        }
      }
    }
    if (decode && content >= 0 && out - frame_start != (uint64_t)content)
      fail(kCorrupt, "frame decodes to %zu bytes, its header states %lld", out - frame_start,
           (long long)content);
    if (checksum) {
      const uint32_t want = rd32(take(4, "the content checksum"));
      if (decode && (uint32_t)xxh64(dst + frame_start, out - frame_start) != want)
        fail(kChecksum, "content checksum mismatch");
    }
    return content;
  }

  void compressed_block(const uint8_t* p, size_t n) {
    const uint8_t* end = p + n;
    size_t nlit = 0;
    p = read_literals(p, n, &nlit);
    const size_t block_start = out;
    if (p >= end) fail(kCorrupt, "compressed block: no sequences section");
    size_t nseq = *p++;
    if (nseq >= 128) {
      if (nseq == 255) {
        if (end - p < 2) fail(kCorrupt, "compressed block: sequence count past the block");
        nseq = rd16(p) + 0x7F00;
        p += 2;
      } else {
        if (end - p < 1) fail(kCorrupt, "compressed block: sequence count past the block");
        nseq = ((nseq - 128) << 8) + *p++;
      }
    }
    size_t lit = 0;
    if (nseq) {
      if (p >= end) fail(kCorrupt, "compressed block: no symbol compression modes");
      const uint8_t modes = *p++;
      if (modes & 3) fail(kCorrupt, "compressed block: reserved mode bits set");
      p = table(ll, modes >> 6, p, end, 9, 35, kLLDefault, 36, 6, "literal lengths");
      p = table(of, (modes >> 4) & 3, p, end, 8, 31, kOFDefault, 29, 5, "offsets");
      p = table(ml, (modes >> 2) & 3, p, end, 9, 52, kMLDefault, 53, 6, "match lengths");
      BackStream s(p, (size_t)(end - p), "sequences");
      uint32_t sl = ll.init(s), so = of.init(s), sm = ml.init(s);
      for (size_t i = 0; i < nseq; ++i) {
        const uint32_t ofc = of.symbol[so], llc = ll.symbol[sl], mlc = ml.symbol[sm];
        if (ofc > 31 || llc > 35 || mlc > 52) fail(kCorrupt, "sequences: code out of range");
        uint64_t ofv = (1ULL << ofc) + s.read((int)ofc);
        const uint64_t mlen = kMLBase[mlc] + s.read(kMLBits[mlc]);
        const uint64_t llen = kLLBase[llc] + s.read(kLLBits[llc]);
        if (i + 1 < nseq) {
          ll.update(sl, s);
          ml.update(sm, s);
          of.update(so, s);
        }
        uint64_t offset;
        if (ofv > 3) {
          offset = ofv - 3;
          reps[2] = reps[1], reps[1] = reps[0], reps[0] = offset;
        } else {
          const uint64_t idx = ofv - 1 + (llen == 0);
          if (idx == 0) {
            offset = reps[0];
          } else {
            offset = idx < 3 ? reps[idx] : reps[0] - 1;
            if (idx > 1) reps[2] = reps[1];
            reps[1] = reps[0];
            reps[0] = offset;
          }
        }
        if (llen > nlit - lit) fail(kCorrupt, "sequences: more literals than decoded");
        emit_check(llen);
        memcpy(dst + out, literals + lit, llen);
        out += llen;
        lit += llen;
        if (offset == 0 || offset > out - frame_start)
          fail(kCorrupt, "sequences: offset %llu before the frame's start", (unsigned long long)offset);
        emit_check(mlen);
        uint8_t* op = dst + out;
        const uint8_t* from = op - offset;
        for (size_t left = mlen; left;) {
          size_t c = left < (size_t)(op - from) ? left : (size_t)(op - from);
          memcpy(op, from, c);
          op += c;
          left -= c;
        }
        out += mlen;
      }
      if (s.off != 0) fail(kCorrupt, "sequences: bitstream not consumed exactly");
    }
    emit_check(nlit - lit);
    memcpy(dst + out, literals + lit, nlit - lit);
    out += nlit - lit;
    if (out - block_start > block_max) fail(kCorrupt, "block decodes past the frame's block maximum");
  }

  const uint8_t* table(FseTable& t, int mode, const uint8_t* p, const uint8_t* end, int max_acc,
                       int max_sym, const int16_t* dflt, int ndflt, int dflt_acc, const char* what) {
    switch (mode) {
      case 0:
        t.build(dflt, ndflt, dflt_acc, what);
        return p;
      case 1:
        if (p >= end) fail(kCorrupt, "%s: RLE symbol past the block", what);
        if (*p > max_sym) fail(kCorrupt, "%s: RLE symbol out of range", what);
        t.rle(*p);
        return p + 1;
      case 2:
        return p + t.read(p, (size_t)(end - p), max_acc, max_sym, what);
      default:
        if (t.log < 0) fail(kCorrupt, "%s: repeat mode with no earlier table", what);
        return p;
    }
  }

  const uint8_t* read_literals(const uint8_t* p, size_t n, size_t* nlit) {
    if (n < 1) fail(kCorrupt, "literals: empty block");
    const int type = p[0] & 3, sf = (p[0] >> 2) & 3;
    size_t regen, csize = 0, head;
    int streams = 1;
    if (type < 2) {
      if (sf == 0 || sf == 2) {
        head = 1, regen = p[0] >> 3;
      } else if (sf == 1) {
        head = 2;
        if (n < 2) fail(kCorrupt, "literals: header past the block");
        regen = (p[0] >> 4) + ((size_t)p[1] << 4);
      } else {
        head = 3;
        if (n < 3) fail(kCorrupt, "literals: header past the block");
        regen = (p[0] >> 4) + ((size_t)p[1] << 4) + ((size_t)p[2] << 12);
      }
    } else {
      streams = sf == 0 ? 1 : 4;
      head = sf < 2 ? 3 : sf == 2 ? 4 : 5;
      if (n < head) fail(kCorrupt, "literals: header past the block");
      uint64_t h = 0;
      for (size_t i = 0; i < head; ++i) h |= (uint64_t)p[i] << (8 * i);
      const int bits = sf < 2 ? 10 : sf == 2 ? 14 : 18;
      regen = (h >> 4) & ((1u << bits) - 1);
      csize = (h >> (4 + bits)) & ((1u << bits) - 1);
    }
    if (regen > block_max) fail(kCorrupt, "literals: %zu bytes above the block maximum", regen);
    *nlit = regen;
    p += head;
    n -= head;
    if (type == 0) {
      if (regen > n) fail(kCorrupt, "literals: raw literals past the block");
      memcpy(literals, p, regen);
      return p + regen;
    }
    if (type == 1) {
      if (n < 1) fail(kCorrupt, "literals: RLE byte past the block");
      memset(literals, p[0], regen);
      return p + 1;
    }
    if (csize > n) fail(kCorrupt, "literals: compressed literals past the block");
    const uint8_t* q = p;
    size_t left = csize;
    if (type == 2) {
      size_t used = huf.read(q, left);
      q += used;
      left -= used;
    } else if (huf.max_bits == 0) {
      fail(kCorrupt, "literals: treeless literals with no earlier Huffman tree");
    }
    if (streams == 1) {
      huf.decode_stream(q, left, literals, regen);
    } else {
      if (left < 6) fail(kCorrupt, "literals: jump table past the literals");
      const size_t s1 = rd16(q), s2 = rd16(q + 2), s3 = rd16(q + 4);
      q += 6;
      left -= 6;
      if (s1 + s2 + s3 > left) fail(kCorrupt, "literals: Huffman streams past the literals");
      const size_t s4 = left - s1 - s2 - s3, seg = (regen + 3) / 4;
      if (3 * seg > regen) fail(kCorrupt, "literals: too few literals for 4 streams");
      huf.decode_stream(q, s1, literals, seg);
      huf.decode_stream(q + s1, s2, literals + seg, seg);
      huf.decode_stream(q + s1 + s2, s3, literals + 2 * seg, seg);
      huf.decode_stream(q + s1 + s2 + s3, s4, literals + 3 * seg, regen - 3 * seg);
    }
    return p + csize;
  }
};

int report(const Failure& f, int* kind, char* err, int errlen) {
  if (kind) *kind = f.kind;
  if (err && errlen > 0) snprintf(err, errlen, "%s", f.msg.c_str());
  return -1;
}

uint32_t crc_table[8][256];
bool crc_ready = [] {
  for (uint32_t i = 0; i < 256; ++i) {
    uint32_t c = i;
    for (int k = 0; k < 8; ++k) c = (c >> 1) ^ (0x82F63B78u & (0u - (c & 1)));
    crc_table[0][i] = c;
  }
  for (int t = 1; t < 8; ++t)
    for (int i = 0; i < 256; ++i)
      crc_table[t][i] = (crc_table[t - 1][i] >> 8) ^ crc_table[0][crc_table[t - 1][i] & 0xFF];
  return true;
}();

}  // namespace

extern "C" {

int64_t premvos_zstd_content_size(const uint8_t* src, int64_t n, int* kind, char* err,
                                  int errlen) {
  try {
    std::unique_ptr<Decoder> d(new Decoder(src, (size_t)n, nullptr, 0));
    int64_t total = 0;
    bool known = true;
    while (d->pos < d->n) {
      const int64_t c = d->frame(false);
      if (c < 0) known = false;
      else total += c;
    }
    return known ? total : -2;  // -2: a frame states no size
  } catch (const Failure& f) {
    return report(f, kind, err, errlen);
  } catch (const std::bad_alloc&) {
    return report(Failure{kCorrupt, "out of memory"}, kind, err, errlen);
  }
}

int64_t premvos_zstd_decode(const uint8_t* src, int64_t n, uint8_t* dst, int64_t cap, int* kind,
                            char* err, int errlen) {
  try {
    std::unique_ptr<Decoder> d(new Decoder(src, (size_t)n, dst, (size_t)cap));
    while (d->pos < d->n) d->frame(true);
    return (int64_t)d->out;
  } catch (const Failure& f) {
    return report(f, kind, err, errlen);
  } catch (const std::bad_alloc&) {
    return report(Failure{kCorrupt, "out of memory"}, kind, err, errlen);
  }
}

uint32_t premvos_crc32c(const uint8_t* p, int64_t n) {
  uint32_t c = 0xFFFFFFFFu;
  for (; n >= 8; n -= 8, p += 8) {
    uint32_t lo = rd32(p) ^ c, hi = rd32(p + 4);
    c = crc_table[7][lo & 0xFF] ^ crc_table[6][(lo >> 8) & 0xFF] ^ crc_table[5][(lo >> 16) & 0xFF] ^
        crc_table[4][lo >> 24] ^ crc_table[3][hi & 0xFF] ^ crc_table[2][(hi >> 8) & 0xFF] ^
        crc_table[1][(hi >> 16) & 0xFF] ^ crc_table[0][hi >> 24];
  }
  for (; n > 0; --n, ++p) c = (c >> 8) ^ crc_table[0][(c ^ *p) & 0xFF];
  return c ^ 0xFFFFFFFFu;
}

}  // extern "C"

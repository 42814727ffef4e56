// A Zstandard decoder (RFC 8878, decompression only), and CRC32C.
//
// Host code for the orbax checkpoint reader (orbax.py): tensorstore writes
// every OCDBT node and every zarr chunk of a JAX training run as a zstd
// frame, and each OCDBT node ends in a CRC32C of its bytes.  Everything a
// conforming encoder emits is decoded: raw, RLE and compressed blocks; raw,
// RLE, Huffman (1 and 4 streams) and treeless literals; sequences with
// predefined, RLE, FSE-compressed and repeated tables and the three repeat
// offsets; any window up to the frame's; known and unknown content size;
// the XXH64 content checksum (verified); several frames and skippable
// frames back to back.  A frame that names a dictionary is refused.
//
// Every length is checked before it is used: corrupt or truncated input
// gives an error with the input offset where it was found, never a read
// or write out of bounds.  The interface is plain C (loaded with ctypes):
//
//   m2m_zstd_content_size(src, n)  the sum of the frames' declared content
//       sizes; -1 if a frame does not declare it or the headers do not
//       parse (the decode then says why).
//   m2m_zstd_decompress(src, n, dst, cap, &len, err, err_cap, &err_off)
//       0: decoded, `len` bytes in dst; 1: corrupt input, message in err,
//       input offset in err_off; 2: dst is too small (len = bytes decoded
//       before it filled).
//   m2m_crc32c(src, n)              CRC32C (Castagnoli), as OCDBT uses it.
//   m2m_xxh64(src, n, seed)         XXH64.

#include <cstddef>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>

namespace {

struct DecodeError {
  std::string msg;
  size_t off;
};

struct OutputFull {};

[[noreturn]] void fail(size_t off, const char* msg) {
  throw DecodeError{msg, off};
}

inline uint32_t read_le32(const uint8_t* p) {
  return uint32_t(p[0]) | uint32_t(p[1]) << 8 | uint32_t(p[2]) << 16 |
         uint32_t(p[3]) << 24;
}

inline uint64_t read_le64(const uint8_t* p) {
  return uint64_t(read_le32(p)) | uint64_t(read_le32(p + 4)) << 32;
}

inline int highbit(uint32_t v) {  // v > 0
  return 31 - __builtin_clz(v);
}

// ---------------------------------------------------------------- XXH64 --

constexpr uint64_t P1 = 0x9E3779B185EBCA87ULL;
constexpr uint64_t P2 = 0xC2B2AE3D27D4EB4FULL;
constexpr uint64_t P3 = 0x165667B19E3779F9ULL;
constexpr uint64_t P4 = 0x85EBCA77C2B2AE63ULL;
constexpr uint64_t P5 = 0x27D4EB2F165667C5ULL;

inline uint64_t rotl64(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }

inline uint64_t xxh_round(uint64_t acc, uint64_t in) {
  acc += in * P2;
  return rotl64(acc, 31) * P1;
}

inline uint64_t xxh_merge(uint64_t acc, uint64_t v) {
  acc ^= xxh_round(0, v);
  return acc * P1 + P4;
}

uint64_t xxh64(const uint8_t* p, size_t n, uint64_t seed) {
  const uint8_t* end = p + n;
  uint64_t h;
  if (n >= 32) {
    uint64_t v1 = seed + P1 + P2, v2 = seed + P2, v3 = seed, v4 = seed - P1;
    const uint8_t* limit = end - 32;
    do {
      v1 = xxh_round(v1, read_le64(p));
      v2 = xxh_round(v2, read_le64(p + 8));
      v3 = xxh_round(v3, read_le64(p + 16));
      v4 = xxh_round(v4, read_le64(p + 24));
      p += 32;
    } while (p <= limit);
    h = rotl64(v1, 1) + rotl64(v2, 7) + rotl64(v3, 12) + rotl64(v4, 18);
    h = xxh_merge(h, v1);
    h = xxh_merge(h, v2);
    h = xxh_merge(h, v3);
    h = xxh_merge(h, v4);
  } else {
    h = seed + P5;
  }
  h += uint64_t(n);
  while (end - p >= 8) {
    h ^= xxh_round(0, read_le64(p));
    h = rotl64(h, 27) * P1 + P4;
    p += 8;
  }
  if (end - p >= 4) {
    h ^= uint64_t(read_le32(p)) * P1;
    h = rotl64(h, 23) * P2 + P3;
    p += 4;
  }
  while (p < end) {
    h ^= uint64_t(*p) * P5;
    h = rotl64(h, 11) * P1;
    ++p;
  }
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  return h;
}

// --------------------------------------------------------------- CRC32C --

struct Crc32cTable {
  uint32_t t[8][256];
  Crc32cTable() {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k) c = (c >> 1) ^ (0x82F63B78u & (0u - (c & 1)));
      t[0][i] = c;
    }
    for (int s = 1; s < 8; ++s)
      for (uint32_t i = 0; i < 256; ++i)
        t[s][i] = (t[s - 1][i] >> 8) ^ t[0][t[s - 1][i] & 0xFF];
  }
};

uint32_t crc32c(const uint8_t* p, size_t n) {
  static const Crc32cTable tab;
  uint32_t c = 0xFFFFFFFFu;
  while (n >= 8) {  // slicing by 8
    uint32_t lo = read_le32(p) ^ c, hi = read_le32(p + 4);
    c = tab.t[7][lo & 0xFF] ^ tab.t[6][(lo >> 8) & 0xFF] ^
        tab.t[5][(lo >> 16) & 0xFF] ^ tab.t[4][lo >> 24] ^
        tab.t[3][hi & 0xFF] ^ tab.t[2][(hi >> 8) & 0xFF] ^
        tab.t[1][(hi >> 16) & 0xFF] ^ tab.t[0][hi >> 24];
    p += 8;
    n -= 8;
  }
  while (n--) c = (c >> 8) ^ tab.t[0][(c ^ *p++) & 0xFF];
  return c ^ 0xFFFFFFFFu;
}

// ---------------------------------------------------------- bit readers --

// A forward bit stream (the FSE table descriptions): little-endian bytes,
// bits taken from the least significant end.  Bits past the end read as
// zero; the caller checks how many were used.
struct ForwardBits {
  const uint8_t* p;
  size_t n;
  size_t bit = 0;

  uint32_t peek(int nb) const {  // nb <= 32
    uint64_t w = 0;
    size_t byte = bit >> 3;
    for (int i = 0; i < 5 && byte + i < n; ++i)
      w |= uint64_t(p[byte + i]) << (8 * i);
    return uint32_t((w >> (bit & 7)) & ((uint64_t(1) << nb) - 1));
  }
  void skip(int nb) { bit += size_t(nb); }
};

// A backward bit stream (Huffman streams, FSE weights, sequences): read
// from the end, which holds a 1 bit above the first bit of the stream.
// `pos` counts the bits not yet read; bits below the start read as zero
// and make `pos` negative (an overflow the callers test for).
struct BackwardBits {
  const uint8_t* p;
  size_t n;
  int64_t pos;

  BackwardBits(const uint8_t* data, size_t len, size_t off) : p(data), n(len) {
    if (len == 0) fail(off, "empty bit stream");
    uint8_t last = data[len - 1];
    if (last == 0) fail(off + len - 1, "bit stream without its end mark");
    pos = int64_t(len - 1) * 8 + highbit(last);
  }

  uint64_t bits_at(int64_t start, int nb) const {  // nb <= 56
    if (nb == 0) return 0;
    if (start < 0) {
      int real = int(start + nb);
      if (real <= 0) return 0;
      return (bits_at(0, real) << (-start)) & ((uint64_t(1) << nb) - 1);
    }
    size_t byte = size_t(start >> 3);
    uint64_t w;
    if (byte + 8 <= n) {
      w = read_le64(p + byte);
    } else {
      w = 0;
      for (size_t i = 0; byte + i < n; ++i) w |= uint64_t(p[byte + i]) << (8 * i);
    }
    return (w >> (start & 7)) & ((uint64_t(1) << nb) - 1);
  }

  uint64_t read(int nb) {
    pos -= nb;
    return bits_at(pos, nb);
  }
  uint64_t peek(int nb) const { return bits_at(pos - nb, nb); }
  void skip(int nb) { pos -= nb; }
};

// ------------------------------------------------------------------ FSE --

struct FseEntry {
  uint16_t symbol;
  uint8_t nb_bits;
  uint16_t base;  // the next state's base; + the nb_bits read
};

struct FseTable {
  int accuracy_log = 0;
  FseEntry e[1 << 9];
};

// Decode an FSE table description (RFC 8878 4.1.1) from p[0..n): the
// normalized counts into `norm`, -> bytes used.  max_symbol is the largest
// symbol the table may carry, max_log its largest accuracy log.
size_t read_ncount(const uint8_t* p, size_t n, size_t off, int16_t* norm,
                   int max_symbol, int max_log, int* nsym, int* log_out) {
  if (n == 0) fail(off, "truncated FSE table description");
  ForwardBits bits{p, n};
  int log = int(bits.peek(4)) + 5;
  bits.skip(4);
  if (log > max_log) fail(off, "FSE accuracy log too large");
  int remaining = (1 << log) + 1;
  int threshold = 1 << log;
  int nb = log + 1;
  int sym = 0;
  bool previous0 = false;
  while (remaining > 1 && sym <= max_symbol) {
    if (previous0) {
      int repeat;
      do {
        repeat = int(bits.peek(2));
        bits.skip(2);
        for (int r = 0; r < repeat; ++r) {
          if (sym > max_symbol) fail(off, "FSE table: too many symbols");
          norm[sym++] = 0;
        }
        if (bits.bit > n * 8) fail(off, "truncated FSE table description");
      } while (repeat == 3);
      if (sym > max_symbol) fail(off, "FSE table: too many symbols");
    }
    int max = 2 * threshold - 1 - remaining;
    int count;
    uint32_t low = bits.peek(nb - 1);
    if (int(low) < max) {
      count = int(low);
      bits.skip(nb - 1);
    } else {
      count = int(bits.peek(nb));
      if (count >= threshold) count -= max;
      bits.skip(nb);
    }
    count -= 1;  // -1: a "less than one" probability
    remaining -= count < 0 ? -count : count;
    norm[sym++] = int16_t(count);
    previous0 = count == 0;
    while (remaining < threshold) {
      nb -= 1;
      threshold >>= 1;
    }
    if (bits.bit > n * 8) fail(off, "truncated FSE table description");
  }
  if (remaining != 1) fail(off, "corrupt FSE table description");
  *nsym = sym;
  *log_out = log;
  return (bits.bit + 7) >> 3;
}

void build_fse(FseTable& t, const int16_t* norm, int nsym, int log,
               size_t off) {
  int size = 1 << log;
  int high = size - 1;
  uint16_t next[256];
  t.accuracy_log = log;
  int total = 0;
  for (int s = 0; s < nsym; ++s) {
    if (norm[s] == -1) {
      t.e[high--].symbol = uint16_t(s);
      next[s] = 1;
      total += 1;
    } else {
      next[s] = uint16_t(norm[s]);
      total += norm[s];
    }
  }
  if (total != size) fail(off, "FSE table: counts do not sum to its size");
  int step = (size >> 1) + (size >> 3) + 3;
  int mask = size - 1;
  int position = 0;
  for (int s = 0; s < nsym; ++s) {
    for (int i = 0; i < norm[s]; ++i) {
      t.e[position].symbol = uint16_t(s);
      do {
        position = (position + step) & mask;
      } while (position > high);
    }
  }
  if (position != 0) fail(off, "FSE table: bad spread");
  for (int u = 0; u < size; ++u) {
    int s = t.e[u].symbol;
    int state = next[s]++;
    int nb = log - highbit(uint32_t(state));
    t.e[u].nb_bits = uint8_t(nb);
    t.e[u].base = uint16_t((state << nb) - size);
  }
}

void build_rle(FseTable& t, int symbol) {
  t.accuracy_log = 0;
  t.e[0] = FseEntry{uint16_t(symbol), 0, 0};
}

// -------------------------------------------------------------- Huffman --

struct HufEntry {
  uint8_t symbol;
  uint8_t nb_bits;
};

struct HufTable {
  bool valid = false;
  int max_bits = 0;
  HufEntry e[1 << 11];
};

// Decode a Huffman tree description (RFC 8878 4.2.1), -> bytes used.
size_t read_huffman(const uint8_t* p, size_t n, size_t off, HufTable& t) {
  if (n == 0) fail(off, "truncated Huffman tree description");
  uint8_t weights[256];
  int nw = 0;
  size_t used;
  int header = p[0];
  if (header >= 128) {
    nw = header - 127;
    size_t bytes = size_t(nw + 1) / 2;
    if (1 + bytes > n) fail(off, "truncated Huffman weights");
    for (int i = 0; i < nw; ++i) {
      uint8_t b = p[1 + i / 2];
      weights[i] = (i % 2 == 0) ? uint8_t(b >> 4) : uint8_t(b & 15);
    }
    used = 1 + bytes;
  } else {
    size_t csize = size_t(header);
    if (csize == 0 || 1 + csize > n) fail(off, "truncated Huffman weights");
    const uint8_t* q = p + 1;
    int16_t norm[16];
    int nsym, log;
    size_t hdr = read_ncount(q, csize, off + 1, norm, 15, 6, &nsym, &log);
    if (hdr >= csize) fail(off + 1, "Huffman weights: no bit stream");
    FseTable table;
    build_fse(table, norm, nsym, log, off + 1);
    BackwardBits bits(q + hdr, csize - hdr, off + 1 + hdr);
    uint32_t s1 = uint32_t(bits.read(log));
    uint32_t s2 = uint32_t(bits.read(log));
    // two interleaved states; the stream ends when it overflows, and the
    // other state's symbol is the last weight
    for (;;) {
      if (nw > 254) fail(off, "Huffman weights: too many");
      const FseEntry& a = table.e[s1];
      weights[nw++] = uint8_t(a.symbol);
      s1 = a.base + uint32_t(bits.read(a.nb_bits));
      if (bits.pos < 0) {
        weights[nw++] = uint8_t(table.e[s2].symbol);
        break;
      }
      if (nw > 254) fail(off, "Huffman weights: too many");
      const FseEntry& b = table.e[s2];
      weights[nw++] = uint8_t(b.symbol);
      s2 = b.base + uint32_t(bits.read(b.nb_bits));
      if (bits.pos < 0) {
        weights[nw++] = uint8_t(table.e[s1].symbol);
        break;
      }
    }
    used = 1 + csize;
  }
  if (nw > 255) fail(off, "Huffman weights: too many");
  uint32_t total = 0;
  for (int i = 0; i < nw; ++i) {
    if (weights[i] > 11) fail(off, "Huffman weight too large");
    if (weights[i]) total += uint32_t(1) << (weights[i] - 1);
  }
  if (total == 0) fail(off, "Huffman weights all zero");
  int max_bits = highbit(total) + 1;
  if (max_bits > 11) fail(off, "Huffman code too long");
  uint32_t rest = (uint32_t(1) << max_bits) - total;
  if (rest & (rest - 1)) fail(off, "Huffman weights do not complete a tree");
  weights[nw++] = uint8_t(highbit(rest) + 1);
  // lower weights take the lower table slots, symbols in order within one
  int slot = 0;
  for (int w = 1; w <= max_bits; ++w) {
    int span = 1 << (w - 1);
    for (int s = 0; s < nw; ++s) {
      if (weights[s] != w) continue;
      for (int k = 0; k < span; ++k)
        t.e[slot + k] = HufEntry{uint8_t(s), uint8_t(max_bits + 1 - w)};
      slot += span;
    }
  }
  if (slot != (1 << max_bits)) fail(off, "Huffman table incomplete");
  t.max_bits = max_bits;
  t.valid = true;
  return used;
}

void decode_huffman_stream(const HufTable& t, const uint8_t* p, size_t n,
                           size_t off, uint8_t* out, size_t count) {
  BackwardBits bits(p, n, off);
  int mb = t.max_bits;
  for (size_t i = 0; i < count; ++i) {
    const HufEntry& e = t.e[bits.peek(mb)];
    out[i] = e.symbol;
    bits.skip(e.nb_bits);
  }
  if (bits.pos != 0) fail(off, "Huffman stream not consumed exactly");
}

// ---------------------------------------------------------------- frame --

constexpr size_t kMaxBlock = 128 * 1024;

const int16_t kLLNorm[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2,
                             2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2,
                             2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t kMLNorm[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1,
                             1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                             1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                             1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t kOFNorm[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                             1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};

const uint32_t kLLBase[36] = {
    0,    1,    2,     3,     4,     5,     6,      7,      8,    9,
    10,   11,   12,    13,    14,    15,    16,     18,     20,   22,
    24,   28,   32,    40,    48,    64,    128,    256,    512,  1024,
    2048, 4096, 8192,  16384, 32768, 65536};
const uint8_t kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3,
                             4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t kMLBase[53] = {
    3,    4,    5,    6,    7,     8,     9,     10,    11,  12,  13,
    14,   15,   16,   17,   18,    19,    20,    21,    22,  23,  24,
    25,   26,   27,   28,   29,    30,    31,    32,    33,  34,  35,
    37,   39,   41,   43,   47,    51,    59,    67,    83,  99,  131,
    259,  515,  1027, 2051, 4099,  8195,  16387, 32771, 65539};
const uint8_t kMLBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3, 4, 4,
                             5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};

struct Output {
  uint8_t* dst;
  size_t cap;
  size_t len = 0;

  void need(size_t k) const {
    if (k > cap - len) throw OutputFull{};
  }
};

struct Frame {
  HufTable huf;
  FseTable ll, ml, of;
  bool ll_ok = false, ml_ok = false, of_ok = false;
  uint32_t rep[3] = {1, 4, 8};
  uint64_t window = 0;
  size_t start = 0;  // the frame's first byte in the output
  uint8_t literals[kMaxBlock];
};

// -> literal count; the literals in f.literals; *used = section bytes
size_t decode_literals(Frame& f, const uint8_t* b, size_t n, size_t off,
                       size_t* used) {
  if (n == 0) fail(off, "truncated literals section");
  int type = b[0] & 3;
  int sf = (b[0] >> 2) & 3;
  if (type <= 1) {  // raw or RLE
    size_t hsz, regen;
    if (sf == 0 || sf == 2) {
      hsz = 1;
      regen = b[0] >> 3;
    } else if (sf == 1) {
      hsz = 2;
      if (n < 2) fail(off, "truncated literals header");
      regen = (b[0] >> 4) + (size_t(b[1]) << 4);
    } else {
      hsz = 3;
      if (n < 3) fail(off, "truncated literals header");
      regen = (b[0] >> 4) + (size_t(b[1]) << 4) + (size_t(b[2]) << 12);
    }
    if (regen > kMaxBlock) fail(off, "literals larger than a block");
    if (type == 0) {
      if (regen > n - hsz) fail(off, "truncated raw literals");
      std::memcpy(f.literals, b + hsz, regen);
      *used = hsz + regen;
    } else {
      if (n < hsz + 1) fail(off, "truncated RLE literals");
      std::memset(f.literals, b[hsz], regen);
      *used = hsz + 1;
    }
    return regen;
  }
  // Huffman-compressed (2) or treeless (3)
  size_t hsz = sf <= 1 ? 3 : (sf == 2 ? 4 : 5);
  if (n < hsz) fail(off, "truncated literals header");
  int streams = sf == 0 ? 1 : 4;
  size_t regen, csize;
  if (hsz == 3) {
    uint32_t h = uint32_t(b[0]) | uint32_t(b[1]) << 8 | uint32_t(b[2]) << 16;
    regen = (h >> 4) & 0x3FF;
    csize = (h >> 14) & 0x3FF;
  } else if (hsz == 4) {
    uint32_t h = read_le32(b);
    regen = (h >> 4) & 0x3FFF;
    csize = (h >> 18) & 0x3FFF;
  } else {
    uint64_t h = uint64_t(read_le32(b)) | uint64_t(b[4]) << 32;
    regen = size_t((h >> 4) & 0x3FFFF);
    csize = size_t((h >> 22) & 0x3FFFF);
  }
  if (regen > kMaxBlock) fail(off, "literals larger than a block");
  if (csize > n - hsz) fail(off, "truncated compressed literals");
  const uint8_t* p = b + hsz;
  size_t pn = csize;
  size_t poff = off + hsz;
  if (type == 2) {
    size_t t = read_huffman(p, pn, poff, f.huf);
    p += t;
    pn -= t;
    poff += t;
  } else if (!f.huf.valid) {
    fail(off, "treeless literals with no previous Huffman table");
  }
  if (streams == 1) {
    decode_huffman_stream(f.huf, p, pn, poff, f.literals, regen);
  } else {
    if (pn < 6) fail(poff, "truncated literals jump table");
    size_t s1 = size_t(p[0]) | size_t(p[1]) << 8;
    size_t s2 = size_t(p[2]) | size_t(p[3]) << 8;
    size_t s3 = size_t(p[4]) | size_t(p[5]) << 8;
    size_t rest = pn - 6;
    if (s1 + s2 + s3 > rest) fail(poff, "literals jump table past its end");
    size_t s4 = rest - s1 - s2 - s3;
    size_t seg = (regen + 3) / 4;
    if (3 * seg > regen) fail(poff, "too few literals for four streams");
    const uint8_t* q = p + 6;
    size_t qoff = poff + 6;
    size_t sizes[4] = {s1, s2, s3, s4};
    size_t counts[4] = {seg, seg, seg, regen - 3 * seg};
    size_t o = 0;
    for (int i = 0; i < 4; ++i) {
      decode_huffman_stream(f.huf, q, sizes[i], qoff, f.literals + o,
                            counts[i]);
      q += sizes[i];
      qoff += sizes[i];
      o += counts[i];
    }
  }
  *used = hsz + csize;
  return regen;
}

// one of the three sequence tables, by its compression mode
size_t read_seq_table(FseTable& t, bool& ok, int mode, const uint8_t* p,
                      size_t n, size_t off, const int16_t* def, int def_n,
                      int def_log, int max_symbol, int max_log) {
  switch (mode) {
    case 0:
      build_fse(t, def, def_n, def_log, off);
      ok = true;
      return 0;
    case 1:
      if (n < 1) fail(off, "truncated RLE sequence table");
      if (p[0] > max_symbol) fail(off, "RLE sequence symbol out of range");
      build_rle(t, p[0]);
      ok = true;
      return 1;
    case 2: {
      int16_t norm[64];
      int nsym, log;
      size_t used = read_ncount(p, n, off, norm, max_symbol, max_log, &nsym,
                                &log);
      build_fse(t, norm, nsym, log, off);
      ok = true;
      return used;
    }
    default:
      if (!ok) fail(off, "repeated sequence table with no previous table");
      return 0;
  }
}

void decode_compressed_block(Frame& f, const uint8_t* b, size_t n, size_t off,
                             Output& out) {
  size_t used;
  size_t nlit = decode_literals(f, b, n, off, &used);
  const uint8_t* p = b + used;
  size_t pn = n - used;
  size_t poff = off + used;
  size_t block_start = out.len;
  if (pn < 1) fail(poff, "truncated sequences section");
  size_t nseq = p[0];
  size_t h = 1;
  if (nseq >= 128) {
    if (nseq == 255) {
      if (pn < 3) fail(poff, "truncated sequences header");
      nseq = (size_t(p[1]) | size_t(p[2]) << 8) + 0x7F00;
      h = 3;
    } else {
      if (pn < 2) fail(poff, "truncated sequences header");
      nseq = ((nseq - 128) << 8) + p[1];
      h = 2;
    }
  }
  const uint8_t* lit = f.literals;
  size_t lit_left = nlit;
  if (nseq == 0) {
    if (h != pn) fail(poff, "bytes after an empty sequences section");
  } else {
    if (pn < h + 1) fail(poff, "truncated sequences header");
    uint8_t modes = p[h];
    if (modes & 3) fail(poff + h, "reserved bits set in sequence modes");
    size_t q = h + 1;
    q += read_seq_table(f.ll, f.ll_ok, modes >> 6, p + q, pn - q, poff + q,
                        kLLNorm, 36, 6, 35, 9);
    q += read_seq_table(f.of, f.of_ok, (modes >> 4) & 3, p + q, pn - q,
                        poff + q, kOFNorm, 29, 5, 31, 8);
    q += read_seq_table(f.ml, f.ml_ok, (modes >> 2) & 3, p + q, pn - q,
                        poff + q, kMLNorm, 53, 6, 52, 9);
    if (q >= pn) fail(poff + q, "sequences: no bit stream");
    BackwardBits bits(p + q, pn - q, poff + q);
    uint32_t sll = uint32_t(bits.read(f.ll.accuracy_log));
    uint32_t sof = uint32_t(bits.read(f.of.accuracy_log));
    uint32_t sml = uint32_t(bits.read(f.ml.accuracy_log));
    for (size_t i = 0; i < nseq; ++i) {
      const FseEntry& el = f.ll.e[sll];
      const FseEntry& eo = f.of.e[sof];
      const FseEntry& em = f.ml.e[sml];
      int ofc = eo.symbol, mlc = em.symbol, llc = el.symbol;
      if (ofc > 31) fail(poff + q, "offset code out of range");
      uint64_t ofv = (uint64_t(1) << ofc) + bits.read(ofc);
      uint64_t ml = kMLBase[mlc] + bits.read(kMLBits[mlc]);
      uint64_t ll = kLLBase[llc] + bits.read(kLLBits[llc]);
      uint64_t offset;
      if (ofv > 3) {
        offset = ofv - 3;
        f.rep[2] = f.rep[1];
        f.rep[1] = f.rep[0];
        f.rep[0] = uint32_t(offset);
      } else {
        int idx = int(ofv) - 1 + (ll == 0 ? 1 : 0);  // 0..3
        if (idx == 0) {
          offset = f.rep[0];
        } else {
          offset = idx == 3 ? uint64_t(f.rep[0]) - 1 : f.rep[idx];
          if (offset == 0) fail(poff + q, "repeat offset of zero");
          if (idx != 1) f.rep[2] = f.rep[1];
          f.rep[1] = f.rep[0];
          f.rep[0] = uint32_t(offset);
        }
      }
      if (ll > lit_left) fail(poff + q, "sequence uses more literals than decoded");
      out.need(ll);
      std::memcpy(out.dst + out.len, lit, ll);
      out.len += ll;
      lit += ll;
      lit_left -= ll;
      size_t produced = out.len - f.start;
      if (offset > produced || offset > f.window)
        fail(poff + q, "match offset before the start of the window");
      out.need(ml);
      uint8_t* d = out.dst + out.len;
      const uint8_t* s = d - offset;
      if (offset >= ml) {
        std::memcpy(d, s, ml);
      } else {
        for (uint64_t k = 0; k < ml; ++k) d[k] = s[k];
      }
      out.len += ml;
      if (i + 1 < nseq) {
        sll = el.base + uint32_t(bits.read(el.nb_bits));
        sml = em.base + uint32_t(bits.read(em.nb_bits));
        sof = eo.base + uint32_t(bits.read(eo.nb_bits));
      }
      if (bits.pos < 0) fail(poff + q, "sequences bit stream overrun");
    }
    if (bits.pos != 0) fail(poff + q, "sequences bit stream not consumed exactly");
  }
  out.need(lit_left);
  std::memcpy(out.dst + out.len, lit, lit_left);
  out.len += lit_left;
  if (out.len - block_start > kMaxBlock)
    fail(off, "block decodes to more than 128 KiB");
}

// Decode the frame at src[*pos..n) (its magic already checked).
void decode_frame(Frame& f, const uint8_t* src, size_t n, size_t* pos,
                  Output& out) {
  size_t at = *pos + 4;
  size_t frame_off = *pos;
  if (at >= n) fail(frame_off, "truncated frame header");
  uint8_t fhd = src[at++];
  int fcs_flag = fhd >> 6;
  bool single = (fhd >> 5) & 1;
  bool checksum = (fhd >> 2) & 1;
  int dict_flag = fhd & 3;
  if (fhd & 8) fail(at - 1, "reserved bit set in frame header");
  uint64_t window = 0;
  if (!single) {
    if (at >= n) fail(at, "truncated frame header");
    uint8_t wd = src[at++];
    int exponent = wd >> 3, mantissa = wd & 7;
    uint64_t base = uint64_t(1) << (10 + exponent);
    window = base + (base / 8) * mantissa;
  }
  static const int dict_sizes[4] = {0, 1, 2, 4};
  int dsz = dict_sizes[dict_flag];
  if (size_t(dsz) > n - at) fail(at, "truncated frame header");
  uint32_t dict_id = 0;
  for (int i = 0; i < dsz; ++i) dict_id |= uint32_t(src[at + i]) << (8 * i);
  if (dict_id != 0) fail(at, "frame needs a dictionary");
  at += size_t(dsz);
  int fcs_size = fcs_flag == 0 ? (single ? 1 : 0) : (1 << fcs_flag);
  if (size_t(fcs_size) > n - at) fail(at, "truncated frame header");
  bool has_fcs = fcs_size > 0;
  uint64_t fcs = 0;
  for (int i = 0; i < fcs_size; ++i) fcs |= uint64_t(src[at + i]) << (8 * i);
  if (fcs_size == 2) fcs += 256;
  at += size_t(fcs_size);
  if (single) window = fcs;

  f.huf.valid = false;
  f.ll_ok = f.ml_ok = f.of_ok = false;
  f.rep[0] = 1;
  f.rep[1] = 4;
  f.rep[2] = 8;
  f.window = window;
  f.start = out.len;
  for (;;) {
    if (n - at < 3) fail(at, "truncated block header");
    uint32_t bh = uint32_t(src[at]) | uint32_t(src[at + 1]) << 8 |
                  uint32_t(src[at + 2]) << 16;
    size_t boff = at;
    at += 3;
    bool last = bh & 1;
    int type = (bh >> 1) & 3;
    size_t bsize = bh >> 3;
    if (bsize > kMaxBlock) fail(boff, "block larger than 128 KiB");
    if (type == 0) {
      if (bsize > n - at) fail(boff, "truncated raw block");
      out.need(bsize);
      std::memcpy(out.dst + out.len, src + at, bsize);
      out.len += bsize;
      at += bsize;
    } else if (type == 1) {
      if (n - at < 1) fail(boff, "truncated RLE block");
      out.need(bsize);
      std::memset(out.dst + out.len, src[at], bsize);
      out.len += bsize;
      at += 1;
    } else if (type == 2) {
      if (bsize > n - at) fail(boff, "truncated compressed block");
      decode_compressed_block(f, src + at, bsize, at, out);
      at += bsize;
    } else {
      fail(boff, "reserved block type");
    }
    if (has_fcs && out.len - f.start > fcs)
      fail(boff, "frame decodes to more than its content size");
    if (last) break;
  }
  if (has_fcs && out.len - f.start != fcs)
    fail(at, "frame content size does not match the decoded size");
  if (checksum) {
    if (n - at < 4) fail(at, "truncated frame checksum");
    uint32_t want = read_le32(src + at);
    uint32_t got = uint32_t(xxh64(out.dst + f.start, out.len - f.start, 0));
    if (want != got) fail(at, "frame checksum mismatch");
    at += 4;
  }
  *pos = at;
}

constexpr uint32_t kMagic = 0xFD2FB528u;

bool is_skippable(uint32_t magic) { return (magic & 0xFFFFFFF0u) == 0x184D2A50u; }

}  // namespace

extern "C" {

int64_t m2m_zstd_content_size(const uint8_t* src, size_t n) {
  size_t at = 0;
  uint64_t total = 0;
  if (n == 0) return -1;
  while (at < n) {
    if (n - at < 4) return -1;
    uint32_t magic = read_le32(src + at);
    if (is_skippable(magic)) {
      if (n - at < 8) return -1;
      uint64_t sz = read_le32(src + at + 4);
      if (sz > n - at - 8) return -1;
      at += 8 + size_t(sz);
      continue;
    }
    if (magic != kMagic || n - at < 5) return -1;
    at += 4;
    uint8_t fhd = src[at++];
    int fcs_flag = fhd >> 6;
    bool single = (fhd >> 5) & 1;
    static const int dict_sizes[4] = {0, 1, 2, 4};
    size_t skip = (single ? 0 : 1) + size_t(dict_sizes[fhd & 3]);
    int fcs_size = fcs_flag == 0 ? (single ? 1 : 0) : (1 << fcs_flag);
    if (fcs_size == 0 || skip + size_t(fcs_size) > n - at) return -1;
    at += skip;
    uint64_t fcs = 0;
    for (int i = 0; i < fcs_size; ++i) fcs |= uint64_t(src[at + i]) << (8 * i);
    if (fcs_size == 2) fcs += 256;
    at += size_t(fcs_size);
    total += fcs;
    if (total > (uint64_t(1) << 62)) return -1;
    for (;;) {  // skip the blocks
      if (n - at < 3) return -1;
      uint32_t bh = uint32_t(src[at]) | uint32_t(src[at + 1]) << 8 |
                    uint32_t(src[at + 2]) << 16;
      at += 3;
      size_t len = ((bh >> 1) & 3) == 1 ? 1 : size_t(bh >> 3);
      if (len > n - at) return -1;
      at += len;
      if (bh & 1) break;
    }
    if ((fhd >> 2) & 1) {
      if (n - at < 4) return -1;
      at += 4;
    }
  }
  return int64_t(total);
}

int m2m_zstd_decompress(const uint8_t* src, size_t n, uint8_t* dst, size_t cap,
                        size_t* out_len, char* err, size_t err_cap,
                        size_t* err_off) {
  Output out{dst, cap};
  Frame* f = nullptr;
  try {
    f = new Frame();
    size_t at = 0;
    if (n == 0) fail(0, "no frame");
    while (at < n) {
      if (n - at < 4) fail(at, "truncated frame magic");
      uint32_t magic = read_le32(src + at);
      if (is_skippable(magic)) {
        if (n - at < 8) fail(at, "truncated skippable frame");
        uint64_t sz = read_le32(src + at + 4);
        if (sz > n - at - 8) fail(at, "truncated skippable frame");
        at += 8 + size_t(sz);
      } else if (magic == kMagic) {
        decode_frame(*f, src, n, &at, out);
      } else {
        fail(at, "not a zstd frame: bad magic");
      }
    }
    delete f;
    *out_len = out.len;
    return 0;
  } catch (const DecodeError& e) {
    delete f;
    std::snprintf(err, err_cap, "%s", e.msg.c_str());
    *err_off = e.off;
    *out_len = out.len;
    return 1;
  } catch (const OutputFull&) {
    delete f;
    *out_len = out.len;
    return 2;
  } catch (...) {
    delete f;
    std::snprintf(err, err_cap, "%s", "internal error");
    *err_off = 0;
    *out_len = out.len;
    return 1;
  }
}

uint32_t m2m_crc32c(const uint8_t* src, size_t n) { return crc32c(src, n); }

uint64_t m2m_xxh64(const uint8_t* src, size_t n, uint64_t seed) {
  return xxh64(src, n, seed);
}

}  // extern "C"

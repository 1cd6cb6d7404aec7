// Native core for bcfl_tpu_torch.data.tokenizer.HashTokenizer.encode_batch
// (a copy of the JAX package's tokenizer.cc; the two stay identical in
// behaviour).
//
// The reference's data loader re-tokenizes the full dataset hundreds of
// times per run (SURVEY.md §3.2); this rebuild tokenizes ONCE into a static
// [N, seq_len] cache — and this file is that cache-build's hot loop in C++.
// Bit-for-bit parity with the Python path (tests/test_torch_native.py):
//
//   words = re.findall(r"[a-z0-9']+|[^\sa-z0-9']", text.lower())
//   ids   = ([CLS] + [crc32(w)%(V-4)+4 for w in words[:seq_len-2]] + [SEP])[:seq_len]
//
// The caller lowercases in Python (full Unicode case rules stay there); this
// core consumes the lowered UTF-8 bytes and needs only: UTF-8 codepoint
// iteration, Python's \s whitespace set, the ASCII word classes, and
// zlib-compatible CRC-32. No libc beyond <cstdint>/<cstring>.

#include <cstdint>
#include <cstring>

namespace {

constexpr int PAD_ID = 0;
constexpr int CLS_ID = 2;
constexpr int SEP_ID = 3;
constexpr int N_SPECIAL = 4;

// CRC-32/ISO-HDLC (zlib.crc32): reflected, poly 0xEDB88320, init/xorout ~0.
// Table is built at load time (static initializer): ctypes releases the GIL
// during the call, so a lazy runtime init would be a data race between
// concurrently-tokenizing threads.
struct CrcTable {
  uint32_t t[256];
  CrcTable() {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k)
        c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
      t[i] = c;
    }
  }
};
const CrcTable crc;

inline uint32_t crc32_bytes(const uint8_t* p, size_t n) {
  uint32_t c = 0xFFFFFFFFu;
  for (size_t i = 0; i < n; ++i) c = crc.t[(c ^ p[i]) & 0xFF] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

// Python re \s for str patterns == str.isspace() set
inline bool is_space_cp(uint32_t cp) {
  switch (cp) {
    case 0x09: case 0x0A: case 0x0B: case 0x0C: case 0x0D:
    case 0x1C: case 0x1D: case 0x1E: case 0x1F:
    case 0x20: case 0x85: case 0xA0: case 0x1680:
    case 0x2028: case 0x2029: case 0x202F: case 0x205F: case 0x3000:
      return true;
    default:
      return cp >= 0x2000 && cp <= 0x200A;
  }
}

inline bool is_word_byte(uint8_t b) {
  return (b >= 'a' && b <= 'z') || (b >= '0' && b <= '9') || b == '\'';
}

// decode one UTF-8 codepoint at p (valid input: produced by Python .encode)
inline uint32_t decode_cp(const uint8_t* p, int* len) {
  uint8_t b = p[0];
  if (b < 0x80) { *len = 1; return b; }
  if (b < 0xE0) { *len = 2; return ((b & 0x1Fu) << 6) | (p[1] & 0x3Fu); }
  if (b < 0xF0) {
    *len = 3;
    return ((b & 0x0Fu) << 12) | ((p[1] & 0x3Fu) << 6) | (p[2] & 0x3Fu);
  }
  *len = 4;
  return ((b & 0x07u) << 18) | ((p[1] & 0x3Fu) << 12) |
         ((p[2] & 0x3Fu) << 6) | (p[3] & 0x3Fu);
}

}  // namespace

extern "C" {

// texts: concatenated lowered UTF-8; offsets[n+1] delimit each text.
// ids/mask: int32 [n, seq_len], caller-allocated.
void bcfl_hash_tokenize(const uint8_t* texts, const int64_t* offsets,
                        int64_t n, int64_t seq_len, int64_t vocab_size,
                        int32_t* ids, int32_t* mask) {
  const uint32_t mod = static_cast<uint32_t>(vocab_size - N_SPECIAL);
  const int64_t cap = seq_len - 2 > 0 ? seq_len - 2 : 0;  // words kept
  for (int64_t t = 0; t < n; ++t) {
    int32_t* row = ids + t * seq_len;
    int32_t* mrow = mask + t * seq_len;
    const uint8_t* p = texts + offsets[t];
    const uint8_t* end = texts + offsets[t + 1];
    int64_t nw = 0;  // words emitted
    int64_t k = 0;   // ids emitted
    if (seq_len > 0) row[k++] = CLS_ID;
    while (p < end && nw < cap) {
      uint8_t b = *p;
      if (is_word_byte(b)) {  // ASCII word run [a-z0-9']+
        const uint8_t* s = p;
        do { ++p; } while (p < end && is_word_byte(*p));
        row[k++] = static_cast<int32_t>(
            crc32_bytes(s, static_cast<size_t>(p - s)) % mod + N_SPECIAL);
        ++nw;
      } else {
        int len = 1;
        uint32_t cp = b < 0x80 ? b : decode_cp(p, &len);
        if (!is_space_cp(cp)) {  // single-codepoint token [^\sa-z0-9']
          row[k++] = static_cast<int32_t>(
              crc32_bytes(p, static_cast<size_t>(len)) % mod + N_SPECIAL);
          ++nw;
        }
        p += len;
      }
    }
    if (k < seq_len) row[k++] = SEP_ID;
    // Python builds [CLS]+words+[SEP] then truncates to seq_len: SEP only
    // survives when it fits, which the k < seq_len guard reproduces (and
    // seq_len==1 keeps only CLS, seq_len==2 -> CLS,SEP — cap==0 paths)
    for (int64_t i = 0; i < k; ++i) mrow[i] = 1;
    for (int64_t i = k; i < seq_len; ++i) { row[i] = PAD_ID; mrow[i] = 0; }
  }
}

}  // extern "C"

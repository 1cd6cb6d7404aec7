// SHA-256 (FIPS 180-4) + hash-chain primitives for the BC-FL weight ledger.
//
// The reference describes its blockchain layer only in prose (README.md:10;
// MT notebook cells 26-28 model a 0.043 GB ledger payload) — there is no
// blockchain code to port (SURVEY.md §2.2 C18). This is the native core of
// the real implementation: digesting per-client parameter buffers and
// extending the chain head runs in C++ on the host, off the Python
// hot path. Exposed as a plain C ABI for ctypes.
//
// Built by bcfl_tpu_torch/native/build.py (g++ -O3 -shared -fPIC).

#include <cstdint>
#include <cstring>
#include <cstddef>

namespace {

constexpr uint32_t K[64] = {
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
    0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
    0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
    0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
    0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
    0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2};

inline uint32_t rotr(uint32_t x, unsigned n) { return (x >> n) | (x << (32 - n)); }

struct Sha256Ctx {
  uint32_t h[8];
  uint64_t len;      // total bytes seen
  uint8_t buf[64];   // pending block
  size_t buflen;
};

void sha256_init(Sha256Ctx* c) {
  static const uint32_t H0[8] = {0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
                                 0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19};
  std::memcpy(c->h, H0, sizeof(H0));
  c->len = 0;
  c->buflen = 0;
}

void sha256_block(Sha256Ctx* c, const uint8_t* p) {
  uint32_t w[64];
  for (int i = 0; i < 16; ++i)
    w[i] = (uint32_t(p[4 * i]) << 24) | (uint32_t(p[4 * i + 1]) << 16) |
           (uint32_t(p[4 * i + 2]) << 8) | uint32_t(p[4 * i + 3]);
  for (int i = 16; i < 64; ++i) {
    uint32_t s0 = rotr(w[i - 15], 7) ^ rotr(w[i - 15], 18) ^ (w[i - 15] >> 3);
    uint32_t s1 = rotr(w[i - 2], 17) ^ rotr(w[i - 2], 19) ^ (w[i - 2] >> 10);
    w[i] = w[i - 16] + s0 + w[i - 7] + s1;
  }
  uint32_t a = c->h[0], b = c->h[1], cc = c->h[2], d = c->h[3];
  uint32_t e = c->h[4], f = c->h[5], g = c->h[6], h = c->h[7];
  for (int i = 0; i < 64; ++i) {
    uint32_t S1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
    uint32_t ch = (e & f) ^ (~e & g);
    uint32_t t1 = h + S1 + ch + K[i] + w[i];
    uint32_t S0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
    uint32_t maj = (a & b) ^ (a & cc) ^ (b & cc);
    uint32_t t2 = S0 + maj;
    h = g; g = f; f = e; e = d + t1;
    d = cc; cc = b; b = a; a = t1 + t2;
  }
  c->h[0] += a; c->h[1] += b; c->h[2] += cc; c->h[3] += d;
  c->h[4] += e; c->h[5] += f; c->h[6] += g; c->h[7] += h;
}

void sha256_update(Sha256Ctx* c, const uint8_t* data, size_t len) {
  c->len += len;
  if (c->buflen) {
    size_t need = 64 - c->buflen;
    size_t take = len < need ? len : need;
    std::memcpy(c->buf + c->buflen, data, take);
    c->buflen += take;
    data += take;
    len -= take;
    if (c->buflen == 64) {
      sha256_block(c, c->buf);
      c->buflen = 0;
    }
  }
  while (len >= 64) {
    sha256_block(c, data);
    data += 64;
    len -= 64;
  }
  if (len) {
    std::memcpy(c->buf, data, len);
    c->buflen = len;
  }
}

void sha256_final(Sha256Ctx* c, uint8_t out[32]) {
  uint64_t bitlen = c->len * 8;
  uint8_t pad = 0x80;
  sha256_update(c, &pad, 1);
  uint8_t zero = 0;
  while (c->buflen != 56) sha256_update(c, &zero, 1);
  uint8_t lenb[8];
  for (int i = 0; i < 8; ++i) lenb[i] = uint8_t(bitlen >> (56 - 8 * i));
  sha256_update(c, lenb, 8);
  for (int i = 0; i < 8; ++i) {
    out[4 * i] = uint8_t(c->h[i] >> 24);
    out[4 * i + 1] = uint8_t(c->h[i] >> 16);
    out[4 * i + 2] = uint8_t(c->h[i] >> 8);
    out[4 * i + 3] = uint8_t(c->h[i]);
  }
}

}  // namespace

extern "C" {

// One-shot digest.
void bcfl_sha256(const uint8_t* data, uint64_t len, uint8_t out[32]) {
  Sha256Ctx c;
  sha256_init(&c);
  sha256_update(&c, data, size_t(len));
  sha256_final(&c, out);
}

// Digest of a list of buffers (a parameter tree's leaves, in canonical
// order) without concatenating on the Python side.
void bcfl_sha256_multi(const uint8_t* const* bufs, const uint64_t* lens,
                       uint64_t n, uint8_t out[32]) {
  Sha256Ctx c;
  sha256_init(&c);
  for (uint64_t i = 0; i < n; ++i)
    sha256_update(&c, bufs[i], size_t(lens[i]));
  sha256_final(&c, out);
}

// Chain extension: H(prev_hash[32] || payload). The ledger's entry hash.
void bcfl_chain_extend(const uint8_t prev[32], const uint8_t* payload,
                       uint64_t len, uint8_t out[32]) {
  Sha256Ctx c;
  sha256_init(&c);
  sha256_update(&c, prev, 32);
  sha256_update(&c, payload, size_t(len));
  sha256_final(&c, out);
}

// Verify a stored chain: heads[i] == H(heads[i-1] || payloads[i]) for all i
// (heads[-1] = genesis zeros). Returns the index of the first bad link or -1.
int64_t bcfl_chain_verify(const uint8_t* const* payloads, const uint64_t* lens,
                          const uint8_t* heads /* n x 32 */, uint64_t n) {
  uint8_t prev[32];
  std::memset(prev, 0, 32);
  uint8_t h[32];
  for (uint64_t i = 0; i < n; ++i) {
    bcfl_chain_extend(prev, payloads[i], lens[i], h);
    if (std::memcmp(h, heads + 32 * i, 32) != 0) return int64_t(i);
    std::memcpy(prev, h, 32);
  }
  return -1;
}

}  // extern "C"

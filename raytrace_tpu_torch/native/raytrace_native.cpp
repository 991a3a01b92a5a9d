// Native host-side runtime for raytrace_tpu.
//
// The reference's host runtime is Rust (LZ4 chunk cache at
// src/world/chunk_storage.rs:42-68 via the lz4 crate; clipped 3D block
// copies at src/util.rs:381-663 feeding the streaming staging buffers).
// This file provides the same data-plane services as a small C++ library
// loaded through ctypes: an LZ4 *block format* codec (public format,
// implemented from the format description) and strided clipped 3D copies.
//
// Build: see native/Makefile (g++ -O3 -shared -fPIC).

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

inline uint32_t read32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}

constexpr int kHashLog = 16;

inline uint32_t hash_seq(uint32_t seq) {
  return (seq * 2654435761u) >> (32 - kHashLog);
}

}  // namespace

extern "C" {

// Worst-case compressed size for n input bytes (LZ4 bound).
int rt_lz4_compress_bound(int n) { return n + n / 255 + 16; }

// Compress src[0..n) into dst (capacity cap) using the LZ4 block format.
// Greedy single-pass matcher with a 64K-entry hash table. Returns the
// compressed size, or -1 if dst is too small.
int rt_lz4_compress(const uint8_t* src, int n, uint8_t* dst, int cap) {
  if (n < 0 || cap < rt_lz4_compress_bound(n)) return -1;
  std::vector<int32_t> table(1 << kHashLog, -1);

  int ip = 0, anchor = 0, op = 0;
  // Per the block format: the last match must start >= 12 bytes before the
  // end, and the last 5 bytes are always literals.
  const int match_limit = n - 12;

  auto emit_sequence = [&](int lit_len, int match_len, int offset) {
    int token_pos = op++;
    int lit = lit_len;
    if (lit >= 15) {
      dst[token_pos] = 0xF0;
      lit -= 15;
      while (lit >= 255) {
        dst[op++] = 255;
        lit -= 255;
      }
      dst[op++] = static_cast<uint8_t>(lit);
    } else {
      dst[token_pos] = static_cast<uint8_t>(lit << 4);
    }
    std::memcpy(dst + op, src + anchor, lit_len);
    op += lit_len;
    if (match_len < 0) return;  // final literal run, no match part
    dst[op++] = static_cast<uint8_t>(offset & 0xFF);
    dst[op++] = static_cast<uint8_t>(offset >> 8);
    int ml = match_len - 4;
    if (ml >= 15) {
      dst[token_pos] |= 0x0F;
      ml -= 15;
      while (ml >= 255) {
        dst[op++] = 255;
        ml -= 255;
      }
      dst[op++] = static_cast<uint8_t>(ml);
    } else {
      dst[token_pos] |= static_cast<uint8_t>(ml);
    }
  };

  while (ip < match_limit) {
    uint32_t seq = read32(src + ip);
    uint32_t h = hash_seq(seq);
    int ref = table[h];
    table[h] = ip;
    if (ref >= 0 && ip - ref <= 65535 && read32(src + ref) == seq) {
      int mlen = 4;
      // Matches must leave 5 literal bytes at the end of the block.
      int max_len = n - 5 - ip;
      while (mlen < max_len && src[ref + mlen] == src[ip + mlen]) mlen++;
      emit_sequence(ip - anchor, mlen, ip - ref);
      ip += mlen;
      anchor = ip;
    } else {
      ip++;
    }
  }
  emit_sequence(n - anchor, -1, 0);
  return op;
}

// Decompress an LZ4 block into dst (expected decompressed size = cap).
// Returns the decompressed size, or -1 on malformed input / overflow.
int rt_lz4_decompress(const uint8_t* src, int n, uint8_t* dst, int cap) {
  int ip = 0, op = 0;
  while (ip < n) {
    uint8_t token = src[ip++];
    int lit = token >> 4;
    if (lit == 15) {
      uint8_t b;
      do {
        if (ip >= n) return -1;
        b = src[ip++];
        lit += b;
      } while (b == 255);
    }
    if (ip + lit > n || op + lit > cap) return -1;
    std::memcpy(dst + op, src + ip, lit);
    ip += lit;
    op += lit;
    if (ip >= n) break;  // last sequence has no match part
    if (ip + 2 > n) return -1;
    int offset = src[ip] | (src[ip + 1] << 8);
    ip += 2;
    if (offset == 0 || offset > op) return -1;
    int mlen = (token & 15) + 4;
    if ((token & 15) == 15) {
      uint8_t b;
      do {
        if (ip >= n) return -1;
        b = src[ip++];
        mlen += b;
      } while (b == 255);
    }
    if (op + mlen > cap) return -1;
    // Byte-wise copy: matches may overlap their own output.
    int ref = op - offset;
    for (int i = 0; i < mlen; i++) dst[op + i] = dst[ref + i];
    op += mlen;
  }
  return op;
}

// Clipped strided 3D block copy between C-order (Z, Y, X) arrays.
// All coordinate triples are in (x, y, z) order like the python callers.
// elem: element size in bytes. Copies size[] elements starting at
// src_start in src (dims src_dim) to dst_start in dst (dims dst_dim),
// clipping the transfer to both arrays (reference src/util.rs:440-604).
void rt_copy3d(const uint8_t* src, uint8_t* dst, int elem,
               const int64_t* src_dim, const int64_t* dst_dim,
               const int64_t* size, const int64_t* src_start,
               const int64_t* dst_start) {
  int64_t s0[3], d0[3], nn[3];
  for (int a = 0; a < 3; a++) {
    int64_t lo = 0;
    if (-src_start[a] > lo) lo = -src_start[a];
    if (-dst_start[a] > lo) lo = -dst_start[a];
    int64_t hi = size[a];
    if (src_dim[a] - src_start[a] < hi) hi = src_dim[a] - src_start[a];
    if (dst_dim[a] - dst_start[a] < hi) hi = dst_dim[a] - dst_start[a];
    if (hi <= lo) return;
    s0[a] = src_start[a] + lo;
    d0[a] = dst_start[a] + lo;
    nn[a] = hi - lo;
  }
  const int64_t src_row = src_dim[0] * elem;
  const int64_t src_plane = src_row * src_dim[1];
  const int64_t dst_row = dst_dim[0] * elem;
  const int64_t dst_plane = dst_row * dst_dim[1];
  const int64_t run = nn[0] * elem;
  for (int64_t z = 0; z < nn[2]; z++) {
    const uint8_t* sp = src + (s0[2] + z) * src_plane + s0[1] * src_row + s0[0] * elem;
    uint8_t* dp = dst + (d0[2] + z) * dst_plane + d0[1] * dst_row + d0[0] * elem;
    for (int64_t y = 0; y < nn[1]; y++) {
      std::memcpy(dp, sp, run);
      sp += src_row;
      dp += dst_row;
    }
  }
}

}  // extern "C"

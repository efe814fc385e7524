// Native ingest data-loader: WAV decode + file SHA-1 + threaded batch fill.
//
// Equivalent of the reference's native decode path (pydub ->
// ffmpeg C code at reference __init__.py:86 and the SHA-1 file hashing of
// unique_hash at __init__.py:305-323): the host-side loader that keeps the
// device fed during ingest. Decoding and hashing release the GIL entirely
// (plain C ABI via ctypes) and fan out over a std::thread pool, so corpus
// decode overlaps with device fingerprinting.
//
// Scope: 8/16/24/32-bit PCM and float32 RIFF/WAVE (the formats the Python
// fallback in audio/io.py supports); everything else returns an error and
// the caller falls back to Python.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -o libsia_loader.so dataloader.cpp -lpthread

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------- SHA-1 --
struct Sha1 {
  uint32_t h[5] = {0x67452301u, 0xEFCDAB89u, 0x98BADCFEu, 0x10325476u,
                   0xC3D2E1F0u};
  uint64_t total = 0;
  uint8_t buf[64];
  size_t fill = 0;

  static uint32_t rotl(uint32_t x, int n) { return (x << n) | (x >> (32 - n)); }

  void block(const uint8_t* p) {
    uint32_t w[80];
    for (int i = 0; i < 16; ++i)
      w[i] = (uint32_t(p[4 * i]) << 24) | (uint32_t(p[4 * i + 1]) << 16) |
             (uint32_t(p[4 * i + 2]) << 8) | uint32_t(p[4 * i + 3]);
    for (int i = 16; i < 80; ++i)
      w[i] = rotl(w[i - 3] ^ w[i - 8] ^ w[i - 14] ^ w[i - 16], 1);
    uint32_t a = h[0], b = h[1], c = h[2], d = h[3], e = h[4];
    for (int i = 0; i < 80; ++i) {
      uint32_t f, k;
      if (i < 20) { f = (b & c) | (~b & d); k = 0x5A827999u; }
      else if (i < 40) { f = b ^ c ^ d; k = 0x6ED9EBA1u; }
      else if (i < 60) { f = (b & c) | (b & d) | (c & d); k = 0x8F1BBCDCu; }
      else { f = b ^ c ^ d; k = 0xCA62C1D6u; }
      uint32_t t = rotl(a, 5) + f + e + k + w[i];
      e = d; d = c; c = rotl(b, 30); b = a; a = t;
    }
    h[0] += a; h[1] += b; h[2] += c; h[3] += d; h[4] += e;
  }

  void update(const uint8_t* p, size_t n) {
    total += n;
    while (n) {
      size_t take = 64 - fill < n ? 64 - fill : n;
      memcpy(buf + fill, p, take);
      fill += take; p += take; n -= take;
      if (fill == 64) { block(buf); fill = 0; }
    }
  }

  void hex(char out[41]) {
    uint64_t bits = total * 8;
    uint8_t pad = 0x80;
    update(&pad, 1);
    uint8_t z = 0;
    while (fill != 56) update(&z, 1);
    uint8_t len[8];
    for (int i = 0; i < 8; ++i) len[i] = uint8_t(bits >> (56 - 8 * i));
    update(len, 8);
    static const char* d = "0123456789ABCDEF";
    for (int i = 0; i < 5; ++i)
      for (int j = 0; j < 4; ++j) {
        uint8_t byte = uint8_t(h[i] >> (24 - 8 * j));
        out[8 * i + 2 * j] = d[byte >> 4];
        out[8 * i + 2 * j + 1] = d[byte & 0xF];
      }
    out[40] = 0;
  }
};

// ------------------------------------------------------------- WAV parse --
struct WavInfo {
  int channels = 0;
  int rate = 0;
  int bits = 0;
  int fmt = 0;  // 1 = PCM, 3 = IEEE float
  const uint8_t* data = nullptr;
  uint64_t data_len = 0;
};

uint32_t rd32(const uint8_t* p) {
  return uint32_t(p[0]) | (uint32_t(p[1]) << 8) | (uint32_t(p[2]) << 16) |
         (uint32_t(p[3]) << 24);
}
uint16_t rd16(const uint8_t* p) { return uint16_t(p[0]) | (uint16_t(p[1]) << 8); }

bool parse_wav(const uint8_t* p, size_t n, WavInfo* out) {
  if (n < 44 || memcmp(p, "RIFF", 4) || memcmp(p + 8, "WAVE", 4)) return false;
  size_t off = 12;
  while (off + 8 <= n) {
    uint32_t sz = rd32(p + off + 4);
    if (!memcmp(p + off, "fmt ", 4) && off + 8 + 16 <= n) {
      out->fmt = rd16(p + off + 8);
      out->channels = rd16(p + off + 10);
      out->rate = int(rd32(p + off + 12));
      out->bits = rd16(p + off + 22);
      // extension bytes must ALSO fit in the file, not just in the
      // chunk-declared sz (a truncated file with sz=40 would over-read)
      if (out->fmt == 0xFFFE && sz >= 40 && off + 8 + 26 <= n)
        out->fmt = rd16(p + off + 8 + 24);
    } else if (!memcmp(p + off, "data", 4)) {
      out->data = p + off + 8;
      out->data_len = sz < n - off - 8 ? sz : n - off - 8;
      // bits must be a byte-aligned sane depth: callers divide by
      // (bits/8)*channels, so bits=0 would SIGFPE the whole process
      return out->channels > 0 && out->rate > 0 &&
             (out->bits == 8 || out->bits == 16 || out->bits == 24 ||
              out->bits == 32 || out->bits == 64);
    }
    off += 8 + sz + (sz & 1);
  }
  return false;
}

bool read_file(const char* path, std::vector<uint8_t>* out) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  fseek(f, 0, SEEK_END);
  long n = ftell(f);
  fseek(f, 0, SEEK_SET);
  out->resize(size_t(n));
  bool ok = n >= 0 && fread(out->data(), 1, size_t(n), f) == size_t(n);
  fclose(f);
  return ok;
}

// decode one channel into float32 (raw int16-scale values, matching the
// Python reader in audio/io.py)
long decode_channel(const WavInfo& w, int channel, float* out, long cap) {
  int ch = w.channels;
  if (channel >= ch) return -2;
  long frames;
  const uint8_t* p = w.data;
  switch (w.bits) {
    case 16: {
      frames = long(w.data_len / (2 * ch));
      if (frames > cap) frames = cap;
      for (long i = 0; i < frames; ++i)
        out[i] = float(int16_t(rd16(p + 2 * (i * ch + channel))));
      return frames;
    }
    case 8: {
      frames = long(w.data_len / ch);
      if (frames > cap) frames = cap;
      for (long i = 0; i < frames; ++i)
        out[i] = float(int16_t((int(p[i * ch + channel]) - 128) << 8));
      return frames;
    }
    case 24: {
      frames = long(w.data_len / (3 * ch));
      if (frames > cap) frames = cap;
      for (long i = 0; i < frames; ++i) {
        const uint8_t* q = p + 3 * (i * ch + channel);
        int32_t v = int32_t(uint32_t(q[0]) | (uint32_t(q[1]) << 8) |
                            (uint32_t(q[2]) << 16));
        v = (v << 8) >> 16;  // sign extend, keep top 16 bits
        out[i] = float(int16_t(v));
      }
      return frames;
    }
    case 32: {
      frames = long(w.data_len / (4 * ch));
      if (frames > cap) frames = cap;
      if (w.fmt == 3) {
        for (long i = 0; i < frames; ++i) {
          float v;
          memcpy(&v, p + 4 * (i * ch + channel), 4);
          v *= 32768.0f;
          if (v > 32767.f) v = 32767.f;
          if (v < -32768.f) v = -32768.f;
          out[i] = float(int16_t(v));
        }
      } else {
        for (long i = 0; i < frames; ++i) {
          int32_t v = int32_t(rd32(p + 4 * (i * ch + channel)));
          out[i] = float(int16_t(v >> 16));
        }
      }
      return frames;
    }
    default:
      return -3;
  }
}

}  // namespace

extern "C" {

// SHA-1 of a file's bytes; writes 40 uppercase hex chars + NUL.
int sia_sha1_file(const char* path, char* hex_out) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  Sha1 s;
  uint8_t buf[1 << 16];
  size_t n;
  while ((n = fread(buf, 1, sizeof buf, f)) > 0) s.update(buf, n);
  fclose(f);
  s.hex(hex_out);
  return 0;
}

// Probe a WAV: returns 0 and fills channels/rate/frames, or <0 on error.
int sia_wav_info(const char* path, int* channels, int* rate, long* frames) {
  std::vector<uint8_t> bytes;
  if (!read_file(path, &bytes)) return -1;
  WavInfo w;
  if (!parse_wav(bytes.data(), bytes.size(), &w)) return -2;
  *channels = w.channels;
  *rate = w.rate;
  *frames = long(w.data_len / ((w.bits / 8) * w.channels));
  return 0;
}

// Decode one channel as float32 int16-scale samples; returns frame count.
long sia_decode_channel(const char* path, int channel, float* out, long cap) {
  std::vector<uint8_t> bytes;
  if (!read_file(path, &bytes)) return -1;
  WavInfo w;
  if (!parse_wav(bytes.data(), bytes.size(), &w)) return -2;
  return decode_channel(w, channel, out, cap);
}

// Threaded batch fill: decode channel 0 of n files into an (n, cap) f32
// matrix (zero padded), plus per-file valid lengths and SHA-1 hex digests
// (41 bytes per file). Returns 0, or the number of failed files.
int sia_load_batch(const char** paths, int n, float* out, long cap,
                   long* n_valid, char* sha_hex, int n_threads) {
  if (n_threads < 1) n_threads = 1;
  std::vector<int> failed(size_t(n), 0);
  std::vector<std::thread> pool;
  for (int t = 0; t < n_threads; ++t) {
    pool.emplace_back([&, t]() {
      for (int i = t; i < n; i += n_threads) {
        memset(out + long(i) * cap, 0, size_t(cap) * 4);
        n_valid[i] = 0;
        // ONE disk read per file: hash and decode the same buffer
        // (hashing via sia_sha1_file re-read the file from disk,
        // doubling ingest I/O in the loop this module exists to speed)
        std::vector<uint8_t> bytes;
        if (!read_file(paths[i], &bytes)) {
          failed[size_t(i)] = 1;
          sha_hex[41 * i] = 0;
          continue;
        }
        Sha1 s;
        s.update(bytes.data(), bytes.size());
        s.hex(sha_hex + 41 * i);
        WavInfo w;
        long got = -2;
        if (parse_wav(bytes.data(), bytes.size(), &w))
          got = decode_channel(w, 0, out + long(i) * cap, cap);
        n_valid[i] = got > 0 ? got : 0;
        if (got < 0) failed[size_t(i)] = 1;
      }
    });
  }
  for (auto& th : pool) th.join();
  int bad = 0;
  for (int v : failed) bad += v;
  return bad;
}

}  // extern "C"

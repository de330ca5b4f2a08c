// Native WAV reader/writer of the PyTorch port of mlx-audio-primitives-tpu:
// its own copy of the JAX package's csrc/wavio.cpp, built with tables.cpp
// into one library by the port's `_native.py`.
//
// A small RIFF/WAVE codec (PCM 16/24/32 + IEEE float32) behind the same C
// ABI / ctypes / NumPy-fallback contract as tables.cpp. The pure-NumPy twin
// in `utils/audio_io.py` is the oracle; tests assert the two paths
// bit-identical.
//
// All functions return 0 on success, negative on error:
//   -1 io error        -2 not RIFF/WAVE     -3 missing/short chunk
//   -4 unsupported fmt -5 bad arguments

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {

constexpr uint16_t kPcm = 1;
constexpr uint16_t kIeeeFloat = 3;
constexpr uint16_t kExtensible = 0xFFFE;

struct WavLayout {
  uint16_t fmt = 0;
  uint16_t channels = 0;
  uint32_t sr = 0;
  uint16_t bits = 0;
  size_t data_off = 0;
  size_t data_size = 0;
};

bool read_file(const char* path, std::vector<uint8_t>& buf) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  if (size < 0) {
    std::fclose(f);
    return false;
  }
  std::fseek(f, 0, SEEK_SET);
  buf.resize(static_cast<size_t>(size));
  size_t got = size ? std::fread(buf.data(), 1, buf.size(), f) : 0;
  std::fclose(f);
  return got == buf.size();
}

uint32_t rd_u32(const uint8_t* p) {
  return static_cast<uint32_t>(p[0]) | (static_cast<uint32_t>(p[1]) << 8) |
         (static_cast<uint32_t>(p[2]) << 16) |
         (static_cast<uint32_t>(p[3]) << 24);
}

uint16_t rd_u16(const uint8_t* p) {
  return static_cast<uint16_t>(p[0] | (p[1] << 8));
}

// Header-only chunk scan: reads each 8-byte chunk header + the fmt body,
// fseeks over everything else — info on a multi-GB file never loads it.
int scan_header(const char* path, WavLayout* out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  std::fseek(f, 0, SEEK_END);
  long fsize = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  uint8_t hdr[12];
  if (fsize < 12 || std::fread(hdr, 1, 12, f) != 12 ||
      std::memcmp(hdr, "RIFF", 4) != 0 ||
      std::memcmp(hdr + 8, "WAVE", 4) != 0) {
    std::fclose(f);
    return -2;  // not RIFF/WAVE (or too short)
  }
  bool have_fmt = false, have_data = false;
  long pos = 12;
  while (pos + 8 <= fsize) {
    uint8_t ch[8];
    std::fseek(f, pos, SEEK_SET);
    if (std::fread(ch, 1, 8, f) != 8) break;
    size_t size = rd_u32(ch + 4);
    long body = pos + 8;
    if (body + static_cast<long>(size) > fsize) {
      if (std::memcmp(ch, "data", 4) == 0) {
        size = static_cast<size_t>(fsize - body);
      } else {
        std::fclose(f);
        return -3;
      }
    }
    if (std::memcmp(ch, "fmt ", 4) == 0) {
      if (size < 16) {
        std::fclose(f);
        return -3;
      }
      uint8_t p[40];
      size_t want = size < sizeof(p) ? size : sizeof(p);
      if (std::fread(p, 1, want, f) != want) {
        std::fclose(f);
        return -1;
      }
      out->fmt = rd_u16(p);
      out->channels = rd_u16(p + 2);
      out->sr = rd_u32(p + 4);
      out->bits = rd_u16(p + 14);
      if (out->fmt == kExtensible) {
        if (size < 40) {
          std::fclose(f);
          return -3;
        }
        out->fmt = rd_u16(p + 24);
      }
      have_fmt = true;
    } else if (std::memcmp(ch, "data", 4) == 0 && !have_data) {
      out->data_off = static_cast<size_t>(body);
      out->data_size = size;
      have_data = true;
    }
    pos = body + static_cast<long>(size) + (size & 1);
  }
  std::fclose(f);
  if (!have_fmt || !have_data) return -3;
  if (out->channels < 1) return -4;
  if (out->fmt != kPcm && out->fmt != kIeeeFloat) return -4;
  if (out->bits != 16 && out->bits != 24 && out->bits != 32) return -4;
  if (out->fmt == kIeeeFloat && out->bits != 32) return -4;
  return 0;
}

// Walk the chunk list; mirrors utils/audio_io.py::_parse_chunks, including
// the tolerated truncated FINAL data chunk and even-offset padding.
int parse(const std::vector<uint8_t>& buf, WavLayout* out) {
  if (buf.size() < 12 || std::memcmp(buf.data(), "RIFF", 4) != 0 ||
      std::memcmp(buf.data() + 8, "WAVE", 4) != 0) {
    return -2;
  }
  bool have_fmt = false, have_data = false;
  size_t pos = 12;
  while (pos + 8 <= buf.size()) {
    const uint8_t* hdr = buf.data() + pos;
    size_t size = rd_u32(hdr + 4);
    size_t body = pos + 8;
    if (body + size > buf.size()) {
      if (std::memcmp(hdr, "data", 4) == 0) {
        size = buf.size() - body;
      } else {
        return -3;
      }
    }
    if (std::memcmp(hdr, "fmt ", 4) == 0) {
      if (size < 16) return -3;
      const uint8_t* p = buf.data() + body;
      out->fmt = rd_u16(p);
      out->channels = rd_u16(p + 2);
      out->sr = rd_u32(p + 4);
      out->bits = rd_u16(p + 14);
      if (out->fmt == kExtensible) {
        if (size < 40) return -3;
        out->fmt = rd_u16(p + 24);
      }
      have_fmt = true;
    } else if (std::memcmp(hdr, "data", 4) == 0 && !have_data) {
      out->data_off = body;
      out->data_size = size;
      have_data = true;
    }
    pos = body + size + (size & 1);
  }
  if (!have_fmt || !have_data) return -3;
  if (out->channels < 1) return -4;
  if (out->fmt != kPcm && out->fmt != kIeeeFloat) return -4;
  if (out->bits != 16 && out->bits != 24 && out->bits != 32) return -4;
  if (out->fmt == kIeeeFloat && out->bits != 32) return -4;
  return 0;
}

void wr_u32(std::vector<uint8_t>& v, uint32_t x) {
  v.push_back(static_cast<uint8_t>(x & 0xFF));
  v.push_back(static_cast<uint8_t>((x >> 8) & 0xFF));
  v.push_back(static_cast<uint8_t>((x >> 16) & 0xFF));
  v.push_back(static_cast<uint8_t>((x >> 24) & 0xFF));
}

void wr_u16(std::vector<uint8_t>& v, uint16_t x) {
  v.push_back(static_cast<uint8_t>(x & 0xFF));
  v.push_back(static_cast<uint8_t>((x >> 8) & 0xFF));
}

void wr_tag(std::vector<uint8_t>& v, const char* tag) {
  v.insert(v.end(), tag, tag + 4);
}

// NaN maps to 0 so both codecs encode it deterministically (lrint(NaN) is
// unspecified and would break the byte-identical native/NumPy contract).
double clip1(double x) {
  if (std::isnan(x)) return 0.0;
  return x < -1.0 ? -1.0 : (x > 1.0 ? 1.0 : x);
}

}  // namespace

extern "C" {

// Header probe (header-only I/O: chunk bodies are fseek'd over, never
// loaded). format_out: 0 = PCM, 1 = IEEE float.
int32_t mapt_wav_info(const char* path, int64_t* frames_out,
                      int32_t* channels_out, int32_t* sr_out,
                      int32_t* bits_out, int32_t* format_out) {
  if (!path || !frames_out || !channels_out || !sr_out || !bits_out ||
      !format_out) {
    return -5;
  }
  WavLayout w;
  int rc = scan_header(path, &w);
  if (rc != 0) return rc;
  size_t bytes_per = static_cast<size_t>(w.channels) * (w.bits / 8);
  *frames_out = static_cast<int64_t>(w.data_size / bytes_per);
  *channels_out = w.channels;
  *sr_out = static_cast<int32_t>(w.sr);
  *bits_out = w.bits;
  *format_out = (w.fmt == kIeeeFloat) ? 1 : 0;
  return 0;
}

// Decode the whole file into caller-allocated interleaved float32
// (capacity_frames * channels floats) in ONE read+parse pass, writing the
// frame count actually decoded to frames_out — the file is re-read after
// the caller's info probe, so a concurrent rewrite must not leave the
// trailing capacity as uninitialized memory. PCM scales by 2^(bits-1),
// float32 passes through verbatim — identical to audio_io.py::_decode.
int32_t mapt_wav_read_f32(const char* path, float* out,
                          int64_t capacity_frames, int64_t* frames_out,
                          int32_t* channels_out) {
  if (!path || !out || !frames_out || !channels_out) return -5;
  std::vector<uint8_t> buf;
  if (!read_file(path, buf)) return -1;
  WavLayout w;
  int rc = parse(buf, &w);
  if (rc != 0) return rc;
  size_t bytes_per = static_cast<size_t>(w.channels) * (w.bits / 8);
  size_t frames = w.data_size / bytes_per;
  if (static_cast<int64_t>(frames) > capacity_frames) return -5;
  *frames_out = static_cast<int64_t>(frames);
  *channels_out = w.channels;
  const uint8_t* p = buf.data() + w.data_off;
  size_t n = frames * w.channels;
  if (w.fmt == kIeeeFloat) {
    std::memcpy(out, p, n * 4);
    return 0;
  }
  if (w.bits == 16) {
    for (size_t i = 0; i < n; ++i) {
      int16_t v = static_cast<int16_t>(rd_u16(p + 2 * i));
      out[i] = static_cast<float>(v) / 32768.0f;
    }
  } else if (w.bits == 32) {
    for (size_t i = 0; i < n; ++i) {
      int32_t v = static_cast<int32_t>(rd_u32(p + 4 * i));
      out[i] = static_cast<float>(static_cast<double>(v) / 2147483648.0);
    }
  } else {  // 24-bit
    for (size_t i = 0; i < n; ++i) {
      const uint8_t* s = p + 3 * i;
      int32_t v = static_cast<int32_t>(
          static_cast<uint32_t>(s[0]) | (static_cast<uint32_t>(s[1]) << 8) |
          (static_cast<uint32_t>(s[2]) << 16));
      if (v >= (1 << 23)) v -= (1 << 24);
      out[i] = static_cast<float>(v) / 8388608.0f;
    }
  }
  return 0;
}

// Encode interleaved float32 (frames x channels). bits: 16/24 = PCM with
// round(clip(x) * (2^(bits-1) - 1)) — identical to audio_io.py::_encode —
// 32 = IEEE float32 verbatim (with the fact chunk non-PCM WAVE requires).
int32_t mapt_wav_write(const char* path, const float* data, int64_t frames,
                       int32_t channels, int32_t sr, int32_t bits) {
  if (!path || !data || frames < 0 || channels < 1 || sr <= 0) return -5;
  if (bits != 16 && bits != 24 && bits != 32) return -5;
  size_t n = static_cast<size_t>(frames) * channels;
  size_t block = static_cast<size_t>(channels) * (bits / 8);
  std::vector<uint8_t> payload;
  payload.reserve(n * (bits / 8));
  if (bits == 32) {
    payload.resize(n * 4);
    std::memcpy(payload.data(), data, n * 4);
  } else if (bits == 16) {
    for (size_t i = 0; i < n; ++i) {
      double v = clip1(static_cast<double>(data[i])) * 32767.0;
      int16_t q = static_cast<int16_t>(std::lrint(v));
      payload.push_back(static_cast<uint8_t>(q & 0xFF));
      payload.push_back(static_cast<uint8_t>((q >> 8) & 0xFF));
    }
  } else {  // 24
    for (size_t i = 0; i < n; ++i) {
      double v = clip1(static_cast<double>(data[i])) * 8388607.0;
      int32_t q = static_cast<int32_t>(std::lrint(v));
      uint32_t u = static_cast<uint32_t>(q);
      payload.push_back(static_cast<uint8_t>(u & 0xFF));
      payload.push_back(static_cast<uint8_t>((u >> 8) & 0xFF));
      payload.push_back(static_cast<uint8_t>((u >> 16) & 0xFF));
    }
  }
  uint16_t tag = (bits == 32) ? kIeeeFloat : kPcm;
  std::vector<uint8_t> out;
  out.reserve(payload.size() + 64);
  size_t fact = (tag == kIeeeFloat) ? 12 : 0;
  size_t padded = payload.size() + (payload.size() & 1);
  wr_tag(out, "RIFF");
  wr_u32(out, static_cast<uint32_t>(4 + 8 + 16 + fact + 8 + padded));
  wr_tag(out, "WAVE");
  wr_tag(out, "fmt ");
  wr_u32(out, 16);
  wr_u16(out, tag);
  wr_u16(out, static_cast<uint16_t>(channels));
  wr_u32(out, static_cast<uint32_t>(sr));
  wr_u32(out, static_cast<uint32_t>(sr * block));
  wr_u16(out, static_cast<uint16_t>(block));
  wr_u16(out, static_cast<uint16_t>(bits));
  if (tag == kIeeeFloat) {
    wr_tag(out, "fact");
    wr_u32(out, 4);
    wr_u32(out, static_cast<uint32_t>(frames));
  }
  wr_tag(out, "data");
  wr_u32(out, static_cast<uint32_t>(payload.size()));
  out.insert(out.end(), payload.begin(), payload.end());
  if (payload.size() & 1) out.push_back(0);

  FILE* f = std::fopen(path, "wb");
  if (!f) return -1;
  size_t put = out.empty() ? 0 : std::fwrite(out.data(), 1, out.size(), f);
  int closed = std::fclose(f);
  return (put == out.size() && closed == 0) ? 0 : -1;
}

}  // extern "C"

// Native IO tier: threaded batch WAV decoding + reference-exact int->float
// normalization.
//
// The reference's data path (sound/sound.go: go-audio/wav FullPCMBuffer +
// GetFloatAtIdx) is single-threaded Go; at corpus scale the host-side decode
// becomes the bottleneck feeding the accelerator. This library decodes batches of
// WAV files in parallel into a caller-provided [n_files, max_samples] float32
// matrix, applying the reference's normalization (divide by 0x7F / 0x7FFF /
// 0x7FFFFF / 0x7FFFFFFF per 8/16/24/32-bit, sound/sound.go:130-141) and the
// reference's SoundToTensor flattening (first NumFrames interleaved samples,
// sound/sound.go:116-127).
//
// Exposed as a plain C ABI for ctypes (no pybind11 in this environment).

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

struct WavInfo {
  int32_t sample_rate = 0;
  int32_t channels = 0;
  int32_t bit_depth = 0;
  int64_t n_data_bytes = 0;
  int64_t data_offset = 0;
  int32_t format = 0;  // 1 = PCM, 3 = IEEE float
};

// Error codes (keep in sync with auditory_tpu/io/native.py)
enum Status : int32_t {
  OK = 0,
  ERR_OPEN = 1,
  ERR_RIFF = 2,
  ERR_FMT = 3,
  ERR_UNSUPPORTED = 4,
  ERR_TRUNCATED = 5,
  ERR_TOO_LONG = 6,
  // the file decodes fine but its samples don't fit int16 (24/32-bit or
  // float WAV): caller must use the float path for this file
  ERR_NOT_I16 = 7,
};

uint32_t rd_u32(const uint8_t* p) {
  return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
         ((uint32_t)p[3] << 24);
}
uint16_t rd_u16(const uint8_t* p) {
  return (uint16_t)p[0] | ((uint16_t)p[1] << 8);
}

int64_t file_size_of(FILE* f) {
  long pos = ftell(f);
  if (fseek(f, 0, SEEK_END) != 0) return -1;
  long end = ftell(f);
  fseek(f, pos, SEEK_SET);
  return (int64_t)end;
}

int32_t parse_header(FILE* f, WavInfo* info) {
  const int64_t fsz = file_size_of(f);
  uint8_t hdr[12];
  if (fread(hdr, 1, 12, f) != 12) return ERR_RIFF;
  if (memcmp(hdr, "RIFF", 4) != 0 || memcmp(hdr + 8, "WAVE", 4) != 0)
    return ERR_RIFF;

  // walk chunks. Chunk sizes are UNTRUSTED: cap every allocation/seek
  // against the real file size (a corrupt size like 0xFFFFFFFF would
  // otherwise drive a multi-GB allocation -- std::bad_alloc escaping a
  // worker thread terminates the whole process -- or, computed in uint32,
  // wrap the skip to 0 and loop misparsing the body as chunk headers).
  for (;;) {
    uint8_t ch[8];
    if (fread(ch, 1, 8, f) != 8) return info->n_data_bytes ? OK : ERR_FMT;
    uint32_t sz = rd_u32(ch + 4);
    const int64_t skip = (int64_t)sz + (sz & 1);  // 64-bit: no wrap
    if (memcmp(ch, "fmt ", 4) == 0) {
      if (sz < 16 || (int64_t)sz > fsz) return ERR_FMT;
      std::vector<uint8_t> body(sz);
      if (fread(body.data(), 1, sz, f) != sz) return ERR_FMT;
      info->format = rd_u16(body.data());
      if (info->format == 0xFFFE && sz >= 40) {
        // WAVE_FORMAT_EXTENSIBLE: the effective format is the first two
        // bytes of the sub-format GUID in the extension (PCM=1, float=3);
        // common in pro-audio exports -- the pure-Python fallback (stdlib
        // wave on Python >= 3.12) decodes these, so the native tier must
        // too rather than regress them to ERR_UNSUPPORTED
        info->format = rd_u16(body.data() + 24);
      }
      info->channels = rd_u16(body.data() + 2);
      info->sample_rate = (int32_t)rd_u32(body.data() + 4);
      info->bit_depth = rd_u16(body.data() + 14);
      if (sz & 1) fseek(f, 1, SEEK_CUR);
    } else if (memcmp(ch, "data", 4) == 0) {
      info->n_data_bytes = sz;
      info->data_offset = ftell(f);
      // a declared size past EOF means a truncated (or still-being-
      // written) file: clamp to the bytes actually present so the
      // allocation is bounded by reality and the decoder emits what
      // exists -- matching the Python-wave fallback tier, which also
      // decodes the available frames of such files (tier consistency:
      // corpus results must not depend on which decoder tier ran)
      if (fsz >= 0 && info->n_data_bytes > fsz - info->data_offset) {
        int64_t avail = fsz - info->data_offset;
        info->n_data_bytes = avail > 0 ? avail : 0;
      }
      // keep walking? data is what we need; fmt usually precedes data
      if (info->format != 0) return OK;
      if (fseek(f, (long)skip, SEEK_CUR) != 0) return ERR_FMT;
    } else {
      if (fseek(f, (long)skip, SEEK_CUR) != 0) return ERR_FMT;
    }
  }
}

double divisor_for(int32_t bit_depth) {
  switch (bit_depth) {  // sound/sound.go:130-141
    case 32: return 2147483647.0;   // 0x7FFFFFFF
    case 24: return 8388607.0;      // 0x7FFFFF
    case 16: return 32767.0;        // 0x7FFF
    case 8: return 127.0;           // 0x7F
    default: return 0.0;
  }
}

// Decode one file into out[0..max_samples); writes the number of emitted
// samples into *n_out. flatten_frames: reference SoundToTensor semantics
// (first n_frames interleaved samples); channel >= 0: de-interleave that
// channel instead.
int32_t decode_one(const char* path, float* out, int64_t max_samples,
                   int32_t channel, int32_t* sr, int32_t* channels,
                   int32_t* bit_depth, int64_t* n_out) {
  *n_out = 0;
  FILE* f = fopen(path, "rb");
  if (!f) return ERR_OPEN;
  WavInfo info;
  int32_t st = parse_header(f, &info);
  if (st != OK) { fclose(f); return st; }
  if (info.channels <= 0 || info.sample_rate <= 0) { fclose(f); return ERR_FMT; }
  *sr = info.sample_rate;
  *channels = info.channels;
  *bit_depth = info.bit_depth;

  int bytes_per = info.bit_depth / 8;
  if (info.format == 1) {
    if (info.bit_depth != 8 && info.bit_depth != 16 && info.bit_depth != 24 &&
        info.bit_depth != 32) { fclose(f); return ERR_UNSUPPORTED; }
  } else if (info.format == 3) {
    if (info.bit_depth != 32) { fclose(f); return ERR_UNSUPPORTED; }
  } else {
    fclose(f);
    return ERR_UNSUPPORTED;
  }

  if (channel >= info.channels) { fclose(f); return ERR_UNSUPPORTED; }

  int64_t total_samples = info.n_data_bytes / bytes_per;
  int64_t n_frames = total_samples / info.channels;
  // reference SoundToTensor: first n_frames interleaved samples (the
  // per-channel path emits the same count, one sample per frame)
  if (n_frames > max_samples) { fclose(f); return ERR_TOO_LONG; }

  std::vector<uint8_t> raw(info.n_data_bytes);
  fseek(f, (long)info.data_offset, SEEK_SET);
  size_t got = fread(raw.data(), 1, (size_t)info.n_data_bytes, f);
  fclose(f);
  if ((int64_t)got < info.n_data_bytes) return ERR_TRUNCATED;

  const double div = divisor_for(info.bit_depth);
  const uint8_t* p = raw.data();
  auto sample_at = [&](int64_t idx) -> double {
    const uint8_t* q = p + idx * bytes_per;
    if (info.format == 3) {  // IEEE float32 (extension; not in reference)
      float v;
      memcpy(&v, q, 4);
      return (double)v;
    }
    int64_t v = 0;
    switch (info.bit_depth) {
      case 8: v = (int64_t)q[0]; break;  // go-audio keeps raw unsigned 0..255
      case 16: v = (int16_t)rd_u16(q); break;
      case 24: {
        int32_t u = (int32_t)q[0] | ((int32_t)q[1] << 8) | ((int32_t)q[2] << 16);
        if (u & 0x800000) u -= 0x1000000;
        v = u;
        break;
      }
      case 32: v = (int32_t)rd_u32(q); break;
    }
    return div == 0.0 ? 0.0 : (double)v / div;
  };

  if (channel < 0) {
    for (int64_t i = 0; i < n_frames; ++i) out[i] = (float)sample_at(i);
  } else {
    for (int64_t i = 0; i < n_frames; ++i)
      out[i] = (float)sample_at(i * info.channels + channel);
  }
  *n_out = n_frames;
  return OK;
}

// Raw-sample decode for 8/16-bit PCM: emits the integer samples (sign-
// corrected) as int16 plus the reference normalization divisor, so the
// int->float divide can happen on the accelerator after a half-size
// transfer. 24/32-bit and float files return ERR_NOT_I16 (caller falls back
// to the float path).
int32_t decode_one_i16(const char* path, int16_t* out, int64_t max_samples,
                       int32_t channel, int32_t* sr, float* divisor,
                       int64_t* n_out) {
  *n_out = 0;
  *divisor = 0.0f;
  FILE* f = fopen(path, "rb");
  if (!f) return ERR_OPEN;
  WavInfo info;
  int32_t st = parse_header(f, &info);
  if (st != OK) { fclose(f); return st; }
  if (info.channels <= 0 || info.sample_rate <= 0) { fclose(f); return ERR_FMT; }
  *sr = info.sample_rate;
  if (info.format != 1 || (info.bit_depth != 8 && info.bit_depth != 16)) {
    fclose(f);
    // distinguish "decodable, just not i16" from genuinely unsupported
    bool decodable =
        (info.format == 1 && (info.bit_depth == 24 || info.bit_depth == 32)) ||
        (info.format == 3 && info.bit_depth == 32);
    return decodable ? ERR_NOT_I16 : ERR_UNSUPPORTED;
  }
  if (channel >= info.channels) { fclose(f); return ERR_UNSUPPORTED; }
  int bytes_per = info.bit_depth / 8;
  int64_t total_samples = info.n_data_bytes / bytes_per;
  int64_t n_frames = total_samples / info.channels;
  if (n_frames > max_samples) { fclose(f); return ERR_TOO_LONG; }

  std::vector<uint8_t> raw(info.n_data_bytes);
  fseek(f, (long)info.data_offset, SEEK_SET);
  size_t got = fread(raw.data(), 1, (size_t)info.n_data_bytes, f);
  fclose(f);
  if ((int64_t)got < info.n_data_bytes) return ERR_TRUNCATED;

  *divisor = (float)divisor_for(info.bit_depth);
  const uint8_t* p = raw.data();
  auto sample_at = [&](int64_t idx) -> int16_t {
    const uint8_t* q = p + idx * bytes_per;
    if (info.bit_depth == 8) return (int16_t)q[0];  // raw unsigned, like go-audio
    return (int16_t)rd_u16(q);
  };
  if (channel < 0) {
    for (int64_t i = 0; i < n_frames; ++i) out[i] = sample_at(i);
  } else {
    for (int64_t i = 0; i < n_frames; ++i)
      out[i] = sample_at(i * info.channels + channel);
  }
  *n_out = n_frames;
  return OK;
}

}  // namespace

extern "C" {

int32_t auditory_wav_info(const char* path, int32_t* sr, int32_t* channels,
                          int32_t* bit_depth, int64_t* n_frames) {
  FILE* f = fopen(path, "rb");
  if (!f) return ERR_OPEN;
  WavInfo info;
  int32_t st = parse_header(f, &info);
  fclose(f);
  if (st != OK) return st;
  *sr = info.sample_rate;
  *channels = info.channels;
  *bit_depth = info.bit_depth;
  int bytes_per = info.bit_depth / 8;
  *n_frames = bytes_per > 0 && info.channels > 0
                  ? info.n_data_bytes / bytes_per / info.channels
                  : 0;
  return OK;
}

int32_t auditory_wav_decode(const char* path, float* out, int64_t max_samples,
                            int32_t channel, int32_t* sr, int32_t* channels,
                            int32_t* bit_depth, int64_t* n_samples) {
  return decode_one(path, out, max_samples, channel, sr, channels, bit_depth,
                    n_samples);
}

// Batch decode: paths as a NUL-separated blob. out is [n_files, max_samples]
// row-major. statuses/lengths/srs are [n_files]. Returns count of OK files.
int32_t auditory_wav_decode_batch(const char* paths_blob, int32_t n_files,
                                  float* out, int64_t max_samples,
                                  int32_t channel, int32_t* statuses,
                                  int64_t* lengths, int32_t* srs,
                                  int32_t n_threads) {
  std::vector<const char*> paths(n_files);
  const char* p = paths_blob;
  for (int32_t i = 0; i < n_files; ++i) {
    paths[i] = p;
    p += strlen(p) + 1;
  }
  if (n_threads <= 0) n_threads = (int32_t)std::thread::hardware_concurrency();
  if (n_threads <= 0) n_threads = 4;
  if (n_threads > n_files) n_threads = n_files > 0 ? n_files : 1;

  std::atomic<int32_t> next(0), ok_count(0);
  auto worker = [&]() {
    for (;;) {
      int32_t i = next.fetch_add(1);
      if (i >= n_files) return;
      int32_t ch_n = 0, bd = 0;
      int64_t n = 0;
      memset(out + (int64_t)i * max_samples, 0, sizeof(float) * max_samples);
      int32_t st;
      try {
        st = decode_one(paths[i], out + (int64_t)i * max_samples,
                        max_samples, channel, &srs[i], &ch_n, &bd, &n);
      } catch (...) {
        // per-file error contract: an exception (e.g. std::bad_alloc on a
        // corrupt size that slipped the header caps) must never escape the
        // worker -- std::terminate would kill the whole corpus run
        st = ERR_FMT;
        n = 0;
      }
      statuses[i] = st;
      lengths[i] = n;
      if (st == OK) ok_count.fetch_add(1);
    }
  };
  std::vector<std::thread> threads;
  for (int32_t t = 0; t < n_threads; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
  return ok_count.load();
}

// Batch raw-int16 decode (8/16-bit PCM). out is [n_files, max_samples]
// int16 row-major; divisors [n_files] float32 carry the reference
// normalization divisor per file. Files that need the float path get
// status ERR_NOT_I16. Returns count of OK files.
int32_t auditory_wav_decode_batch_i16(const char* paths_blob, int32_t n_files,
                                      int16_t* out, int64_t max_samples,
                                      int32_t channel, int32_t* statuses,
                                      int64_t* lengths, int32_t* srs,
                                      float* divisors, int32_t n_threads) {
  std::vector<const char*> paths(n_files);
  const char* p = paths_blob;
  for (int32_t i = 0; i < n_files; ++i) {
    paths[i] = p;
    p += strlen(p) + 1;
  }
  if (n_threads <= 0) n_threads = (int32_t)std::thread::hardware_concurrency();
  if (n_threads <= 0) n_threads = 4;
  if (n_threads > n_files) n_threads = n_files > 0 ? n_files : 1;

  std::atomic<int32_t> next(0), ok_count(0);
  auto worker = [&]() {
    for (;;) {
      int32_t i = next.fetch_add(1);
      if (i >= n_files) return;
      int64_t n = 0;
      memset(out + (int64_t)i * max_samples, 0, sizeof(int16_t) * max_samples);
      int32_t st;
      try {
        st = decode_one_i16(paths[i], out + (int64_t)i * max_samples,
                            max_samples, channel, &srs[i], &divisors[i], &n);
      } catch (...) {
        st = ERR_FMT;  // see the float worker: never let an exception
        n = 0;         // escape a worker thread (std::terminate)
      }
      statuses[i] = st;
      lengths[i] = n;
      if (st == OK) ok_count.fetch_add(1);
    }
  };
  std::vector<std::thread> threads;
  for (int32_t t = 0; t < n_threads; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
  return ok_count.load();
}

const char* auditory_io_version() { return "auditory_io 0.1.0"; }

}  // extern "C"

// Native audio I/O for stutter_tpu_torch: multithreaded WAV decode + batch
// assembly (the port's own copy of stutter_tpu/native/stutter_io.cpp).
//
// The reference's per-clip decode (librosa.load -> soundfile C library,
// ref: pipeline1.py:100-106) is the host-side bottleneck once feature
// extraction runs on the GPU. This library decodes a whole batch of WAV files
// into a caller-provided [B, N] float32 buffer with a thread pool, so the
// host can keep a device-feed pipeline saturated (decode of batch k+1
// overlaps device compute of batch k; see stutter_tpu_torch/io/native.py).
//
// Exposed C ABI (ctypes):
//   int st_load_wav_batch(const char** paths, int n_files,
//                         float* out, long long n_samples_max,
//                         int* lengths, int target_sr, int n_threads);
// Returns the number of successfully decoded files; failed rows are
// zero-filled with length 0 (the reference's degrade-don't-crash contract).
// Only PCM16/24/32 and float32 WAVs at target_sr are decoded natively;
// other content fails the row (Python falls back / resamples).

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct Chunk {
  const uint8_t* data;
  size_t size;
};

bool find_chunks(const uint8_t* buf, size_t size, Chunk* fmt, Chunk* data) {
  if (size < 12 || memcmp(buf, "RIFF", 4) != 0 || memcmp(buf + 8, "WAVE", 4) != 0)
    return false;
  size_t pos = 12;
  bool have_fmt = false, have_data = false;
  while (pos + 8 <= size) {
    uint32_t csize;
    memcpy(&csize, buf + pos + 4, 4);
    const uint8_t* body = buf + pos + 8;
    if (pos + 8 + csize > size) csize = static_cast<uint32_t>(size - pos - 8);
    if (memcmp(buf + pos, "fmt ", 4) == 0) {
      *fmt = {body, csize};
      have_fmt = true;
    } else if (memcmp(buf + pos, "data", 4) == 0) {
      *data = {body, csize};
      have_data = true;
    }
    pos += 8 + csize + (csize & 1);
  }
  return have_fmt && have_data;
}

// Decode one file into out[0..n_max); returns decoded length or -1.
long long decode_wav(const char* path, float* out, long long n_max, int target_sr) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  fseek(f, 0, SEEK_END);
  long fsize = ftell(f);
  fseek(f, 0, SEEK_SET);
  if (fsize <= 0) {
    fclose(f);
    return -1;
  }
  std::vector<uint8_t> buf(static_cast<size_t>(fsize));
  size_t got = fread(buf.data(), 1, buf.size(), f);
  fclose(f);
  if (got != buf.size()) return -1;

  Chunk fmt{}, data{};
  if (!find_chunks(buf.data(), buf.size(), &fmt, &data) || fmt.size < 16) return -1;

  uint16_t audio_format, channels, bits;
  uint32_t sample_rate;
  memcpy(&audio_format, fmt.data, 2);
  memcpy(&channels, fmt.data + 2, 2);
  memcpy(&sample_rate, fmt.data + 4, 4);
  memcpy(&bits, fmt.data + 14, 2);
  if (audio_format == 0xFFFE) {
    // WAVE_FORMAT_EXTENSIBLE: real tag = first two bytes of the SubFormat
    // GUID at offset 24; the GUID suffix must be the canonical ksmedia base.
    // Reject unknown GUIDs instead of guessing from bit depth.
    static const uint8_t kKsSuffix[14] = {0x00, 0x00, 0x00, 0x00, 0x10, 0x00,
                                          0x80, 0x00, 0x00, 0xAA, 0x00, 0x38,
                                          0x9B, 0x71};
    if (fmt.size < 40 || memcmp(fmt.data + 26, kKsSuffix, 14) != 0) return -1;
    memcpy(&audio_format, fmt.data + 24, 2);
  }
  if (audio_format != 1 && audio_format != 3) return -1;
  if (channels == 0 || sample_rate != static_cast<uint32_t>(target_sr)) return -1;

  const size_t bytes_per = bits / 8;
  if (bytes_per == 0) return -1;
  long long total_frames =
      static_cast<long long>(data.size / (bytes_per * channels));
  long long n = total_frames < n_max ? total_frames : n_max;

  const uint8_t* p = data.data;
  const double inv_ch = 1.0 / channels;
  for (long long i = 0; i < n; ++i) {
    double acc = 0.0;
    for (int c = 0; c < channels; ++c) {
      const uint8_t* s = p + (i * channels + c) * bytes_per;
      double v;
      if (audio_format == 3 && bits == 32) {  // IEEE float
        float fv;
        memcpy(&fv, s, 4);
        v = fv;
      } else if (bits == 16) {
        int16_t iv;
        memcpy(&iv, s, 2);
        v = iv / 32768.0;
      } else if (bits == 32) {
        int32_t iv;
        memcpy(&iv, s, 4);
        v = iv / 2147483648.0;
      } else if (bits == 24) {
        int32_t iv = s[0] | (s[1] << 8) | (s[2] << 16);
        if (iv >= (1 << 23)) iv -= (1 << 24);
        v = iv / 8388608.0;
      } else if (bits == 8) {
        v = (s[0] - 128) / 128.0;
      } else {
        return -1;
      }
      acc += v;
    }
    out[i] = static_cast<float>(acc * inv_ch);
  }
  return n;
}

}  // namespace

extern "C" {

int st_load_wav_batch(const char** paths, int n_files, float* out,
                      long long n_samples_max, int* lengths, int target_sr,
                      int n_threads) {
  if (n_threads <= 0) n_threads = 4;
  std::atomic<int> next(0), ok(0);
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n_files) break;
      float* row = out + static_cast<long long>(i) * n_samples_max;
      memset(row, 0, sizeof(float) * n_samples_max);
      long long n = decode_wav(paths[i], row, n_samples_max, target_sr);
      if (n < 0) {
        lengths[i] = 0;
      } else {
        lengths[i] = static_cast<int>(n);
        ok.fetch_add(1);
      }
    }
  };
  std::vector<std::thread> threads;
  int nt = n_threads < n_files ? n_threads : (n_files > 0 ? n_files : 1);
  threads.reserve(nt);
  for (int t = 0; t < nt; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
  return ok.load();
}

// Version/presence probe for the Python binding.
int st_abi_version() { return 1; }

}  // extern "C"

// Native audio data path for the port's host-side loaders (a copy of the
// JAX package's diffbinaural_tpu/native/audio_native.cpp, same C ABI).
//
// WAV decode (8/16/24/32-bit PCM and 32-bit float, interleaved -> planar
// float32), peak normalisation and polyphase kaiser-sinc resampling run in
// C++ off the GIL; Python loader threads only orchestrate.  Bound with
// ctypes by diffbinaural_tpu_torch/native/__init__.py, which builds it with
// g++ at first use into diffbinaural_tpu_torch/build/.
//
// Build by hand: g++ -O3 -shared -fPIC audio_native.cpp -o libaudio_native.so

#include <cstdint>
#include <cstring>
#include <cmath>
#include <cstdio>
#include <vector>
#include <algorithm>

namespace {

struct WavInfo {
  uint32_t sample_rate = 0;
  uint16_t channels = 0;
  uint16_t bits = 0;
  uint16_t format = 0;  // 1 = PCM, 3 = float
  const uint8_t* data = nullptr;
  size_t data_bytes = 0;
};

bool parse_wav(const uint8_t* buf, size_t n, WavInfo* out) {
  if (n < 44 || memcmp(buf, "RIFF", 4) != 0 || memcmp(buf + 8, "WAVE", 4) != 0)
    return false;
  size_t pos = 12;
  bool have_fmt = false;
  while (pos + 8 <= n) {
    const char* id = reinterpret_cast<const char*>(buf + pos);
    uint32_t sz;
    memcpy(&sz, buf + pos + 4, 4);
    const uint8_t* body = buf + pos + 8;
    if (memcmp(id, "fmt ", 4) == 0 && sz >= 16 && pos + 8 + sz <= n) {
      memcpy(&out->format, body, 2);
      memcpy(&out->channels, body + 2, 2);
      memcpy(&out->sample_rate, body + 4, 4);
      memcpy(&out->bits, body + 14, 2);
      if (out->format == 0xFFFE && sz >= 24) {  // extensible: sub-format
        uint16_t sub;
        memcpy(&sub, body + 24, 2);
        out->format = sub;
      }
      have_fmt = true;
    } else if (memcmp(id, "data", 4) == 0) {
      out->data = body;
      out->data_bytes = std::min<size_t>(sz, n - pos - 8);
      if (have_fmt) return true;
    }
    pos += 8 + sz + (sz & 1);
  }
  return have_fmt && out->data != nullptr;
}

inline float cvt_sample(const uint8_t* p, uint16_t bits, uint16_t format) {
  if (format == 3) {  // IEEE float
    float v;
    memcpy(&v, p, 4);
    return v;
  }
  switch (bits) {
    case 16: {
      int16_t v;
      memcpy(&v, p, 2);
      return static_cast<float>(v) / 32768.0f;
    }
    case 24: {
      int32_t v = (p[0] << 8) | (p[1] << 16) | (p[2] << 24);
      return static_cast<float>(v >> 8) / 8388608.0f;
    }
    case 32: {
      int32_t v;
      memcpy(&v, p, 4);
      return static_cast<float>(v) / 2147483648.0f;
    }
    case 8:
      return (static_cast<float>(p[0]) - 128.0f) / 128.0f;
    default:
      return 0.0f;
  }
}

}  // namespace

extern "C" {

// Probe: returns 0 on success; fills *channels, *sample_rate, *frames.
int wav_probe(const char* path, int32_t* channels, int32_t* sample_rate,
              int64_t* frames) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  fseek(f, 0, SEEK_END);
  long n = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> buf(n);
  if (fread(buf.data(), 1, n, f) != static_cast<size_t>(n)) {
    fclose(f);
    return -2;
  }
  fclose(f);
  WavInfo info;
  if (!parse_wav(buf.data(), buf.size(), &info)) return -3;
  const int bytes_per = info.bits / 8;
  *channels = info.channels;
  *sample_rate = info.sample_rate;
  *frames = static_cast<int64_t>(info.data_bytes / (bytes_per * info.channels));
  return 0;
}

// Decode interleaved WAV → planar float32 [channels][frames].
// out must hold channels*frames floats.  Returns frames decoded, <0 on error.
int64_t wav_decode(const char* path, float* out, int64_t max_frames) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  fseek(f, 0, SEEK_END);
  long n = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> buf(n);
  if (fread(buf.data(), 1, n, f) != static_cast<size_t>(n)) {
    fclose(f);
    return -2;
  }
  fclose(f);
  WavInfo info;
  if (!parse_wav(buf.data(), buf.size(), &info)) return -3;
  const int bytes_per = info.bits / 8;
  const int64_t frames = std::min<int64_t>(
      max_frames,
      static_cast<int64_t>(info.data_bytes / (bytes_per * info.channels)));
  for (int64_t t = 0; t < frames; ++t) {
    const uint8_t* frame = info.data + t * bytes_per * info.channels;
    for (int c = 0; c < info.channels; ++c) {
      out[static_cast<int64_t>(c) * frames + t] =
          cvt_sample(frame + c * bytes_per, info.bits, info.format);
    }
  }
  return frames;
}

// Peak normalisation to `level` in place (librosa.util.normalize * level).
void peak_normalize(float* x, int64_t n, float level) {
  float peak = 0.0f;
  for (int64_t i = 0; i < n; ++i) peak = std::max(peak, std::fabs(x[i]));
  if (peak < 1e-10f) return;
  const float s = level / peak;
  for (int64_t i = 0; i < n; ++i) x[i] *= s;
}

// Polyphase resampling by up/down with a kaiser-windowed sinc filter of
// `half_taps` taps per zero crossing (matches scipy.resample_poly quality).
// out must hold ceil(n*up/down) floats; returns the output length.
int64_t resample_poly(const float* x, int64_t n, int32_t up, int32_t down,
                      float* out, float beta, int32_t half_taps) {
  // design low-pass: cutoff = 1/max(up,down), length 2*half_taps*max+1
  const int32_t m = std::max(up, down);
  const int64_t half = static_cast<int64_t>(half_taps) * m;
  const int64_t taps = 2 * half + 1;
  std::vector<double> h(taps);
  // kaiser window via modified Bessel I0
  auto bessel_i0 = [](double v) {
    double sum = 1.0, term = 1.0;
    for (int k = 1; k < 32; ++k) {
      term *= (v / 2.0 / k) * (v / 2.0 / k);
      sum += term;
      if (term < 1e-16 * sum) break;
    }
    return sum;
  };
  const double i0b = bessel_i0(beta);
  const double fc = 1.0 / m;
  double gain = 0.0;
  for (int64_t i = 0; i < taps; ++i) {
    const double t = static_cast<double>(i - half);
    const double sinc =
        t == 0.0 ? fc : std::sin(M_PI * fc * t) / (M_PI * t);
    const double w = i0b == 0.0
                         ? 1.0
                         : bessel_i0(beta * std::sqrt(std::max(
                               0.0, 1.0 - (t / half) * (t / half)))) /
                               i0b;
    h[i] = sinc * w;
    gain += h[i];
  }
  for (auto& v : h) v *= up / gain;  // DC gain = up (zero-stuffing loss)
  // normalise DC gain of the polyphase sum to `up`
  const int64_t out_len = (n * up + down - 1) / down;
  for (int64_t o = 0; o < out_len; ++o) {
    const int64_t pos = o * down;           // position on the up-lattice
    double acc = 0.0;
    // y_up[k] = x[k/up] when divisible; convolve with h centred at pos
    const int64_t k_lo = pos - half;
    const int64_t k_hi = pos + half;
    // only lattice points divisible by up contribute
    int64_t k = k_lo + ((up - ((k_lo % up) + up) % up) % up);
    for (; k <= k_hi; k += up) {
      const int64_t xi = k / up;
      if (xi >= 0 && xi < n) acc += x[xi] * h[k - k_lo];
    }
    out[o] = static_cast<float>(acc);
  }
  return out_len;
}

}  // extern "C"

// Native audio runtime: WAV decode, polyphase resampling, SNR mixing.
//
// The reference framework's data path is librosa.load inside 60-70
// DataLoader worker processes (m1 common.py:57, dataset.py:226). The TPU
// rebuild moves DSP on-device; what remains on host — decode, resample,
// crop — lives here as a small C library driven through ctypes
// (sos_tpu_torch/runtime/engine.py), with a pthread pool for batch assembly.
//
// The resampler reproduces scipy.signal.resample_poly's filter design
// (firwin(2*10*max(up,down)+1, 1/max(up,down), kaiser(beta)) so outputs
// match the Python fallback within float tolerance.
//
// Build: sos_tpu_torch/runtime/engine.py `build` (g++ -O3 -shared -fPIC)

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <pthread.h>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// WAV decode
// ---------------------------------------------------------------------------

// Returns number of mono float32 samples written to out (capped at
// max_samples), or -1 on error. sr_out receives the sample rate.
// Multi-channel audio is downmixed by channel mean (librosa mono=True).
int64_t decode_wav(const char* path, float* out, int64_t max_samples,
                   int32_t* sr_out) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  fseek(f, 0, SEEK_END);
  long size = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> buf((size_t)size);
  if (fread(buf.data(), 1, (size_t)size, f) != (size_t)size) {
    fclose(f);
    return -1;
  }
  fclose(f);
  if (size < 44 || memcmp(buf.data(), "RIFF", 4) ||
      memcmp(buf.data() + 8, "WAVE", 4))
    return -1;

  uint16_t fmt = 0, channels = 0, bits = 0;
  uint32_t sr = 0;
  const uint8_t* data = nullptr;
  uint32_t data_size = 0;
  size_t pos = 12;
  while (pos + 8 <= (size_t)size) {
    uint32_t csize;
    memcpy(&csize, buf.data() + pos + 4, 4);
    const uint8_t* body = buf.data() + pos + 8;
    if (!memcmp(buf.data() + pos, "fmt ", 4) && csize >= 16) {
      memcpy(&fmt, body, 2);
      memcpy(&channels, body + 2, 2);
      memcpy(&sr, body + 4, 4);
      memcpy(&bits, body + 14, 2);
    } else if (!memcmp(buf.data() + pos, "data", 4)) {
      data = body;
      data_size = csize;
      if (pos + 8 + data_size > (size_t)size)
        data_size = (uint32_t)(size - pos - 8);
    }
    pos += 8 + csize + (csize & 1);
  }
  if (!data || !channels || !bits) return -1;
  if (fmt == 0xFFFE) fmt = (bits == 32) ? 3 : 1;  // extensible

  const int64_t bytes_per = bits / 8;
  const int64_t frames = data_size / (bytes_per * channels);
  const int64_t n = frames < max_samples ? frames : max_samples;
  const double inv_ch = 1.0 / channels;

  for (int64_t i = 0; i < n; ++i) {
    double acc = 0.0;
    for (int c = 0; c < channels; ++c) {
      const uint8_t* p = data + (i * channels + c) * bytes_per;
      double v = 0.0;
      if (fmt == 1) {
        if (bits == 16) {
          int16_t s;
          memcpy(&s, p, 2);
          v = s / 32768.0;
        } else if (bits == 32) {
          int32_t s;
          memcpy(&s, p, 4);
          v = s / 2147483648.0;
        } else if (bits == 24) {
          int32_t s = p[0] | (p[1] << 8) | (p[2] << 16);
          if (s >= (1 << 23)) s -= (1 << 24);
          v = s / 8388608.0;
        } else if (bits == 8) {
          v = ((int)p[0] - 128) / 128.0;
        }
      } else if (fmt == 3) {
        if (bits == 32) {
          float s;
          memcpy(&s, p, 4);
          v = s;
        } else if (bits == 64) {
          double s;
          memcpy(&s, p, 8);
          v = s;
        }
      }
      acc += v;
    }
    out[i] = (float)(acc * inv_ch);
  }
  *sr_out = (int32_t)sr;
  return n;
}

// Number of mono samples (for buffer sizing) and sample rate.
int64_t wav_info(const char* path, int32_t* sr_out) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  uint8_t hdr[12];
  if (fread(hdr, 1, 12, f) != 12 || memcmp(hdr, "RIFF", 4) ||
      memcmp(hdr + 8, "WAVE", 4)) {
    fclose(f);
    return -1;
  }
  uint16_t channels = 0, bits = 0;
  uint32_t sr = 0, data_size = 0;
  uint8_t chunk[8];
  while (fread(chunk, 1, 8, f) == 8) {
    uint32_t csize;
    memcpy(&csize, chunk + 4, 4);
    if (!memcmp(chunk, "fmt ", 4)) {
      uint8_t body[16];
      if (fread(body, 1, 16, f) != 16) break;
      memcpy(&channels, body + 2, 2);
      memcpy(&sr, body + 4, 4);
      memcpy(&bits, body + 14, 2);
      fseek(f, (long)(csize - 16 + (csize & 1)), SEEK_CUR);
    } else if (!memcmp(chunk, "data", 4)) {
      data_size = csize;
      break;
    } else {
      fseek(f, (long)(csize + (csize & 1)), SEEK_CUR);
    }
  }
  fclose(f);
  if (!channels || !bits) return -1;
  *sr_out = (int32_t)sr;
  return (int64_t)data_size / ((bits / 8) * channels);
}

// ---------------------------------------------------------------------------
// Polyphase resampler (scipy.signal.resample_poly-compatible)
// ---------------------------------------------------------------------------

static double bessel_i0(double x) {
  // series expansion, converges quickly for the beta range used
  double sum = 1.0, term = 1.0;
  double y = x * x / 4.0;
  for (int k = 1; k < 64; ++k) {
    term *= y / (k * (double)k);
    sum += term;
    if (term < 1e-18 * sum) break;
  }
  return sum;
}

// firwin(numtaps, cutoff, window=('kaiser', beta)) with scale=True.
static void design_lowpass(double cutoff, double beta, int64_t numtaps,
                           double* h) {
  const double m = (numtaps - 1) / 2.0;
  const double i0b = bessel_i0(beta);
  for (int64_t i = 0; i < numtaps; ++i) {
    double t = i - m;
    double sinc = (t == 0.0) ? cutoff
                             : sin(M_PI * cutoff * t) / (M_PI * t);
    double r = (numtaps == 1) ? 0.0 : (2.0 * i / (numtaps - 1) - 1.0);
    double w = bessel_i0(beta * sqrt(fmax(0.0, 1.0 - r * r))) / i0b;
    h[i] = sinc * w;
  }
  // scale=True: unity gain at DC
  double gain = 0.0;
  // firwin scales by the response at the band center (0 for lowpass)
  for (int64_t i = 0; i < numtaps; ++i) gain += h[i];
  for (int64_t i = 0; i < numtaps; ++i) h[i] /= gain;
}

// y = resample_poly(x, up, down, window=('kaiser', beta)).
// Output buffer must hold ceil(n*up/down) samples. Returns output length.
int64_t resample_poly(const float* x, int64_t n, int32_t up, int32_t down,
                      double beta, float* y) {
  if (up == down) {
    memcpy(y, x, sizeof(float) * (size_t)n);
    return n;
  }
  const int64_t max_rate = up > down ? up : down;
  const int64_t half = 10 * max_rate;  // scipy: n_taps/2
  const int64_t numtaps = 2 * half + 1;
  std::vector<double> h((size_t)numtaps);
  design_lowpass(1.0 / max_rate, beta, numtaps, h.data());
  for (int64_t i = 0; i < numtaps; ++i) h[(size_t)i] *= up;

  const int64_t out_len = (n * up + down - 1) / down;
  // upfirdn: y[m] = sum_k h[k] * xz[m*down - k + half], where xz is the
  // zero-stuffed input (xz[j] = x[j/up] when j%up==0).
  for (int64_t m = 0; m < out_len; ++m) {
    const int64_t center = m * down + half;
    double acc = 0.0;
    // xz index j = center - k must satisfy j % up == 0, 0 <= j/up < n
    // iterate over valid input samples i = j/up directly
    int64_t j_hi = center < (n - 1) * up ? center : (n - 1) * up;
    int64_t i_lo_j = center - (numtaps - 1);
    if (i_lo_j < 0) i_lo_j = 0;
    // smallest multiple of up >= i_lo_j
    int64_t j = ((i_lo_j + up - 1) / up) * up;
    for (; j <= j_hi; j += up) {
      const int64_t k = center - j;
      acc += h[(size_t)k] * x[j / up];
    }
    y[m] = (float)acc;
  }
  return out_len;
}

// ---------------------------------------------------------------------------
// SNR mixing (reference add_signals, m1 tools.py:804-843)
// ---------------------------------------------------------------------------

void mix_at_snr(const float* clean, const float* noise, int64_t n,
                double snr_db, double norm, float* mixed_out,
                float* clean_out, float* noise_out) {
  double p_sig = 0.0, p_noise = 0.0;
  for (int64_t i = 0; i < n; ++i) p_sig += (double)clean[i] * clean[i];
  for (int64_t i = 0; i < n; ++i) p_noise += (double)noise[i] * noise[i];
  double scale_noise = 1.0;
  if (p_sig > 0.0) {
    const double pn = p_sig / pow(10.0, snr_db / 10.0);
    const double ratio = sqrt(p_noise) / sqrt(pn);
    if (ratio != 0.0) scale_noise = 1.0 / ratio;
  }
  double peak = 0.0;
  for (int64_t i = 0; i < n; ++i) {
    const double ns = noise[i] * scale_noise;
    const double mx = clean[i] + ns;
    mixed_out[i] = (float)mx;
    clean_out[i] = clean[i];
    noise_out[i] = (float)ns;
    const double a = fabs(mx);
    if (a > peak) peak = a;
  }
  if (norm > 0.0 && peak > 0.0) {
    const double s = norm / peak;
    for (int64_t i = 0; i < n; ++i) {
      mixed_out[i] = (float)(mixed_out[i] * s);
      clean_out[i] = (float)(clean_out[i] * s);
      noise_out[i] = (float)(noise_out[i] * s);
    }
  }
}

// ---------------------------------------------------------------------------
// Threaded batch assembly: decode+resample many files concurrently
// ---------------------------------------------------------------------------

struct LoadTask {
  const char* path;
  float* out;        // destination (already offset per item)
  int64_t max_samples;
  int32_t target_sr;
  int64_t result;    // samples written (post-resample), -1 on error
  double beta;
};

static void* load_worker(void* arg) {
  LoadTask* t = (LoadTask*)arg;
  int32_t sr = 0;
  int64_t n_info = wav_info(t->path, &sr);
  if (n_info < 0) {
    t->result = -1;
    return nullptr;
  }
  std::vector<float> tmp((size_t)n_info);
  int64_t n = decode_wav(t->path, tmp.data(), n_info, &sr);
  if (n < 0) {
    t->result = -1;
    return nullptr;
  }
  if (sr == t->target_sr) {
    int64_t c = n < t->max_samples ? n : t->max_samples;
    memcpy(t->out, tmp.data(), sizeof(float) * (size_t)c);
    t->result = c;
    return nullptr;
  }
  // reduce up/down by gcd
  int64_t a = t->target_sr, b = sr;
  while (b) {
    int64_t r = a % b;
    a = b;
    b = r;
  }
  int32_t up = (int32_t)(t->target_sr / a), down = (int32_t)(sr / a);
  std::vector<float> res((size_t)((n * up + down - 1) / down));
  int64_t rn = resample_poly(tmp.data(), n, up, down, t->beta, res.data());
  int64_t c = rn < t->max_samples ? rn : t->max_samples;
  memcpy(t->out, res.data(), sizeof(float) * (size_t)c);
  t->result = c;
  return nullptr;
}

// Decode+resample `count` files into out (stride max_samples floats each).
// lengths[i] receives per-file sample counts. Runs up to `threads`
// pthreads. Returns 0 on success, -1 if any file failed.
int32_t load_batch(const char** paths, int32_t count, float* out,
                   int64_t max_samples, int32_t target_sr, int32_t threads,
                   int64_t* lengths) {
  std::vector<LoadTask> tasks((size_t)count);
  for (int32_t i = 0; i < count; ++i) {
    tasks[i] = LoadTask{paths[i], out + (int64_t)i * max_samples,
                        max_samples, target_sr, 0, 12.9846};
  }
  if (threads < 1) threads = 1;
  int32_t done = 0;
  while (done < count) {
    int32_t n = count - done < threads ? count - done : threads;
    std::vector<pthread_t> tids((size_t)n);
    for (int32_t i = 0; i < n; ++i)
      pthread_create(&tids[i], nullptr, load_worker, &tasks[done + i]);
    for (int32_t i = 0; i < n; ++i) pthread_join(tids[i], nullptr);
    done += n;
  }
  int32_t status = 0;
  for (int32_t i = 0; i < count; ++i) {
    lengths[i] = tasks[i].result;
    if (tasks[i].result < 0) status = -1;
  }
  return status;
}

}  // extern "C"

// ARS batch sampler: the C++ hot path of the port's input pipeline.
//
// The standard training pipeline's per-batch work, outside the Python GIL:
//   record fetch (zero-copy mmap of the ARS store) -> random crop
//   -> int16 -> float32 -> optional random allpass "phase mangle"
//   -> dequantize dither
// for a [batch, crop, C] float32 batch, rows assembled on threads. The
// same C ABI (ars_open, ars_len, ars_sample_batch, ars_close) and the same
// numbers as the JAX package's sampler; loaded with ctypes by
// rave_tpu_torch/data/native.py, which builds it into build/kernels/.
//
// Build: g++ -O3 -march=native -shared -fPIC -o libars.so ars_pipeline.cc -lpthread

#include <cstdint>
#include <cstring>
#include <cmath>
#include <cstdio>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>
#include <thread>
#include <vector>

namespace {

struct Ars {
  const int16_t* data = nullptr;
  size_t bytes = 0;
  int fd = -1;
  int64_t num_signal = 0;
  int64_t channels = 0;
  int64_t n_records = 0;
};

// splitmix64 — deterministic per-(seed, index) stream
static inline uint64_t splitmix64(uint64_t& s) {
  uint64_t z = (s += 0x9E3779B97F4A7C15ull);
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
  return z ^ (z >> 31);
}

static inline double uniform01(uint64_t& s) {
  return (splitmix64(s) >> 11) * (1.0 / 9007199254740992.0);
}

}  // namespace

extern "C" {

void* ars_open(const char* data_path, int64_t num_signal, int64_t channels) {
  int fd = open(data_path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    close(fd);
    return nullptr;
  }
  void* p = mmap(nullptr, st.st_size, PROT_READ, MAP_SHARED, fd, 0);
  if (p == MAP_FAILED) {
    close(fd);
    return nullptr;
  }
  madvise(p, st.st_size, MADV_RANDOM);
  Ars* h = new Ars();
  h->data = static_cast<const int16_t*>(p);
  h->bytes = st.st_size;
  h->fd = fd;
  h->num_signal = num_signal;
  h->channels = channels;
  h->n_records = (int64_t)(st.st_size / (2 * num_signal * channels));
  return h;
}

int64_t ars_len(void* handle) {
  return handle ? static_cast<Ars*>(handle)->n_records : 0;
}

void ars_close(void* handle) {
  if (!handle) return;
  Ars* h = static_cast<Ars*>(handle);
  munmap(const_cast<int16_t*>(
             reinterpret_cast<const int16_t*>(h->data)),
         h->bytes);
  close(h->fd);
  delete h;
}

// Assemble a [batch, crop, C] float32 batch.
//   indices[b]    : record index per row
//   seed          : base seed; row stream = f(seed, indices[b], epoch_tag)
//   dither_bits   : 0 disables dequantization dither (16 in the reference,
//                   rave/dataset.py:223-231)
//   mangle_p      : probability of the random-allpass phase mangle
//                   (0 disables; reference uses 0.8)
//   sr            : sample rate for the allpass pole frequency draw
void ars_sample_batch(void* handle, const int64_t* indices, int64_t batch,
                      int64_t crop, uint64_t seed, uint64_t epoch_tag,
                      int dither_bits, double mangle_p, double sr,
                      float* out) {
  Ars* h = static_cast<Ars*>(handle);
  const int64_t C = h->channels;
  const int64_t rec_len = h->num_signal;
  const float scale = 1.0f / 32767.0f;
  const float dither_amp =
      dither_bits > 0 ? 1.0f / (float)(1 << (dither_bits - 1)) : 0.0f;

  int n_threads = (int)std::min<int64_t>(batch, std::thread::hardware_concurrency());
  if (n_threads < 1) n_threads = 1;

  auto work = [&](int t0) {
    std::vector<float> tmp;
    for (int64_t b = t0; b < batch; b += n_threads) {
      uint64_t s = seed ^ (0x9E3779B97F4A7C15ull * (uint64_t)(indices[b] + 1)) ^
                   (epoch_tag * 0xD1B54A32D192ED03ull);
      const int16_t* rec = h->data + (uint64_t)indices[b] * rec_len * C;
      int64_t max_off = rec_len - crop;
      int64_t off = max_off > 0 ? (int64_t)(uniform01(s) * (double)(max_off + 1))
                                : 0;
      if (off > max_off) off = max_off;
      float* dst = out + (uint64_t)b * crop * C;
      const int16_t* src = rec + off * C;
      for (int64_t i = 0; i < crop * C; ++i) dst[i] = src[i] * scale;

      if (mangle_p > 0 && uniform01(s) < mangle_p) {
        // random allpass from a conjugate pole pair
        // (reference rave/core.py:36-45)
        double min_f = std::log(20.0), max_f = std::log(2000.0);
        double f = std::exp(uniform01(s) * (max_f - min_f) + min_f);
        double omega = 2.0 * M_PI * f / sr;
        double amp = 0.99;
        double re = amp * std::cos(omega);
        double a1 = -2.0 * re, a2 = amp * amp;
        double b0 = amp * amp, b1 = -2.0 * re, b2 = 1.0;
        for (int64_t c = 0; c < C; ++c) {
          double x1 = 0, x2 = 0, y1 = 0, y2 = 0;
          for (int64_t i = 0; i < crop; ++i) {
            double x = dst[i * C + c];
            double y = b0 * x + b1 * x1 + b2 * x2 - a1 * y1 - a2 * y2;
            x2 = x1; x1 = x;
            y2 = y1; y1 = y;
            dst[i * C + c] = (float)y;
          }
        }
      }
      if (dither_amp > 0) {
        for (int64_t i = 0; i < crop * C; ++i)
          dst[i] += (float)uniform01(s) * dither_amp;
      }
    }
  };

  if (n_threads == 1) {
    work(0);
  } else {
    std::vector<std::thread> threads;
    threads.reserve(n_threads);
    for (int t = 0; t < n_threads; ++t) threads.emplace_back(work, t);
    for (auto& th : threads) th.join();
  }
}

}  // extern "C"

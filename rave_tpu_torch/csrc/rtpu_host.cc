// rtpu_host — the port's Python-free consumer of a .rtpu artifact, over libtorch.
//
// The counterpart of native/rtpu_host.cc (the JAX package's host, which
// drives its StableHLO step modules through PJRT), and so the framework's
// analog of the reference's C++ deployment hosts (nn~ for Max/PD and the
// RAVE VST consume the TorchScript artifact, reference scripts/export.py:586
// + nn_tilde). It loads the TorchScript step programs that
// rave_tpu_torch/export/export.py writes beside the .pt2 (manifest
// aot.<method>.ts_file) with torch::jit::load and streams audio block by
// block on the device the artifact was exported on (aot.<method>.device):
// a card export runs on the card, and without a card the host exits naming
// the device; it never runs on another device than the artifact's. Nothing
// is compiled at load. Only the artifact directory is read: manifest.json,
// <method>_step.ts and <method>_step.state (the initial state).
//
// Usage:
//   rtpu_host [options] <model.rtpu> info
//   rtpu_host [options] <model.rtpu> bench   [n_blocks] [forward|encode|decode]
//   rtpu_host [options] <model.rtpu> forward <in.wav> <out.wav> [seed_base]
//   rtpu_host [options] <model.rtpu> encode  <in.wav> <latents.f32> [seed_base]
//   rtpu_host [options] <model.rtpu> decode  <latents.f32> <out.wav> [seed_base]
//   rtpu_host [options] <model.rtpu> prior   <n_frames> <latents.f32> [seed_base]
//
// Options (the nn_tilde register_attribute analog: AdaIN style transfer
// on adain-equipped artifacts):
//   --attr name[=v]      set an attribute before streaming (repeatable; a
//                        bare name means 1): the manifest's attribute_ops
//                        fill every state leaf whose name ends with .leaf
//   --load-state f       start from a state saved by --save-state; applied
//                        before the --attr fills
//   --save-state f       write the state after the run, so learn-target,
//                        learn-source and transfer run as separate processes
//   --no-dither          prior: decode the sampled bins without the dither
//
// Seeds: block i (prior step i) uses hash32(seed_base ^ hash32(i + 1)),
// lowbias32 on uint32 values: the seed that the Python ExportedRAVE(path,
// seed=seed_base) draws for its (i+1)-th streaming call, and the prior's
// prior_step_seed(seed_base, i). The prior's dither and padding come from
// the port's counter-based draws (rave_tpu_torch/utils/rng.py), written
// here as the same libtorch tensor ops on the device, so `prior` returns
// what ExportedRAVE.sample_prior returns.
//
// Numerics: at start the host sets the Python served path's backend flags
// (cuDNN on, not deterministic, no benchmark; TF32 off in convolutions and
// matmuls: rave_tpu_torch/train/loop.py::fp32_exact) and turns the
// TorchScript profiling executor and graph optimizations off, so no fuser
// rewrites the traced graph and each step runs the ATen kernels of the
// Python eager step. info and bench print these settings.
//
// Steps as CUDA graphs (the JAX host's one compiled executable per block;
// rave_tpu_torch/nn/graphs.py::StepGraphs in Python): on the card a step
// program's first call copies the block and the seed into static buffers,
// runs the program twice on a side stream from the pool (the warm-ups: the
// interpreter's first-run set-up, cuDNN's choice, cuBLAS and cuFFT plans;
// the step is pure, so the state stays as it was), captures one call that
// also copies the new state into the state tensors in place, and replays
// it; every later block is a copy in, a fill of the seed and a replay. The
// state tensors keep their addresses for the life of the process. The graph
// records the kernels chosen under the backend flags, which are set before
// any capture. A capture or replay error exits non-zero naming it: there is
// no eager path on the card (bench times one beside the graph and holds the
// two bit-equal). A build without -DRTPU_HOST_CUDA_GRAPHS (a CPU wheel's)
// refuses a card artifact. On the CPU the steps run eagerly through the
// interpreter, the new state written into the same state tensors in place.
// info and every streaming command print which ran.
//
// Layouts: wavs are interleaved [T, C] and the programs take [1, C, block];
// latent files are raw little-endian float32 [n_frames, latent_size]
// row-major (the programs' latents are [1, latent_size, frames]). There is
// no resampling: a wav at another rate is streamed as it is, with a
// warning, and its channels are repeated or truncated to n_channels. The
// state stays on the device between blocks: the state outputs of one call
// are the state inputs of the next.

#include <dlfcn.h>
#include <torch/cuda.h>
#include <torch/script.h>
#include <torch/csrc/jit/runtime/graph_executor.h>

#ifdef RTPU_HOST_CUDA_GRAPHS
// cuda.h first: CUDAGraph's members depend on CUDA_VERSION, which must be
// the value libtorch_cuda was compiled with
#include <cuda.h>
#include <ATen/cuda/CUDAGraph.h>
#include <c10/core/StreamGuard.h>
#include <c10/cuda/CUDAStream.h>
#include <memory>
#include <optional>
#endif

#include <algorithm>
#include <chrono>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fstream>
#include <map>
#include <random>
#include <string>
#include <vector>

namespace {

constexpr int64_t kMask32 = 0xFFFFFFFFll;
// the Python artifact's salts (rave_tpu_torch/export/artifact.py)
constexpr int64_t kPriorDitherSalt = 5, kPriorPadSalt = 6;

[[noreturn]] void Die(const std::string& msg) {
  fprintf(stderr, "%s\n", msg.c_str());
  exit(1);
}

// An exception's message: c10's without its C++ backtrace, the TorchScript
// interpreter's (a std::runtime_error) with the program's traceback.
std::string ErrorText(const std::exception& e) {
  const auto* c10_error = dynamic_cast<const c10::Error*>(&e);
  return c10_error ? c10_error->what_without_backtrace() : e.what();
}

// ---------------------------------------------------------------------------
// Minimal JSON parser — enough for machine-generated manifest.json.
// ---------------------------------------------------------------------------
struct Json {
  enum Kind { kNull, kBool, kNum, kStr, kArr, kObj } kind = kNull;
  bool b = false;
  double num = 0;
  std::string str;
  std::vector<Json> arr;
  std::map<std::string, Json> obj;

  const Json& at(const std::string& k) const {
    static const Json null;
    auto it = obj.find(k);
    return it == obj.end() ? null : it->second;
  }
  bool has(const std::string& k) const { return obj.count(k) > 0; }
  int64_t i64() const { return static_cast<int64_t>(num); }
};

class JsonParser {
 public:
  explicit JsonParser(const std::string& s) : s_(s) {}
  Json Parse() {
    Json v = Value();
    Ws();
    if (p_ != s_.size()) Fail("trailing data");
    return v;
  }

 private:
  const std::string& s_;
  size_t p_ = 0;

  [[noreturn]] void Fail(const char* what) {
    fprintf(stderr, "manifest.json parse error at byte %zu: %s\n", p_, what);
    exit(1);
  }
  void Ws() {
    while (p_ < s_.size() && (s_[p_] == ' ' || s_[p_] == '\n' ||
                              s_[p_] == '\t' || s_[p_] == '\r'))
      p_++;
  }
  char Peek() {
    if (p_ >= s_.size()) Fail("eof");
    return s_[p_];
  }
  void Expect(char c) {
    if (Peek() != c) Fail("unexpected char");
    p_++;
  }
  Json Value() {
    Ws();
    char c = Peek();
    if (c == '{') return Obj();
    if (c == '[') return Arr();
    if (c == '"') {
      Json v;
      v.kind = Json::kStr;
      v.str = Str();
      return v;
    }
    if (c == 't' || c == 'f') {
      Json v;
      v.kind = Json::kBool;
      v.b = (c == 't');
      p_ += v.b ? 4 : 5;
      return v;
    }
    if (c == 'n') {
      p_ += 4;
      return Json();
    }
    return Num();
  }
  std::string Str() {
    Expect('"');
    std::string out;
    while (Peek() != '"') {
      char c = s_[p_++];
      if (c == '\\') {
        char e = s_[p_++];
        switch (e) {
          case 'n': out += '\n'; break;
          case 't': out += '\t'; break;
          case 'r': out += '\r'; break;
          case 'b': out += '\b'; break;
          case 'f': out += '\f'; break;
          case 'u': {
            // manifest strings are ASCII in practice; decode BMP as UTF-8
            unsigned code = 0;
            for (int i = 0; i < 4; i++) {
              char h = s_[p_++];
              code = code * 16 + (h <= '9' ? h - '0' : (h | 32) - 'a' + 10);
            }
            if (code < 0x80) {
              out += static_cast<char>(code);
            } else if (code < 0x800) {
              out += static_cast<char>(0xC0 | (code >> 6));
              out += static_cast<char>(0x80 | (code & 0x3F));
            } else {
              out += static_cast<char>(0xE0 | (code >> 12));
              out += static_cast<char>(0x80 | ((code >> 6) & 0x3F));
              out += static_cast<char>(0x80 | (code & 0x3F));
            }
            break;
          }
          default: out += e;
        }
      } else {
        out += c;
      }
    }
    p_++;
    return out;
  }
  Json Num() {
    size_t start = p_;
    while (p_ < s_.size() && (isdigit(s_[p_]) || s_[p_] == '-' ||
                              s_[p_] == '+' || s_[p_] == '.' ||
                              s_[p_] == 'e' || s_[p_] == 'E'))
      p_++;
    Json v;
    v.kind = Json::kNum;
    v.num = atof(s_.substr(start, p_ - start).c_str());
    return v;
  }
  Json Arr() {
    Expect('[');
    Json v;
    v.kind = Json::kArr;
    Ws();
    if (Peek() == ']') {
      p_++;
      return v;
    }
    while (true) {
      v.arr.push_back(Value());
      Ws();
      if (Peek() == ',') {
        p_++;
        continue;
      }
      Expect(']');
      return v;
    }
  }
  Json Obj() {
    Expect('{');
    Json v;
    v.kind = Json::kObj;
    Ws();
    if (Peek() == '}') {
      p_++;
      return v;
    }
    while (true) {
      Ws();
      std::string k = Str();
      Ws();
      Expect(':');
      v.obj[k] = Value();
      Ws();
      if (Peek() == ',') {
        p_++;
        continue;
      }
      Expect('}');
      return v;
    }
  }
};

// ---------------------------------------------------------------------------
// WAV I/O — PCM16 and IEEE float32, interleaved.
// ---------------------------------------------------------------------------
struct Wav {
  int sample_rate = 0;
  int channels = 0;
  std::vector<float> frames;  // interleaved [T, C]
  int64_t n_frames() const { return channels ? frames.size() / channels : 0; }
};

bool ReadWav(const std::string& path, Wav* out) {
  std::ifstream f(path, std::ios::binary);
  if (!f) return false;
  char riff[4], wave[4];
  uint32_t riff_size;
  f.read(riff, 4);
  f.read(reinterpret_cast<char*>(&riff_size), 4);
  f.read(wave, 4);
  if (memcmp(riff, "RIFF", 4) || memcmp(wave, "WAVE", 4)) return false;
  uint16_t fmt = 0, channels = 0, bits = 0;
  uint32_t rate = 0;
  while (f) {
    char id[4];
    uint32_t size;
    f.read(id, 4);
    f.read(reinterpret_cast<char*>(&size), 4);
    if (!f) break;
    if (!memcmp(id, "fmt ", 4)) {
      std::vector<char> buf(size);
      f.read(buf.data(), size);
      fmt = *reinterpret_cast<uint16_t*>(&buf[0]);
      channels = *reinterpret_cast<uint16_t*>(&buf[2]);
      rate = *reinterpret_cast<uint32_t*>(&buf[4]);
      bits = *reinterpret_cast<uint16_t*>(&buf[14]);
      if (fmt == 0xFFFE && size >= 40) {  // WAVE_FORMAT_EXTENSIBLE
        fmt = *reinterpret_cast<uint16_t*>(&buf[24]);
      }
    } else if (!memcmp(id, "data", 4)) {
      std::vector<char> buf(size);
      f.read(buf.data(), size);
      out->sample_rate = rate;
      out->channels = channels;
      if (fmt == 1 && bits == 16) {
        const int16_t* p = reinterpret_cast<const int16_t*>(buf.data());
        size_t n = size / 2;
        out->frames.resize(n);
        for (size_t i = 0; i < n; i++) out->frames[i] = p[i] / 32768.f;
      } else if (fmt == 3 && bits == 32) {
        const float* p = reinterpret_cast<const float*>(buf.data());
        out->frames.assign(p, p + size / 4);
      } else {
        fprintf(stderr, "unsupported wav: fmt=%d bits=%d\n", fmt, bits);
        return false;
      }
      return channels > 0;
    } else {
      f.seekg(size + (size & 1), std::ios::cur);
    }
  }
  return false;
}

bool WriteWav(const std::string& path, const Wav& w) {
  std::ofstream f(path, std::ios::binary);
  if (!f) return false;
  uint32_t data_size = static_cast<uint32_t>(w.frames.size() * 2);
  uint32_t riff_size = 36 + data_size;
  uint16_t fmt = 1, bits = 16, ch = static_cast<uint16_t>(w.channels);
  uint32_t rate = w.sample_rate, byte_rate = rate * ch * 2;
  uint16_t block_align = ch * 2;
  uint32_t fmt_size = 16;
  f.write("RIFF", 4);
  f.write(reinterpret_cast<char*>(&riff_size), 4);
  f.write("WAVE", 4);
  f.write("fmt ", 4);
  f.write(reinterpret_cast<char*>(&fmt_size), 4);
  f.write(reinterpret_cast<char*>(&fmt), 2);
  f.write(reinterpret_cast<char*>(&ch), 2);
  f.write(reinterpret_cast<char*>(&rate), 4);
  f.write(reinterpret_cast<char*>(&byte_rate), 4);
  f.write(reinterpret_cast<char*>(&block_align), 2);
  f.write(reinterpret_cast<char*>(&bits), 2);
  f.write("data", 4);
  f.write(reinterpret_cast<char*>(&data_size), 4);
  for (float x : w.frames) {
    float c = x < -1.f ? -1.f : (x > 1.f ? 1.f : x);
    int16_t q = static_cast<int16_t>(c * 32767.f);
    f.write(reinterpret_cast<char*>(&q), 2);
  }
  return true;
}

std::string ReadFile(const std::string& path) {
  std::ifstream f(path, std::ios::binary);
  if (!f) Die("cannot read " + path);
  return std::string((std::istreambuf_iterator<char>(f)),
                     std::istreambuf_iterator<char>());
}

// ---------------------------------------------------------------------------
// The port's counter-based draws (rave_tpu_torch/utils/rng.py)
// ---------------------------------------------------------------------------
// lowbias32 (C. Wellons' integer hash) of a uint32 value
uint32_t Hash32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

// the seed of block (prior step) i of a stream drawn from seed_base
uint32_t ChainSeed(uint32_t seed_base, int64_t i) {
  return Hash32(seed_base ^ Hash32(static_cast<uint32_t>(i + 1)));
}

// (x * c) mod 2^32 for 0 <= x < 2^32, exact in int64: c in 16-bit halves
at::Tensor Shr(const at::Tensor& x, int64_t n) { return at::bitwise_right_shift(x, n); }

at::Tensor Mul32(const at::Tensor& x, int64_t c) {
  int64_t lo = c & 0xFFFF, hi = c >> 16;
  return (x * lo + at::bitwise_left_shift((x * hi) & 0xFFFF, 16)) & kMask32;
}

at::Tensor Hash32(const at::Tensor& x0) {
  at::Tensor x = x0 ^ Shr(x0, 16);
  x = Mul32(x, 0x7FEB352D);
  x = x ^ Shr(x, 15);
  x = Mul32(x, 0x846CA68B);
  return x ^ Shr(x, 16);
}

// 32 hashed bits per counter value, keyed by (seed, salt)
at::Tensor UniformBits(uint32_t seed, int64_t salt, const at::Tensor& counter) {
  int64_t key = Hash32(seed ^ Hash32(static_cast<uint32_t>(salt)));
  return Hash32(Hash32((counter + key) & kMask32) ^ key);
}

at::Tensor NormalFromSeed(uint32_t seed, at::IntArrayRef shape, int64_t salt,
                          const c10::Device& device) {
  int64_t n = c10::multiply_integers(shape);
  at::Tensor bits = UniformBits(
      seed, salt, torch::arange(2 * n, torch::dtype(torch::kInt64).device(device)));
  bits = Shr(bits, 8).to(torch::kFloat64).reshape({n, 2});
  at::Tensor u1 = (bits.select(1, 0) + 0.5) / 16777216.0;  // in (0, 1)
  at::Tensor u2 = bits.select(1, 1) / 16777216.0;
  at::Tensor z = torch::sqrt(-2.0 * torch::log(u1)) * torch::cos(2.0 * M_PI * u2);
  return z.to(torch::kFloat32).reshape(shape);
}

at::Tensor UniformFromSeed(uint32_t seed, at::IntArrayRef shape, int64_t salt,
                           const c10::Device& device) {
  int64_t n = c10::multiply_integers(shape);
  at::Tensor bits = UniformBits(
      seed, salt, torch::arange(n, torch::dtype(torch::kInt64).device(device)));
  return (Shr(bits, 8).to(torch::kFloat32) / 16777216.0).reshape(shape);
}

// ---------------------------------------------------------------------------
// The device and the backend flags
// ---------------------------------------------------------------------------
void SetBackendFlags() {
  auto& ctx = at::globalContext();
  ctx.setUserEnabledCuDNN(true);
  ctx.setDeterministicCuDNN(false);
  ctx.setBenchmarkCuDNN(false);
  ctx.setAllowTF32CuDNN(false);
  ctx.setAllowTF32CuBLAS(false);
  torch::jit::getExecutorMode() = false;
  torch::jit::getProfilingMode() = false;
  torch::jit::setGraphExecutorOptimize(false);
}

void PrintBackendFlags() {
  auto& ctx = at::globalContext();
  printf("cudnn: enabled %d deterministic %d benchmark %d allow_tf32 %d\n",
         ctx.userEnabledCuDNN(), ctx.deterministicCuDNN(), ctx.benchmarkCuDNN(),
         ctx.allowTF32CuDNN());
  printf("matmul: allow_tf32 %d\n", ctx.allowTF32CuBLAS());
  printf("torchscript: profiling_executor %d profiling_mode %d optimize %d\n",
         static_cast<int>(torch::jit::getExecutorMode()),
         static_cast<int>(torch::jit::getProfilingMode()),
         static_cast<int>(torch::jit::getGraphExecutorOptimize()));
}

// The card's name by libcuda's cuDeviceGetName (the library torch's CUDA
// backend loads): its C interface needs no CUDA header.
std::string CudaDeviceName(int index) {
  void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_GLOBAL);
  if (!lib) Die(std::string("cannot load libcuda.so.1: ") + dlerror());
  using InitFn = int (*)(unsigned);
  using GetFn = int (*)(int*, int);
  using NameFn = int (*)(char*, int, int);
  auto init = reinterpret_cast<InitFn>(dlsym(lib, "cuInit"));
  auto get = reinterpret_cast<GetFn>(dlsym(lib, "cuDeviceGet"));
  auto name = reinterpret_cast<NameFn>(dlsym(lib, "cuDeviceGetName"));
  int dev = 0;
  char buf[256] = {0};
  if (!init || !get || !name || init(0) != 0 || get(&dev, index) != 0 ||
      name(buf, sizeof buf, dev) != 0)
    Die("cannot read the name of CUDA device " + std::to_string(index));
  return buf;
}

// ---------------------------------------------------------------------------
// The streaming runner
// ---------------------------------------------------------------------------
torch::Dtype DtypeOf(const std::string& d) {
  if (d == "float32") return torch::kFloat32;
  if (d == "float64") return torch::kFloat64;
  if (d == "bfloat16") return torch::kBFloat16;
  if (d == "float16") return torch::kFloat16;
  if (d == "int64") return torch::kInt64;
  if (d == "int32") return torch::kInt32;
  if (d == "uint8") return torch::kUInt8;
  if (d == "bool") return torch::kBool;
  Die("unsupported dtype " + d);
}

struct TensorSpec {
  std::vector<int64_t> shape;
  std::string dtype;
  int64_t bytes() const {
    return c10::multiply_integers(shape) * c10::elementSize(DtypeOf(dtype));
  }
};

std::vector<TensorSpec> ParseSpecs(const Json& list) {
  std::vector<TensorSpec> out;
  for (const auto& t : list.arr) {
    TensorSpec s;
    s.dtype = t.at("dtype").str;
    for (const auto& d : t.at("shape").arr) s.shape.push_back(d.i64());
    out.push_back(std::move(s));
  }
  return out;
}

// A named attribute set on the command line: --attr name[=value].
struct AttrOp {
  std::string name;
  float value = 1.f;
};

constexpr int kWarmupCalls = 2;  // eager calls on a side stream before a capture

// A loaded step program: the TorchScript module, its flat I/O specs and its
// state, resident on the device between calls. The state tensors keep their
// addresses: every write to them is in place. On the card the program is
// served from static buffers (the block `x`, the int64 `seed`) by `graph`,
// whose output `y` each replay overwrites.
struct Method {
  torch::jit::Module module;
  std::vector<TensorSpec> inputs, outputs;
  int64_t n_state = 0;
  std::vector<at::Tensor> state;
  at::Tensor x, seed, y;
#ifdef RTPU_HOST_CUDA_GRAPHS
  std::unique_ptr<at::cuda::CUDAGraph> graph;
#endif
};

// The step's outputs: the block's output and the next state.
struct StepOut {
  at::Tensor y;
  std::vector<at::Tensor> state;
};

// The next state into the state tensors, in place. A program returns either
// the tensor it was given (a leaf it did not touch) or a new one, which
// shares no memory with another state tensor.
void CopyBack(std::vector<at::Tensor>& state, const std::vector<at::Tensor>& next) {
  for (size_t i = 0; i < state.size(); i++)
    if (!next[i].is_same(state[i])) state[i].copy_(next[i]);
}

class RtpuHost {
 public:
  explicit RtpuHost(const std::string& dir)
      : dir_(dir),
        manifest_(JsonParser(ReadFile(dir + "/manifest.json")).Parse()),
        device_(torch::kCPU) {
    const Json& aot = manifest_.at("aot");
    if (aot.kind != Json::kObj || aot.obj.empty())
      Die(dir_ + " has no step programs (manifest aot)");
    std::string where = aot.obj.begin()->second.at("device").str;
    device_ = c10::Device(where);
    if (device_.is_cuda()) {
      if (!torch::cuda::is_available())
        Die("the artifact's programs run on " + where +
            ", and this machine has no CUDA device");
#ifndef RTPU_HOST_CUDA_GRAPHS
      Die("the artifact's programs run on " + where + ", and this host was built without "
          "CUDA graphs (RTPU_HOST_CUDA_GRAPHS): build it against a CUDA wheel");
#endif
      if (!device_.has_index()) device_ = c10::Device(torch::kCUDA, 0);
      device_name_ = CudaDeviceName(device_.index());
    } else if (!device_.is_cpu()) {
      Die("unsupported device " + where);
    }
  }

  const Json& manifest() const { return manifest_; }
  const c10::Device& device() const { return device_; }
  std::string DeviceLine() const {
    return device_.str() + (device_name_.empty() ? "" : " (" + device_name_ + ")");
  }

  void SetStateOptions(std::vector<AttrOp> attrs, std::string load_path,
                       std::string save_path) {
    attrs_ = std::move(attrs);
    load_state_ = std::move(load_path);
    save_state_ = std::move(save_path);
  }
  const std::string& save_state_path() const { return save_state_; }

  Method& Load(const std::string& name) {
    auto it = methods_.find(name);
    if (it != methods_.end()) return it->second;
    const Json& aot = manifest_.at("aot").at(name);
    if (aot.kind != Json::kObj) Die("artifact has no program " + name);
    if (!aot.has("ts_file") || !aot.has("state_file"))
      Die("artifact has no TorchScript program for " + name +
          " (export it again with a version that writes <method>_step.ts)");
    if (c10::Device(aot.at("device").str).type() != device_.type())
      Die(name + " was exported on " + aot.at("device").str + ", not " +
          device_.str());
    if (aot.at("kept_inputs").arr.size() != aot.at("inputs").arr.size())
      Die(name + ": the program dropped unused inputs");
    Method m;
    // Where the trace saved each tensor: the weights on the artifact's
    // device, the trace's shape arithmetic (sizes divided by constant 0-d
    // tensors, read back with int()) on the host. Mapping those constants to
    // the card too would make every int() a device read: a synchronize per
    // read eagerly, and an error inside a CUDA graph capture.
    m.module = torch::jit::load(dir_ + "/" + aot.at("ts_file").str);
    for (const auto& t : m.module.parameters())
      if (t.device() != device_) Die(name + ": a weight lies on " + t.device().str());
    for (const auto& t : m.module.buffers())
      if (t.device() != device_) Die(name + ": a buffer lies on " + t.device().str());
    m.module.eval();
    m.inputs = ParseSpecs(aot.at("inputs"));
    m.outputs = ParseSpecs(aot.at("outputs"));
    m.n_state = aot.at("n_state").i64();
    m.state = ReadState(dir_ + "/" + aot.at("state_file").str, m);
    if (!load_state_.empty()) CopyBack(m.state, ReadState(load_state_, m));
    ApplyAttributes(name, m, aot);
    return methods_.emplace(name, std::move(m)).first->second;
  }

  // A state file (rtpu_host's RTPUST01 layout: magic, leaf count, then each
  // leaf's u64 byte size and raw bytes in the flat state order) on the device.
  std::vector<at::Tensor> ReadState(const std::string& path, const Method& m) {
    std::string raw = ReadFile(path);
    const char* p = raw.data();
    const char* end = raw.data() + raw.size();
    if (raw.size() < 16 || memcmp(p, "RTPUST01", 8) != 0)
      Die(path + ": not an rtpu state file");
    uint64_t n = 0;
    memcpy(&n, p + 8, 8);
    p += 16;
    if (static_cast<int64_t>(n) != m.n_state)
      Die(path + ": " + std::to_string(n) + " state leaves, the program takes " +
          std::to_string(m.n_state));
    std::vector<at::Tensor> out;
    for (int64_t i = 0; i < m.n_state; i++) {
      uint64_t sz = 0;
      if (p + 8 > end) Die(path + ": truncated");
      memcpy(&sz, p, 8);
      p += 8;
      const TensorSpec& s = m.inputs[i];
      if (sz != static_cast<uint64_t>(s.bytes()) || p + sz > end)
        Die(path + ": leaf " + std::to_string(i) + " is " + std::to_string(sz) +
            " bytes, expected " + std::to_string(s.bytes()));
      at::Tensor host = torch::empty(s.shape, torch::dtype(DtypeOf(s.dtype)));
      memcpy(host.data_ptr(), p, sz);
      out.push_back(host.to(device_));
      p += sz;
    }
    return out;
  }

  // The --attr fills: each op of the manifest's attribute_ops fills every
  // state leaf whose name (aot.<method>.state_leaves) ends with .op.leaf.
  void ApplyAttributes(const std::string& name, Method& m, const Json& aot) {
    if (attrs_.empty()) return;
    const Json& ops_map = manifest_.at("attribute_ops");
    const Json& leaves = aot.at("state_leaves");
    if (static_cast<int64_t>(leaves.arr.size()) != m.n_state)
      Die("artifact lacks state_leaves for " + name);
    for (const auto& attr : attrs_) {
      if (!ops_map.has(attr.name))
        Die("artifact exposes no attribute '" + attr.name + "'");
      for (const auto& op : ops_map.at(attr.name).arr) {
        const std::string& leaf = op.at("leaf").str;
        float fill = op.at("fill").kind == Json::kNull
                         ? attr.value
                         : static_cast<float>(op.at("fill").num);
        bool found = false;
        for (int64_t i = 0; i < m.n_state; i++) {
          const std::string& path = leaves.arr[i].str;
          bool match = path == leaf ||
                       (path.size() > leaf.size() &&
                        path[path.size() - leaf.size() - 1] == '.' &&
                        path.compare(path.size() - leaf.size(), leaf.size(), leaf) == 0);
          if (!match) continue;
          if (m.inputs[i].dtype != "float32")
            Die("attribute leaf " + path + " is " + m.inputs[i].dtype);
          m.state[i].fill_(fill);
          found = true;
        }
        if (!found)
          fprintf(stderr, "warning: attribute %s: no state leaf ends with '%s'\n",
                  attr.name.c_str(), leaf.c_str());
      }
    }
  }

  void SaveState(const Method& m, const std::string& path) {
    std::ofstream f(path, std::ios::binary);
    if (!f) Die("cannot write " + path);
    f.write("RTPUST01", 8);
    uint64_t n = static_cast<uint64_t>(m.n_state);
    f.write(reinterpret_cast<char*>(&n), 8);
    for (const auto& t : m.state) {
      at::Tensor host = t.to(torch::kCPU).contiguous();
      uint64_t sz = host.nbytes();
      f.write(reinterpret_cast<char*>(&sz), 8);
      f.write(static_cast<const char*>(host.data_ptr()), static_cast<std::streamsize>(sz));
    }
  }

  // The program through the interpreter: (state..., x, seed) -> (y, next).
  StepOut Run(Method& m, const std::vector<at::Tensor>& state, const at::Tensor& x,
              const at::Tensor& seed) {
    c10::List<at::Tensor> in;
    for (const auto& t : state) in.push_back(t);
    auto out = m.module.forward({in, x, seed}).toTuple();
    const auto& el = out->elements();
    c10::List<at::Tensor> next = el.at(1).toTensorList();
    if (static_cast<int64_t>(next.size()) != m.n_state)
      Die("the program returned " + std::to_string(next.size()) + " state tensors for " +
          std::to_string(m.n_state));
    return {el.at(0).toTensor(), std::vector<at::Tensor>(next.begin(), next.end())};
  }

  at::Tensor SeedTensor(uint32_t seed) const {
    return torch::full({}, static_cast<int64_t>(seed),
                       torch::dtype(torch::kInt64).device(device_));
  }

  // One streaming step of the path the commands serve: (state..., x, seed)
  // -> y, the next state written into m.state in place. On the card y is the
  // graph's static output: read it before the next step of `m`.
  at::Tensor Step(Method& m, const at::Tensor& x, uint32_t seed) {
    calls_++;
#ifdef RTPU_HOST_CUDA_GRAPHS
    if (device_.is_cuda()) {  // a build without graphs refused a card artifact at load
      if (!m.graph) return Capture(m, x, seed);
      try {
        m.x.copy_(x);
        m.seed.fill_(static_cast<int64_t>(seed));
        m.graph->replay();
      } catch (const std::exception& e) {
        Die(std::string("CUDA graph replay failed: ") + ErrorText(e));
      }
      return m.y;
    }
#endif
    StepOut out = Run(m, m.state, x.to(device_), SeedTensor(seed));
    CopyBack(m.state, out.state);
    return out.y;
  }

  // One step through the interpreter on `state`, replaced by the next (the
  // eager path that bench times beside the graph).
  at::Tensor StepEager(Method& m, std::vector<at::Tensor>& state, const at::Tensor& x,
                       uint32_t seed) {
    StepOut out = Run(m, state, x.to(device_), SeedTensor(seed));
    state = std::move(out.state);
    return out.y;
  }

  // How the steps ran, for the last lines of a command.
  std::string StepsLine() const {
    if (!device_.is_cuda()) return "steps: eager on the cpu, " + std::to_string(calls_) + " calls";
    return "steps: cuda graph, " + std::to_string(captures_) +
           (captures_ == 1 ? " capture, " : " captures, ") + std::to_string(calls_) +
           " replays (warm-up and capture " + std::to_string(capture_s_) + " s)";
  }

  void Synchronize() const {
    if (device_.is_cuda()) torch::cuda::synchronize(device_.index());
  }

 private:
  std::string dir_;
  Json manifest_;
  c10::Device device_;
  std::string device_name_;
  std::map<std::string, Method> methods_;
  std::vector<AttrOp> attrs_;
  std::string load_state_, save_state_;
  int64_t calls_ = 0, captures_ = 0;  // steps served (replays on the card), graphs captured
  double capture_s_ = 0;

#ifdef RTPU_HOST_CUDA_GRAPHS
  // the memory pool of this process's graphs (never replayed at once)
  std::optional<decltype(at::cuda::graph_pool_handle())> pool_;

  // The first call of `m` on the card: static buffers, two warm-ups and a
  // capture on a side stream, then the replay that serves this block.
  at::Tensor Capture(Method& m, const at::Tensor& x, uint32_t seed) {
    auto t0 = std::chrono::steady_clock::now();
    try {
      const TensorSpec& in = m.inputs[m.n_state];
      m.x = torch::empty(in.shape, torch::dtype(DtypeOf(in.dtype)).device(device_));
      m.x.copy_(x);
      m.seed = SeedTensor(seed);
      if (!pool_) pool_ = at::cuda::graph_pool_handle();
      Synchronize();
      c10::cuda::CUDAStream side = c10::cuda::getStreamFromPool(false, device_.index());
      {
        c10::StreamGuard guard(side.unwrap());
        for (int i = 0; i < kWarmupCalls; i++) Run(m, m.state, m.x, m.seed);
        Synchronize();
        m.graph = std::make_unique<at::cuda::CUDAGraph>();
        m.graph->capture_begin(*pool_, cudaStreamCaptureModeThreadLocal);
        StepOut out = Run(m, m.state, m.x, m.seed);
        CopyBack(m.state, out.state);
        m.y = out.y;
        m.graph->capture_end();
      }
      Synchronize();
      m.graph->replay();
      Synchronize();
    } catch (const std::exception& e) {
      Die(std::string("CUDA graph capture failed: ") + ErrorText(e));
    }
    captures_++;
    capture_s_ += std::chrono::duration<double>(std::chrono::steady_clock::now() - t0).count();
    return m.y;
  }
#endif
};

// [1, C, n] on any device -> interleaved [n, C] floats on the host
std::vector<float> Interleaved(const at::Tensor& y) {
  at::Tensor h = y.to(torch::kCPU).squeeze(0).t().contiguous().to(torch::kFloat32);
  return std::vector<float>(h.data_ptr<float>(), h.data_ptr<float>() + h.numel());
}

// interleaved [n, C] host floats -> [1, C, n]
at::Tensor Planar(const std::vector<float>& frames, int64_t n, int64_t channels) {
  return torch::from_blob(const_cast<float*>(frames.data()), {n, channels}, torch::kFloat32)
      .t()
      .contiguous()
      .unsqueeze(0);
}

void WriteFloats(const std::string& path, const std::vector<float>& v) {
  std::ofstream f(path, std::ios::binary);
  if (!f) Die("cannot write " + path);
  f.write(reinterpret_cast<const char*>(v.data()), static_cast<std::streamsize>(v.size() * 4));
}

}  // namespace

int main(int argc, char** argv) {
  bool no_dither = false;
  std::vector<AttrOp> attrs;
  std::string load_state, save_state;
  std::vector<std::string> pos;
  for (int i = 1; i < argc; i++) {
    std::string a = argv[i];
    if (a == "--no-dither") {
      no_dither = true;
    } else if (a == "--attr" && i + 1 < argc) {
      std::string kv = argv[++i];
      size_t eq = kv.find('=');
      AttrOp op;
      op.name = eq == std::string::npos ? kv : kv.substr(0, eq);
      op.value = eq == std::string::npos ? 1.f : static_cast<float>(atof(kv.substr(eq + 1).c_str()));
      attrs.push_back(std::move(op));
    } else if (a == "--save-state" && i + 1 < argc) {
      save_state = argv[++i];
    } else if (a == "--load-state" && i + 1 < argc) {
      load_state = argv[++i];
    } else if (a.rfind("--", 0) == 0) {
      Die("unknown option " + a);
    } else {
      pos.push_back(a);
    }
  }
  if (pos.size() < 2) {
    fprintf(stderr,
            "usage: rtpu_host [--attr name[=v] ...] [--load-state f] [--save-state f]\n"
            "                 [--no-dither] <model.rtpu> <command>\n"
            "commands:\n"
            "  info\n"
            "  bench [n_blocks] [forward|encode|decode]\n"
            "  forward <in.wav> <out.wav> [seed_base]\n"
            "  encode <in.wav> <latents.f32> [seed_base]\n"
            "  decode <latents.f32> <out.wav> [seed_base]\n"
            "  prior <n_frames> <latents.f32> [seed_base]\n");
    return 1;
  }
  SetBackendFlags();
  c10::NoGradGuard no_grad;
  const std::string dir = pos[0], cmd = pos[1];
  RtpuHost host(dir);
  host.SetStateOptions(std::move(attrs), load_state, save_state);
  const Json& man = host.manifest();
  const c10::Device device = host.device();
  int64_t block = man.at("block_size").i64();
  int64_t sr = man.at("sampling_rate").i64();
  int64_t n_channels = man.at("n_channels").i64();
  int64_t latent = man.at("latent_size").i64();
  int64_t stream_batch = man.at("stream_batch").i64();
  int64_t frames_per_block = block / man.at("methods").at("encode").at("out_ratio").i64();

  if (cmd == "info") {
    printf("name: %s\n", man.at("name").str.c_str());
    printf("sampling_rate: %lld\n", static_cast<long long>(sr));
    printf("block_size: %lld\n", static_cast<long long>(block));
    printf("n_channels: %lld\n", static_cast<long long>(n_channels));
    printf("stream_batch: %lld\n", static_cast<long long>(stream_batch));
    printf("latent_size: %lld\n", static_cast<long long>(latent));
    printf("latent_family: %s\n", man.at("latent_family").str.c_str());
    printf("frames_per_block: %lld\n", static_cast<long long>(frames_per_block));
    printf("total_latency_samples: %lld\n",
           static_cast<long long>(man.at("latency").at("total_samples").i64()));
    printf("device: %s\n", host.DeviceLine().c_str());
    printf("steps: %s\n", device.is_cuda() ? "cuda graph" : "eager on the cpu");
    PrintBackendFlags();
    for (const auto& kv : man.at("aot").obj)
      printf("aot_method: %s%s\n", kv.first.c_str(),
             kv.second.has("ts_file") ? "" : " (unavailable)");
    for (const auto& a : man.at("attributes").arr) printf("attribute: %s\n", a.str.c_str());
    return 0;
  }

  if (cmd == "bench") {
    // What an audio callback pays per block: the upload, the step, the
    // fetch of the output to the host and a synchronize, the state kept on
    // the device. Realtime budget = block_size / sampling_rate. The same
    // blocks and seeds run twice from the same initial state: eagerly
    // through the interpreter (on a copy of the state), then, on the card,
    // as the graph replays that the commands serve, whose outputs and final
    // state must be bit-equal to the eager ones.
    int64_t n_blocks = pos.size() > 2 ? atoll(pos[2].c_str()) : 256;
    std::string which = pos.size() > 3 ? pos[3] : "forward";
    if (which != "forward" && which != "encode" && which != "decode")
      Die("bench: unknown method " + which);
    if (n_blocks < 1) Die("bench: n_blocks must be positive");
    constexpr int64_t kWarmBlocks = 8;
    Method& m = host.Load(which + "_step");
    const TensorSpec& in = m.inputs[m.n_state];
    int64_t numel = c10::multiply_integers(in.shape);
    std::vector<float> xs(static_cast<size_t>((n_blocks + kWarmBlocks) * numel));
    std::mt19937 rng(17);
    std::normal_distribution<float> nrm(0.f, which == "decode" ? 1.f : 0.1f);
    for (auto& v : xs) v = nrm(rng);
    // the blocks' outputs on the host, the p50, p95 and mean ms of the timed ones
    auto timed = [&](auto&& step, std::vector<at::Tensor>* ys) {
      std::vector<double> ms;
      for (int64_t bi = -kWarmBlocks; bi < n_blocks; bi++) {
        host.Synchronize();
        auto t0 = std::chrono::steady_clock::now();
        at::Tensor x = torch::from_blob(xs.data() + (bi + kWarmBlocks) * numel, in.shape,
                                        torch::kFloat32);
        at::Tensor y = step(x, ChainSeed(0, bi + kWarmBlocks)).to(torch::kCPU);
        host.Synchronize();
        auto t1 = std::chrono::steady_clock::now();
        ys->push_back(y);
        if (bi >= 0) ms.push_back(std::chrono::duration<double, std::milli>(t1 - t0).count());
      }
      std::sort(ms.begin(), ms.end());
      double sum = 0;
      for (double v : ms) sum += v;
      return std::vector<double>{ms[ms.size() / 2], ms[ms.size() * 95 / 100], sum / ms.size()};
    };
    std::vector<at::Tensor> eager_state, eager_ys, graph_ys;
    for (const auto& t : m.state) eager_state.push_back(t.clone());
    std::vector<double> eager = timed(
        [&](const at::Tensor& x, uint32_t seed) {
          return host.StepEager(m, eager_state, x, seed);
        }, &eager_ys);
    double budget_ms = 1000.0 * block / sr;
    printf("device: %s\n", host.DeviceLine().c_str());
    PrintBackendFlags();
    printf("blocks: %lld x %lld samples (budget %.2f ms/block)\n",
           static_cast<long long>(n_blocks), static_cast<long long>(block), budget_ms);
    double p50 = eager[0], p95 = eager[1];
    if (device.is_cuda()) {
      std::vector<double> graph = timed(
          [&](const at::Tensor& x, uint32_t seed) { return host.Step(m, x, seed); }, &graph_ys);
      bool ys_equal = true, state_equal = true;
      for (size_t i = 0; i < graph_ys.size(); i++)
        ys_equal = ys_equal && torch::equal(graph_ys[i], eager_ys[i]);
      for (int64_t i = 0; i < m.n_state; i++)
        state_equal = state_equal && torch::equal(m.state[i].cpu(), eager_state[i].cpu());
      printf("per-block %s: p50 %.4f ms  p95 %.4f ms  mean %.4f ms\n", which.c_str(), graph[0],
             graph[1], graph[2]);
      printf("per-block %s eager: p50 %.4f ms  p95 %.4f ms  mean %.4f ms\n", which.c_str(),
             eager[0], eager[1], eager[2]);
      printf("graph vs eager over %lld blocks: outputs bit-equal %d, state bit-equal %d\n",
             static_cast<long long>(graph_ys.size()), ys_equal, state_equal);
      printf("%s\n", host.StepsLine().c_str());
      if (!ys_equal || !state_equal) Die("bench: the graph is not bit-equal to the eager steps");
      p50 = graph[0];
      p95 = graph[1];
    } else {
      printf("per-block %s eager: p50 %.4f ms  p95 %.4f ms  mean %.4f ms\n", which.c_str(),
             eager[0], eager[1], eager[2]);
    }
    printf("realtime headroom: %.1fx (p50), %.1fx (p95)\n", budget_ms / p50, budget_ms / p95);
    return 0;
  }

  if (stream_batch != 1)
    Die("this host streams stream_batch=1 artifacts (mono or multichannel signal batch 1); "
        "a stereo-batched artifact streams two rows per block, which this host does not");
  if (pos.size() < 4) Die("missing input/output paths");
  const std::string in_path = pos[2], out_path = pos[3];
  uint32_t seed_base = pos.size() > 4 ? static_cast<uint32_t>(atoll(pos[4].c_str())) : 0;

  if (cmd == "forward" || cmd == "encode") {
    Wav wav;
    if (!ReadWav(in_path, &wav)) Die("cannot read input wav " + in_path);
    if (wav.sample_rate != sr)
      fprintf(stderr, "warning: wav rate %d != model rate %lld (no resampling)\n",
              wav.sample_rate, static_cast<long long>(sr));
    // channel adaptation: repeat or truncate to n_channels
    int64_t T = wav.n_frames();
    int64_t n_blocks = (T + block - 1) / block;
    std::vector<float> x(static_cast<size_t>(n_blocks * block * n_channels), 0.f);
    for (int64_t t = 0; t < T; t++)
      for (int64_t c = 0; c < n_channels; c++)
        x[t * n_channels + c] = wav.frames[t * wav.channels + (c % wav.channels)];
    Method& m = host.Load(cmd + "_step");
    std::vector<float> out, xblock(static_cast<size_t>(block * n_channels));
    for (int64_t bi = 0; bi < n_blocks; bi++) {
      std::copy(x.begin() + bi * block * n_channels, x.begin() + (bi + 1) * block * n_channels,
                xblock.begin());
      auto y = Interleaved(host.Step(m, Planar(xblock, block, n_channels),
                                     ChainSeed(seed_base, bi)));
      out.insert(out.end(), y.begin(), y.end());
    }
    if (!host.save_state_path().empty()) host.SaveState(m, host.save_state_path());
    printf("%s\n", host.StepsLine().c_str());
    if (cmd == "forward") {
      Wav w;
      w.sample_rate = static_cast<int>(sr);
      w.channels = static_cast<int>(n_channels);
      w.frames.assign(out.begin(), out.begin() + T * n_channels);
      if (!WriteWav(out_path, w)) Die("cannot write output wav " + out_path);
      printf("wrote %s: %lld frames x %lld ch @ %lld Hz\n", out_path.c_str(),
             static_cast<long long>(w.n_frames()), static_cast<long long>(n_channels),
             static_cast<long long>(sr));
    } else {
      WriteFloats(out_path, out);
      printf("wrote %s: [%lld, %lld] float32 latents (%.2f Hz)\n", out_path.c_str(),
             static_cast<long long>(out.size() / latent), static_cast<long long>(latent),
             man.at("latent_rate_hz").num);
    }
    return 0;
  }

  if (cmd == "decode") {
    std::string raw = ReadFile(in_path);
    int64_t total_frames = static_cast<int64_t>(raw.size() / 4 / latent);
    if (total_frames == 0) Die("latent file too small");
    int64_t n_blocks = (total_frames + frames_per_block - 1) / frames_per_block;
    std::vector<float> z(static_cast<size_t>(n_blocks * frames_per_block * latent), 0.f);
    memcpy(z.data(), raw.data(), static_cast<size_t>(total_frames * latent) * 4);
    Method& m = host.Load("decode_step");
    std::vector<float> out, zblock(static_cast<size_t>(frames_per_block * latent));
    for (int64_t bi = 0; bi < n_blocks; bi++) {
      std::copy(z.begin() + bi * frames_per_block * latent,
                z.begin() + (bi + 1) * frames_per_block * latent, zblock.begin());
      auto y = Interleaved(host.Step(m, Planar(zblock, frames_per_block, latent),
                                     ChainSeed(seed_base, bi)));
      out.insert(out.end(), y.begin(), y.end());
    }
    if (!host.save_state_path().empty()) host.SaveState(m, host.save_state_path());
    printf("%s\n", host.StepsLine().c_str());
    Wav w;
    w.sample_rate = static_cast<int>(sr);
    w.channels = static_cast<int>(n_channels);
    w.frames = std::move(out);
    if (!WriteWav(out_path, w)) Die("cannot write output wav " + out_path);
    printf("wrote %s: %lld frames x %lld ch @ %lld Hz\n", out_path.c_str(),
           static_cast<long long>(w.n_frames()), static_cast<long long>(n_channels),
           static_cast<long long>(sr));
    return 0;
  }

  if (cmd == "prior") {
    // ExportedRAVE.sample_prior: n_frames + D - 1 steps of the prior from a
    // zero frame, fed back on the device; the bins decoded with the dither,
    // the diagonal shift undone, normals for the dimensions the prior does
    // not model (rave_tpu_torch/export/artifact.py).
    if (man.at("prior").kind != Json::kObj) Die("artifact was exported without a prior");
    int64_t n_frames = atoll(in_path.c_str());
    if (n_frames <= 0) Die("prior: n_frames must be positive");
    int64_t D = man.at("prior").at("latent_size").i64();
    int64_t R = man.at("prior").at("resolution").i64();
    Method& m = host.Load("prior_step");
    int64_t n = n_frames + D - 1;
    at::Tensor x = torch::zeros({1, D * R, 1}, torch::dtype(torch::kFloat32).device(device));
    std::vector<at::Tensor> ys;
    for (int64_t i = 0; i < n; i++) {
      x = host.Step(m, x, ChainSeed(seed_base, i));  // the next step copies it in
      ys.push_back(x.clone());
    }
    if (!host.save_state_path().empty()) host.SaveState(m, host.save_state_path());
    printf("%s\n", host.StepsLine().c_str());
    at::Tensor y = torch::cat(ys, -1);
    // QuantizedNormal(R).decode: the bins' lower edges plus the dither
    at::Tensor q = y.reshape({1, -1, R, n}).argmax(2).to(torch::kFloat32) / R;
    if (!no_dither)
      q = q + UniformFromSeed(seed_base, {1, D, n}, kPriorDitherSalt, device) / R;
    q = (at::special_erfinv(2 * q - 1) * M_SQRT2).clamp(-4.0, 4.0);
    // DiagonalShift.inverse: shift(x.flip(1)).flip(1)
    at::Tensor f = q.flip({1});
    std::vector<at::Tensor> rows;
    for (int64_t d = 0; d < D; d++)
      rows.push_back(f.select(1, d).slice(1, D - 1 - d, D - 1 - d + n_frames));
    at::Tensor zq = torch::stack(rows, 1).flip({1});
    if (D < latent)
      zq = torch::cat({zq, NormalFromSeed(seed_base, {1, latent - D, n_frames}, kPriorPadSalt,
                                          device)}, 1);
    zq = zq.slice(1, 0, latent);
    at::Tensor h = zq.squeeze(0).t().contiguous().to(torch::kCPU);
    WriteFloats(out_path, std::vector<float>(h.data_ptr<float>(), h.data_ptr<float>() + h.numel()));
    printf("wrote %s: [%lld, %lld] float32 latents from the prior\n", out_path.c_str(),
           static_cast<long long>(n_frames), static_cast<long long>(latent));
    return 0;
  }

  Die("unknown command " + cmd);
}

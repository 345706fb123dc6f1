// The fused dilated residual unit as a registered torch op,
//
//   rave_tpu_torch::dilated_unit(Tensor x, Tensor w1, Tensor w2, int dilation,
//                                int pad_left, int pad_right, int[] plan) -> Tensor
//
//   y = leaky(leaky(x) (*)_d w1) . w2 + x        (LeakyReLU slope 0.2)
//
// in the port's layouts: x, y [B, C, T]; w1 [C_out, C_in, K] and w2
// [C_out, C_in], as F.conv1d takes them. A TorchScript trace or a
// torch.export of a model that calls it records one node per unit, which
// both TorchScript and libtorch's loader can run once this library is
// loaded (`torch.ops.load_library` in Python, dlopen in C++): the saved
// portable program (rave_tpu_torch/export/portable.py) launches the Hopper
// kernel on the card. The ctypes launch of ops/kernels/dilated_unit.py writes
// into an empty buffer that a trace never sees the kernel fill, so a trace
// must reach the kernel through this op.
//
//   * CPU: the plain version in ATen (leaky, the dilated conv1d with the
//     pads, leaky, the 1x1 product, + x), the twin of
//     ops/kernels/dilated_unit.py::fused_dilated_unit_reference.
//   * CUDA (built with RTPU_UNIT_CUDA, on a CUDA wheel): the C entry
//     `dilated_unit_forward` of csrc/dilated_unit.cu, which this library
//     links (the kernel library sits beside it: rpath $ORIGIN), called as
//     ops/kernels/dilated_unit.py::_forward calls it: the same checks, x
//     padded to TMA's 16-byte rows, one workspace of prepared weights (and
//     leaky(h) when the plan splits), the launch on the current stream, the
//     crop back to T. A refused launch raises; nothing falls back to the
//     plain version on a CUDA tensor.
//   * Meta: the output's shape, for torch.export and FakeTensor.
//
// `plan` is ops/kernels/dilated_unit.py::Plan as ints (fused, np, w_stages,
// x_stages, flush, smem bytes), picked by `kernel_plan` on the exporting
// card and baked into the trace; the op checks that the block's shared
// memory fits the device's opt-in limit. On the CPU the plan is empty and
// unread. `dilated_unit_launches() -> int` counts the CUDA kernel launches
// this library made since it was loaded.

#include <torch/library.h>

#include <ATen/core/Tensor.h>
#include <ATen/ops/add.h>
#include <ATen/ops/constant_pad_nd.h>
#include <ATen/ops/conv1d.h>
#include <ATen/ops/empty.h>
#include <ATen/ops/empty_like.h>
#include <ATen/ops/leaky_relu.h>

#include <atomic>
#include <cstdint>

#ifdef RTPU_UNIT_CUDA
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>

extern "C" {
int dilated_unit_smem_limit();
int dilated_unit_forward(const void* x, const void* w1, const void* w2, void* y, void* wbuf,
                         void* hbuf, int B, int C, int T, int K, int dilation, int pad_left,
                         int is_bf16, int fused, int np, int w_stages, int x_stages, int flush,
                         cudaStream_t stream);
}
#endif

namespace {

constexpr double kSlope = 0.2;
constexpr int64_t kTile = 128, kMaxBox = 256;  // the kernel's tile; a TMA box's frames
std::atomic<int64_t> launch_count{0};

at::Tensor leaky(const at::Tensor& t) { return at::leaky_relu(t, kSlope); }

at::Tensor unit_cpu(const at::Tensor& x, const at::Tensor& w1, const at::Tensor& w2,
                    int64_t dilation, int64_t pad_left, int64_t pad_right,
                    c10::IntArrayRef /*plan*/) {
  const int64_t one = 1, zero = 0;
  const at::Tensor h = at::conv1d(at::constant_pad_nd(leaky(x), {pad_left, pad_right}), w1, {},
                                  at::IntArrayRef(one), at::IntArrayRef(zero),
                                  at::IntArrayRef(dilation));
  return at::add(at::conv1d(leaky(h), w2.unsqueeze(-1)), x);
}

at::Tensor unit_meta(const at::Tensor& x, const at::Tensor&, const at::Tensor&, int64_t,
                     int64_t, int64_t, c10::IntArrayRef) {
  return at::empty_like(x);
}

int64_t launches() { return launch_count.load(); }

#ifdef RTPU_UNIT_CUDA
// ops/kernels/dilated_unit.py::window: frames of an activation window
int64_t window(int64_t halo, int64_t pad_left, int64_t elem) {
  const int64_t step = 16 / elem;
  const int64_t lead = (pad_left + step - 1) / step * step;
  int64_t w = (kTile + halo + lead - pad_left + 7) / 8 * 8;
  while (w % 32 != 8) w += 8;
  return w;
}

// ops/kernels/dilated_unit.py::_check
void check(const at::Tensor& x, const at::Tensor& w1, const at::Tensor& w2, int64_t dilation,
           int64_t pad_left, int64_t pad_right) {
  TORCH_CHECK(x.dim() == 3 && w1.dim() == 3 && w2.dim() == 2,
              "expected x [B,C,T], w1 [C,C,K], w2 [C,C]; got ", x.sizes(), ", ", w1.sizes(),
              ", ", w2.sizes());
  const int64_t C = x.size(1), K = w1.size(2);
  TORCH_CHECK(w1.size(0) == C && w1.size(1) == C && w2.size(0) == C && w2.size(1) == C,
              "weights ", w1.sizes(), ", ", w2.sizes(), " do not match C=", C);
  TORCH_CHECK(dilation >= 1 && pad_left >= 0 && pad_right >= 0 &&
                  pad_left + pad_right == dilation * (K - 1),
              "'same' output needs pad_left + pad_right == dilation*(K-1); got d=", dilation,
              ", pads=(", pad_left, ", ", pad_right, "), K=", K);
  const auto dtype = x.scalar_type();
  TORCH_CHECK(dtype == at::kFloat || dtype == at::kBFloat16,
              "the CUDA kernel takes float32 or bfloat16; x is ", dtype);
  TORCH_CHECK(w1.device() == x.device() && w2.device() == x.device(), "w1 is on ", w1.device(),
              ", w2 on ", w2.device(), ", x on ", x.device());
  TORCH_CHECK(w1.scalar_type() == dtype && w2.scalar_type() == dtype,
              "x, w1 and w2 must share a dtype; x is ", dtype, ", w1 ", w1.scalar_type(), " w2 ",
              w2.scalar_type());
  TORCH_CHECK(x.is_contiguous(), "x must be contiguous");
  const int64_t step = dtype == at::kBFloat16 ? 16 : 8;
  TORCH_CHECK(C % step == 0, "the ", dtype, " kernel takes C % ", step,
              " == 0 (whole k", step, " tensor-core steps); C=", C);
  TORCH_CHECK(window(dilation * (K - 1), pad_left, x.element_size()) <= kMaxBox,
              "(K-1)*dilation = ", dilation * (K - 1), " frames of halo: the kernel's ", kTile,
              "-frame tile plus the halo must fit one ", kMaxBox, "-frame TMA box");
}

at::Tensor unit_cuda(const at::Tensor& x, const at::Tensor& w1, const at::Tensor& w2,
                     int64_t dilation, int64_t pad_left, int64_t pad_right,
                     c10::IntArrayRef plan) {
  check(x, w1, w2, dilation, pad_left, pad_right);
  TORCH_CHECK(plan.size() == 6, "plan is (fused, np, w_stages, x_stages, flush, smem); got ",
              plan.size(), " values");
  const bool fused = plan[0] != 0;
  const c10::cuda::CUDAGuard guard(x.device());
  const int64_t limit = dilated_unit_smem_limit();
  TORCH_CHECK(plan[5] <= limit, "the unit's plan needs ", plan[5],
              " bytes of shared memory per block; ", x.device(), " allows ", limit,
              " (the plan was made for another card: export the program on this one)");
  const int64_t B = x.size(0), C = x.size(1), T = x.size(2), K = w1.size(2);
  const bool bf16 = x.scalar_type() == at::kBFloat16;
  const int64_t step = 16 / x.element_size();
  const int64_t Tp = (T + step - 1) / step * step;  // dilated_unit.py::tma_length
  const at::Tensor xp = Tp == T ? x : at::constant_pad_nd(x, {0, Tp - T});
  const at::Tensor w1c = w1.contiguous(), w2c = w2.contiguous();
  // one workspace: the prepared weights, then (split) leaky(h) [B, C, Tp]
  const int64_t weights = (bf16 ? K : 2 * (K + 1)) * C * C;
  const at::Tensor work = at::empty({weights + (fused ? 0 : B * C * Tp)}, x.options());
  const at::Tensor y = at::empty_like(xp);
  void* h = fused ? nullptr : static_cast<char*>(work.data_ptr()) + weights * x.element_size();
  const int err = dilated_unit_forward(
      xp.data_ptr(), w1c.data_ptr(), w2c.data_ptr(), y.data_ptr(), work.data_ptr(), h, (int)B,
      (int)C, (int)Tp, (int)K, (int)dilation, (int)pad_left, (int)bf16, (int)fused,
      (int)plan[1], (int)plan[2], (int)plan[3], (int)plan[4],
      c10::cuda::getCurrentCUDAStream(x.device().index()).stream());
  TORCH_CHECK(err == 0, "dilated_unit kernel launch failed: cudaError ", err);
  launch_count.fetch_add(1);
  return Tp == T ? y : y.narrow(-1, 0, T).contiguous();
}
#endif

}  // namespace

TORCH_LIBRARY(rave_tpu_torch, m) {
  m.def("dilated_unit(Tensor x, Tensor w1, Tensor w2, int dilation, int pad_left, "
        "int pad_right, int[] plan) -> Tensor");
  m.def("dilated_unit_launches() -> int", &launches);
}

TORCH_LIBRARY_IMPL(rave_tpu_torch, CPU, m) { m.impl("dilated_unit", &unit_cpu); }

TORCH_LIBRARY_IMPL(rave_tpu_torch, Meta, m) { m.impl("dilated_unit", &unit_meta); }

#ifdef RTPU_UNIT_CUDA
TORCH_LIBRARY_IMPL(rave_tpu_torch, CUDA, m) { m.impl("dilated_unit", &unit_cuda); }
#endif

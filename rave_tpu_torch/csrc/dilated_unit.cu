// Fused dilated residual unit, forward, fp32, for Hopper (sm_90a).
//
//   y = leaky(leaky(x) (*)_d w1) . w2 + x        (LeakyReLU slope 0.2)
//
// x, y [B, C, T] (channels-first, contiguous); w1t [K, C_in, C_out];
// w2t [C_in, C_out]; the convolution is zero-padded by `pad_left` frames on
// the left and (K-1)*d - pad_left on the right, so T_out == T. C % 8 == 0.
//
// Replaces the Pallas TPU kernel rave_tpu/ops/kernels/dilated_unit.py
// (`_kernel`, launched by `_pallas_forward`). That kernel kept both weight
// matrices resident in VMEM next to a 1024-frame tile; at C = 384 the weights
// alone are 2.4 MB, ten times the 227 KB of shared memory a Hopper block can
// have, so the design here is different:
//
//   * one block (8 warps) per (batch, tile of TT frames); TT in {64, 32, 16}
//     is picked per shape by `dilated_unit_tile` so that the block's shared
//     memory fits (see there for the order);
//   * the block stages leaky(x) for its tile plus the (K-1)*d halo once, and
//     keeps the whole [C, TT] intermediate leaky(h) in shared memory, so h
//     never reaches device memory: one read of x (plus the halo and the
//     residual re-read from L2) and one write of y;
//   * both convolutions are GEMMs over the tile, [TT x C_in] . [C_in x CO]
//     per pass of CO output channels (conv1 as K shifted GEMMs), on the
//     tensor cores with mma.sync m16n8k8 TF32. To keep fp32 accuracy each
//     operand is split into a TF32 high part and a TF32 remainder and three
//     products are summed (hi.hi + hi.lo + lo.hi, "3xTF32"): the error is
//     that of fp32 FMA, not TF32's ~1e-3;
//   * w1 and w2 stream through shared memory in chunks of KC (32 or 16)
//     input channels x CO output channels, double-buffered with cp.async,
//     and are reused by every frame of the tile. Shared-memory row strides
//     are padded so that fragment loads are free of bank conflicts.
//
// What bounds it on the H100: each unit does 2 (K+1) C^2 T B FLOP (9.7 GFLOP
// per unit at B = 16, 131072 samples, the same at every level). 3xTF32 costs
// three tensor-core products per FMA, so the compute roof is 495 / 3 = 165
// TFLOP/s; every block also re-reads all of w1 and w2 from L2, (K+1) C^2 * 4
// bytes per tile of TT frames, which bounds the small tiles (TT = 16 at
// C = 768) at 2 TT FLOP per weight float read. wgmma, TMA and bf16 are later
// work.
//
// This file is the forward only. The gradient, as in the TPU kernel's
// `custom_vjp` (`_fwd` / `_bwd`), recomputes the unit in plain PyTorch and
// differentiates that (`FusedDilatedUnit` in ops/kernels/dilated_unit.py):
// the TPU kernel had no backward kernel either.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr float kSlope = 0.2f;

// Warp layout of a pass: WM x WN warps over (frames, output channels); each
// warp owns MI m16 tiles of frames and NI n8 tiles of channels. KC input
// channels of weights are staged per pipeline step.
template <int TT_>
struct Cfg;
template <>
struct Cfg<64> { static constexpr int TT = 64, WM = 2, MI = 2, WN = 4, NI = 3, KC = 32; };
template <>
struct Cfg<32> { static constexpr int TT = 32, WM = 1, MI = 2, WN = 8, NI = 3, KC = 32; };
template <>
struct Cfg<16> { static constexpr int TT = 16, WM = 1, MI = 1, WN = 8, NI = 6, KC = 16; };

template <class P>
__host__ __device__ constexpr int co_per_pass() { return P::WN * P::NI * 8; }

// Row stride (floats) >= n, a multiple of 8, and 8 or 24 mod 32: fragment
// loads (4 rows x 8 consecutive columns per warp) then hit 32 distinct banks.
__host__ __device__ constexpr int padded(int n) {
  int m = (n + 7) / 8 * 8;
  while (m % 32 != 8 && m % 32 != 24) m += 8;
  return m;
}

__device__ __forceinline__ float leaky(float v) { return v >= 0.f ? v : kSlope * v; }

__device__ __forceinline__ uint32_t tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = tf32(v);
  lo = tf32(v - __uint_as_float(hi));
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem, bool valid) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int bytes = valid ? 16 : 0;  // 0: zero-fill the 16 bytes
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_one() { asm volatile("cp.async.wait_group 1;\n" ::); }

// ws[c][o] = w[(ci0 + c) * C + co0 + o] for c < KC, o < CO, zero outside C.
template <int CO, int KC>
__device__ __forceinline__ void stage_weights(float* ws, const float* __restrict__ w, int C,
                                              int ci0, int co0) {
  constexpr int LDW = padded(CO);
  for (int i = threadIdx.x; i < KC * CO / 4; i += kThreads) {
    const int c = i / (CO / 4), o = (i - c * (CO / 4)) * 4;
    const int ci = ci0 + c, co = co0 + o;
    const bool valid = ci < C && co < C;
    cp_async16(ws + c * LDW + o, valid ? w + (size_t)ci * C + co : w, valid);
  }
}

// One pass of CO output channels starting at co0:
//   acc[t][co] += sum_{k < K} sum_{ci < C} xs[ci][t + k d] * w[k][ci][co0 + co]
// with xs in shared memory (row stride lda) and w (K x [C, C], [ci][co]) in
// global memory, streamed through the two ws buffers. Each step's products
// go to a fresh tensor-core accumulator that is then added to `acc` in fp32:
// the tensor cores' internal accumulation truncates, and flushing every KC
// channels keeps the error at the level of fp32 FMA instead of ten times it.
template <class P>
__device__ __forceinline__ void gemm_pass(float (&acc)[P::MI][P::NI][4], const float* xs, int lda,
                                          const float* __restrict__ w, int K, int dilation, int C,
                                          int co0, float* ws) {
  constexpr int CO = co_per_pass<P>();
  constexpr int LDW = padded(CO);
  constexpr int KC = P::KC;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int tb = (warp % P::WM) * P::MI * 16;  // first frame of this warp
  const int cb = (warp / P::WM) * P::NI * 8;   // first channel of this warp (in the pass)
  const int chunks = (C + KC - 1) / KC;
  const int n = K * chunks;

  stage_weights<CO, KC>(ws, w, C, 0, co0);
  cp_async_commit();
  for (int it = 0; it < n; ++it) {
    if (it + 1 < n) {
      const int k1 = (it + 1) / chunks, c1 = (it + 1 - k1 * chunks) * KC;
      stage_weights<CO, KC>(ws + ((it + 1) & 1) * KC * LDW, w + (size_t)k1 * C * C, C, c1, co0);
    }
    cp_async_commit();
    cp_async_wait_one();  // chunk `it` has landed (this thread's copies)
    __syncthreads();      // ... and everyone's; `xs` staged before the first pass
    const int k = it / chunks, ci0 = (it - k * chunks) * KC;
    const float* wb = ws + (it & 1) * KC * LDW;
    const float* xk = xs + k * dilation;
    float part[P::MI][P::NI][4] = {};
#pragma unroll
    for (int kk = 0; kk < KC; kk += 8) {
      if (ci0 + kk >= C) break;  // C % 8 == 0: k8 steps are whole
      uint32_t ahi[P::MI][4], alo[P::MI][4], bhi[P::NI][2], blo[P::NI][2];
      const float* xr = xk + (size_t)(ci0 + kk + tig) * lda;
#pragma unroll
      for (int mi = 0; mi < P::MI; ++mi) {
        const int t = tb + mi * 16 + g;
        split(xr[t], ahi[mi][0], alo[mi][0]);
        split(xr[t + 8], ahi[mi][1], alo[mi][1]);
        split(xr[4 * lda + t], ahi[mi][2], alo[mi][2]);
        split(xr[4 * lda + t + 8], ahi[mi][3], alo[mi][3]);
      }
      const float* wr = wb + (kk + tig) * LDW + cb + g;
#pragma unroll
      for (int ni = 0; ni < P::NI; ++ni) {
        split(wr[ni * 8], bhi[ni][0], blo[ni][0]);
        split(wr[4 * LDW + ni * 8], bhi[ni][1], blo[ni][1]);
      }
#pragma unroll
      for (int mi = 0; mi < P::MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < P::NI; ++ni) {
          mma(part[mi][ni], ahi[mi], blo[ni]);
          mma(part[mi][ni], alo[mi], bhi[ni]);
          mma(part[mi][ni], ahi[mi], bhi[ni]);
        }
    }
#pragma unroll
    for (int mi = 0; mi < P::MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < P::NI; ++ni)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[mi][ni][r] += part[mi][ni][r];
    __syncthreads();  // chunk `it` consumed before its buffer is refilled
  }
}

template <int TT>
__global__ void __launch_bounds__(kThreads)
dilated_unit_kernel(const float* __restrict__ x, const float* __restrict__ w1t,
                    const float* __restrict__ w2t, float* __restrict__ y,
                    int C, int T, int K, int dilation, int pad_left) {
  using P = Cfg<TT>;
  constexpr int CO = co_per_pass<P>();
  constexpr int LDG = padded(TT);
  extern __shared__ __align__(16) float smem[];
  const int TW = TT + (K - 1) * dilation;
  const int LDA = padded(TW);
  float* ws = smem;                         // 2 x [KC][padded(CO)] weight chunks
  float* as = ws + 2 * P::KC * padded(CO);  // [C][LDA] leaky(x), tile plus halo
  float* gs = as + C * LDA;                 // [C][LDG] leaky(h)

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * TT;
  const float* xb = x + (size_t)b * C * T;
  float* yb = y + (size_t)b * C * T;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int tb = (warp % P::WM) * P::MI * 16;
  const int cb = (warp / P::WM) * P::NI * 8;

  for (int i = threadIdx.x; i < C * TW; i += kThreads) {
    const int c = i / TW, j = i - c * TW;
    const int t = t0 - pad_left + j;
    as[c * LDA + j] = (t >= 0 && t < T) ? leaky(xb[(size_t)c * T + t]) : 0.f;
  }

  // conv1 (K dilated taps) -> leaky -> gs
  for (int co0 = 0; co0 < C; co0 += CO) {
    float acc[P::MI][P::NI][4] = {};
    gemm_pass<P>(acc, as, LDA, w1t, K, dilation, C, co0, ws);
#pragma unroll
    for (int mi = 0; mi < P::MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < P::NI; ++ni)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int t = tb + mi * 16 + g + (r >> 1) * 8;
          const int co = co0 + cb + ni * 8 + 2 * tig + (r & 1);
          if (co < C) gs[co * LDG + t] = leaky(acc[mi][ni][r]);
        }
  }
  // (the next pass's first __syncthreads publishes gs)

  // conv2 (1x1) + residual -> y
  for (int co0 = 0; co0 < C; co0 += CO) {
    float acc[P::MI][P::NI][4] = {};
    gemm_pass<P>(acc, gs, LDG, w2t, 1, 0, C, co0, ws);
#pragma unroll
    for (int mi = 0; mi < P::MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < P::NI; ++ni)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int t = t0 + tb + mi * 16 + g + (r >> 1) * 8;
          const int co = co0 + cb + ni * 8 + 2 * tig + (r & 1);
          if (co < C && t < T) {
            const size_t at = (size_t)co * T + t;
            yb[at] = acc[mi][ni][r] + xb[at];
          }
        }
  }
}

template <int TT>
size_t smem_bytes(int C, int K, int dilation) {
  const int lda = padded(TT + (K - 1) * dilation);
  return sizeof(float) * ((size_t)2 * Cfg<TT>::KC * padded(co_per_pass<Cfg<TT>>()) +
                          (size_t)C * lda + (size_t)C * padded(TT));
}

size_t smem_bytes(int C, int K, int dilation, int tile) {
  switch (tile) {
    case 64: return smem_bytes<64>(C, K, dilation);
    case 32: return smem_bytes<32>(C, K, dilation);
    case 16: return smem_bytes<16>(C, K, dilation);
    default: return 0;
  }
}

int max_smem_optin() {
  int dev = 0, bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess)
    return 0;
  return bytes;
}

// Raises the dynamic shared-memory cap of dilated_unit_kernel<TT> to the
// current device's opt-in maximum, once per device. The cap is a limit, not
// a reservation: each launch still asks for what its shape needs.
template <int TT>
cudaError_t raise_smem_cap() {
  constexpr int kMaxDevices = 64;
  static bool raised[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && raised[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(dilated_unit_kernel<TT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             max_smem_optin());
  if (err == cudaSuccess && dev < kMaxDevices) raised[dev] = true;
  return err;
}

template <int TT>
int launch(const float* x, const float* w1t, const float* w2t, float* y, int B, int C, int T,
           int K, int dilation, int pad_left, cudaStream_t stream) {
  const cudaError_t err = raise_smem_cap<TT>();
  if (err != cudaSuccess) return (int)err;
  const size_t smem = smem_bytes<TT>(C, K, dilation);
  const dim3 grid((T + TT - 1) / TT, B);
  dilated_unit_kernel<TT><<<grid, kThreads, smem, stream>>>(x, w1t, w2t, y, C, T, K, dilation,
                                                            pad_left);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Frames per block for this shape, or 0 if no tile fits (the shape is
// refused). Tiles whose pass of output channels is wider than C waste that
// part of their tensor-core work, so they come last; among the others the
// largest tile that leaves room for two blocks per SM wins, else the largest
// that fits one block (the order measured fastest at the v2 shapes).
int dilated_unit_tile(int C, int K, int dilation) {
  const size_t limit = (size_t)max_smem_optin();
  const int tiles[3] = {64, 32, 16};
  const int co[3] = {co_per_pass<Cfg<64>>(), co_per_pass<Cfg<32>>(), co_per_pass<Cfg<16>>()};
  const int narrow = C > co[0] ? C : co[0];
  for (int blocks = 2; blocks >= 1; --blocks)
    for (int i = 0; i < 3; ++i)
      if (co[i] <= narrow && blocks * smem_bytes(C, K, dilation, tiles[i]) <= limit) return tiles[i];
  for (int i = 0; i < 3; ++i)
    if (smem_bytes(C, K, dilation, tiles[i]) <= limit) return tiles[i];
  return 0;
}

// Launches on `stream`; returns cudaGetLastError() after the launch (0 when
// it was accepted), or cudaErrorInvalidValue for a refused shape.
int dilated_unit_forward(const float* x, const float* w1t, const float* w2t, float* y, int B,
                         int C, int T, int K, int dilation, int pad_left, int tile,
                         cudaStream_t stream) {
  if (C % 8 != 0) return (int)cudaErrorInvalidValue;
  switch (tile) {
    case 64: return launch<64>(x, w1t, w2t, y, B, C, T, K, dilation, pad_left, stream);
    case 32: return launch<32>(x, w1t, w2t, y, B, C, T, K, dilation, pad_left, stream);
    case 16: return launch<16>(x, w1t, w2t, y, B, C, T, K, dilation, pad_left, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"

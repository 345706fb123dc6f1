// Fused dilated residual unit, forward, fp32 and bf16, for Hopper (sm_90a).
//
//   y = leaky(leaky(x) (*)_d w1) . w2 + x        (LeakyReLU slope 0.2)
//
// fp32: x, y [B, C, T] (channels-first, contiguous); w1t [K, C_in, C_out];
// w2t [C_in, C_out]; the convolution is zero-padded by `pad_left` frames on
// the left and (K-1)*d - pad_left on the right, so T_out == T. C % 8 == 0.
// The bf16 variant (`dilated_unit_forward_bf16`, described below the fp32
// kernel) takes its weights channel-in fastest and C % 16 == 0.
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
// C = 768) at 2 TT FLOP per weight float read. wgmma and TMA are later work.
//
// This file is the forward only. The gradient, as in the TPU kernel's
// `custom_vjp` (`_fwd` / `_bwd`), recomputes the unit in plain PyTorch and
// differentiates that (`FusedDilatedUnit` in ops/kernels/dilated_unit.py):
// the TPU kernel had no backward kernel either.

#include <cuda_bf16.h>
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

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
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

constexpr int kMaxDevices = 64;

// Raises the dynamic shared-memory cap of `kernel` to the current device's
// opt-in maximum, once per device (`raised` is the kernel's own record). The
// cap is a limit, not a reservation: each launch still asks for what its
// shape needs.
template <class Kernel>
cudaError_t raise_smem_cap(Kernel kernel, bool (&raised)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && raised[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem_optin());
  if (err == cudaSuccess && dev < kMaxDevices) raised[dev] = true;
  return err;
}

template <int TT>
int launch(const float* x, const float* w1t, const float* w2t, float* y, int B, int C, int T,
           int K, int dilation, int pad_left, cudaStream_t stream) {
  static bool raised[kMaxDevices] = {};
  const cudaError_t err = raise_smem_cap(dilated_unit_kernel<TT>, raised);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = smem_bytes<TT>(C, K, dilation);
  const dim3 grid((T + TT - 1) / TT, B);
  dilated_unit_kernel<TT><<<grid, kThreads, smem, stream>>>(x, w1t, w2t, y, C, T, K, dilation,
                                                            pad_left);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 variant (train.bf16): x, w1, w2 and y in bf16.
//
// Replaces the same TPU kernel (`_kernel` / `_pallas_forward` of
// rave_tpu/ops/kernels/dilated_unit.py) on the bf16 inputs that the JAX
// package's `train.bf16` step gives it. It computes
//   a = bf16(leaky(x));  h = sum_k a[t + k d] . w1[k]  (fp32 accumulation);
//   g = bf16(leaky(h));  y = bf16(g . w2 + x)          (residual in fp32),
// which is the Pallas body with its inputs in bf16: `y_ref[0] = (y +
// x.astype(f32)).astype(y.dtype)`. One difference: the Pallas kernel fed
// leaky(h) to its second product in fp32, this one rounds g to bf16 once,
// as the operand of a bf16 tensor-core product (the plain bf16 path rounds
// h and leaky(h) both).
//
// Design: the fp32 kernel's, with the arithmetic of a bf16 product. Both
// convolutions are GEMMs over a tile of TT frames on the tensor cores,
// mma.sync m16n8k16 bf16 with fp32 accumulators, conv1 as K shifted GEMMs;
// bf16 is exact in bf16, so there is no 3x split and no per-chunk flush.
// Activations sit in shared memory frame-major, [frames][C / 2] words of
// two bf16 channels each, so an A fragment (two consecutive input channels
// per register) is one 32-bit load; weights are staged the same way,
// [C_out][C_in], for the B fragments (hence the [K, C_out, C_in] and
// [C_out, C_in] layouts this entry point takes). Row strides are 4 mod 8
// words: fragment loads are free of bank conflicts. Half the element size
// halves the tiles' shared memory, so the tiles are twice the fp32 ones'
// (TT in {128, 64, 32, 16}; `dilated_unit_bf16_tile` picks the largest that
// fits and still gives every SM a block). Weights stream through shared
// memory in chunks of 64 input channels, double-buffered with cp.async.
//
// What bounds it on the H100: 2 (K+1) C^2 T B FLOP per unit (4.8 GFLOP at
// B = 8, 131072 samples), 4.9 us at the 989 TFLOP/s dense bf16 peak, and
// the bf16 x read and y written once (25.2 MB at C = 96, 7.5 us at 3.35
// TB/s, which binds there; the operations bind at C >= 192). About 0.12 ms
// for the 22 units of a B = 8 forward. mma.sync reaches a fraction of the
// peak that only wgmma gives; wgmma, TMA and wider tiles are later work.

template <int TT_>
struct Cfg16;
template <>
struct Cfg16<128> { static constexpr int TT = 128, WM = 4, MI = 2, WN = 2, NI = 6, KC = 64; };
template <>
struct Cfg16<64> { static constexpr int TT = 64, WM = 2, MI = 2, WN = 4, NI = 3, KC = 64; };
template <>
struct Cfg16<32> { static constexpr int TT = 32, WM = 2, MI = 1, WN = 4, NI = 3, KC = 64; };
template <>
struct Cfg16<16> { static constexpr int TT = 16, WM = 1, MI = 1, WN = 8, NI = 3, KC = 64; };

// Row stride in 32-bit words (bf16 pairs): the least m >= n with m % 8 == 4.
// A fragment load (8 rows x 4 consecutive words per warp) then hits 32
// distinct banks, and every row starts 16-byte aligned.
__host__ __device__ constexpr int padded_words(int n) { return (n + 3) / 8 * 8 + 4; }

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// ws[o][c] = w[(co0 + o) * C + ci0 + c] for o < CO, c < KC (row stride
// padded_words(KC / 2) words), zero outside C.
template <int CO, int KC>
__device__ __forceinline__ void stage_weights_bf16(uint32_t* ws, const __nv_bfloat16* __restrict__ w,
                                                   int C, int ci0, int co0) {
  constexpr int LDW = padded_words(KC / 2);
  constexpr int SEGS = KC / 8;  // 16-byte copies per row
  for (int i = threadIdx.x; i < CO * SEGS; i += kThreads) {
    const int o = i / SEGS, c = (i - o * SEGS) * 8;
    const int co = co0 + o, ci = ci0 + c;
    const bool valid = co < C && ci < C;  // C % 16 == 0: a copy is all in or all out
    cp_async16(ws + o * LDW + c / 2, valid ? w + (size_t)co * C + ci : w, valid);
  }
}

// One pass of CO output channels starting at co0:
//   acc[t][co] += sum_{k < K} sum_{ci < C} xs[t + k d][ci] * w[k][co0 + co][ci]
// with xs frame-major in shared memory (row stride lda words) and w (K x
// [C_out, C_in]) in global memory, streamed through the two ws buffers.
template <class P>
__device__ __forceinline__ void gemm_pass_bf16(float (&acc)[P::MI][P::NI][4], const uint32_t* xs,
                                               int lda, const __nv_bfloat16* __restrict__ w, int K,
                                               int dilation, int C, int co0, uint32_t* ws) {
  constexpr int CO = co_per_pass<P>();
  constexpr int KC = P::KC;
  constexpr int LDW = padded_words(KC / 2);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int tb = (warp % P::WM) * P::MI * 16;  // first frame of this warp
  const int cb = (warp / P::WM) * P::NI * 8;   // first channel of this warp (in the pass)
  const int chunks = (C + KC - 1) / KC;
  const int n = K * chunks;

  stage_weights_bf16<CO, KC>(ws, w, C, 0, co0);
  cp_async_commit();
  for (int it = 0; it < n; ++it) {
    if (it + 1 < n) {
      const int k1 = (it + 1) / chunks, c1 = (it + 1 - k1 * chunks) * KC;
      stage_weights_bf16<CO, KC>(ws + ((it + 1) & 1) * CO * LDW, w + (size_t)k1 * C * C, C, c1,
                                 co0);
    }
    cp_async_commit();
    cp_async_wait_one();  // chunk `it` has landed (this thread's copies)
    __syncthreads();      // ... and everyone's; `xs` staged before the first pass
    const int k = it / chunks, ci0 = (it - k * chunks) * KC;
    const uint32_t* wb = ws + (it & 1) * CO * LDW;
    const uint32_t* xk = xs + (size_t)k * dilation * lda;  // tap k: frames shifted by k d
#pragma unroll
    for (int kk = 0; kk < KC; kk += 16) {
      if (ci0 + kk >= C) break;  // C % 16 == 0: k16 steps are whole
      uint32_t a[P::MI][4], b[P::NI][2];
#pragma unroll
      for (int mi = 0; mi < P::MI; ++mi) {
        const uint32_t* xr = xk + (tb + mi * 16 + g) * lda + (ci0 + kk) / 2 + tig;
        a[mi][0] = xr[0];
        a[mi][1] = xr[8 * lda];
        a[mi][2] = xr[4];
        a[mi][3] = xr[8 * lda + 4];
      }
#pragma unroll
      for (int ni = 0; ni < P::NI; ++ni) {
        const uint32_t* wr = wb + (cb + ni * 8 + g) * LDW + kk / 2 + tig;
        b[ni][0] = wr[0];
        b[ni][1] = wr[4];
      }
#pragma unroll
      for (int mi = 0; mi < P::MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < P::NI; ++ni) mma_bf16(acc[mi][ni], a[mi], b[ni]);
    }
    __syncthreads();  // chunk `it` consumed before its buffer is refilled
  }
}

template <int TT>
__global__ void __launch_bounds__(kThreads)
dilated_unit_bf16_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w1k,
                         const __nv_bfloat16* __restrict__ w2, __nv_bfloat16* __restrict__ y,
                         int C, int T, int K, int dilation, int pad_left) {
  using P = Cfg16<TT>;
  constexpr int CO = co_per_pass<P>();
  extern __shared__ __align__(16) uint32_t smem_words[];
  const int TW = TT + (K - 1) * dilation;
  const int LD = padded_words(C / 2);
  uint32_t* ws = smem_words;                                // 2 x [CO][padded_words(KC/2)]
  uint32_t* as = ws + 2 * CO * padded_words(P::KC / 2);     // [TW][LD] leaky(x), tile plus halo
  uint32_t* gs = as + (size_t)TW * LD;                      // [TT][LD] leaky(h)

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * TT;
  const __nv_bfloat16* xb = x + (size_t)b * C * T;
  __nv_bfloat16* yb = y + (size_t)b * C * T;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int tb = (warp % P::WM) * P::MI * 16;
  const int cb = (warp / P::WM) * P::NI * 8;

  for (int i = threadIdx.x; i < (C / 2) * TW; i += kThreads) {
    const int c = i / TW, j = i - c * TW;  // channel pair c, frame j of the window
    const int t = t0 - pad_left + j;
    float lo = 0.f, hi = 0.f;
    if (t >= 0 && t < T) {
      lo = leaky(__bfloat162float(xb[(size_t)(2 * c) * T + t]));
      hi = leaky(__bfloat162float(xb[(size_t)(2 * c + 1) * T + t]));
    }
    as[j * LD + c] = pack_bf16(lo, hi);
  }

  // conv1 (K dilated taps) -> leaky -> bf16 -> gs
  for (int co0 = 0; co0 < C; co0 += CO) {
    float acc[P::MI][P::NI][4] = {};
    gemm_pass_bf16<P>(acc, as, LD, w1k, K, dilation, C, co0, ws);
#pragma unroll
    for (int mi = 0; mi < P::MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < P::NI; ++ni)
#pragma unroll
        for (int h = 0; h < 2; ++h) {  // rows g and g + 8 of the fragment
          const int t = tb + mi * 16 + g + h * 8;
          const int co = co0 + cb + ni * 8 + 2 * tig;
          if (co < C)
            gs[t * LD + co / 2] = pack_bf16(leaky(acc[mi][ni][2 * h]), leaky(acc[mi][ni][2 * h + 1]));
        }
  }
  // (the next pass's first __syncthreads publishes gs)

  // conv2 (1x1) + residual in fp32 -> bf16 y
  for (int co0 = 0; co0 < C; co0 += CO) {
    float acc[P::MI][P::NI][4] = {};
    gemm_pass_bf16<P>(acc, gs, LD, w2, 1, 0, C, co0, ws);
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
            yb[at] = __float2bfloat16_rn(acc[mi][ni][r] + __bfloat162float(xb[at]));
          }
        }
  }
}

template <int TT>
size_t smem_bytes_bf16(int C, int K, int dilation) {
  using P = Cfg16<TT>;
  const size_t ld = padded_words(C / 2);
  return sizeof(uint32_t) * ((size_t)2 * co_per_pass<P>() * padded_words(P::KC / 2) +
                             (TT + (K - 1) * dilation) * ld + TT * ld);
}

size_t smem_bytes_bf16(int C, int K, int dilation, int tile) {
  switch (tile) {
    case 128: return smem_bytes_bf16<128>(C, K, dilation);
    case 64: return smem_bytes_bf16<64>(C, K, dilation);
    case 32: return smem_bytes_bf16<32>(C, K, dilation);
    case 16: return smem_bytes_bf16<16>(C, K, dilation);
    default: return 0;
  }
}

int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return 0;
  return n;
}

template <int TT>
int launch_bf16(const void* x, const void* w1k, const void* w2, void* y, int B, int C, int T,
                int K, int dilation, int pad_left, cudaStream_t stream) {
  static bool raised[kMaxDevices] = {};
  const cudaError_t err = raise_smem_cap(dilated_unit_bf16_kernel<TT>, raised);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = smem_bytes_bf16<TT>(C, K, dilation);
  const dim3 grid((T + TT - 1) / TT, B);
  dilated_unit_bf16_kernel<TT><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w1k),
      static_cast<const __nv_bfloat16*>(w2), static_cast<__nv_bfloat16*>(y), C, T, K, dilation,
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

// Frames per block of the bf16 kernel for B x [C, T] (0: refused): the
// largest tile that fits in shared memory and still gives every SM at least
// one block, else the smallest that fits (the most blocks).
int dilated_unit_bf16_tile(int B, int C, int T, int K, int dilation) {
  const size_t limit = (size_t)max_smem_optin();
  const long sms = sm_count();
  const int tiles[4] = {128, 64, 32, 16};
  for (int i = 0; i < 4; ++i)
    if (smem_bytes_bf16(C, K, dilation, tiles[i]) <= limit &&
        (long)B * ((T + tiles[i] - 1) / tiles[i]) >= sms)
      return tiles[i];
  for (int i = 3; i >= 0; --i)
    if (smem_bytes_bf16(C, K, dilation, tiles[i]) <= limit) return tiles[i];
  return 0;
}

// The bf16 variant: x, y [B, C, T]; w1k [K, C_out, C_in]; w2 [C_out, C_in];
// all bf16, C % 16 == 0. Returns as dilated_unit_forward does.
int dilated_unit_forward_bf16(const void* x, const void* w1k, const void* w2, void* y, int B,
                              int C, int T, int K, int dilation, int pad_left, int tile,
                              cudaStream_t stream) {
  if (C % 16 != 0) return (int)cudaErrorInvalidValue;
  switch (tile) {
    case 128: return launch_bf16<128>(x, w1k, w2, y, B, C, T, K, dilation, pad_left, stream);
    case 64: return launch_bf16<64>(x, w1k, w2, y, B, C, T, K, dilation, pad_left, stream);
    case 32: return launch_bf16<32>(x, w1k, w2, y, B, C, T, K, dilation, pad_left, stream);
    case 16: return launch_bf16<16>(x, w1k, w2, y, B, C, T, K, dilation, pad_left, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"

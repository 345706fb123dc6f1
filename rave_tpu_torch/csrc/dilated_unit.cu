// Fused dilated residual unit, forward, fp32 and bf16, for Hopper (sm_90a).
//
//   y = leaky(leaky(x) (*)_d w1) . w2 + x        (LeakyReLU slope 0.2)
//
// x, y [B, C, T] (channels-first, contiguous; T * sizeof(element) a multiple
// of 16 bytes, which the wrapper arranges); w1 [C_out, C_in, K] and
// w2 [C_out, C_in] as F.conv1d takes them. The convolution is zero-padded by
// `pad_left` frames on the left and (K-1)*d - pad_left on the right, so
// T_out == T.
//
// Replaces the Pallas TPU kernel rave_tpu/ops/kernels/dilated_unit.py
// (`_kernel`, launched by `_pallas_forward`), which kept both weight matrices
// resident in VMEM beside a 1024-frame tile. On Hopper a block has 227 KB of
// shared memory, less than the weights at C >= 192 in fp32, so here:
//
//   * One design, two arithmetics. fp32 runs "3xTF32": each product is
//     a_hi.b_hi + a_hi.b_lo + a_lo.b_hi of TF32 parts, fp32 accuracy on the
//     TF32 tensor cores; the tensor cores' sums (their accumulation
//     truncates) are flushed into fp32 registers every three groups (96
//     products per output). bf16 runs bf16 products with fp32 accumulation;
//     leaky(h) is rounded to bf16 once and the residual is added in fp32.
//   * Both convolutions are GEMMs with M = frames, N = output channels and
//     K = input channels (times the taps), on `wgmma` (m64nNk8 tf32,
//     m64nNk16 bf16). A block has two consumer warpgroups of 64 frames each
//     (a 128-frame tile) and one producer warpgroup whose one thread keeps
//     TMA loads in flight through two rings of mbarrier-tracked stages:
//     activation windows (128 bytes of channels x the tile plus the
//     (K-1)*d halo; TMA's out-of-bounds zero fill is the convolution's
//     padding) and weight tiles ([N, 128 bytes of input channels], 128-byte
//     swizzle, the B operand of wgmma straight from shared memory). Both
//     warpgroups read each weight tile, so the weights cross L2 once per
//     128 frames. `setmaxnreg` gives the consumers the producer's registers.
//     The grid is persistent (one block per SM), so one tile's epilogue
//     overlaps the next tile's first loads.
//   * A comes from registers: the shift of tap k by k*d frames is not a
//     multiple of the 8-row swizzle atom, so the consumers load their A
//     fragments from the window with ld.shared at any row, apply leaky and
//     (fp32) split them into TF32 parts there, once per k-step for all N
//     output channels, one group (a tap's 128-byte step) ahead of the
//     products in flight. The weights are split once per call by a small
//     kernel (`prepare_weights`), which also lays them out [K, C_out, C_in].
//   * Fused (small C): leaky(h) for the block's 128 frames and all C
//     channels stays in shared memory, conv1 writes it pass by pass (N
//     channels each) and conv2 reads it as A, so h never reaches device
//     memory. Split (large C, where h does not fit, or few tiles): the
//     same kernel runs twice, conv1 writing leaky(h) [B, C, T] to device
//     memory and conv2 streaming it back as A, each block one (128-frame,
//     N-channel) tile, which gives C / N times the blocks (at C = 768,
//     B = 16, h is 6.3 MB each way: ~4 us at 3.35 TB/s against the unit's
//     58.6 us bound). The wrapper's `plan` picks the mode, N and the stages.
//
// What bounds it on the H100: each unit does 2 (K+1) C^2 T B FLOP (9.7
// GFLOP at B = 16, 131072 samples, at every level); 3xTF32 makes the fp32
// roof 495 / 3 = 165 TFLOP/s (58.6 us per unit), bf16's is 989 TFLOP/s. The
// weights re-read from L2 per 128-frame tile (4 (K+1) C^2 bytes, twice that
// as fp32 hi/lo parts: 0.30 GB per fp32 unit at B = 16) and the fixed costs
// of each tile (fill, epilogue) are the next limits; TMA multicast of the
// weights across a cluster is the next step (PERF.md).
//
// The gradient (`dilated_unit_backward`, below `forward`) replaces the TPU
// kernel's `_bwd` (rave_tpu/ops/kernels/dilated_unit.py:132), which has no
// Pallas kernel: it recomputes the unit and differentiates it with XLA. Here
// the data gradients are three more launches of this kernel's split mode and
// the weight gradients a kernel of their own (`wgrad_kernel`); see there.

#include <cuda.h>  // CUtensorMap and its enums: types only, the driver is reached at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "dilated_unit_sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr float kSlope = 0.2f;
constexpr int kTile = 128;       // frames per block: two consumer warpgroups of 64
constexpr int kConsumers = 256;  // threads of the consumer warpgroups
constexpr int kThreads = 384;    // plus the producer warpgroup
constexpr int kMaxStages = 4;  // of either ring
// FLUSH: groups whose products gather in the tensor cores before each fp32
// flush, one 32-channel chunk of conv1's three taps (96 products per output)
constexpr int kFlushGroups = 3;
constexpr int kMaxBox = 256;  // TMA's limit on a box's extent

// Per element type: input channels per pipeline step (one 128-byte row) and
// the parts of a weight (fp32: TF32 hi and lo).
template <class E>
struct Arith;
template <>
struct Arith<float> {
  static constexpr int KC = 32, PARTS = 2;
};
template <>
struct Arith<bf16> {
  static constexpr int KC = 64, PARTS = 1;
};

__host__ __device__ constexpr int round_up(int n, int m) { return (n + m - 1) / m * m; }

// Frames before a tile that its activation window starts at: the left
// padding rounded up to 16 bytes (a TMA box must start 16-byte aligned in
// its innermost dimension; coordinates below 0 read as zeros).
__host__ __device__ constexpr int lead(int pad_left, int elem) { return round_up(pad_left, 16 / elem); }

// Frames of an activation window: the lead, the tile and the rest of the
// halo, a multiple of 8 and 8 mod 32, so that A fragment loads (4 channel
// rows x 8 frames per instruction) hit 32 distinct banks.
__host__ __device__ constexpr int window(int halo, int pad_left, int elem) {
  int w = round_up(kTile + halo + lead(pad_left, elem) - pad_left, 8);
  while (w % 32 != 8) w += 8;
  return w;
}

// Row pitch of the resident leaky(h) tile in 32-bit words: the channels
// rounded up to whole steps, plus 4 (rows 4 mod 32 words apart: conflict-free).
template <class E>
__host__ __device__ constexpr int h_pitch_words(int C) {
  return round_up(C, Arith<E>::KC) * (int)sizeof(E) / 4 + 4;
}

// Shared-memory plan of a block; the same on the host (launch size) and the
// device (offsets). Offsets are from a 1024-byte aligned base.
template <class E>
struct Layout {
  int win, w_stage, x_stage, w_stages, x_stages, h_off, bar_off, bytes;
  __host__ __device__ Layout(int C, int win_, int np, int w_stages_, int x_stages_, bool fused) {
    win = win_;
    w_stage = np * 128 * Arith<E>::PARTS;
    x_stage = 128 * win;  // KC channels x win frames
    w_stages = w_stages_;
    x_stages = x_stages_;
    h_off = w_stages * w_stage + x_stages * x_stage;
    bar_off = h_off + (fused ? kTile * h_pitch_words<E>(C) * 4 : 0);
    bytes = 1024 + bar_off + 16 * (w_stages + x_stages);
  }
};

__device__ __forceinline__ float leaky(float v) { return v >= 0.f ? v : kSlope * v; }

__device__ __forceinline__ uint32_t tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_raw(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

template <class E, int NP>
struct Mma;
template <>
struct Mma<float, 96> {
  static __device__ __forceinline__ void run(float (&d)[48], const uint32_t (&a)[4], uint64_t b, int s) {
    sm90::wgmma_tf32_n96(d, a, b, s);
  }
};
template <>
struct Mma<bf16, 96> {
  static __device__ __forceinline__ void run(float (&d)[48], const uint32_t (&a)[4], uint64_t b, int s) {
    sm90::wgmma_bf16_n96(d, a, b, s);
  }
};
template <>
struct Mma<bf16, 192> {
  static __device__ __forceinline__ void run(float (&d)[96], const uint32_t (&a)[4], uint64_t b, int s) {
    sm90::wgmma_bf16_n192(d, a, b, s);
  }
};

// What a launch reads and writes. The output of a sum v (fp32) is, in the
// forward, leaky(v) (leaky_out: the split conv1's leaky(h)) or v + r (conv2's
// y, r = x); in the gradient's launches (the kernel's GRAD instantiation),
// leaky'(m) v, plus r where r is given: dh = leaky'(g) v (m = g) and dx = gy
// + leaky'(x) v (r = gy, m = x), with leaky'(m) = 1 where m > 0, else the
// slope (the sign of g = leaky(h) is the sign of h).
struct Params {
  const void* r;  // added to the output, or null
  const void* m;  // GRAD: the output is scaled by leaky'(m)
  void* out;
  int C, T, taps, dilation, pad_left;
  int leaky_a;    // split mode: A is leaky(input) (conv1), else the input as it is
  int leaky_out;  // split mode, forward: out = leaky(v) (conv1)
  int w_stages, x_stages, batch;
};

// A fragments of one 128-byte step of input channels, for the frames
// row .. row + 8 of this thread (the m16n8k8 / m16n8k16 layout of its warp's
// 16 rows). From an activation window [KC][win] (frames fastest):
template <class E>
struct FragA;
template <>
struct FragA<float> {
  // four k8 steps, hi and lo parts: a[s][0..3] hi, a[s][4..7] lo
  static __device__ __forceinline__ void window(uint32_t (&a)[4][8], const float* w, int win, int row,
                                                bool apply_leaky, int tig) {
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const float* p = w + (8 * s + tig) * win + row;
      float v[4] = {p[0], p[8], p[4 * win], p[4 * win + 8]};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float u = apply_leaky ? leaky(v[i]) : v[i];
        a[s][i] = tf32(u);
        a[s][4 + i] = tf32(u - __uint_as_float(a[s][i]));
      }
    }
  }
  // from the resident leaky(h) tile [kTile][pitch words], channels c0..c0+31
  static __device__ __forceinline__ void resident(uint32_t (&a)[4][8], const uint32_t* h, int pitch,
                                                  int row, int c0, int tig) {
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const float* p = reinterpret_cast<const float*>(h) + row * pitch + c0 + 8 * s + tig;
      float v[4] = {p[0], p[8 * pitch], p[4], p[8 * pitch + 4]};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[s][i] = tf32(v[i]);
        a[s][4 + i] = tf32(v[i] - __uint_as_float(a[s][i]));
      }
    }
  }
};
template <>
struct FragA<bf16> {
  // four k16 steps of two channels per register
  static __device__ __forceinline__ void window(uint32_t (&a)[4][8], const bf16* w, int win, int row,
                                                bool apply_leaky, int tig) {
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const bf16* p = w + (16 * s + 2 * tig) * win + row;
      const bf16 v[8] = {p[0], p[win], p[8], p[win + 8],
                         p[8 * win], p[9 * win], p[8 * win + 8], p[9 * win + 8]};
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[s][i] = apply_leaky ? pack_bf16(leaky(__bfloat162float(v[2 * i])),
                                          leaky(__bfloat162float(v[2 * i + 1])))
                              : pack_raw(v[2 * i], v[2 * i + 1]);
    }
  }
  static __device__ __forceinline__ void resident(uint32_t (&a)[4][8], const uint32_t* h, int pitch,
                                                  int row, int c0, int tig) {
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const uint32_t* p = h + row * pitch + (c0 + 16 * s) / 2 + tig;
      a[s][0] = p[0];
      a[s][1] = p[8 * pitch];
      a[s][2] = p[4];
      a[s][3] = p[8 * pitch + 4];
    }
  }
};

// Keeps a group's A fragments (the registers its products read) alive up to
// this point, so that the next group's fragments load into other registers.
template <class E>
__device__ __forceinline__ void fence_frag(uint32_t (&a)[4][8]) {
#pragma unroll
  for (int s = 0; s < 4; ++s)
#pragma unroll
    for (int i = 0; i < 4 * Arith<E>::PARTS; ++i) asm volatile("" : "+r"(a[s][i])::"memory");
}

// The products of one 128-byte step: four k-steps against the weight stage
// at `wb` (shared-memory address; fp32: hi part, then lo part NP rows on).
// `first` overwrites the sums instead of adding to them.
template <class E, int NP>
__device__ __forceinline__ void mma_step(float (&d)[NP / 2], const uint32_t (&a)[4][8], uint32_t wb,
                                         bool first) {
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const uint64_t b_hi = sm90::desc_sw128(wb + 32 * s);
    const uint32_t(&hi)[4] = *reinterpret_cast<const uint32_t(*)[4]>(&a[s][0]);
    if constexpr (Arith<E>::PARTS == 2) {
      const uint64_t b_lo = sm90::desc_sw128(wb + NP * 128 + 32 * s);
      const uint32_t(&lo)[4] = *reinterpret_cast<const uint32_t(*)[4]>(&a[s][4]);
      Mma<E, NP>::run(d, lo, b_hi, !(first && s == 0));
      Mma<E, NP>::run(d, hi, b_lo, 1);
      Mma<E, NP>::run(d, hi, b_hi, 1);
    } else {
      Mma<E, NP>::run(d, hi, b_hi, !(first && s == 0));
    }
  }
}

template <class E, int NP, bool FUSED, bool FLUSH, bool GRAD>
__global__ void __launch_bounds__(kThreads, 1)
unit_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_w,
            const __grid_constant__ CUtensorMap map_w2, const Params p) {
  using A = Arith<E>;
  constexpr int KC = A::KC;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const int C = p.C, T = p.T;
  const int halo = p.dilation * (p.taps - 1);
  const int shift = lead(p.pad_left, sizeof(E)) - p.pad_left;  // window frame of tile frame 0, tap 0
  const Layout<E> L(C, window(halo, p.pad_left, sizeof(E)), NP, p.w_stages, p.x_stages, FUSED);
  const uint32_t base = sm90::smem_addr(smem);
  const uint32_t w_ring = base, x_ring = base + p.w_stages * L.w_stage;
  const uint32_t bars = base + L.bar_off;  // w_full, w_empty, x_full, x_empty
  const uint32_t w_full = bars, w_empty = bars + 8 * p.w_stages;
  const uint32_t x_full = bars + 16 * p.w_stages, x_empty = x_full + 8 * p.x_stages;

  const int chunks = (C + KC - 1) / KC;
  // Work items, walked by a persistent grid: (frame tile, batch) in the fused
  // mode, (N-channel slice, frame tile, batch) in the split one, the slice
  // fastest. The producer and the consumers walk the same items, so one
  // item's epilogue overlaps the next one's first loads.
  const int frame_tiles = (T + kTile - 1) / kTile;
  const int slices = FUSED ? 1 : (C + NP - 1) / NP;
  const int items = frame_tiles * slices * p.batch;
  struct Item {
    int t0, b, n_first, n_end;  // output channels: every pass of N (fused), the slice (split)
  };
  auto item = [&](int i) {
    const int s = i % slices, rest = i / slices;
    Item it;
    it.t0 = (rest % frame_tiles) * kTile;
    it.b = rest / frame_tiles;
    it.n_first = FUSED ? 0 : s * NP;
    it.n_end = FUSED ? C : it.n_first + NP;
    return it;
  };

  if (threadIdx.x == 0) {
    for (int i = 0; i < p.w_stages; ++i) {
      sm90::mbar_init(w_full + 8 * i, 1);
      sm90::mbar_init(w_empty + 8 * i, kConsumers / 32);  // one arrival per consumer warp
    }
    for (int i = 0; i < p.x_stages; ++i) {
      sm90::mbar_init(x_full + 8 * i, 1);
      sm90::mbar_init(x_empty + 8 * i, kConsumers / 32);
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // ---- producer warpgroup: one thread issues every load -----------------
    sm90::reg_dealloc<40>();
    if (threadIdx.x == kConsumers) {
      sm90::prefetch_map(&map_a);
      sm90::prefetch_map(&map_w);
      if (FUSED) sm90::prefetch_map(&map_w2);
      int ws = 0, wph = 0, xs = 0, xph = 0;
      auto load_w = [&](const CUtensorMap* map, int z, int ci0, int n0) {
        sm90::mbar_wait(w_empty + 8 * ws, wph ^ 1);
        sm90::mbar_expect_tx(w_full + 8 * ws, L.w_stage);
#pragma unroll
        for (int part = 0; part < A::PARTS; ++part)
          sm90::tma_load_3d(w_ring + ws * L.w_stage + part * NP * 128, map, w_full + 8 * ws, ci0,
                            n0, A::PARTS * z + part);
        if (++ws == p.w_stages) ws = 0, wph ^= 1;
      };
      for (int i = blockIdx.x; i < items; i += gridDim.x) {
        const Item it = item(i);
        for (int n0 = it.n_first; n0 < it.n_end; n0 += NP)
          for (int c = 0; c < chunks; ++c) {
            sm90::mbar_wait(x_empty + 8 * xs, xph ^ 1);
            sm90::mbar_expect_tx(x_full + 8 * xs, L.x_stage);
            sm90::tma_load_3d(x_ring + xs * L.x_stage, &map_a, x_full + 8 * xs,
                              it.t0 - lead(p.pad_left, sizeof(E)), c * KC, it.b);
            if (++xs == p.x_stages) xs = 0, xph ^= 1;
            for (int k = 0; k < p.taps; ++k) load_w(&map_w, k, c * KC, n0);
          }
        if (FUSED)
          for (int n0 = 0; n0 < C; n0 += NP)
            for (int c = 0; c < chunks; ++c) load_w(&map_w2, 0, c * KC, n0);
      }
    }
  } else {
    // ---- consumer warpgroups: 64 frames each -----------------------------
    sm90::reg_alloc<232>();
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int g = lane >> 2, tig = lane & 3;
    const int row = warp * 16 + g;  // this thread's first row of the tile (and row + 8)
    const uint8_t* x_ring_ptr = smem + p.w_stages * L.w_stage;
    uint32_t* hs = reinterpret_cast<uint32_t*>(smem + L.h_off);
    const int hp = h_pitch_words<E>(C);
    int ws = 0, wph = 0, xs = 0, xph = 0;

    if (FUSED) {  // the channels past C of the resident tile are read as zeros
      for (int i = lane; i < 16 * hp; i += 32) {
        const int r = warp * 16 + i / hp, word = i % hp;
        if (word * 4 >= C * (int)sizeof(E)) hs[r * hp + word] = 0u;
      }
      __syncwarp();
    }

    float acc[NP / 2];
    float part[FLUSH ? NP / 2 : 1] = {};
    uint32_t a0[4][8], a1[4][8];  // A fragments of two groups: one in flight, one loading

    // One pass: acc = the products of output channels n0 .. n0+NP-1, A from
    // the activation ring (conv1, split conv2) or the resident tile (fused
    // conv2). A group is one 128-byte step of input channels for one tap;
    // one group's products run while the next group's fragments load. With
    // FLUSH the sums of kFlushGroups groups gather in `part`, and the pipeline
    // drains there to add them to acc in fp32.
    auto gemm = [&](int n0, bool from_ring, bool leaky_a) {
#pragma unroll
      for (int i = 0; i < NP / 2; ++i) acc[i] = 0.f;
      if constexpr (!FLUSH) sm90::fence_acc(acc);
      const int taps = from_ring ? p.taps : 1;
      const int groups = chunks * taps;
      int held = -1;  // the weight stage of the group in flight
      auto step = [&](uint32_t(&ab)[4][8], uint32_t(&other)[4][8], int g) {
        const int c = g / taps, k = g - c * taps;
        if (from_ring) {
          if (k == 0) sm90::mbar_wait(x_full + 8 * xs, xph);
          const E* win = reinterpret_cast<const E*>(x_ring_ptr + xs * L.x_stage);
          FragA<E>::window(ab, win, L.win, row + shift + k * p.dilation, leaky_a, tig);
          if (k == taps - 1) {  // the window is in registers now: its stage may refill
            __syncwarp();
            if (lane == 0) sm90::mbar_arrive(x_empty + 8 * xs);
            if (++xs == p.x_stages) xs = 0, xph ^= 1;
          }
        } else {
          FragA<E>::resident(ab, hs, hp, row, c * KC, tig);
        }
        sm90::mbar_wait(w_full + 8 * ws, wph);
        const uint32_t wb = w_ring + ws * L.w_stage;
        if constexpr (FLUSH) {
          const bool first = g % kFlushGroups == 0;
          if (first) sm90::fence_acc(part);
          sm90::wgmma_fence();
          mma_step<E, NP>(part, ab, wb, first);  // a flush's first product overwrites
        } else {
          sm90::wgmma_fence();
          mma_step<E, NP>(acc, ab, wb, false);
        }
        sm90::wgmma_commit();
        sm90::wgmma_wait<1>();  // the previous group is done
        // `other` fed that group: keep its registers apart from `ab`'s until here
        fence_frag<E>(other);
        __syncwarp();
        if (lane == 0 && held >= 0) sm90::mbar_arrive(w_empty + 8 * held);
        held = ws;
        if (++ws == p.w_stages) ws = 0, wph ^= 1;
      };
      // Drains the products in flight and frees the last group's stage.
      auto drain = [&]() {
        sm90::wgmma_wait<0>();
        __syncwarp();
        if (lane == 0 && held >= 0) sm90::mbar_arrive(w_empty + 8 * held);
        held = -1;
      };
      if constexpr (FLUSH) {
        // a flush after every kFlushGroups groups, outside the steps, so that
        // the sums are read only where no product is in flight
        static_assert(kFlushGroups == 3, "the flush block below is written for three groups");
        for (int g = 0; g < groups; g += kFlushGroups) {
          step(a0, a1, g);
          if (g + 1 < groups) step(a1, a0, g + 1);
          if (g + 2 < groups) step(a0, a1, g + 2);
          drain();
          sm90::fence_acc(part);
#pragma unroll
          for (int i = 0; i < NP / 2; ++i) acc[i] += part[i];
        }
      } else {
        for (int g = 0; g < groups; g += 2) {
          step(a0, a1, g);
          if (g + 1 < groups) step(a1, a0, g + 1);
        }
        drain();
        sm90::fence_acc(acc);
      }
    };

    // acc[4 j + r] holds row (row + 8 (r >> 1)), channel n0 + 8 j + 2 tig + (r & 1).
    // r (and, GRAD, m) are read in batches of JB n8 blocks, all loads of a
    // batch before its stores: one latency per batch, not one per value.
    // The forward: out = v + r (residual) or leaky(v); GRAD: out = leaky'(m) v
    // (+ r where given).
    auto store_global = [&](const Item& it, int n0, bool residual) {
      const size_t off = (size_t)it.b * C * T;
      const E* __restrict__ xb = static_cast<const E*>(p.r) + off;
      const E* __restrict__ mb = static_cast<const E*>(p.m) + off;
      E* __restrict__ ob = static_cast<E*>(p.out) + off;
      constexpr int JB = NP / 8 % 6 == 0 ? 6 : 4;
#pragma unroll
      for (int j0 = 0; j0 < NP / 8; j0 += JB) {
        float xv[JB][4];
        [[maybe_unused]] float mv[GRAD ? JB : 1][4];
#pragma unroll
        for (int j = 0; j < JB; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int t = it.t0 + row + 8 * (r >> 1);
            const int co = n0 + 8 * (j0 + j) + 2 * tig + (r & 1);
            xv[j][r] = residual && co < C && t < T ? (float)xb[(size_t)co * T + t] : 0.f;
            if constexpr (GRAD) mv[j][r] = co < C && t < T ? (float)mb[(size_t)co * T + t] : 1.f;
          }
#pragma unroll
        for (int j = 0; j < JB; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int t = it.t0 + row + 8 * (r >> 1);
            const int co = n0 + 8 * (j0 + j) + 2 * tig + (r & 1);
            const float v = acc[4 * (j0 + j) + r];
            if (co < C && t < T) {
              if constexpr (GRAD)
                ob[(size_t)co * T + t] = (E)((mv[j][r] > 0.f ? v : kSlope * v) + xv[j][r]);
              else
                ob[(size_t)co * T + t] = (E)(residual ? v + xv[j][r] : leaky(v));
            }
          }
      }
    };

    for (int i = blockIdx.x; i < items; i += gridDim.x) {
      const Item it = item(i);
      if (!FUSED) {
        gemm(it.n_first, true, p.leaky_a);
        store_global(it, it.n_first, GRAD ? p.r != nullptr : !p.leaky_out);
        continue;
      }
      for (int n0 = 0; n0 < C; n0 += NP) {
        gemm(n0, true, true);
#pragma unroll
        for (int j = 0; j < NP / 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {  // rows row and row + 8
            const int co = n0 + 8 * j + 2 * tig;
            if (co < C) {
              const float v0 = leaky(acc[4 * j + 2 * h]), v1 = leaky(acc[4 * j + 2 * h + 1]);
              uint32_t* dst = hs + (row + 8 * h) * hp;
              if constexpr (sizeof(E) == 4) {
                dst[co] = __float_as_uint(v0);
                dst[co + 1] = __float_as_uint(v1);
              } else {
                dst[co / 2] = pack_bf16(v0, v1);
              }
            }
          }
      }
      __syncwarp();  // each warp reads back only the rows it wrote
      for (int n0 = 0; n0 < C; n0 += NP) {
        gemm(n0, false, false);
        store_global(it, n0, true);
      }
    }
  }
}

// w1 [C_out, C_in, K] -> [K * PARTS, C_out, C_in], w2 [C_out, C_in] ->
// [PARTS, C_out, C_in] (fp32: TF32 hi and lo parts; bf16: w1 permuted, w2
// used as it is).
__global__ void prepare_weights_f32(const float* __restrict__ w1, const float* __restrict__ w2,
                                    float* __restrict__ s1, float* __restrict__ s2, int C, int K) {
  const size_t cc = (size_t)C * C, n1 = K * cc;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n1 + cc;
       i += (size_t)gridDim.x * blockDim.x) {
    float v;
    float* hi;
    if (i < n1) {
      const int k = (int)(i / cc);
      const size_t r = i - k * cc;  // co * C + ci
      v = w1[r * K + k];
      hi = s1 + 2 * k * cc + r;
    } else {
      v = w2[i - n1];
      hi = s2 + (i - n1);
    }
    const float h = __uint_as_float(tf32(v));
    hi[0] = h;
    hi[cc] = __uint_as_float(tf32(v - h));
  }
}

__global__ void prepare_weights_bf16(const bf16* __restrict__ w1, bf16* __restrict__ s1, int C,
                                     int K) {
  const size_t cc = (size_t)C * C, n1 = K * cc;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n1;
       i += (size_t)gridDim.x * blockDim.x) {
    const int k = (int)(i / cc);
    const size_t r = i - k * cc;
    s1[i] = w1[r * K + k];
  }
}

int max_smem_optin() {
  int dev = 0, bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess)
    return 0;
  return bytes;
}

int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 1;
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return 1;
  return n;
}

constexpr int kMaxDevices = 64;

// Raises the dynamic shared-memory cap of `kernel` to the current device's
// opt-in maximum, once per device (`raised` is the kernel's own record).
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

// cuTensorMapEncodeTiled lives in the driver API. It is reached through the
// runtime's cudaGetDriverEntryPoint, so the library needs no -lcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 3-D map (dims innermost first, contiguous) read in boxes of `box`.
bool make_map(CUtensorMap* map, bool is_bf16, const void* ptr, const uint64_t (&dims)[3],
              const uint32_t (&box)[3], bool swizzle) {
  const EncodeTiled enc = encode_tiled();
  if (!enc) return false;
  const uint64_t elem = is_bf16 ? 2 : 4;
  const cuuint64_t d[3] = {dims[0], dims[1], dims[2]};
  const cuuint64_t strides[2] = {dims[0] * elem, dims[0] * dims[1] * elem};
  const cuuint32_t b[3] = {box[0], box[1], box[2]}, ones[3] = {1, 1, 1};
  return enc(map, is_bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
             const_cast<void*>(ptr), d, strides, b, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
             swizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// How a launch runs: the fused forward, a split-mode launch of the forward,
// or a split-mode launch with the gradient's epilogue.
enum Mode { kFused, kSplit, kGrad };

template <class E, int NP, bool FUSED, bool FLUSH, bool GRAD>
int launch(const CUtensorMap& ma, const CUtensorMap& mw, const CUtensorMap& mw2, const Params& p,
           int B, cudaStream_t stream) {
  static bool raised[kMaxDevices] = {};
  const cudaError_t err = raise_smem_cap(unit_kernel<E, NP, FUSED, FLUSH, GRAD>, raised);
  if (err != cudaSuccess) return (int)err;
  const Layout<E> L(p.C, window(p.dilation * (p.taps - 1), p.pad_left, sizeof(E)), NP, p.w_stages,
                    p.x_stages, FUSED);
  // one block per SM (each takes most of the SM's shared memory), or one per item
  const long items = (long)(p.T + kTile - 1) / kTile * (FUSED ? 1 : (p.C + NP - 1) / NP) * B;
  const int grid = (int)(items < sm_count() ? items : sm_count());
  unit_kernel<E, NP, FUSED, FLUSH, GRAD><<<grid, kThreads, L.bytes, stream>>>(ma, mw, mw2, p);
  return (int)cudaGetLastError();
}

template <class E, int NP, bool FLUSH>
int launch_mode(Mode mode, const CUtensorMap& ma, const CUtensorMap& mw, const CUtensorMap& mw2,
                const Params& p, int B, cudaStream_t stream) {
  switch (mode) {
    case kFused: return launch<E, NP, true, FLUSH, false>(ma, mw, mw2, p, B, stream);
    case kSplit: return launch<E, NP, false, FLUSH, false>(ma, mw, mw2, p, B, stream);
    default: return launch<E, NP, false, FLUSH, true>(ma, mw, mw2, p, B, stream);
  }
}

// Dispatches the instantiated (type, N, flush) combinations.
template <class E>
int launch_any(int np, Mode mode, bool flush, const CUtensorMap& ma, const CUtensorMap& mw,
               const CUtensorMap& mw2, const Params& p, int B, cudaStream_t stream) {
  if constexpr (sizeof(E) == 4) {
    if (np == 96)
      return flush ? launch_mode<E, 96, true>(mode, ma, mw, mw2, p, B, stream)
                   : launch_mode<E, 96, false>(mode, ma, mw, mw2, p, B, stream);
  } else if (!flush) {
    if (np == 96) return launch_mode<E, 96, false>(mode, ma, mw, mw2, p, B, stream);
    if (np == 192) return launch_mode<E, 192, false>(mode, ma, mw, mw2, p, B, stream);
  }
  return (int)cudaErrorInvalidValue;
}

template <class E>
int forward(const void* x, const void* w1, const void* w2, void* y, void* wbuf, void* hbuf, int B,
            int C, int T, int K, int dilation, int pad_left, int fused, int np, int w_stages,
            int x_stages, int flush, cudaStream_t stream) {
  using A = Arith<E>;
  const bool is_bf16 = sizeof(E) == 2;
  const int halo = dilation * (K - 1);
  if (B < 1 || C < 1 || T < 1 || K < 1 || dilation < 1 || pad_left < 0 || pad_left > halo ||
      C * (int)sizeof(E) % 16 != 0 || T * (int)sizeof(E) % 16 != 0 ||
      window(halo, pad_left, sizeof(E)) > kMaxBox || w_stages < 2 || w_stages > kMaxStages ||
      x_stages < 2 || x_stages > kMaxStages ||
      Layout<E>(C, window(halo, pad_left, sizeof(E)), np, w_stages, x_stages, fused).bytes >
          max_smem_optin() ||
      Layout<E>(C, window(0, 0, sizeof(E)), np, w_stages, x_stages, false).bytes >
          max_smem_optin())
    return (int)cudaErrorInvalidValue;

  // weights: fp32 split into TF32 parts, laid out [K * PARTS, C_out, C_in]
  const size_t cc = (size_t)C * C;
  E* s1 = static_cast<E*>(wbuf);
  const E* s2 = static_cast<const E*>(w2);
  if constexpr (sizeof(E) == 4) {
    prepare_weights_f32<<<264, 256, 0, stream>>>(static_cast<const float*>(w1),
                                                  static_cast<const float*>(w2), s1,
                                                  s1 + A::PARTS * K * cc, C, K);
    s2 = s1 + A::PARTS * K * cc;
  } else {
    prepare_weights_bf16<<<264, 256, 0, stream>>>(static_cast<const bf16*>(w1), s1, C, K);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const uint32_t box_w[3] = {(uint32_t)A::KC, (uint32_t)np, 1};
  CUtensorMap map_x, map_w1, map_w2;
  if (!make_map(&map_x, is_bf16, x, {(uint64_t)T, (uint64_t)C, (uint64_t)B},
                {(uint32_t)window(halo, pad_left, sizeof(E)), (uint32_t)A::KC, 1}, false) ||
      !make_map(&map_w1, is_bf16, s1, {(uint64_t)C, (uint64_t)C, (uint64_t)(A::PARTS * K)}, box_w,
                true) ||
      !make_map(&map_w2, is_bf16, s2, {(uint64_t)C, (uint64_t)C, (uint64_t)A::PARTS}, box_w, true))
    return (int)cudaErrorInvalidValue;

  if (fused) {
    const Params p{x, nullptr, y, C, T, K, dilation, pad_left, 1, 0, w_stages, x_stages, B};
    return launch_any<E>(np, kFused, flush, map_x, map_w1, map_w2, p, B, stream);
  }
  // split: conv1 -> leaky(h) in hbuf [B, C, T]; conv2 streams it back
  const Params p1{nullptr, nullptr, hbuf, C, T, K, dilation, pad_left, 1, 1, w_stages, x_stages, B};
  int e = launch_any<E>(np, kSplit, flush, map_x, map_w1, map_w2, p1, B, stream);
  if (e != 0) return e;
  CUtensorMap map_h;
  if (!make_map(&map_h, is_bf16, hbuf, {(uint64_t)T, (uint64_t)C, (uint64_t)B},
                {(uint32_t)window(0, 0, sizeof(E)), (uint32_t)A::KC, 1}, false))
    return (int)cudaErrorInvalidValue;
  const Params p2{x, nullptr, y, C, T, 1, 1, 0, 0, 0, w_stages, x_stages, B};
  return launch_any<E>(np, kSplit, flush, map_h, map_w2, map_w2, p2, B, stream);
}

// ---- the gradient ----------------------------------------------------------
//
// Given gy = dL/dy, with a = leaky(x), h = conv_d(a, w1), g = leaky(h):
//   dh  = leaky'(h) * (w2^T gy)                      the forward's conv2, transposed
//   dx  = gy + leaky'(x) * conv_d^T(dh, w1)          its conv1, transposed
//   dw2 = sum_{b,t} gy g^T,  dw1[:, :, k] = sum_{b,t} dh a[t + k d - pad_left]^T
// The data gradients are the forward's split-mode launches over other
// operands: conv1 again to recompute g (nothing of the forward is kept), then
// the 1x1 launch over gy with w2^T (epilogue leaky'(g)) writing dh, then the
// dilated launch over dh with w1 transposed and its taps reversed, the pads
// swapped (the transposed convolution is a convolution), epilogue gy +
// leaky'(x) * v. The weight gradients are GEMMs of C x C outputs whose
// reduction runs over every frame of the batch: `wgrad_kernel` below.
//
// What bounds it on the H100: from x, the weights and gy the gradient needs
// h again (its sign is leaky'(h); dw2 reads leaky(h)), so 2 (3 K + 2) C^2 T B
// FLOP, 2.75 forwards' worth at K = 3, at 3xTF32's 165 TFLOP/s or bf16's 989;
// its bytes (x, gy, dx, g and dh each through device memory once or twice)
// are a few microseconds at 3.35 TB/s. The data launches are the forward's
// split mode (dx's convolution reads dh across tile edges, so dh goes
// through device memory, as does g, which dw2 reads too); the weight
// gradients run on mma.sync, far under the tensor cores' rate (see there).

// Frames of one reduction step of the weight gradients, and the block's
// C x C output tile: 64 output rows (p) x 64 columns (q), four warps of 32 x 32.
constexpr int kWgFrames = 64;
constexpr int kWgTile = 64;
constexpr int kWgThreads = 128;
constexpr int kWgStages = 2;
constexpr int kWgTaps = 3;  // taps per block (acc registers); more taps take more blocks
// fp32: k8 steps whose products (24 per output each) gather in the tensor
// cores before a flush into fp32 registers: 48, half the forward's 96
constexpr int kWgFlush = 2;

// TF32 by integer ops (cvt is slower): rounded to nearest, ties away from 0.
__device__ __forceinline__ uint32_t tf32_round(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

// v = hi + lo in TF32 parts for 3xTF32: hi rounded, lo the rest rounded
// too (the tensor cores would truncate it, a bias that sums over the
// frames' thousands of products).
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  hi = tf32_round(v);
  lo = tf32_round(v - __uint_as_float(hi));
}

// Frames of a weight-gradient smem row: at least `frames`, whole 16-byte TMA
// rows, and 4 mod 32 words, so that a fragment load (8 rows x 4 frames of
// 32-bit words) hits 32 distinct banks.
template <class E>
__host__ __device__ constexpr int wg_pitch(int frames) {
  int w = round_up(frames, 16 / (int)sizeof(E));
  while ((w * (int)sizeof(E) / 4) % 32 != 4) w += 16 / (int)sizeof(E);
  return w;
}

// Frames of Q's window: the chunk, the taps of a block ((taps - 1) d) and the
// offset of the first tap from a 16-byte boundary.
template <class E>
__host__ __device__ constexpr int wg_q_pitch(int taps, int dilation) {
  return wg_pitch<E>(kWgFrames + (taps - 1) * dilation + 16 / (int)sizeof(E) - 1);
}

// The stages' P and Q boxes, then (fp32) Q's lo parts, then the barriers.
template <class E>
__host__ __device__ constexpr int wg_smem_bytes(int pitch_q) {
  return 1024 + (kWgStages * (wg_pitch<E>(kWgFrames) + pitch_q) + (sizeof(E) == 4) * pitch_q) *
                    kWgTile * (int)sizeof(E) +
         8 * kWgStages;
}

struct WgParams {
  void* out;  // splits == 1: the gradient, E [C][C][taps]; else fp32 partials [splits][C][C][taps]
  int C, T, taps, dilation, pad_left, batch;
  int leaky_q;  // Q is leaky(input)
  int splits;   // blocks that share one output tile's frames, each over its own range
  int pitch_q;
};

// D[k][p][q] = sum over the batch's frames t of P[b, p, t] . f(Q[b, q, t + k d -
// pad_left]) for the taps k of blockIdx.z's group, f = leaky or identity, Q zero
// outside [0, T): dw1 (P = dh, Q = x, leaky) and dw2 (P = gy, Q = g, one tap).
// blockIdx.x is the 64 x 64 output tile, blockIdx.y the split of the frames.
//
// Both operands are activations [B, C, T], frames contiguous: the reduction
// dim is the fast one of both, and Q's taps are shifts by k d frames, not a
// multiple of any swizzle atom. So both are read from shared memory into
// registers at any frame (mma.sync fragments, like the forward's A), from
// TMA boxes [64 channels][pitch frames] (zero fill is the padding) in a ring
// of two stages. Q's box is read by every tap, so once it has landed the
// block prepares it in place, once: leaky where asked and (fp32) its TF32
// hi part, its lo part beside it; the taps' fragment loads then do no
// arithmetic. fp32 splits P in registers (3xTF32) and flushes the tensor
// cores' sums into fp32 registers every kWgFlush k8 steps; bf16 multiplies
// bf16 with fp32 sums. The partial sums of the splits are added in a fixed
// order by `wgrad_reduce`: no atomics, the same bits on every run.
//
// What bounds it: 2 K C^2 T B FLOP (dw1; dw2 a K-th of it), at 3xTF32's
// 165 TFLOP/s or bf16's 989 on the H100, over a few MB of activations. It
// runs far from that: mma.sync, not wgmma (whose tf32 B must be K-major in
// swizzled shared memory, which the taps' shifts are not), one 64 x 64
// tile of four warps per block, two blocks per SM.
template <class E, int TK>
__global__ void __launch_bounds__(kWgThreads)
wgrad_kernel(const __grid_constant__ CUtensorMap map_p, const __grid_constant__ CUtensorMap map_q,
             const WgParams p) {
  constexpr int step = 16 / (int)sizeof(E);
  constexpr int PP = wg_pitch<E>(kWgFrames);
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const int C = p.C, QP = p.pitch_q;
  const int p_bytes = kWgTile * PP * (int)sizeof(E), q_bytes = kWgTile * QP * (int)sizeof(E);
  const int stage_bytes = p_bytes + q_bytes;  // both multiples of 1024 (wg_pitch)
  const uint32_t base = sm90::smem_addr(smem);
  float* q_lo = reinterpret_cast<float*>(smem + kWgStages * stage_bytes);  // fp32
  const uint32_t full = base + kWgStages * stage_bytes + (sizeof(E) == 4) * q_bytes;

  const int q_tiles = (C + kWgTile - 1) / kWgTile;
  const int p0 = blockIdx.x / q_tiles * kWgTile, q0 = blockIdx.x % q_tiles * kWgTile;
  const int split = blockIdx.y, k0 = blockIdx.z * TK;
  // this split's chunks: an equal share of the batch's, sample-major
  const int per_b = (p.T + kWgFrames - 1) / kWgFrames;
  const long all = (long)p.batch * per_b;
  const int c_begin = (int)(split * all / p.splits);
  const int n = (int)((split + 1) * all / p.splits) - c_begin;
  // Q's window starts at t0 + k0 d - pad_left, rounded down to 16 bytes
  const int shift = k0 * p.dilation - p.pad_left;
  const int q_off = ((shift % step) + step) % step;
  const int q_rel = shift - q_off;

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < kWgStages; ++s) sm90::mbar_init(full + 8 * s, 1);
    sm90::mbar_fence_init();
  }
  __syncthreads();
  auto issue = [&](int i) {  // chunk c_begin + i into stage i % kWgStages
    const int c = c_begin + i, b = c / per_b, t0 = (c - b * per_b) * kWgFrames;
    const int s = i % kWgStages;
    const uint32_t bar = full + 8 * s, dst = base + s * stage_bytes;
    sm90::mbar_expect_tx(bar, stage_bytes);
    sm90::tma_load_3d(dst, &map_p, bar, t0, p0, b);
    sm90::tma_load_3d(dst + p_bytes, &map_q, bar, t0 + q_rel, q0, b);
  };
  if (tid == 0) {
    sm90::prefetch_map(&map_p);
    sm90::prefetch_map(&map_q);
    for (int i = 0; i < kWgStages && i < n; ++i) issue(i);
  }

  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int pr = 32 * (warp >> 1) + g, qr = 32 * (warp & 1) + g;  // this thread's first rows
  float acc[TK][2][4][4];
#pragma unroll
  for (int j = 0; j < TK; ++j)
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[j][mi][ni][r] = 0.f;

  for (int i = 0; i < n; ++i) {
    const int s = i % kWgStages;
    sm90::mbar_wait(full + 8 * s, (i / kWgStages) & 1);
    const E* P = reinterpret_cast<const E*>(smem + s * stage_bytes);
    E* Q = reinterpret_cast<E*>(smem + s * stage_bytes + p_bytes);
    // Q prepared in place, once for every tap
    if constexpr (sizeof(E) == 4) {
      for (int e = tid; e < kWgTile * QP; e += kWgThreads) {
        const float v = p.leaky_q ? leaky(Q[e]) : Q[e];
        uint32_t hi, lo;
        split_tf32(v, hi, lo);
        Q[e] = __uint_as_float(hi);
        q_lo[e] = __uint_as_float(lo);
      }
    } else if (p.leaky_q) {
      uint32_t* q2 = reinterpret_cast<uint32_t*>(Q);
      for (int e = tid; e < kWgTile * QP / 2; e += kWgThreads) {
        const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(q2 + e);
        q2[e] = pack_bf16(leaky(__low2float(v)), leaky(__high2float(v)));
      }
    }
    __syncthreads();
    if constexpr (sizeof(E) == 4) {
#pragma unroll 2
      for (int ks0 = 0; ks0 < kWgFrames / 8; ks0 += kWgFlush) {
        uint32_t ah[kWgFlush][2][4], al[kWgFlush][2][4];
#pragma unroll
        for (int f = 0; f < kWgFlush; ++f)
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            const float* a = reinterpret_cast<const float*>(P) + (pr + 16 * mi) * PP +
                             8 * (ks0 + f) + tig;
            const float v[4] = {a[0], a[8 * PP], a[4], a[8 * PP + 4]};
#pragma unroll
            for (int r = 0; r < 4; ++r) split_tf32(v[r], ah[f][mi][r], al[f][mi][r]);
          }
#pragma unroll
        for (int j = 0; j < TK; ++j) {
          if (k0 + j >= p.taps) break;
          uint32_t bh[kWgFlush][4][2], bl[kWgFlush][4][2];
#pragma unroll
          for (int f = 0; f < kWgFlush; ++f)
#pragma unroll
            for (int ni = 0; ni < 4; ++ni) {
              const int e = (qr + 8 * ni) * QP + q_off + j * p.dilation + 8 * (ks0 + f) + tig;
              const uint32_t* hi = reinterpret_cast<const uint32_t*>(Q);
              const uint32_t* lo = reinterpret_cast<const uint32_t*>(q_lo);
              bh[f][ni][0] = hi[e];
              bh[f][ni][1] = hi[e + 4];
              bl[f][ni][0] = lo[e];
              bl[f][ni][1] = lo[e + 4];
            }
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)
#pragma unroll
            for (int ni = 0; ni < 4; ++ni) {
              float t[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
              for (int f = 0; f < kWgFlush; ++f) {
                sm90::mma_tf32_m16n8k8(t, al[f][mi], bh[f][ni]);
                sm90::mma_tf32_m16n8k8(t, ah[f][mi], bl[f][ni]);
                sm90::mma_tf32_m16n8k8(t, ah[f][mi], bh[f][ni]);
              }
#pragma unroll
              for (int r = 0; r < 4; ++r) acc[j][mi][ni][r] += t[r];
            }
        }
      }
    } else {
#pragma unroll 2
      for (int ks = 0; ks < kWgFrames / 16; ++ks) {
        uint32_t a[2][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          const bf16* ap = reinterpret_cast<const bf16*>(P) + (pr + 16 * mi) * PP + 16 * ks + 2 * tig;
          a[mi][0] = *reinterpret_cast<const uint32_t*>(ap);
          a[mi][1] = *reinterpret_cast<const uint32_t*>(ap + 8 * PP);
          a[mi][2] = *reinterpret_cast<const uint32_t*>(ap + 8);
          a[mi][3] = *reinterpret_cast<const uint32_t*>(ap + 8 * PP + 8);
        }
#pragma unroll
        for (int j = 0; j < TK; ++j) {
          if (k0 + j >= p.taps) break;
          // an even offset reads each pair as one word; an odd one, two halves
          const int off = q_off + j * p.dilation;
          uint32_t b[4][2];
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) {
            const bf16* q = Q + (qr + 8 * ni) * QP + off + 16 * ks + 2 * tig;
#pragma unroll
            for (int r = 0; r < 2; ++r)
              b[ni][r] = off & 1 ? pack_raw(q[8 * r], q[8 * r + 1])
                                 : *reinterpret_cast<const uint32_t*>(q + 8 * r);
          }
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)
#pragma unroll
            for (int ni = 0; ni < 4; ++ni) sm90::mma_bf16_m16n8k16(acc[j][mi][ni], a[mi], b[ni]);
        }
      }
    }
    // the stage's next writer is TMA (the async proxy): order this block's
    // writes to it before that
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();  // every warp is done with stage s: it may refill
    if (tid == 0 && i + kWgStages < n) issue(i + kWgStages);
  }

  const size_t cct = (size_t)C * C * p.taps;
#pragma unroll
  for (int j = 0; j < TK; ++j) {
    const int k = k0 + j;
    if (k >= p.taps) break;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int row = p0 + pr + 16 * mi + 8 * (r >> 1);
          const int col = q0 + qr - g + 8 * ni + 2 * tig + (r & 1);
          if (row >= C || col >= C) continue;
          const size_t idx = ((size_t)row * C + col) * p.taps + k;
          if (p.splits == 1)
            static_cast<E*>(p.out)[idx] = (E)acc[j][mi][ni][r];
          else
            static_cast<float*>(p.out)[split * cct + idx] = acc[j][mi][ni][r];
        }
  }
}

// out[i] = the sum of the splits' partials, in split order, rounded once.
template <class E>
__global__ void wgrad_reduce(const float* __restrict__ part, E* __restrict__ out, size_t n,
                             int splits) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    float v = 0.f;
    for (int s = 0; s < splits; ++s) v += part[s * n + i];
    out[i] = (E)v;
  }
}

// The weight gradient of one convolution into `out` (E, [C][C][taps]), through
// `part` (fp32, splits x C C taps) when splits > 1.
template <class E>
int wgrad(const void* P, const void* Q, void* out, float* part, int B, int C, int T, int taps,
          int dilation, int pad_left, bool leaky_q, int splits, cudaStream_t stream) {
  const bool is_bf16 = sizeof(E) == 2;
  const int tk = taps == 1 ? 1 : kWgTaps;
  const int pitch_q = wg_q_pitch<E>(tk < taps ? tk : taps, dilation);
  const int bytes = wg_smem_bytes<E>(pitch_q);
  if (splits < 1 || pitch_q > kMaxBox || bytes > max_smem_optin() || (splits > 1 && !part))
    return (int)cudaErrorInvalidValue;
  CUtensorMap map_p, map_q;
  if (!make_map(&map_p, is_bf16, P, {(uint64_t)T, (uint64_t)C, (uint64_t)B},
                {(uint32_t)wg_pitch<E>(kWgFrames), (uint32_t)kWgTile, 1}, false) ||
      !make_map(&map_q, is_bf16, Q, {(uint64_t)T, (uint64_t)C, (uint64_t)B},
                {(uint32_t)pitch_q, (uint32_t)kWgTile, 1}, false))
    return (int)cudaErrorInvalidValue;
  const WgParams wp{splits == 1 ? out : part, C, T, taps, dilation, pad_left, B, (int)leaky_q,
                    splits, pitch_q};
  const int tiles = (C + kWgTile - 1) / kWgTile;
  const dim3 grid(tiles * tiles, splits, (taps + tk - 1) / tk);
  cudaError_t err;
  if (tk == 1) {
    static bool raised[kMaxDevices] = {};
    if ((err = raise_smem_cap(wgrad_kernel<E, 1>, raised)) != cudaSuccess) return (int)err;
    wgrad_kernel<E, 1><<<grid, kWgThreads, bytes, stream>>>(map_p, map_q, wp);
  } else {
    static bool raised[kMaxDevices] = {};
    if ((err = raise_smem_cap(wgrad_kernel<E, kWgTaps>, raised)) != cudaSuccess) return (int)err;
    wgrad_kernel<E, kWgTaps><<<grid, kWgThreads, bytes, stream>>>(map_p, map_q, wp);
  }
  if ((err = cudaGetLastError()) != cudaSuccess || splits == 1) return (int)err;
  const size_t n = (size_t)C * C * taps;
  wgrad_reduce<E><<<(int)((n + 255) / 256 < 1024 ? (n + 255) / 256 : 1024), 256, 0, stream>>>(
      part, static_cast<E*>(out), n, splits);
  return (int)cudaGetLastError();
}

// w1 [C_out, C_in, K] and w2 [C_out, C_in] -> the forward's w1 [K * PARTS, C_out,
// C_in] (the recompute of g), w1 transposed with its taps reversed [K * PARTS,
// C_in, C_out] (dx) and w2^T [PARTS, C_in, C_out] (dh); fp32 as TF32 hi and lo
// parts, bf16 as it is. A block transposes one 32 x 32 tile of tap
// blockIdx.z (z == K: w2) through shared memory, so that reads and writes
// both run along rows.
template <class E>
__global__ void prepare_weights_bwd(const E* __restrict__ w1, const E* __restrict__ w2,
                                    E* __restrict__ s1, E* __restrict__ s1t, E* __restrict__ s2t,
                                    int C, int K) {
  constexpr int parts = Arith<E>::PARTS;
  __shared__ E tile[32][33];
  const size_t cc = (size_t)C * C;
  const int k = blockIdx.z, ci0 = blockIdx.x * 32, co0 = blockIdx.y * 32;
  auto put = [&](E* dst, E v) {
    if constexpr (parts == 2) {
      const float h = __uint_as_float(tf32(v));
      dst[0] = h;
      dst[cc] = __uint_as_float(tf32(v - h));
    } else {
      dst[0] = v;
    }
  };
  for (int j = threadIdx.y; j < 32; j += blockDim.y) {
    const int co = co0 + j, ci = ci0 + threadIdx.x;
    if (co < C && ci < C) {
      const size_t r = (size_t)co * C + ci;
      const E v = k == K ? w2[r] : w1[r * K + k];
      tile[j][threadIdx.x] = v;
      if (k < K) put(s1 + parts * k * cc + r, v);
    }
  }
  __syncthreads();
  E* dst = k == K ? s2t : s1t + parts * (K - 1 - k) * cc;
  for (int j = threadIdx.y; j < 32; j += blockDim.y) {
    const int ci = ci0 + j, co = co0 + threadIdx.x;
    if (co < C && ci < C) put(dst + (size_t)ci * C + co, tile[threadIdx.x][j]);
  }
}

template <class E>
int backward(const void* x, const void* w1, const void* w2, const void* gy, void* dx, void* dw1,
             void* dw2, void* work, float* part, int B, int C, int T, int K, int dilation,
             int pad_left, int np, int w_stages, int x_stages, int flush, int splits1,
             int splits2, cudaStream_t stream) {
  using A = Arith<E>;
  const bool is_bf16 = sizeof(E) == 2;
  const int halo = dilation * (K - 1), pad_right = halo - pad_left;
  auto fits = [&](int win) {
    return win <= kMaxBox &&
           Layout<E>(C, win, np, w_stages, x_stages, false).bytes <= max_smem_optin();
  };
  if (B < 1 || C < 1 || T < 1 || K < 1 || dilation < 1 || pad_left < 0 || pad_left > halo ||
      C * (int)sizeof(E) % 16 != 0 || T * (int)sizeof(E) % 16 != 0 || w_stages < 2 ||
      w_stages > kMaxStages || x_stages < 2 || x_stages > kMaxStages ||
      !fits(window(halo, pad_left, sizeof(E))) || !fits(window(halo, pad_right, sizeof(E))))
    return (int)cudaErrorInvalidValue;

  // work: the three prepared weights, then g and dh [B, C, T]
  const size_t cc = (size_t)C * C, bct = (size_t)B * C * T;
  E* s1 = static_cast<E*>(work);
  E* s1t = s1 + A::PARTS * K * cc;
  E* s2t = s1t + A::PARTS * K * cc;
  E* g = s2t + A::PARTS * cc;
  E* dh = g + bct;
  const dim3 tiles((C + 31) / 32, (C + 31) / 32, K + 1);
  prepare_weights_bwd<E><<<tiles, dim3(32, 8), 0, stream>>>(
      static_cast<const E*>(w1), static_cast<const E*>(w2), s1, s1t, s2t, C, K);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const uint64_t act[3] = {(uint64_t)T, (uint64_t)C, (uint64_t)B};
  const uint32_t box_w[3] = {(uint32_t)A::KC, (uint32_t)np, 1};
  CUtensorMap map_x, map_w1, map_gy, map_w2t, map_dh, map_w1t;
  if (!make_map(&map_x, is_bf16, x, act, {(uint32_t)window(halo, pad_left, sizeof(E)),
                                          (uint32_t)A::KC, 1}, false) ||
      !make_map(&map_w1, is_bf16, s1, {(uint64_t)C, (uint64_t)C, (uint64_t)(A::PARTS * K)}, box_w,
                true))
    return (int)cudaErrorInvalidValue;

  // g = leaky(conv_d(leaky(x), w1)), the forward's split conv1
  const Params pg{nullptr, nullptr, g, C, T, K, dilation, pad_left, 1, 1, w_stages, x_stages, B};
  int e = launch_any<E>(np, kSplit, flush, map_x, map_w1, map_w1, pg, B, stream);
  if (e != 0) return e;
  if (dx || dw1) {  // dh = leaky'(g) * (w2^T gy)
    if (!make_map(&map_gy, is_bf16, gy, act, {(uint32_t)window(0, 0, sizeof(E)), (uint32_t)A::KC, 1},
                  false) ||
        !make_map(&map_w2t, is_bf16, s2t, {(uint64_t)C, (uint64_t)C, (uint64_t)A::PARTS}, box_w,
                  true))
      return (int)cudaErrorInvalidValue;
    const Params ph{nullptr, g, dh, C, T, 1, 1, 0, 0, 0, w_stages, x_stages, B};
    if ((e = launch_any<E>(np, kGrad, flush, map_gy, map_w2t, map_w2t, ph, B, stream)) != 0)
      return e;
  }
  if (dx) {  // dx = gy + leaky'(x) * conv_d(dh, w1 transposed, taps reversed, pads swapped)
    if (!make_map(&map_dh, is_bf16, dh, act,
                  {(uint32_t)window(halo, pad_right, sizeof(E)), (uint32_t)A::KC, 1}, false) ||
        !make_map(&map_w1t, is_bf16, s1t, {(uint64_t)C, (uint64_t)C, (uint64_t)(A::PARTS * K)},
                  box_w, true))
      return (int)cudaErrorInvalidValue;
    const Params pd{gy, x, dx, C, T, K, dilation, pad_right, 0, 0, w_stages, x_stages, B};
    if ((e = launch_any<E>(np, kGrad, flush, map_dh, map_w1t, map_w1t, pd, B, stream)) != 0)
      return e;
  }
  if (dw2 && (e = wgrad<E>(gy, g, dw2, part, B, C, T, 1, 1, 0, false, splits2, stream)) != 0)
    return e;
  if (dw1 && (e = wgrad<E>(dh, x, dw1, part, B, C, T, K, dilation, pad_left, true, splits1,
                           stream)) != 0)
    return e;
  return 0;
}

}  // namespace

extern "C" {

// The opt-in shared memory of a block on the current device (the wrapper's
// plan sizes the stages by it).
int dilated_unit_smem_limit() { return max_smem_optin(); }

// Launches on `stream`: the weight preparation into `wbuf` (fp32: 2 (K+1)
// C^2 floats; bf16: K C^2), then the unit, fused or split (split: leaky(h)
// through `hbuf`, B C T elements). Returns cudaGetLastError() after the last
// launch (0 when every launch was accepted), or cudaErrorInvalidValue for a
// refused shape or plan. `plan` in ops/kernels/dilated_unit.py picks
// fused, np, w_stages, x_stages and flush.
int dilated_unit_forward(const void* x, const void* w1, const void* w2, void* y, void* wbuf,
                         void* hbuf, int B, int C, int T, int K, int dilation, int pad_left,
                         int is_bf16, int fused, int np, int w_stages, int x_stages, int flush,
                         cudaStream_t stream) {
  return is_bf16 ? forward<bf16>(x, w1, w2, y, wbuf, hbuf, B, C, T, K, dilation, pad_left, fused,
                                 np, w_stages, x_stages, flush, stream)
                 : forward<float>(x, w1, w2, y, wbuf, hbuf, B, C, T, K, dilation, pad_left, fused,
                                  np, w_stages, x_stages, flush, stream);
}

// The gradient, on `stream`: dx [B, C, T], dw1 [C, C, K] and dw2 [C, C] in
// the inputs' type, each skipped where its pointer is null. `work` holds
// PARTS (2 K + 1) C^2 + 2 B C T elements of that type (the prepared weights,
// g and dh); `part` (fp32) max(splits1 K, splits2) C^2 floats where a split
// count is above 1. Returns as `dilated_unit_forward`; `backward_plan` in
// ops/kernels/dilated_unit.py picks np, the stages, flush and the splits.
int dilated_unit_backward(const void* x, const void* w1, const void* w2, const void* gy, void* dx,
                          void* dw1, void* dw2, void* work, void* part, int B, int C, int T, int K,
                          int dilation, int pad_left, int is_bf16, int np, int w_stages,
                          int x_stages, int flush, int splits1, int splits2, cudaStream_t stream) {
  float* f = static_cast<float*>(part);
  return is_bf16 ? backward<bf16>(x, w1, w2, gy, dx, dw1, dw2, work, f, B, C, T, K, dilation,
                                  pad_left, np, w_stages, x_stages, flush, splits1, splits2, stream)
                 : backward<float>(x, w1, w2, gy, dx, dw1, dw2, work, f, B, C, T, K, dilation,
                                   pad_left, np, w_stages, x_stages, flush, splits1, splits2,
                                   stream);
}

}  // extern "C"

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
// both weight gradients one launch of a wgmma kernel of their own
// (`wgrad_wgmma_kernel`: Q shifted in registers, P swizzled by TMA, splits
// over frames reduced in the launch in a fixed order); see there.

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
// reduction runs over every frame of the batch: `wgrad_wgmma_kernel` below.
//
// What bounds it on the H100: from x, the weights and gy the gradient needs
// h again (its sign is leaky'(h); dw2 reads leaky(h)), so 2 (3 K + 2) C^2 T B
// FLOP, 2.75 forwards' worth at K = 3, at 3xTF32's 165 TFLOP/s or bf16's 989;
// its bytes (x, gy, dx, g and dh each through device memory once or twice)
// are a few microseconds at 3.35 TB/s. The data launches are the forward's
// split mode (dx's convolution reads dh across tile edges, so dh goes
// through device memory, as does g, which dw2 reads too). The weight
// gradients, 2 (K + 1) C^2 T B of those FLOP, are one launch of
// `wgrad_wgmma_kernel` below. So a unit's gradient is five launches at every
// shape: prepare_weights_bwd, g, dh, dx and the weight gradients.

// ---- the weight gradients ----------------------------------------------------
//
// For each tap k of each gradient, D[q][p] = sum over the batch's frames t of
// f(Q[b, q, t + k d - pad_left]) . P[b, p, t], Q zero outside [0, T):
//   dw1: Q = x, f = leaky, P = dh, K taps;   dw2: Q = g, f = identity, P = gy,
// one tap; written transposed, dw[p][q][k] ([C_out][C_in][taps]).
//
// What bounds it: 2 (K + 1) C^2 T B FLOP (4.83 GFLOP per unit at every v2
// level at B = 8) at 3xTF32's 165 TFLOP/s or bf16's 989 on the H100, and the
// bytes its tiles bring from L2 into shared memory (every tile of N output
// channels reads Q's windows again, every tile of 128 input channels P): on
// the H100 a block takes ~30 kB of these boxes per us, which bounds bf16;
// fp32 is bound by its products and the flush (PERF.md, from a per-block
// clock). The design:
//   * A GEMM per tap with M = input channels q, N = output channels p and
//     the reduction over frames, on wgmma (m64nNk8 tf32, m64nNk16 bf16).
//     Both operands are [B, C, T] with frames contiguous, so P, the
//     unshifted operand, loaded by TMA in boxes [N channel rows][128 bytes of
//     frames] (a chunk: 32 fp32 or 64 bf16 frames) with the 128-byte
//     swizzle, is already the K-major B that wgmma reads from shared memory
//     (tf32 has no transpose bit). Q, shifted by k d - pad_left frames (not a
//     multiple of any swizzle atom), is A from registers: loaded with
//     ld.shared at any frame from a plain TMA window [128 q rows][the chunk
//     + 16 bytes] (a box starts 16-byte aligned), as the forward loads its
//     A, f and (fp32) the TF32 hi/lo split applied there. A tile has one
//     tap, so each window element is prepared once, as it loads. TMA's zero
//     fill is the padding (leaky(0) = 0). bf16's leaky is three bf16x2
//     instructions, exact (see there). N is 96, or 192 in bf16 (the plan's).
//   * fp32 is 3xTF32 (a_lo b_hi + a_hi b_lo + a_hi b_hi, each part rounded)
//     with the tensor cores' sums flushed into fp32 registers every
//     kWgFlush k8 steps (48 products per output), two windows' sums
//     alternating. B's parts: three helper warps split each landed P box,
//     the hi part in place and the lo part into a second buffer with the
//     same swizzle (the split is elementwise, the swizzle an address
//     permutation), then fence.proxy.async before the consumers' wgmma reads
//     them. bf16 multiplies bf16 with fp32 sums and reads P as it lands.
//   * Warp specialised: one producer thread keeps TMA loads in flight in a
//     ring of 3-6 stages (full, ready (fp32: split) and empty mbarriers);
//     two consumer warpgroups of 64 q rows each read every stage's P;
//     `setmaxnreg` gives them the producer's registers.
//   * The work is tiles of (gradient, tap, 128 q rows, N p rows), dw1's
//     first, each over the batch's chunks, sample-major. Block b runs the
//     units [floor(b U / grid), floor((b + 1) U / grid)) of that sequence of
//     U (tile, chunk) units: the plan's grid (`wg_grid`) is one block per
//     tile, or a whole number of blocks per tile, or one per SM. A block's
//     run over one tile is a segment. A whole tile's sums are the gradient.
//     A segment of a shared tile writes fp32 partials (each warpgroup its
//     half, in the accumulators' order: coalesced) and counts its arrival (a
//     release fence, then an atomic increment); the sums are added in two
//     levels, each by the last arrival at a counter: groups of R =
//     ceil(sqrt(nseg)) consecutive segments, then the groups, so the
//     critical path reads R + nseg / R partials, not nseg. The last resets
//     the counter and writes the gradient in the input's type. No atomics in
//     the sums, and the order depends on the shape alone: the same inputs
//     give the same bits.
// What it leaves (measured, PERF.md): at C = 96 the second warpgroup holds
// 32 real q rows of 64 (a quarter of the tile idle) and at C = 192 the
// second q tile's second warpgroup none; each tap's tile reads its Q window
// and P box again (a tile of three taps shares them, but triples its
// partials and spills fp32's registers: slower); Q's windows cost ~25% more
// than 128-byte rows would (the 16-byte start alignment; sharing 128-byte
// lines across stages instead was slower); a split tile's reduction, 10-20 us
// at the end of the launch; ptxas serializes fp32's products around the
// flush (C7514); the stores of dw1 interleave the taps that separate tiles
// write (stride K).

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

constexpr int kWgRows = 128;  // q rows of a tile: two consumer warpgroups of 64
constexpr int kWgMinStages = 3, kWgMaxStages = 6;
constexpr int kWgHelpers = 3;  // producer warps that split fp32's P into TF32 parts
// fp32: k8 steps whose products (8 frames x 3 per output each) gather in the
// tensor cores before a flush into fp32 registers: 48
constexpr int kWgFlush = 2;
// counters of a tile's warpgroup half: the tile's, then one per group of its
// segments (at most ceil(sqrt(segments)) <= 12 groups at 132 SMs)
constexpr int kWgCounters = 16;

// Per element type: the frames of a chunk (one 128-byte swizzle row of P),
// TMA's 16-byte start alignment in frames, and the frames of a Q window row
// (the chunk and that alignment: 144 bytes, 36 words, 4 mod 8, so that an A
// fragment load of 8 rows x 4 words hits 32 distinct banks).
template <class E>
struct Wg {
  static constexpr int FRAMES = 128 / (int)sizeof(E), STEP = 16 / (int)sizeof(E);
  static constexpr int QP = FRAMES + STEP, PARTS = Arith<E>::PARTS;
  // P [np][128 bytes] (and fp32's lo part of it), then Q [128][QP]; each a
  // multiple of 1024 bytes
  __host__ __device__ static constexpr int stage_bytes(int np) {
    return PARTS * np * 128 + kWgRows * QP * (int)sizeof(E);
  }
  __host__ __device__ static constexpr int tx_bytes(int np) {  // what TMA writes into a stage
    return np * 128 + kWgRows * QP * (int)sizeof(E);
  }
  // the stages, their full / ready / empty barriers, a flag per consumer warpgroup
  __host__ __device__ static constexpr int smem_bytes(int np, int stages) {
    return 1024 + stages * (stage_bytes(np) + 24) + 8;
  }
};

// One weight gradient of a launch.
struct WgGrad {
  void* out;  // E [C][C][taps]
  int taps, dilation, pad_left;
  float slope;  // f(v) = v where v >= 0, else slope v: leaky (kSlope) or the identity (1)
};

struct WgParams {
  WgGrad grad[2];        // dw1 first where both run
  int C, T, stages;
  int q_tiles, p_tiles;  // tiles of one tap
  int tiles0, tiles;     // of grad[0]; of the launch
  int chunks;            // of a tile: batch x ceil(T / FRAMES), sample-major
  float* part;           // fp32 partials: 2 slots per block, kWgRows x N each
  int* counters;         // kWgCounters per tile and consumer warpgroup, 0 between launches
};

// The tile of a unit: its index, gradient, tap, and first q and p.
struct WgTile {
  int t, g, k, q0, p0;
  WgGrad grad;
};

__device__ __forceinline__ WgTile wg_tile(const WgParams& p, int t, int np) {
  WgTile x;
  x.t = t;
  x.g = t >= p.tiles0;
  x.grad = x.g ? p.grad[1] : p.grad[0];
  const int per_tap = p.q_tiles * p.p_tiles, r0 = t - (x.g ? p.tiles0 : 0);
  x.k = r0 / per_tap;
  const int r = r0 - x.k * per_tap;
  x.q0 = r / p.p_tiles * kWgRows;
  x.p0 = r % p.p_tiles * np;
  return x;
}

// Block b runs the units [wg_lo(b), wg_lo(b + 1)); wg_block(u) is the block
// that runs unit u.
__device__ __forceinline__ long long wg_lo(long long b, long long units, int grid) {
  return b * units / grid;
}
__device__ __forceinline__ int wg_block(long long u, long long units, int grid) {
  return (int)(((u + 1) * grid - 1) / units);
}

// Keeps registers that an asynchronous product reads alive up to this point.
template <int S, int R>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[S][R]) {
#pragma unroll
  for (int s = 0; s < S; ++s)
#pragma unroll
    for (int r = 0; r < R; ++r) asm volatile("" : "+r"(a[s][r])::"memory");
}

template <class E, int NP>
__global__ void __launch_bounds__(kThreads, 1)
wgrad_wgmma_kernel(const __grid_constant__ CUtensorMap map_p0,
                   const __grid_constant__ CUtensorMap map_q0,
                   const __grid_constant__ CUtensorMap map_p1,
                   const __grid_constant__ CUtensorMap map_q1, const WgParams p) {
  using W = Wg<E>;
  constexpr bool kF32 = sizeof(E) == 4;
  constexpr int SB = W::stage_bytes(NP), QP = W::QP, F = W::FRAMES, STEP = W::STEP;
  constexpr int Q_OFF = W::PARTS * NP * 128;  // Q's offset in a stage
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const uint32_t base = sm90::smem_addr(smem);
  const uint32_t full = base + p.stages * SB, ready = full + 8 * p.stages;
  const uint32_t empty = ready + 8 * p.stages;
  volatile int* last_flag = reinterpret_cast<volatile int*>(smem + p.stages * (SB + 24));
  const long long units = (long long)p.tiles * p.chunks;
  const int grid = gridDim.x;
  const long long lo = wg_lo(blockIdx.x, units, grid), hi = wg_lo(blockIdx.x + 1, units, grid);
  const int per_b = (p.T + F - 1) / F;  // chunks of one sample

  if (threadIdx.x == 0) {
    for (int i = 0; i < p.stages; ++i) {
      sm90::mbar_init(full + 8 * i, 1);
      sm90::mbar_init(ready + 8 * i, kWgHelpers);       // one arrival per helper warp
      sm90::mbar_init(empty + 8 * i, kConsumers / 32);  // one per consumer warp
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  // Every role walks the block's units segment by segment: `visit(tile, c0,
  // c1)` for the chunks [c0, c1) of each tile in turn.
  auto walk = [&](auto visit) {
    for (long long u = lo; u < hi;) {
      const int t = (int)(u / p.chunks), c0 = (int)(u - (long long)t * p.chunks);
      const int c1 = (int)min((long long)p.chunks, c0 + (hi - u));
      visit(wg_tile(p, t, NP), c0, c1);
      u += c1 - c0;
    }
  };
  // Q's window of a tile starts at its tap's shift rounded down to 16 bytes;
  // q_off is the tap's first frame in the window.
  auto shift_of = [](const WgTile& tl) { return tl.k * tl.grad.dilation - tl.grad.pad_left; };
  auto q_off_of = [&](const WgTile& tl) { return ((shift_of(tl) % STEP) + STEP) % STEP; };

  if (threadIdx.x >= kConsumers) {
    // ---- producer warpgroup --------------------------------------------------
    sm90::reg_dealloc<40>();  // with the consumers' 232: the launch's 168 x 384 registers
    const int warp = (threadIdx.x - kConsumers) >> 5, lane = threadIdx.x & 31;
    int s = 0, ph = 0;
    if (warp == 0) {
      if (lane == 0) {  // one thread issues every load
        sm90::prefetch_map(&map_p0);
        sm90::prefetch_map(&map_q0);
        sm90::prefetch_map(&map_p1);
        sm90::prefetch_map(&map_q1);
        walk([&](const WgTile& tl, int c0, int c1) {
          const CUtensorMap* mp = tl.g ? &map_p1 : &map_p0;
          const CUtensorMap* mq = tl.g ? &map_q1 : &map_q0;
          const int q_rel = shift_of(tl) - q_off_of(tl);
          for (int c = c0; c < c1; ++c) {
            const int b = c / per_b, t0 = (c - b * per_b) * F;
            sm90::mbar_wait(empty + 8 * s, ph ^ 1);
            sm90::mbar_expect_tx(full + 8 * s, W::tx_bytes(NP));
            const uint32_t st = base + s * SB;
            sm90::tma_load_3d(st, mp, full + 8 * s, t0, tl.p0, b);
            sm90::tma_load_3d(st + Q_OFF, mq, full + 8 * s, t0 + q_rel, tl.q0, b);
            if (++s == p.stages) s = 0, ph ^= 1;
          }
        });
      }
    } else if constexpr (kF32) {
      // helpers: each landed P box into TF32 parts, hi in place, lo NP * 128 bytes on
      const int h = threadIdx.x - kConsumers - 32;
      for (long long u = lo; u < hi; ++u) {
        sm90::mbar_wait(full + 8 * s, ph);
        float4* pp = reinterpret_cast<float4*>(smem + s * SB);
        for (int i = h; i < NP * 8; i += 32 * kWgHelpers) {
          const float4 v = pp[i];
          uint32_t h0, h1, h2, h3, l0, l1, l2, l3;
          split_tf32(v.x, h0, l0);
          split_tf32(v.y, h1, l1);
          split_tf32(v.z, h2, l2);
          split_tf32(v.w, h3, l3);
          pp[i] = make_float4(__uint_as_float(h0), __uint_as_float(h1), __uint_as_float(h2),
                              __uint_as_float(h3));
          pp[i + NP * 8] = make_float4(__uint_as_float(l0), __uint_as_float(l1),
                                       __uint_as_float(l2), __uint_as_float(l3));
        }
        sm90::fence_proxy_async();  // these writes before the consumers' wgmma reads
        __syncwarp();
        if (lane == 0) sm90::mbar_arrive(ready + 8 * s);
        if (++s == p.stages) s = 0, ph ^= 1;
      }
    }
    return;
  }

  // ---- consumer warpgroups: 64 q rows each -------------------------------------
  sm90::reg_alloc<232>();
  const int wg = threadIdx.x >> 7, tid = threadIdx.x & 127;
  const int lane = tid & 31, g = lane >> 2, tig = lane & 3;
  const int row = 64 * wg + 16 * (tid >> 5) + g;  // this thread's first q row of a tile (and row + 8)
  const uint32_t landed = kF32 ? ready : full;     // a stage may be read once this completes
  int s = 0, ph = 0;
  auto advance = [&]() {
    if (++s == p.stages) s = 0, ph ^= 1;
  };
  auto release = [&](int stage) {  // this warp is done with `stage`
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(empty + 8 * stage);
  };
  float acc[NP / 2];  // acc[4 j + r]: D at q row + 8 (r >> 1), p 8 j + 2 tig + (r & 1)

  walk([&](const WgTile& tl, int c0, int c1) {
    const int n = c1 - c0;
    if (tl.q0 + 64 * wg >= p.C) {  // no row of this warpgroup: keep the ring's pace only
      for (int i = 0; i < n; ++i) {
        sm90::mbar_wait(landed + 8 * s, ph);
        release(s);
        advance();
      }
      return;
    }
    const int q_off = q_off_of(tl);
#pragma unroll
    for (int i = 0; i < NP / 2; ++i) acc[i] = 0.f;

    if constexpr (kF32) {
      const float slope = tl.grad.slope;  // leaky on dw1's Q as its fragments load
      // A fragments of one flush window (kWgFlush k8 steps): [step][0..3] hi,
      // [4..7] lo; the m64k8 layout: rows row, row + 8; frames tig, tig + 4.
      // Two windows' sums alternate between part0 and part1: a window's
      // products run while the window before is flushed into acc and the
      // window after loads its fragments.
      constexpr int WPS = 4 / kWgFlush;  // windows per chunk
      uint32_t fa0[kWgFlush][8], fa1[kWgFlush][8];
      float part0[NP / 2], part1[NP / 2];
#pragma unroll
      for (int i = 0; i < NP / 2; ++i) part0[i] = part1[i] = 0.f;
      auto frag = [&](uint32_t(&f)[kWgFlush][8], int st, int w) {
        const float* q = reinterpret_cast<const float*>(smem + st * SB + Q_OFF) + row * QP +
                         q_off + 8 * kWgFlush * (w % WPS) + tig;
#pragma unroll
        for (int ff = 0; ff < kWgFlush; ++ff) {
          const float* a = q + 8 * ff;
          const float v[4] = {a[0], a[8 * QP], a[4], a[8 * QP + 4]};
#pragma unroll
          for (int i = 0; i < 4; ++i)
            split_tf32(v[i] >= 0.f ? v[i] : slope * v[i], f[ff][i], f[ff][4 + i]);
        }
      };
      const int nw = n * WPS;
      int held = -1;  // the stage that the window in flight before this one frees when done
      sm90::mbar_wait(ready + 8 * s, ph);
      frag(fa0, s, 0);
      auto window = [&](uint32_t(&cur)[kWgFlush][8], uint32_t(&other)[kWgFlush][8],
                        float(&sum)[NP / 2], float(&prev)[NP / 2], int w) {
        const uint32_t wb = base + s * SB;
        sm90::fence_acc(sum);
        sm90::wgmma_fence();
#pragma unroll
        for (int ff = 0; ff < kWgFlush; ++ff) {
          const int ks = kWgFlush * (w % WPS) + ff;
          const uint64_t b_hi = sm90::desc_sw128(wb + 32 * ks);
          const uint64_t b_lo = sm90::desc_sw128(wb + NP * 128 + 32 * ks);
          const uint32_t(&a_hi)[4] = *reinterpret_cast<const uint32_t(*)[4]>(&cur[ff][0]);
          const uint32_t(&a_lo)[4] = *reinterpret_cast<const uint32_t(*)[4]>(&cur[ff][4]);
          Mma<float, NP>::run(sum, a_lo, b_hi, ff != 0);  // a window's first product overwrites
          Mma<float, NP>::run(sum, a_hi, b_lo, 1);
          Mma<float, NP>::run(sum, a_hi, b_hi, 1);
        }
        sm90::wgmma_commit();
        sm90::wgmma_wait<1>();  // the window before is done: flush its sums
        fence_regs(other);      // its fragments: apart from `cur`'s registers until here
        sm90::fence_acc(prev);
        if (w > 0) {
#pragma unroll
          for (int i = 0; i < NP / 2; ++i) acc[i] += prev[i];
        }
        if (held >= 0) release(held);
        held = -1;
        if ((w + 1) % WPS == 0) {  // this window ends its chunk: the stage is freed after it
          held = s;
          advance();
        }
        if (w + 1 < nw) {
          if ((w + 1) % WPS == 0) sm90::mbar_wait(ready + 8 * s, ph);
          frag(other, s, w + 1);
        }
      };
      for (int w = 0; w < nw; w += 2) {
        window(fa0, fa1, part0, part1, w);
        if (w + 1 < nw) window(fa1, fa0, part1, part0, w + 1);
      }
      sm90::wgmma_wait<0>();
      fence_regs(fa0);
      fence_regs(fa1);
      sm90::fence_acc(part0);
      sm90::fence_acc(part1);
      if (nw % 2) {  // the last window's sums
#pragma unroll
        for (int i = 0; i < NP / 2; ++i) acc[i] += part0[i];
      } else {
#pragma unroll
        for (int i = 0; i < NP / 2; ++i) acc[i] += part1[i];
      }
      release(held);
    } else {
      // The slope as two bf16 parts: 0.2f = 0.2001953125 - 0.000195503..., and
      // fma(v, hi, bf16(v lo)) rounds to the bf16 of 0.2f v (in fp32) for every
      // bf16 v, as the reference's leaky does (tests/test_torch_dilated_unit_wgrad.py)
      const __nv_bfloat162 kSlopeHi = __float2bfloat162_rn(0.2001953125f);
      const __nv_bfloat162 kSlopeLo = __float2bfloat162_rn(-0.00019550323486328125f);
      // A fragments of one chunk: four k16 steps, the m64k16 layout: rows row,
      // row + 8; frame pairs 2 tig, 2 tig + 8 (two 16-bit loads at an odd shift)
      uint32_t fb0[4][4], fb1[4][4] = {};
      const bool lq = tl.grad.slope != 1.f;  // leaky on dw1's Q as its fragments load
      auto frag = [&](uint32_t(&f)[4][4], int st) {
        const bf16* q = reinterpret_cast<const bf16*>(smem + st * SB + Q_OFF) + row * QP +
                        q_off + 2 * tig;
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          const bf16* a[4] = {q + 16 * ks, q + 16 * ks + 8 * QP, q + 16 * ks + 8,
                              q + 16 * ks + 8 * QP + 8};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            uint32_t v = q_off & 1 ? pack_raw(a[i][0], a[i][1])
                                   : *reinterpret_cast<const uint32_t*>(a[i]);
            if (lq) {  // leaky: max(v, 0.2 v), 0.2 v rounded as bf16(0.2f v)
              const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&v);
              const __nv_bfloat162 r = __hmax2(h, __hfma2(h, kSlopeHi, __hmul2(h, kSlopeLo)));
              v = *reinterpret_cast<const uint32_t*>(&r);
            }
            f[ks][i] = v;
          }
        }
      };
      sm90::fence_acc(acc);
      int held = -1;  // the stage of the chunk in flight
      sm90::mbar_wait(full + 8 * s, ph);
      frag(fb0, s);
      // One chunk's products while the chunk before finishes; then the next
      // chunk's fragments load into the registers that one used.
      auto chunk = [&](uint32_t(&cur)[4][4], uint32_t(&other)[4][4], int i) {
        const uint32_t wb = base + s * SB;
        sm90::wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          Mma<bf16, NP>::run(acc, cur[ks], sm90::desc_sw128(wb + 32 * ks), 1);
        sm90::wgmma_commit();
        sm90::wgmma_wait<1>();  // the chunk before is done: its stage and fragments are free
        fence_regs(other);
        if (held >= 0) release(held);
        held = s;
        advance();
        if (i + 1 < n) {
          sm90::mbar_wait(full + 8 * s, ph);
          frag(other, s);
        }
      };
      for (int i = 0; i < n; i += 2) {
        chunk(fb0, fb1, i);
        if (i + 1 < n) chunk(fb1, fb0, i + 1);
      }
      sm90::wgmma_wait<0>();
      fence_regs(fb0);
      fence_regs(fb1);
      sm90::fence_acc(acc);
      release(held);
    }

    // ---- epilogue ---------------------------------------------------------------
    E* out = static_cast<E*>(tl.grad.out);
    auto put_all = [&]() {  // acc is the tile's gradient: dw[p][q][k]
#pragma unroll
      for (int j = 0; j < NP / 8; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int q = tl.q0 + row + 8 * (r >> 1), pc = tl.p0 + 8 * j + 2 * tig + (r & 1);
          if (q < p.C && pc < p.C)
            out[((size_t)pc * p.C + q) * tl.grad.taps + tl.k] = (E)acc[4 * j + r];
        }
    };
    if (c0 == 0 && c1 == p.chunks) {  // the whole tile
      put_all();
      return;
    }
    // A segment of a shared tile: its partials in slot 0 (the block's first
    // tile) or 1 (its last), this warpgroup's half in the accumulators' order.
    auto partials = [&](int b) {
      const int slot = 2 * b + (tl.t == wg_lo(b, units, grid) / p.chunks ? 0 : 1);
      return reinterpret_cast<float4*>(p.part) + (size_t)(2 * slot + wg) * (NP / 8) * 128 + tid;
    };
    auto store = [&](int b) {
      float4* dst = partials(b);
#pragma unroll
      for (int j = 0; j < NP / 8; ++j)
        dst[j * 128] = make_float4(acc[4 * j], acc[4 * j + 1], acc[4 * j + 2], acc[4 * j + 3]);
    };
    // acc = the partials of blocks b0, b0 + stride, ... (count of them), in that
    // order; JG n8 blocks of M partials in flight at a time (NP / 8 is 12 or 24)
    auto gather = [&](int b0, int count, int stride) {
      constexpr int JG = 12, M = NP <= 128 ? 2 : 1;  // bf16's N = 192 spills with 2
#pragma unroll
      for (int i = 0; i < NP / 2; ++i) acc[i] = 0.f;
      auto add = [&](const float4(&x)[JG], int j0) {
#pragma unroll
        for (int j = 0; j < JG; ++j) {
          float* a = &acc[4 * (j0 + j)];
          a[0] += x[j].x;
          a[1] += x[j].y;
          a[2] += x[j].z;
          a[3] += x[j].w;
        }
      };
#pragma unroll
      for (int j0 = 0; j0 < NP / 8; j0 += JG) {
        int m = 0;
        for (; m + M <= count; m += M) {
          float4 x[M][JG];
#pragma unroll
          for (int mm = 0; mm < M; ++mm) {
            const float4* src = partials(b0 + (m + mm) * stride) + j0 * 128;
#pragma unroll
            for (int j = 0; j < JG; ++j) x[mm][j] = __ldcg(src + j * 128);
          }
#pragma unroll
          for (int mm = 0; mm < M; ++mm) add(x[mm], j0);
        }
        for (; m < count; ++m) {
          float4 x[JG];
          const float4* src = partials(b0 + m * stride) + j0 * 128;
#pragma unroll
          for (int j = 0; j < JG; ++j) x[j] = __ldcg(src + j * 128);
          add(x, j0);
        }
      }
    };
    // Publishes this warpgroup's writes and counts an arrival at `counter` of
    // `expected`; true (to every thread) for the last, which resets it.
    auto arrive_last = [&](int* counter, int expected) {
      __threadfence();  // release: the partials before the count
      sm90::named_barrier(1 + wg, 128);
      if (tid == 0) {
        const bool last = atomicAdd(counter, 1) == expected - 1;
        if (last) atomicExch(counter, 0);  // for the next launch
        last_flag[wg] = last;
      }
      sm90::named_barrier(1 + wg, 128);
      const bool last = last_flag[wg];
      if (last) __threadfence();  // acquire: every arrival's partials are written
      return last;
    };
    store(blockIdx.x);
    const int b_first = wg_block((long long)tl.t * p.chunks, units, grid);
    const int nseg = wg_block((long long)(tl.t + 1) * p.chunks - 1, units, grid) - b_first + 1;
    int R = 1;
    while (R * R < nseg) ++R;
    const int groups = (nseg + R - 1) / R, gi = (blockIdx.x - b_first) / R;
    const int g_first = b_first + gi * R, g_size = min(R, nseg - gi * R);
    int* counters = p.counters + (2 * tl.t + wg) * kWgCounters;  // [0] the tile, [1 + gi] group gi
    if (!arrive_last(counters + 1 + gi, g_size)) return;
    gather(g_first, g_size, 1);
    if (groups > 1) {
      store(g_first);  // the group's sum over its first segment's partials
      if (!arrive_last(counters, groups)) return;
      gather(b_first, groups, R);
    }
    put_all();
  });
}

// The N instantiated per type: fp32 96 (its flush's two sums take the
// registers a wider N would need), bf16 96 and 192.
template <class E>
bool wgrad_width_ok(int np) {
  return np == 96 || (sizeof(E) == 2 && np == 192);
}

// Whether the weight gradients can run with N = np, `stages` and `grid`.
template <class E>
bool wgrad_plan_ok(int np, int stages, int grid) {
  return wgrad_width_ok<E>(np) && stages >= kWgMinStages && stages <= kWgMaxStages &&
         grid >= 1 && Wg<E>::smem_bytes(np, stages) <= max_smem_optin();
}

template <class E, int NP>
int wgrad_launch(const CUtensorMap (&m)[4], const WgParams& p, int grid, cudaStream_t stream) {
  static bool raised[kMaxDevices] = {};
  const cudaError_t err = raise_smem_cap(wgrad_wgmma_kernel<E, NP>, raised);
  if (err != cudaSuccess) return (int)err;
  wgrad_wgmma_kernel<E, NP><<<grid, kThreads, Wg<E>::smem_bytes(NP, p.stages), stream>>>(
      m[0], m[1], m[2], m[3], p);
  return (int)cudaGetLastError();
}

// Both weight gradients in one launch, each skipped where its output is null:
// dw1 (P = dh, Q = x under leaky, K taps) and dw2 (P = gy, Q = g, one tap); N
// = np, `stages` ring stages, `grid` blocks at most, each with an equal
// share of the (tile, chunk) units (grid = the tiles: one tile each). `part`
// holds 2 grid kWgRows np floats, `counters` 2 kWgCounters ints per tile.
template <class E>
int wgrad(const void* dh, const void* x, const void* gy, const void* g, void* dw1, void* dw2,
          float* part, int* counters, int B, int C, int T, int K, int dilation, int pad_left,
          int np, int stages, int grid, cudaStream_t stream) {
  using W = Wg<E>;
  if (!dw1 && !dw2) return 0;
  if (!wgrad_plan_ok<E>(np, stages, grid) || !part || !counters) return (int)cudaErrorInvalidValue;
  const bool is_bf16 = sizeof(E) == 2;
  const uint64_t act[3] = {(uint64_t)T, (uint64_t)C, (uint64_t)B};
  const uint32_t box_p[3] = {(uint32_t)W::FRAMES, (uint32_t)np, 1};
  const uint32_t box_q[3] = {(uint32_t)W::QP, (uint32_t)kWgRows, 1};
  WgParams p{};
  CUtensorMap m[4];
  int n = 0;
  auto add = [&](const void* P, const void* Q, void* out, int taps, int dil, int pad, float slope) {
    p.grad[n] = WgGrad{out, taps, dil, pad, slope};
    const bool ok = make_map(&m[2 * n], is_bf16, P, act, box_p, true) &&
                    make_map(&m[2 * n + 1], is_bf16, Q, act, box_q, false);
    ++n;
    return ok;
  };
  if (dw1 && !add(dh, x, dw1, K, dilation, pad_left, kSlope)) return (int)cudaErrorInvalidValue;
  if (dw2 && !add(gy, g, dw2, 1, 1, 0, 1.f)) return (int)cudaErrorInvalidValue;
  if (n == 1) m[2] = m[0], m[3] = m[1], p.grad[1] = p.grad[0];
  p.C = C;
  p.T = T;
  p.stages = stages;
  p.q_tiles = (C + kWgRows - 1) / kWgRows;
  p.p_tiles = (C + np - 1) / np;
  p.tiles0 = p.grad[0].taps * p.q_tiles * p.p_tiles;
  p.tiles = p.tiles0 + (n == 2 ? p.q_tiles * p.p_tiles : 0);
  p.chunks = B * ((T + W::FRAMES - 1) / W::FRAMES);
  p.part = part;
  p.counters = counters;
  const long long units = (long long)p.tiles * p.chunks;
  if (grid > units) grid = (int)units;  // no block without a unit
  if constexpr (sizeof(E) == 2)
    if (np == 192) return wgrad_launch<E, 192>(m, p, grid, stream);
  return wgrad_launch<E, 96>(m, p, grid, stream);
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
             void* dw2, void* work, float* part, int* counters, int B, int C, int T, int K,
             int dilation, int pad_left, int np, int w_stages, int x_stages, int flush, int wg_np,
             int wg_stages, int wg_grid, cudaStream_t stream) {
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
      !fits(window(halo, pad_left, sizeof(E))) || !fits(window(halo, pad_right, sizeof(E))) ||
      ((dw1 || dw2) && !wgrad_plan_ok<E>(wg_np, wg_stages, wg_grid)))
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
  // dw1 and dw2 in one launch
  return wgrad<E>(dh, x, gy, g, dw1, dw2, part, counters, B, C, T, K, dilation, pad_left, wg_np,
                  wg_stages, wg_grid, stream);
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
// the inputs' type, each skipped where its pointer is null; five launches
// (the weights' preparation, g, dh, dx, and dw1 with dw2). `work` holds
// PARTS (2 K + 1) C^2 + 2 B C T elements of that type (the prepared weights,
// g and dh); `part` (fp32) 2 wg_grid 128 wg_np floats; `counters`
// (int32) 32 per weight-gradient tile, zero, and left zero by every launch
// that completes. Returns as `dilated_unit_forward`; `backward_plan` in
// ops/kernels/dilated_unit.py picks np, the stages, flush and the weight
// gradients' N, stages and grid.
int dilated_unit_backward(const void* x, const void* w1, const void* w2, const void* gy, void* dx,
                          void* dw1, void* dw2, void* work, void* part, void* counters, int B,
                          int C, int T, int K, int dilation, int pad_left, int is_bf16, int np,
                          int w_stages, int x_stages, int flush, int wg_np, int wg_stages,
                          int wg_grid, cudaStream_t stream) {
  float* f = static_cast<float*>(part);
  int* c = static_cast<int*>(counters);
  return is_bf16 ? backward<bf16>(x, w1, w2, gy, dx, dw1, dw2, work, f, c, B, C, T, K, dilation,
                                  pad_left, np, w_stages, x_stages, flush, wg_np, wg_stages,
                                  wg_grid, stream)
                 : backward<float>(x, w1, w2, gy, dx, dw1, dw2, work, f, c, B, C, T, K, dilation,
                                   pad_left, np, w_stages, x_stages, flush, wg_np, wg_stages,
                                   wg_grid, stream);
}

}  // extern "C"

// Device helpers shared by the three cooperative ECS-LIF kernels,
// ecs_lif.cu (K1), ecs_lif_rows.cu (K2) and ecs_lif_v2.cu (K3), and the
// plain-LIF kernel lif_fused.cu (K6): roundings to the storage dtype, the
// spike, bf16-pair arithmetic, loads, cp.async, the grid-wide barrier, the
// recurrence's tail, the depthwise pass into a float32 tile, and the
// wgmma product's fragments.  The ECS-LIF kernels drive the same barrier
// buffer of a (device, stream) (snn/ecs_lif.py:_barrier), so its protocol is
// written once, here.  _build.py hashes the headers a source includes into
// its library's name, so an edited header rebuilds every kernel that
// includes it.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

// --- roundings and the spike ----------------------------------------------------

// round a float to the storage dtype and back
template <typename T> __device__ __forceinline__ float rnd(float v);
template <> __device__ __forceinline__ float rnd<float>(float v) { return v; }
template <> __device__ __forceinline__ float rnd<bf16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// one operation, rounded like the dtype's own arithmetic (no FMA contraction)
template <typename T> __device__ __forceinline__ float mul(float a, float b) { return rnd<T>(__fmul_rn(a, b)); }
template <typename T> __device__ __forceinline__ float add(float a, float b) { return rnd<T>(__fadd_rn(a, b)); }
template <typename T> __device__ __forceinline__ float sub(float a, float b) { return rnd<T>(__fsub_rn(a, b)); }

// spike (or SiLU) of a membrane value
template <typename T>
__device__ __forceinline__ float fire(float m, float thresh, int act) {
  if (act) return rnd<T>(__fdiv_rn(m, __fadd_rn(1.0f, expf(-m))));
  return m > thresh ? 1.0f : 0.0f;
}

// --- bf16 pairs -------------------------------------------------------------------

// bf16 pairs in one 32-bit word, the lower channel in the low half.  One
// bf16x2 operation rounds each exact result once; for the product or sum of
// two bf16 values that is the same value as the float32 operation rounded
// to bf16 (a product of two 8-bit significands is exact in float32; a sum
// is exact in float32 unless the smaller addend lies below the larger's
// half ulp by far, and then both round to the larger), so these are the
// operations of the kernels' tails (and K2's depthwise pass), two elements
// at a time and without the float-to-bf16 conversions, which run at a
// quarter of the FMA rate.
__device__ __forceinline__ uint32_t hadd2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("add.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ uint32_t hsub2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("sub.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ uint32_t hmul2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
// fma.rn.bf16x2: a * b + c rounded once.  Where a is a Heaviside spike (0
// or 1) the product is exact, so this is the depthwise pass's multiply,
// round, add, round.
__device__ __forceinline__ uint32_t hfma2(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}
__device__ __forceinline__ float lo_f(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float hi_f(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }
__device__ __forceinline__ uint32_t pack_bf16x2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// the constants of `finish` as bf16 pairs
struct Pairs {
  uint32_t alpha, leak, beta, decay, one;
};

// --- loads and stores -----------------------------------------------------------

// the cache path of a global load: default, read-only (non-coherent), L2 only
// (coherent with other blocks' stores during the launch)
enum Ld { kPlain, kNc, kCg };

template <int L, typename V = uint4>
__device__ __forceinline__ V ldg(const void* p) {
  const V* q = reinterpret_cast<const V*>(p);
  if constexpr (L == kNc) return __ldg(q);
  else if constexpr (L == kCg) return __ldcg(q);
  else return *q;
}

// 8 consecutive elements (16-byte aligned)
template <int L>
__device__ __forceinline__ void load8(const bf16* p, float v[8]) {
  const uint4 u = ldg<L>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
  #pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x; v[2 * i + 1] = f.y;
  }
}
template <int L>
__device__ __forceinline__ void load8(const float* p, float v[8]) {
  const float4 a = ldg<L, float4>(p), b = ldg<L, float4>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void store8(float* p, const float v[8]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store8(bf16* p, const float v[8]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
  #pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

// one element, as float
template <int L> __device__ __forceinline__ float ld1(const float* p) { return ldg<L, float>(p); }
template <int L> __device__ __forceinline__ float ld1(const bf16* p) {
  return __uint_as_float((uint32_t)ldg<L, unsigned short>(p) << 16);
}
__device__ __forceinline__ void st1(float* p, float v) { *p = v; }
__device__ __forceinline__ void st1(bf16* p, float v) { *p = __float2bfloat16_rn(v); }

// 8 elements of T as 32-bit words (16-byte aligned): 4 for bf16, 8 for f32
template <int L, typename T>
__device__ __forceinline__ void ld8w(const T* p, uint32_t* w) {
  const uint4 a = ldg<L>(p);
  w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
  if constexpr (sizeof(T) == 4) {
    const uint4 b = ldg<L>(p + 4);
    w[4] = b.x; w[5] = b.y; w[6] = b.z; w[7] = b.w;
  }
}
template <typename T>
__device__ __forceinline__ void st8w(T* p, const uint32_t* w) {
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  if constexpr (sizeof(T) == 4)
    *reinterpret_cast<uint4*>(p + 4) = make_uint4(w[4], w[5], w[6], w[7]);
}

// --- the recurrence's tail ---------------------------------------------------------

// The per-element tail of a step t >= 1: the ecs update from the 1x1 product
// `acc` (with ecs the previous field), then the membrane and spike of step t
// (with spk the previous spike), updated in place.  K: the kernel's
// parameters, with the constants rounded to the dtype (alpha, leak, beta,
// decay), thresh and act.
template <typename T, typename K>
__device__ __forceinline__ void finish(float acc, float bias, float& ecs, float& mem,
                                       float& spk, float x, const K& k) {
  const float ev = add<T>(rnd<T>(acc), bias);
  ecs = add<T>(mul<T>(k.alpha, ev), mul<T>(k.leak, ecs));
  const float fecs = mul<T>(k.beta, rnd<T>(tanhf(ecs)));
  const float gate = sub<T>(1.0f, spk);
  const float m = mul<T>(mul<T>(mem, k.decay), gate);
  mem = add<T>(add<T>(m, x), fecs);
  spk = fire<T>(mem, k.thresh, k.act);
}

// `finish` on two elements: the product rounded to bf16 (`ew`) and bf16 pairs
__device__ __forceinline__ void finish2(uint32_t ew, uint32_t bias, uint32_t& ecs,
                                        uint32_t& mem, uint32_t& spk, uint32_t x,
                                        const Pairs& k2, float thresh, int act) {
  const uint32_t ev = hadd2(ew, bias);
  ecs = hadd2(hmul2(k2.alpha, ev), hmul2(k2.leak, ecs));
  const uint32_t fecs = hmul2(k2.beta, pack_bf16x2(tanhf(lo_f(ecs)), tanhf(hi_f(ecs))));
  const uint32_t gate = hsub2(k2.one, spk);
  mem = hadd2(hadd2(hmul2(hmul2(mem, k2.decay), gate), x), fecs);
  const float m0 = lo_f(mem), m1 = hi_f(mem);
  if (act)
    spk = pack_bf16x2(__fdiv_rn(m0, __fadd_rn(1.0f, expf(-m0))),
                      __fdiv_rn(m1, __fadd_rn(1.0f, expf(-m1))));
  else
    spk = (m0 > thresh ? 0x3F80u : 0u) | (m1 > thresh ? 0x3F800000u : 0u);
}

// the constants of a kernel's parameters as bf16 pairs
template <typename K>
__device__ __forceinline__ Pairs pairs(const K& k) {
  return Pairs{pack_bf16x2(k.alpha, k.alpha), pack_bf16x2(k.leak, k.leak),
               pack_bf16x2(k.beta, k.beta), pack_bf16x2(k.decay, k.decay), 0x3F803F80u};
}

// --- shared memory, copies, barriers -----------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared through L2 (.cg); src_bytes 0 fills zeros
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int Pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(Pending) : "memory");
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Every block of the grid (all resident: a cooperative launch) waits here
// until all have arrived; what each wrote before is then visible to the
// others' L2 loads.  bar[0] counts arrivals and is back at 0 when the
// barrier opens; bar[1], the generation, grows by one a barrier.  So the
// buffer is ready for the next barrier and the next launch as it is, and
// every block must reach every barrier.  A barrier still closed after 10 s
// (a fault: a step takes milliseconds) traps, so the launch fails instead
// of hanging the card.
__device__ __forceinline__ void grid_sync(unsigned* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned gen = ld_acquire(bar + 1);
    __threadfence();
    if (atomicAdd(bar, 1u) == gridDim.x - 1) {
      atomicExch(bar, 0u);
      __threadfence();
      atomicAdd(bar + 1, 1u);
    } else {
      const unsigned long long t0 = global_ns();
      while (ld_acquire(bar + 1) == gen) {
        __nanosleep(64);
        if (global_ns() - t0 > 10000000000ull) __trap();
      }
    }
    __threadfence();
  }
  __syncthreads();
}


// --- the flat pixel plane ------------------------------------------------------------
// K: a kernel's parameters with the plane's P (= N*H*W), H, W and C

// image, row and column of flat pixel px: 32-bit divisions where the plane
// allows (H*W < 2^31 always: the wrappers check H*W*C)
struct Pix {
  long long n;
  int h, w;
};
template <typename K>
__device__ __forceinline__ Pix pixel(long long px, const K& p) {
  const unsigned hw = (unsigned)(p.H * p.W);
  if (p.P <= 0x7fffffffLL) {
    const unsigned q = (unsigned)px, img = q / hw, rem = q - img * hw, h = rem / (unsigned)p.W;
    return {(long long)img, (int)h, (int)(rem - h * (unsigned)p.W)};
  }
  const long long img = px / hw;
  const int rem = (int)(px - img * hw), h = rem / p.W;
  return {img, h, rem - h * p.W};
}

// x at flat pixel px, step 0, channel 0, through x's strides (K: x, xs_n,
// xs_h, xs_w)
template <typename T, typename K>
__device__ __forceinline__ const T* x_at(const K& p, long long px) {
  const Pix q = pixel(px, p);
  return static_cast<const T*>(p.x) + q.n * p.xs_n + q.h * p.xs_h + q.w * p.xs_w;
}

// bit tap = 3*dy + dx: the tap of pixel px lies in the image (none for px >= P)
template <typename K>
__device__ __forceinline__ uint32_t tap_mask(long long px, const K& p) {
  if (px >= p.P) return 0u;
  const Pix q = pixel(px, p);
  uint32_t m = 0u;
  #pragma unroll
  for (int tap = 0; tap < 9; ++tap)
    if ((unsigned)(q.h + tap / 3 - 1) < (unsigned)p.H && (unsigned)(q.w + tap % 3 - 1) < (unsigned)p.W)
      m |= 1u << tap;
  return m;
}

// The window of prev ([P][C] dense: out[t-1]) that the 3x3 taps of the tile
// [p0, p0 + run - 2) reach, channels [c0, c0 + 128 / sizeof(T)), in slots of
// 128 bytes: the flat pixel p + dy*W + dx lies in slot (dy+1)*S + (p - p0) +
// dx + 1, S = min(W, run) (three row runs of `run` pixels, or one run of
// 2W + run where they overlap).  16-byte piece c16 of a slot sits at c16 ^
// (slot & 7).  Slots outside the plane (and channels past C) are zeros;
// pixels of a neighbouring row or image are loaded but masked by the taps.
// `vec` (C % 8 == 0): cp.async in 16-byte pieces into dst (win's shared
// address), to be waited for; else element by element through L2 into
// win, at once.
template <typename T, typename K>
__device__ __forceinline__ void load_window128(const T* prev, uint32_t dst, uint8_t* win,
                                               long long p0, int c0, const K& p, int S, int NS,
                                               int run, bool vec) {
  constexpr int E = 16 / sizeof(T), KC = 128 / sizeof(T);
  auto pixel_of = [&](int slot) {
    return p.W <= run ? p0 - p.W - 1 + slot
                      : p0 + (long long)(slot / run - 1) * p.W - 1 + slot % run;
  };
  if (vec) {
    for (int i = threadIdx.x; i < NS * 8; i += blockDim.x) {
      const int slot = i >> 3, c16 = i & 7;
      const long long px = pixel_of(slot);
      const int c = c0 + c16 * E;
      const bool in = px >= 0 && px < p.P && c < p.C;
      cp_async16(dst + slot * 128 + ((c16 ^ (slot & 7)) << 4), in ? prev + px * p.C + c : prev,
                 in ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < NS * KC; i += blockDim.x) {
      const int slot = i / KC, c = i % KC;
      const long long px = pixel_of(slot);
      T v{};
      if (px >= 0 && px < p.P && c0 + c < p.C) {
        const T* src = prev + px * p.C + c0 + c;
        if constexpr (sizeof(T) == 2) {
          const unsigned short u = __ldcg(reinterpret_cast<const unsigned short*>(src));
          v = *reinterpret_cast<const bf16*>(&u);
        } else {
          v = __ldcg(src);
        }
      }
      *reinterpret_cast<T*>(win + slot * 128 + (((c / E) ^ (slot & 7)) << 4) + (c % E) * sizeof(T)) = v;
    }
  }
}

// --- the depthwise pass in float32, tap by tap -----------------------------------------

// d of pixel r of the tile and channels 16*half .. +16 of a 32-channel
// float32 chunk whose window slots are 128 bytes (16-byte piece c16 at
// c16 ^ (slot & 7)), tap by tap from zero in the dtype's own rounding, then
// + bias, into As [32][TILE].  dw: the chunk's weight of tap k and channel c
// at dw[k * ws + c]; bias: its 32 biases.  A tap outside the image reads a
// slot of zeros (`zero`), so that it adds +-0, as the plain version's zero
// padding does, without a branch.  Heaviside spikes (ACT false) multiply
// exactly, so the product and sum take one fused operation with the same
// result.  UNROLL: taps unrolled together (fewer keep fewer loads in flight,
// and registers for a caller whose product is live meanwhile).
template <bool ACT, int TILE, int UNROLL = 9>
__device__ __forceinline__ void depthwise_f32(const uint8_t* win, const uint8_t* zero,
                                              const float* dw, int ws, const float* bias, int S,
                                              int r, int half, uint32_t valid, float* As) {
  float d[16];
  #pragma unroll
  for (int i = 0; i < 16; ++i) d[i] = 0.f;
  #pragma unroll UNROLL
  for (int tap = 0; tap < 9; ++tap) {
    const int slot = (tap / 3) * S + r + tap % 3;
    const bool in = (valid >> tap) & 1u;
    const uint8_t* base = in ? win + slot * 128 : zero;
    const int swz = in ? slot & 7 : 0;
    #pragma unroll
    for (int c4 = 0; c4 < 4; ++c4) {
      const float4 sv = *reinterpret_cast<const float4*>(base + (((4 * half + c4) ^ swz) << 4));
      const float4 k = *reinterpret_cast<const float4*>(dw + tap * ws + 16 * half + 4 * c4);
      const float a[4] = {sv.x, sv.y, sv.z, sv.w}, b[4] = {k.x, k.y, k.z, k.w};
      #pragma unroll
      for (int i = 0; i < 4; ++i)
        d[4 * c4 + i] = ACT ? __fadd_rn(d[4 * c4 + i], __fmul_rn(a[i], b[i]))
                            : __fmaf_rn(a[i], b[i], d[4 * c4 + i]);
    }
  }
  #pragma unroll
  for (int i = 0; i < 16; ++i)
    As[(16 * half + i) * TILE + r] = __fadd_rn(d[i], bias[16 * half + i]);
}

// --- the wgmma product: A from registers, B resident ------------------------------------

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int Pending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(Pending) : "memory");
}

// D[64, N] += A[64, 16] (registers, bf16) * B[16, N] (shared, K-major, 128B swizzle)
template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t a[4], uint64_t desc);
template <>
__device__ __forceinline__ void wgmma_rs<32>(float* d, const uint32_t a[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_rs<64>(float* d, const uint32_t a[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_rs<128>(float* d, const uint32_t a[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// shared-memory descriptor of a K-major, 128-byte-swizzled operand: start
// address, LBO 1 (unused when swizzled), SBO 1024 bytes (8 rows of 128 bytes)
__device__ __forceinline__ uint64_t smem_desc_sw128(uint32_t addr) {
  return (uint64_t)((addr >> 4) & 0x3FFF) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

// The channel (0..63 of a chunk) whose depthwise weight and bias sit at
// position i of the chunk in shared memory: position 16q + 4ks + j holds what
// quad lane q puts in value j of k-step ks of its A fragment, channel
// 16ks + 8(j/2) + 2q + j%2, so that a thread reads its 16 in two pieces.
__device__ __forceinline__ int quad_channel(int i) {
  const int q = i >> 4, ks = (i >> 2) & 3, j = i & 3;
  return 16 * ks + 8 * (j >> 1) + 2 * q + (j & 1);
}

// The block's slice of pw as B: chunk kc is [N rows (output channels)][64 k]
// of 128 bytes, K in channel order, 16-byte piece index XOR (n % 8).  pw is
// read through the caller's strides (K: pw, pw_si, pw_so, pw_vec, C): in
// 16-byte runs along ci (pw_vec 1) or co (2), else element by element.
template <int N, typename K>
__device__ void load_b(const K& p, uint8_t* bmat, int slice, int nk) {
  const bf16* pw = static_cast<const bf16*>(p.pw);
  const int C = p.C, co0 = slice * N, cp = nk * 64;
  auto put = [&](int ci, int n, bf16 v) {
    const int k = ci & 63;
    *reinterpret_cast<bf16*>(bmat + ((ci >> 6) * N + n) * 128 +
                             ((((k * 2) >> 4) ^ (n & 7)) << 4) + ((k * 2) & 15)) = v;
  };
  if (p.pw_vec == 1) {            // 8 input channels of one output channel in 16 bytes
    for (int i = threadIdx.x; i < N * (cp / 8); i += blockDim.x) {
      const int n = i / (cp / 8), ci = i % (cp / 8) * 8, co = co0 + n;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (co < C && ci < C)
        v = __ldg(reinterpret_cast<const uint4*>(pw + co * p.pw_so + ci));
      *reinterpret_cast<uint4*>(bmat + ((ci >> 6) * N + n) * 128 +
                                ((((ci & 63) >> 3) ^ (n & 7)) << 4)) = v;
    }
  } else if (p.pw_vec == 2) {     // 8 output channels of one input channel in 16 bytes
    for (int i = threadIdx.x; i < cp * (N / 8); i += blockDim.x) {
      const int ci = i / (N / 8), n = i % (N / 8) * 8, co = co0 + n;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (co < C && ci < C)
        v = __ldg(reinterpret_cast<const uint4*>(pw + ci * p.pw_si + co));
      const bf16* e = reinterpret_cast<const bf16*>(&v);
      #pragma unroll
      for (int j = 0; j < 8; ++j) put(ci, n + j, e[j]);
    }
  } else {
    for (int i = threadIdx.x; i < cp * N; i += blockDim.x) {
      const int ci = i / N, n = i % N, co = co0 + n;
      put(ci, n, co < C && ci < C ? pw[ci * p.pw_si + co * p.pw_so] : bf16{});
    }
  }
  // the generic-proxy stores of B, visible to wgmma's async proxy
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// --- the product's accumulators ---------------------------------------------------------

// lanes q = 0..3 of a quad hold x[m] = X[q][m]; afterwards x[m] = X[m][q]
__device__ __forceinline__ void quad_transpose(uint32_t x[4], int q) {
  const bool up = q & 2, odd = q & 1;
  uint32_t s0 = up ? x[0] : x[2], s1 = up ? x[1] : x[3];
  s0 = __shfl_xor_sync(0xffffffffu, s0, 2);
  s1 = __shfl_xor_sync(0xffffffffu, s1, 2);
  if (up) { x[0] = s0; x[1] = s1; } else { x[2] = s0; x[3] = s1; }
  uint32_t t0 = odd ? x[0] : x[1], t1 = odd ? x[2] : x[3];
  t0 = __shfl_xor_sync(0xffffffffu, t0, 1);
  t1 = __shfl_xor_sync(0xffffffffu, t1, 1);
  if (odd) { x[0] = t0; x[2] = t1; } else { x[1] = t0; x[3] = t1; }
}

// acc[4j + 2h + e] is (row r0 + 8h, column 8j + 2q + e) of the item: wgmma's
// accumulator layout, which the f32 products keep too.  A 4x4 transpose
// within each quad gives lane q the 8 columns 32s + 8q .. +8 of each set s
// of four j: acc values a[s][0..8).
template <int N>
__device__ __forceinline__ void row_sets(const float* acc, int h, int q, float a[][8]) {
  #pragma unroll
  for (int s = 0; s < N / 32; ++s) {
    uint32_t ev[4], od[4];
    #pragma unroll
    for (int m = 0; m < 4; ++m) {
      ev[m] = __float_as_uint(acc[4 * (4 * s + m) + 2 * h]);
      od[m] = __float_as_uint(acc[4 * (4 * s + m) + 2 * h + 1]);
    }
    quad_transpose(ev, q);
    quad_transpose(od, q);
    #pragma unroll
    for (int m = 0; m < 4; ++m) {
      a[s][2 * m] = __uint_as_float(ev[m]);
      a[s][2 * m + 1] = __uint_as_float(od[m]);
    }
  }
}

}  // namespace

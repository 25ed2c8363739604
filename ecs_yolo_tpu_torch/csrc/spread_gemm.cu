// Fused ECS spread pw1x1(dw3x3(s) + dwb) + pwb as one implicit product, for
// Hopper (sm_90a).
//
// Replaces ecs_yolo_tpu/snn/pallas_dw.py:packed_spread_pallas (the TPU kernel
// `_packed_spread_kernel`): out[pos, :] = patches[pos, 9C] @ M[9C, C] + const
// with M[(dy, dx, ci), co] = dw[dy, dx, ci] * pw[ci, co] and
// const = dwb @ pw + pwb, both composed by the caller.  The spike plane
// s [N, H, W, C] holds 0 or 1 and is read as int8; the product accumulates
// in f32, const is added in f32, and the result is rounded once.  The TPU
// kernel works on a width-packed [N, H, W/2, 2C] layout and splits the
// product into two width phases; on the canonical layout there is one
// product and no phase.
//
// What bounds it: at C = 64, 2 * 9 * C operations per output element against
// one byte read and one element written: operations, narrowly, in bf16 on
// the tensor cores (0.061 ms of tensor work against 0.047 ms of memory at
// 8 x 320 x 320 x 64); operations by far in f32 on the CUDA cores.
//
// bf16 design (spread_gemm_wgmma), for what a per-tap design pays: each spike
// byte fetched and converted once per tap (9 times), M re-fetched by every
// block, loads that never overlap the product, and B re-read from shared
// memory by every warp.
//   * Persistent blocks, two an SM, hold M in shared memory for their whole
//     life: loaded once per block, per tap as a [Cout rows][128 bytes] K-major
//     tile in the 128-byte swizzle that a wgmma B descriptor reads, and const
//     beside it.
//   * A tile is TH x TW = 128 output pixels of one image (8 x 16 at the
//     site shapes, chosen by snn/spread.py:plan_gemm).  Its halo window of
//     (TH+2) x (TW+2) x C int8 arrives once, by cp.async with zero-fill
//     outside the image, into a ring of 2-3 stages; an mbarrier per stage
//     says "full" (cp.async.mbarrier.arrive.noinc) and one says "empty".
//     The window of tile i+stages-1 is in flight while tile i computes, and
//     each spike byte crosses from memory (TH+2)(TW+2)/(TH TW) = 1.41 times.
//   * Two warpgroups each own 64 of the tile's pixels.  For each tap a warp
//     reads its A fragment straight from the window at the shifted offset,
//     16 bytes a pixel row, and widens 0/1 bytes to bf16 in registers; the
//     product is wgmma m64nCk16 with A from registers and B from the resident
//     M.  K within a tap is permuted (physical channel
//     q * C/4 + 4 ks + j for the thread's quad position q, k-step ks and
//     element j) so that a thread's four A values of every k-step lie in one
//     32-bit word of its 16-byte read; M's rows are stored in the same order.
//     Taps alternate two A register sets, so the conversion of tap t+1
//     overlaps the wgmma of tap t.
//   * Epilogue: const added in f32, one rounding, a 4 x 4 transpose inside
//     each quad of lanes, and 16-byte stores; pixels outside the image (the
//     ragged last tile of a row or column) are masked.
// f32 (spread_gemm_f32): 64 pixels a block, 4x4 outputs a thread, FMA in
// full f32 (no TF32), M[tap] staged per tap as [Cin][Cout].
// Requires C % 16 == 0 and C <= 64; the wrapper checks it.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxC = 64;
constexpr int BMF = 64;           // pixels per block, f32 FMA path

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 8 spikes of the pixel `src` (or zeros), channels c..c+7
__device__ __forceinline__ uint2 load_spikes8(const int8_t* s, long long src, int C, int c,
                                              bool valid) {
  if (!valid) return make_uint2(0u, 0u);
  return *reinterpret_cast<const uint2*>(s + src * C + c);
}

// --- bf16: wgmma, resident M, halo windows by cp.async ---------------------------

constexpr int kWgThreads = 256;   // two warpgroups of 64 output pixels each

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

// arrives on `bar` once every cp.async this thread issued so far has landed
__device__ __forceinline__ void mbar_arrive_cp_async(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" :: "r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// 16 bytes global -> shared; src_bytes 0 fills the 16 bytes with zeros
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

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
__device__ __forceinline__ void wgmma_rs<16>(float* d, const uint32_t a[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}
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
__device__ __forceinline__ void wgmma_rs<48>(float* d, const uint32_t a[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23}, "
      "{%24, %25, %26, %27}, %28, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
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

// shared-memory descriptor of a K-major, 128-byte-swizzled operand: start
// address, LBO 1 (unused when swizzled), SBO 1024 bytes (8 rows of 128 bytes)
__device__ __forceinline__ uint64_t smem_desc_sw128(uint32_t addr) {
  return (uint64_t)((addr >> 4) & 0x3FFF) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

// position within a tap's K of physical channel ci (see the header)
template <int C>
__device__ __forceinline__ int k_of_channel(int ci) {
  constexpr int Q = C / 4;
  const int q = ci / Q, r = ci % Q, ks = r >> 2, j = r & 3;
  return 16 * ks + 8 * (j >> 1) + 2 * q + (j & 1);
}

// the C/16 words of 4 spikes this thread reads for one pixel row
template <int C>
__device__ __forceinline__ void load_words(const uint8_t* p, uint32_t w[C / 16]) {
  if constexpr (C == 64) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
  } else if constexpr (C == 32) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    w[0] = v.x; w[1] = v.y;
  } else {
    #pragma unroll
    for (int k = 0; k < C / 16; ++k) w[k] = reinterpret_cast<const uint32_t*>(p)[k];
  }
}

// bytes (b0, b1) of a word of 0/1 spikes -> bf16x2 (b0, b1); 0x3F80 is bf16 1.0
__device__ __forceinline__ uint32_t spikes_lo(uint32_t w) {
  return __byte_perm(w, 0u, 0x4140) * 0x3F80u;
}
__device__ __forceinline__ uint32_t spikes_hi(uint32_t w) {
  return __byte_perm(w, 0u, 0x4342) * 0x3F80u;
}

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

__device__ __forceinline__ uint32_t pack_bf16x2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// m is M [9C][C] as composed; the tile plan (th, tw, stages, tiles) comes from
// snn/spread.py:plan_gemm, and the grid is its `grid`.
template <int C>
__global__ void __launch_bounds__(kWgThreads, 2)
spread_gemm_wgmma(const int8_t* __restrict__ s, const bf16* __restrict__ m,
                  const float* __restrict__ cst, bf16* __restrict__ out,
                  int N, int H, int W, int TH, int TW, int stages, int tiles) {
  constexpr int Q = C / 4;            // bytes of a pixel row a thread reads
  constexpr int KS = C / 16;          // k-steps a tap
  constexpr int NJ = C / 8;           // 8-column blocks of the accumulator
  extern __shared__ uint8_t smem_raw[];
  // M starts on the swizzle's 1024-byte atom (the plan's 1024 bytes of slack)
  uint8_t* bs = smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u);
  const int WW = TW + 2;
  const int win_bytes = (TH + 2) * WW * C;
  uint8_t* wins = bs + 9 * C * 128;
  float* cst_s = reinterpret_cast<float*>(wins + stages * win_bytes);
  uint64_t* bars = reinterpret_cast<uint64_t*>(cst_s + C);   // full[stages], empty[stages]

  const int tid = threadIdx.x, lane = tid % 32;
  const int nwb = (W + TW - 1) / TW, nhb = (H + TH - 1) / TH;
  const uint32_t wins_addr = smem_addr(wins);
  const uint32_t full0 = smem_addr(bars), empty0 = smem_addr(bars + stages);

  if (tid == 0) {
    for (int st = 0; st < stages; ++st) {
      mbar_init(full0 + 8 * st, kWgThreads);
      mbar_init(empty0 + 8 * st, kWgThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // every thread copies its share of tile t's window into stage st, then
  // arrives on full[st] when its copies have landed
  auto load_window = [&](int t, int st) {
    const int n = t / (nwb * nhb), h0 = (t / nwb) % nhb * TH - 1, w0 = t % nwb * TW - 1;
    const int chunks = (TH + 2) * WW * (C / 16);
    const uint32_t dst0 = wins_addr + st * win_bytes;
    for (int idx = tid; idx < chunks; idx += kWgThreads) {
      const int pix = idx / (C / 16), part = idx % (C / 16);
      const int hh = h0 + pix / WW, ww = w0 + pix % WW;
      const bool in = hh >= 0 && hh < H && ww >= 0 && ww < W;
      const int8_t* src = in ? s + (((long long)n * H + hh) * W + ww) * C + part * 16 : s;
      cp_async16(dst0 + idx * 16, src, in ? 16 : 0);
    }
    mbar_arrive_cp_async(full0 + 8 * st);
  };

  for (int j = 0; j < stages - 1; ++j) {
    const int t = blockIdx.x + j * gridDim.x;
    if (t < tiles) load_window(t, j);
  }

  // M, once: row n of tap `tap` holds M[tap * C + ci][n] at k_of_channel(ci),
  // 16-byte chunk index XOR (n % 8)
  for (int idx = tid; idx < 9 * C * (C / 8); idx += kWgThreads) {
    const int row = idx / (C / 8), n0 = idx % (C / 8) * 8;
    const int tap = row / C, k = k_of_channel<C>(row % C);
    const uint4 v = *reinterpret_cast<const uint4*>(m + (long long)row * C + n0);
    const bf16* e = reinterpret_cast<const bf16*>(&v);
    #pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int n = n0 + i;
      *reinterpret_cast<bf16*>(bs + tap * C * 128 + n * 128 +
                               ((((k * 2) >> 4) ^ (n & 7)) << 4) + ((k * 2) & 15)) = e[i];
    }
  }
  for (int i = tid; i < C; i += kWgThreads) cst_s[i] = cst[i];
  // make the generic-proxy stores of M visible to wgmma's async proxy
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  // this thread's two accumulator rows: pixels p and p + 8 of the tile
  const int q = lane % 4;
  const int p0 = 64 * (tid / 128) + 16 * ((tid / 32) % 4) + lane / 4, p1 = p0 + 8;
  const int th0 = p0 / TW, tw0 = p0 % TW, th1 = p1 / TW, tw1 = p1 % TW;
  const int off0 = (th0 * WW + tw0) * C + q * Q, off1 = (th1 * WW + tw1) * C + q * Q;
  const uint64_t desc0 = smem_desc_sw128(smem_addr(bs));

  int i = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++i) {
    const int st = i % stages;
    {  // keep stages-1 windows in flight: refill the stage tile i-1 used
      const int j = i + stages - 1, tj = blockIdx.x + j * gridDim.x;
      if (tj < tiles) {
        const int sj = j % stages;
        if (j >= stages) mbar_wait(empty0 + 8 * sj, (j / stages - 1) & 1);
        load_window(tj, sj);
      }
    }
    mbar_wait(full0 + 8 * st, (i / stages) & 1);
    const uint8_t* win = wins + st * win_bytes;

    float acc[C / 2];
    #pragma unroll
    for (int r = 0; r < C / 2; ++r) acc[r] = 0.f;
    uint32_t a[2][KS][4];
    #pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int b = tap & 1;
      if (tap >= 2) wgmma_wait<1>();          // tap-2's wgmma read a[b]
      const int sh = ((tap / 3) * WW + tap % 3) * C;
      uint32_t w0[KS], w1[KS];
      load_words<C>(win + off0 + sh, w0);
      load_words<C>(win + off1 + sh, w1);
      #pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        a[b][ks][0] = spikes_lo(w0[ks]);
        a[b][ks][1] = spikes_lo(w1[ks]);
        a[b][ks][2] = spikes_hi(w0[ks]);
        a[b][ks][3] = spikes_hi(w1[ks]);
      }
      wgmma_fence();
      #pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        wgmma_rs<C>(acc, a[b][ks], desc0 + ((tap * C * 128 + ks * 32) >> 4));
      wgmma_commit();
    }
    mbar_arrive(empty0 + 8 * st);             // the window is read
    wgmma_wait<0>();

    // epilogue: + const, round, 16-byte stores of 8 channels per lane
    const int n = t / (nwb * nhb), hb = (t / nwb) % nhb * TH, wb = t % nwb * TW;
    #pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int hh = hb + (half ? th1 : th0), ww = wb + (half ? tw1 : tw0);
      const bool in = hh < H && ww < W;
      bf16* o = out + (((long long)n * H + hh) * W + ww) * C;
      uint32_t x[NJ];
      #pragma unroll
      for (int jb = 0; jb < NJ; ++jb) {
        const float2 cc = *reinterpret_cast<const float2*>(cst_s + 8 * jb + 2 * q);
        x[jb] = pack_bf16x2(acc[4 * jb + 2 * half] + cc.x, acc[4 * jb + 2 * half + 1] + cc.y);
      }
      #pragma unroll
      for (int set = 0; set < NJ / 4; ++set) {
        quad_transpose(&x[4 * set], q);
        if (in)
          *reinterpret_cast<uint4*>(o + 8 * (4 * set + q)) =
              make_uint4(x[4 * set], x[4 * set + 1], x[4 * set + 2], x[4 * set + 3]);
      }
      #pragma unroll
      for (int jb = NJ / 4 * 4; jb < NJ; ++jb)
        if (in) *reinterpret_cast<uint32_t*>(o + 8 * jb + 2 * q) = x[jb];
    }
  }
}

template <int C>
int launch_wgmma(const int8_t* s, const bf16* m, const float* cst, bf16* out, int N, int H,
                 int W, int th, int tw, int stages, int tiles, int grid, int smem,
                 cudaStream_t st) {
  static int smem_set = 0;   // the dynamic shared memory this C's kernel may take
  if (smem > smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        spread_gemm_wgmma<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = smem;
  }
  spread_gemm_wgmma<C><<<grid, kWgThreads, smem, st>>>(s, m, cst, out, N, H, W, th, tw,
                                                       stages, tiles);
  return (int)cudaGetLastError();
}

// --- f32: CUDA cores, full f32 ---------------------------------------------------

// m is [9][Cin][Cout]
__global__ void __launch_bounds__(kThreads)
spread_gemm_f32(const int8_t* __restrict__ s, const float* __restrict__ m,
                const float* __restrict__ cst, float* __restrict__ out,
                long long P, int H, int W, int C) {
  // +4 pads each K row: the transposed A stores then conflict at most 2-way
  __shared__ __align__(16) float As[kMaxC][BMF + 4];
  __shared__ __align__(16) float Bs[kMaxC][kMaxC];

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const long long p0 = (long long)blockIdx.x * BMF;
  const int gpr = C / 8;
  const int a_groups = BMF * gpr;        // <= 512: at most 2 a thread
  const int b_vecs = C * (C / 4);        // float4s of M[tap]: at most 4 a thread

  int rq[2], cq[2], hq[2], wq[2];
  #pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int g = tid + q * kThreads;
    rq[q] = g / gpr;
    cq[q] = (g % gpr) * 8;
    const long long p = p0 + rq[q];
    const bool in = g < a_groups && p < P;
    wq[q] = in ? (int)(p % W) : -4;
    hq[q] = in ? (int)((p / W) % H) : -4;
  }

  float acc[4][4] = {};
  const bool cols_live = tx * 4 < C;

  for (int tap = 0; tap < 9; ++tap) {
    const int dy = tap / 3 - 1, dx = tap % 3 - 1;
    __syncthreads();
    #pragma unroll
    for (int q = 0; q < 2; ++q) {
      if (tid + q * kThreads >= a_groups) continue;
      const int hh = hq[q] + dy, ww = wq[q] + dx;
      const bool valid = hh >= 0 && hh < H && ww >= 0 && ww < W;
      const uint2 raw = load_spikes8(s, p0 + rq[q] + (long long)dy * W + dx, C, cq[q], valid);
      const int8_t* sv = reinterpret_cast<const int8_t*>(&raw);
      #pragma unroll
      for (int i = 0; i < 8; ++i) As[cq[q] + i][rq[q]] = (float)sv[i];
    }
    #pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int v = tid + q * kThreads;
      if (v >= b_vecs) continue;
      const int kk = v / (C / 4), n4 = (v % (C / 4)) * 4;
      *reinterpret_cast<float4*>(&Bs[kk][n4]) =
          *reinterpret_cast<const float4*>(m + ((long long)tap * C + kk) * C + n4);
    }
    __syncthreads();
    if (cols_live) {
      for (int kk = 0; kk < C; ++kk) {
        const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
        const float4 b = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[4] = {b.x, b.y, b.z, b.w};
        #pragma unroll
        for (int i = 0; i < 4; ++i)
          #pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
  }

  if (!cols_live) return;
  const int co = tx * 4;
  const float4 cc = *reinterpret_cast<const float4*>(cst + co);
  #pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long p = p0 + ty * 4 + i;
    if (p >= P) continue;
    *reinterpret_cast<float4*>(out + p * C + co) =
        make_float4(acc[i][0] + cc.x, acc[i][1] + cc.y, acc[i][2] + cc.z, acc[i][3] + cc.w);
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16; m is M [9C][C] as composed.  s is int8
// [N, H, W, C], contiguous, 16-byte aligned; cst is float32 [C]; C % 16 == 0,
// C <= 64.  th, tw, stages, tiles, grid and smem are the bf16 kernel's plan
// (snn/spread.py:plan_gemm); the f32 kernel ignores them.  Returns the
// launch's cudaError_t.
int spread_gemm_fwd(int dtype, const void* s, const void* m, const void* cst, void* out,
                    int N, int H, int W, int C, int th, int tw, int stages, int tiles,
                    int grid, int smem, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long P = (long long)N * H * W;
  if (C % 16 != 0 || C > kMaxC || C <= 0) return (int)cudaErrorInvalidValue;
  if (P == 0) return (int)cudaSuccess;
  if (dtype == 0) {
    spread_gemm_f32<<<(unsigned)((P + BMF - 1) / BMF), kThreads, 0, st>>>(
        static_cast<const int8_t*>(s), static_cast<const float*>(m),
        static_cast<const float*>(cst), static_cast<float*>(out), P, H, W, C);
    return (int)cudaGetLastError();
  }
  if (dtype != 1 || th * tw != 128 || tw % 16 != 0 || stages < 2 || grid <= 0)
    return (int)cudaErrorInvalidValue;
  const int8_t* s8 = static_cast<const int8_t*>(s);
  const bf16* mb = static_cast<const bf16*>(m);
  const float* cf = static_cast<const float*>(cst);
  bf16* o = static_cast<bf16*>(out);
  switch (C) {
    case 16: return launch_wgmma<16>(s8, mb, cf, o, N, H, W, th, tw, stages, tiles, grid, smem, st);
    case 32: return launch_wgmma<32>(s8, mb, cf, o, N, H, W, th, tw, stages, tiles, grid, smem, st);
    case 48: return launch_wgmma<48>(s8, mb, cf, o, N, H, W, th, tw, stages, tiles, grid, smem, st);
    default: return launch_wgmma<64>(s8, mb, cf, o, N, H, W, th, tw, stages, tiles, grid, smem, st);
  }
}

const char* spread_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

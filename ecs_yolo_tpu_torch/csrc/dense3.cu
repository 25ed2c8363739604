// Dense 3x3 SAME convolution over an int8 plane as one implicit product, for
// Hopper (sm_90a).
//
// Replaces scripts/bench_pallas_dw.py:pallas_dense3 (the TPU kernel
// `_dense3_kernel`, the prototype of the packed composite spread):
// out[pos, co] = patches[pos, 9C] @ bf16(k9c)[9C, C] + bias, where the patch
// row of a pixel holds its 3x3 neighbourhood in (dy, dx, ci) order with zeros
// outside the image.  Every int8 value is converted to bf16 exactly, the
// weights are rounded to bf16 whatever the output dtype (as the TPU kernel
// does), the product accumulates in f32, the bias is added in f32, and the
// result is rounded once to the output dtype (f32 or bf16).  The TPU kernel's
// row blocks (`bh`) are a VMEM device and change nothing here.
//
// What bounds it: operations.  2 * 9 * C operations per output element
// against one byte read and one element written; at C = 128 that is ~1150
// operations a byte, far above the card's ratio.
//
// Two kernels; the plan (ecs_yolo_tpu_torch/scripts/bench_pallas_dw.py:
// plan_dense3) names the one a shape takes.
//
// dense3_wgmma, the route of every C <= 64 and of C = 128, 192, 256, whose
// weight slice fits beside the windows.  Built from csrc/spread_gemm.cu's
// pieces, for what a per-tap design pays: each byte fetched and converted 9
// times, the weights re-fetched by every block, loads that never overlap the
// product, and B re-read from shared memory by every warp.
//   * Persistent blocks, one an SM, each own one Cout slice of BN channels
//     (BN = 64 at C = 128) for their whole life: its weights, 9 x C x BN
//     bf16, are loaded once (rounded from f32 where the caller passes f32)
//     into the 128-byte-swizzled K-major layout a wgmma B descriptor reads,
//     one [BN rows][128 bytes] block per tap and 64-channel chunk of K, with
//     the slice's bias in f32 beside them.  The grid is a multiple of the
//     slice count, so a block walking every grid-th (tile, slice) pair keeps
//     its slice; the slices of a tile run on neighbouring blocks at once and
//     the later reads of its window come from L2.
//   * A tile is 16 x 8 output pixels of one image.  Its 18 x 10 x C int8
//     window arrives once per slice, by cp.async with zero-fill outside the
//     image, under an mbarrier, while the tile before it multiplies: each
//     byte crosses from memory 1.41 times a slice, not 9 times a 64-deep
//     slice.
//   * The window is converted to bf16 once a tile, into chunk planes
//     [C/8][PP][8 channels] (PP = 181, the window's 180 pixels and one, so
//     that the stores conflict at most two ways).  Every integer in
//     -128..127 is exact in bf16: a byte b = m - 128 s (m its low 7 bits, s
//     its sign bit) is bf16(128 + m) - bf16(128 + 128 s), both operands made
//     by a byte permute and one logic operation, the difference one
//     fma.rn.bf16x2 for two values.
//   * Two warpgroups each own 8 rows x 8 columns of the tile and run wgmma
//     m64nBNk16 with both operands from shared memory: A without swizzle
//     (a tile row of 8 pixels is one core matrix; LBO one plane, SBO one
//     window row), so each tap's shifted A is the same descriptor at
//     another start address and K needs no reordering; B from the resident
//     slice.  The 9 x C/16 wgmmas of a tile are one commit group.  A first
//     version converted A into registers at every tap (wgmma with A from
//     registers) and was 1.4x slower on the H100: the per-tap conversion
//     and loads alone took 0.53 of its 0.73 ms at (16, 320, 160, 128).
//   * Epilogue: bias added in f32, one rounding; 16-byte stores (a 4 x 4
//     transpose inside each quad of lanes for bf16, a pair exchange for
//     f32); pixels outside the image (the ragged last tile of a row or
//     column) are masked.
//
// dense3_mma, the route of every other C % 16 == 0 (C > 64 not a multiple
// of 64, or C >= 320, whose slice does not fit): a block owns 128
// consecutive output pixels (flattened over N, H, W) and 64 output channels;
// for each tap and 64-channel slice of the input it stages the shifted
// [128, 64] tile as bf16 and the [64 out, 64 in] weight slice in shared
// memory, and 8 warps multiply them with mma.sync m16n8k16.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// --- dense3_wgmma: resident weight slice, windows by cp.async, wgmma ---------------

constexpr int kWgThreads = 256;    // two warpgroups of 64 output pixels each
constexpr int TH = 16, TW = 8;     // a tile: 16 rows x 8 columns
constexpr int WW = TW + 2;         // window width
constexpr int WP = (TH + 2) * WW;  // window pixels
constexpr int PP = WP | 1;         // bf16 plane stride, 16-byte rows (odd)

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count)
               : "memory");
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
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// D[64, N] += A[64, 16] (shared, K-major, no swizzle) * B[16, N] (shared,
// K-major, 128-byte swizzle)
template <int N>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t da, uint64_t db);
template <>
__device__ __forceinline__ void wgmma_ss<16>(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "%8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_ss<32>(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_ss<48>(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23}, "
      "%24, %25, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "l"(da), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_ss<64>(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// descriptor of a K-major operand in the 128-byte swizzle: start address, LBO
// 1 (unused when swizzled), SBO 1024 bytes (8 rows of 128 bytes)
__device__ __forceinline__ uint64_t smem_desc_sw128(uint32_t addr) {
  return (uint64_t)((addr >> 4) & 0x3FFF) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

// descriptor of a K-major operand without swizzle: start address, LBO the
// step between the two core matrices of a k16 step (along K), SBO the step
// between 8-row groups (along M)
__device__ __forceinline__ uint64_t smem_desc_plain(uint32_t addr, uint32_t lbo,
                                                    uint32_t sbo) {
  return (uint64_t)((addr >> 4) & 0x3FFF) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);
}

// two int8 bytes, each in the low byte of a 16-bit half of p, -> bf16x2,
// exactly: (128 + low 7 bits) - (128 + 128 * sign bit)
__device__ __forceinline__ uint32_t i8x2_to_bf16x2(uint32_t p) {
  const uint32_t x = (p & 0x007F007Fu) | 0x43004300u;   // 128 + m
  const uint32_t c = (p & 0x00800080u) | 0xC300C300u;   // -(128 + 128 s)
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(x), "r"(0x3F803F80u), "r"(c));
  return d;
}
// bytes (b0, b1) and (b2, b3) of a word -> bf16x2
__device__ __forceinline__ uint32_t i8_lo(uint32_t w) {
  return i8x2_to_bf16x2(__byte_perm(w, 0u, 0x4140));
}
__device__ __forceinline__ uint32_t i8_hi(uint32_t w) {
  return i8x2_to_bf16x2(__byte_perm(w, 0u, 0x4342));
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

// the bias-added row `half` of this thread's accumulator, stored to o (the
// pixel's first channel of the slice) when `in`
template <int BN>
__device__ __forceinline__ void store_row(bf16* o, const float* acc, const float* bias_s,
                                          int half, int q, bool in) {
  constexpr int NJ = BN / 8;
  uint32_t x[NJ];
  #pragma unroll
  for (int jb = 0; jb < NJ; ++jb) {
    const float2 bb = *reinterpret_cast<const float2*>(bias_s + 8 * jb + 2 * q);
    x[jb] = pack_bf16x2(acc[4 * jb + 2 * half] + bb.x, acc[4 * jb + 2 * half + 1] + bb.y);
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
template <int BN>
__device__ __forceinline__ void store_row(float* o, const float* acc, const float* bias_s,
                                          int half, int q, bool in) {
  // blocks j0 = 2 pr and j1 = 2 pr + 1: an even lane ends with 4 channels of
  // j0, an odd lane 4 of j1, after one exchange of 2 values with its partner
  const bool odd = q & 1;
  #pragma unroll
  for (int pr = 0; pr < BN / 16; ++pr) {
    const int j0 = 2 * pr, j1 = j0 + 1;
    const float2 b0 = *reinterpret_cast<const float2*>(bias_s + 8 * j0 + 2 * q);
    const float2 b1 = *reinterpret_cast<const float2*>(bias_s + 8 * j1 + 2 * q);
    const float v00 = acc[4 * j0 + 2 * half] + b0.x, v01 = acc[4 * j0 + 2 * half + 1] + b0.y;
    const float v10 = acc[4 * j1 + 2 * half] + b1.x, v11 = acc[4 * j1 + 2 * half + 1] + b1.y;
    const float r0 = __shfl_xor_sync(0xffffffffu, odd ? v00 : v10, 1);
    const float r1 = __shfl_xor_sync(0xffffffffu, odd ? v01 : v11, 1);
    if (in) {
      if (odd)
        *reinterpret_cast<float4*>(o + 8 * j1 + 2 * (q - 1)) = make_float4(r0, r1, v10, v11);
      else
        *reinterpret_cast<float4*>(o + 8 * j0 + 2 * q) = make_float4(v00, v01, r0, r1);
    }
  }
}

// k9c [9C][C] in (dy, dx, ci) row order, bf16 (w_bf16) or f32 rounded here;
// bias [C] bf16 (b_bf16) or f32.  tiles and slices come from
// bench_pallas_dw.py:plan_dense3, the grid is its `grid` (a multiple of
// `slices`); BN * slices == C and CW == min(C, 64).
template <int CW, int BN, int NC, typename O>
__global__ void __launch_bounds__(kWgThreads, 1)
dense3_wgmma(const int8_t* __restrict__ s, const void* __restrict__ k9c, int w_bf16,
             const void* __restrict__ bias, int b_bf16, O* __restrict__ out, int N, int H,
             int W, int tiles, int slices) {
  constexpr int C = CW * NC;         // NC chunks of CW channels
  constexpr int KST = C / 16;        // k16 steps a tap
  extern __shared__ uint8_t smem_raw[];
  // the weights start on the swizzle's 1024-byte atom (the plan's slack)
  uint8_t* bs = smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u);
  uint8_t* abf = bs + 9 * NC * BN * 128;        // bf16 planes [C/8][PP][16 bytes]
  uint8_t* win8 = abf + (C / 8) * PP * 16;      // int8 window [WP][C]
  float* bias_s = reinterpret_cast<float*>(win8 + WP * C);
  const uint32_t full = smem_addr(bias_s + BN);  // the window has landed

  const int tid = threadIdx.x, lane = tid % 32, wg = tid / 128, wi = (tid / 32) % 4;
  const int nwb = (W + TW - 1) / TW, nhb = (H + TH - 1) / TH;
  const int items = tiles * slices;
  const int n0 = blockIdx.x % slices * BN;     // this block's Cout slice
  const uint32_t win_addr = smem_addr(win8);

  if (tid == 0) {
    mbar_init(full, kWgThreads);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // every thread copies its share of tile t's window, then arrives on full
  // when its copies have landed
  auto load_window = [&](int t) {
    const int n = t / (nwb * nhb), h0 = (t / nwb) % nhb * TH - 1, w0 = t % nwb * TW - 1;
    for (int idx = tid; idx < WP * (C / 16); idx += kWgThreads) {
      const int pix = idx / (C / 16), part = idx % (C / 16);
      const int hh = h0 + pix / WW, ww = w0 + pix % WW;
      const bool in = hh >= 0 && hh < H && ww >= 0 && ww < W;
      const int8_t* src = in ? s + (((long long)n * H + hh) * W + ww) * C + part * 16 : s;
      cp_async16(win_addr + idx * 16, src, in ? 16 : 0);
    }
    mbar_arrive_cp_async(full);
  };
  if ((int)blockIdx.x < items) load_window(blockIdx.x / slices);

  // the slice's weights, once: row n of block u = tap * NC + ci / CW holds
  // k9c[tap * C + ci][n0 + n] at k = ci % CW, 16-byte chunk index XOR (n % 8)
  for (int idx = tid; idx < 9 * C * (BN / 8); idx += kWgThreads) {
    const int row = idx / (BN / 8), nb = idx % (BN / 8) * 8;
    const int tap = row / C, ci = row % C;
    const int u = tap * NC + ci / CW, k = ci % CW;
    const long long at = (long long)row * C + n0 + nb;
    uint4 v;
    if (w_bf16) {
      v = *reinterpret_cast<const uint4*>(static_cast<const bf16*>(k9c) + at);
    } else {
      const float4* f = reinterpret_cast<const float4*>(static_cast<const float*>(k9c) + at);
      const float4 f0 = f[0], f1 = f[1];
      v = make_uint4(pack_bf16x2(f0.x, f0.y), pack_bf16x2(f0.z, f0.w),
                     pack_bf16x2(f1.x, f1.y), pack_bf16x2(f1.z, f1.w));
    }
    const bf16* e = reinterpret_cast<const bf16*>(&v);
    #pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int n = nb + i;
      *reinterpret_cast<bf16*>(bs + u * BN * 128 + n * 128 +
                               ((((k * 2) >> 4) ^ (n & 7)) << 4) + ((k * 2) & 15)) = e[i];
    }
  }
  for (int i = tid; i < BN; i += kWgThreads)
    bias_s[i] = b_bf16 ? __bfloat162float(static_cast<const bf16*>(bias)[n0 + i])
                       : static_cast<const float*>(bias)[n0 + i];

  // warpgroup wg's A: window rows 8 wg.., shifted by each tap's offset
  const uint64_t da0 = smem_desc_plain(smem_addr(abf) + 8 * wg * WW * 16, PP * 16, WW * 16);
  const uint64_t db0 = smem_desc_sw128(smem_addr(bs));
  const int q = lane % 4;
  int i = 0;
  for (int it = blockIdx.x; it < items; it += gridDim.x, ++i) {
    mbar_wait(full, i & 1);
    __syncthreads();            // the wgmmas of the tile before have read abf
    for (int idx = tid; idx < WP * (C / 16); idx += kWgThreads) {
      const int pix = idx / (C / 16), part = idx % (C / 16);
      const uint4 v = *reinterpret_cast<const uint4*>(win8 + idx * 16);
      *reinterpret_cast<uint4*>(abf + (2 * part * PP + pix) * 16) =
          make_uint4(i8_lo(v.x), i8_hi(v.x), i8_lo(v.y), i8_hi(v.y));
      *reinterpret_cast<uint4*>(abf + ((2 * part + 1) * PP + pix) * 16) =
          make_uint4(i8_lo(v.z), i8_hi(v.z), i8_lo(v.w), i8_hi(v.w));
    }
    // make the generic-proxy stores (planes, and the weights before the
    // first tile) visible to wgmma's async proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();            // the planes are whole, the int8 window read
    if (it + (int)gridDim.x < items) load_window((it + gridDim.x) / slices);

    float acc[BN / 2];
    #pragma unroll
    for (int r = 0; r < BN / 2; ++r) acc[r] = 0.f;
    wgmma_fence();
    #pragma unroll
    for (int tap = 0; tap < 9; ++tap)
      #pragma unroll
      for (int ks = 0; ks < KST; ++ks)
        wgmma_ss<BN>(acc, da0 + ((((tap / 3) * WW + tap % 3) * 16 + 2 * ks * PP * 16) >> 4),
                     db0 + (((tap * NC + ks / 4) * BN * 128 + (ks % 4) * 32) >> 4));
    wgmma_commit();
    wgmma_wait_all();

    // this thread's rows 16 wi + lane / 4 (+ 8) of its warpgroup's 64 are
    // tile pixels (8 wg + 2 wi (+ 1), lane / 4)
    const int t = it / slices;
    const int n = t / (nwb * nhb), hb = (t / nwb) % nhb * TH, wb = t % nwb * TW;
    #pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int hh = hb + 8 * wg + 2 * wi + half, ww = wb + lane / 4;
      store_row<BN>(out + (((long long)n * H + hh) * W + ww) * C + n0, acc, bias_s, half, q,
                    hh < H && ww < W);
    }
  }
}

template <int CW, int BN, int NC, typename O>
int launch_wgmma(const int8_t* s, const void* k9c, int w_bf16, const void* bias, int b_bf16,
                 O* out, int N, int H, int W, int tiles, int slices, int grid, int smem,
                 cudaStream_t st) {
  static int smem_set = 0;   // the dynamic shared memory this instance may take
  if (smem > smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        dense3_wgmma<CW, BN, NC, O>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = smem;
  }
  dense3_wgmma<CW, BN, NC, O><<<grid, kWgThreads, smem, st>>>(
      s, k9c, w_bf16, bias, b_bf16, out, N, H, W, tiles, slices);
  return (int)cudaGetLastError();
}

// the instances: (chunk width, slice width, chunks) of every plan of the
// "wgmma" route (bench_pallas_dw.py:DENSE3_INSTANCES)
template <typename O>
int dispatch_wgmma(int cw, int bn, int nc, const int8_t* s, const void* k9c, int w_bf16,
                   const void* bias, int b_bf16, O* out, int N, int H, int W, int tiles,
                   int slices, int grid, int smem, cudaStream_t st) {
#define DENSE3_CASE(CW_, BN_, NC_)                                                    \
  if (cw == CW_ && bn == BN_ && nc == NC_)                                            \
    return launch_wgmma<CW_, BN_, NC_, O>(s, k9c, w_bf16, bias, b_bf16, out, N, H, W, \
                                          tiles, slices, grid, smem, st);
  DENSE3_CASE(16, 16, 1)
  DENSE3_CASE(32, 32, 1)
  DENSE3_CASE(48, 48, 1)
  DENSE3_CASE(64, 64, 1)
  DENSE3_CASE(64, 64, 2)
  DENSE3_CASE(64, 32, 3)
  DENSE3_CASE(64, 16, 4)
#undef DENSE3_CASE
  return (int)cudaErrorInvalidValue;
}

// --- dense3_mma: flattened pixel blocks on mma.sync -------------------------------

constexpr int kThreads = 256;
constexpr int BM = 128;           // pixels per block
constexpr int BNM = 64;           // output channels per block
constexpr int BK = 64;            // input channels per staged slice
constexpr int LDT = BK + 8;       // padded smem row (halves): ldmatrix conflict-free

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// kt is the weights as [Cout][9C] (row co holds k9c[:, co]), bf16; bias f32
template <typename O>
__global__ void __launch_bounds__(kThreads)
dense3_mma(const int8_t* __restrict__ s, const bf16* __restrict__ kt,
           const float* __restrict__ bias, O* __restrict__ out, long long P, int H, int W,
           int C) {
  __shared__ __align__(16) bf16 As[BM][LDT];
  __shared__ __align__(16) bf16 Bs[BNM][LDT];

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const long long p0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BNM;
  const long long K9 = 9LL * C;

  // the 4 A groups of 8 channels this thread stages: tile row and channel
  int rq[4], cq[4], hq[4], wq[4];
  #pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int g = tid + q * kThreads;    // 0..1023: 128 rows x 8 groups
    rq[q] = g / (BK / 8);
    cq[q] = (g % (BK / 8)) * 8;
    const long long p = p0 + rq[q];
    wq[q] = p < P ? (int)(p % W) : -4;   // -4: no tap of it is ever valid
    hq[q] = p < P ? (int)((p / W) % H) : -4;
  }

  float acc[8][4] = {};

  for (int tap = 0; tap < 9; ++tap) {
    const int dy = tap / 3 - 1, dx = tap % 3 - 1;
    for (int k0 = 0; k0 < C; k0 += BK) {
      __syncthreads();                   // the previous slice's mma is done
      #pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int hh = hq[q] + dy, ww = wq[q] + dx, ci = k0 + cq[q];
        uint2 raw = make_uint2(0u, 0u);
        if (hh >= 0 && hh < H && ww >= 0 && ww < W && ci < C)
          raw = *reinterpret_cast<const uint2*>(
              s + (p0 + rq[q] + (long long)dy * W + dx) * C + ci);
        const int8_t* sv = reinterpret_cast<const int8_t*>(&raw);
        uint4 u;
        __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&u);
        #pragma unroll
        for (int i = 0; i < 4; ++i)
          h2[i] = __floats2bfloat162_rn((float)sv[2 * i], (float)sv[2 * i + 1]);
        *reinterpret_cast<uint4*>(&As[rq[q]][cq[q]]) = u;
      }
      #pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int ch = tid + q * kThreads;   // 0..511: 64 rows x 8 chunks
        const int n = ch / (BK / 8), kc = (ch % (BK / 8)) * 8;
        uint4 u = make_uint4(0u, 0u, 0u, 0u);
        if (n0 + n < C && k0 + kc < C)
          u = *reinterpret_cast<const uint4*>(kt + (long long)(n0 + n) * K9 +
                                              (long long)tap * C + k0 + kc);
        *reinterpret_cast<uint4*>(&Bs[n][kc]) = u;
      }
      __syncthreads();
      #pragma unroll
      for (int ks = 0; ks < BK; ks += 16) {
        uint32_t a[4];
        ldmatrix_x4(a, &As[warp * 16 + lane % 16][ks + (lane / 16) * 8]);
        #pragma unroll
        for (int nj = 0; nj < BNM / 16; ++nj) {
          uint32_t b[4];
          ldmatrix_x4(b, &Bs[nj * 16 + lane % 8 + (lane / 16) * 8][ks + ((lane / 8) % 2) * 8]);
          mma_bf16(acc[2 * nj], a, b[0], b[1]);
          mma_bf16(acc[2 * nj + 1], a, b[2], b[3]);
        }
      }
    }
  }

  // accumulator fragment: rows lane/4 and lane/4 + 8, columns (lane%4)*2, +1
  #pragma unroll
  for (int ni = 0; ni < BNM / 8; ++ni) {
    const int co = n0 + ni * 8 + (lane % 4) * 2;
    if (co >= C) continue;
    const float2 bb = *reinterpret_cast<const float2*>(bias + co);
    #pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long p = p0 + warp * 16 + lane / 4 + h * 8;
      if (p >= P) continue;
      store2(out + p * C + co, acc[ni][2 * h] + bb.x, acc[ni][2 * h + 1] + bb.y);
    }
  }
}

}  // namespace

extern "C" {

// The resident-slice route.  out_dtype: 0 = float32, 1 = bfloat16; w_dtype
// and b_dtype the same codes for k9c [9C][C] and bias [C], read in place.
// s is int8 [N, H, W, C], contiguous; s, k9c and out are 16-byte aligned;
// th, tw, bn, cw, tiles, slices, grid and smem are the plan
// (bench_pallas_dw.py:plan_dense3, route "wgmma").  Returns the launch's
// cudaError_t.
int dense3_wgmma_fwd(int out_dtype, int w_dtype, int b_dtype, const void* s,
                     const void* k9c, const void* bias, void* out, int N, int H, int W,
                     int C, int th, int tw, int bn, int cw, int tiles, int slices, int grid,
                     int smem, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (C <= 0 || C % 16 != 0 || cw != (C < 64 ? C : 64) || C % cw != 0 ||
      bn * slices != C || th != TH || tw != TW || grid <= 0 || grid % slices != 0 ||
      (unsigned)w_dtype > 1u || (unsigned)b_dtype > 1u)
    return (int)cudaErrorInvalidValue;
  if ((long long)N * H * W == 0) return (int)cudaSuccess;
  const int8_t* s8 = static_cast<const int8_t*>(s);
  if (out_dtype == 0)
    return dispatch_wgmma<float>(cw, bn, C / cw, s8, k9c, w_dtype, bias, b_dtype,
                                 static_cast<float*>(out), N, H, W, tiles, slices, grid,
                                 smem, st);
  if (out_dtype == 1)
    return dispatch_wgmma<bf16>(cw, bn, C / cw, s8, k9c, w_dtype, bias, b_dtype,
                                static_cast<bf16*>(out), N, H, W, tiles, slices, grid,
                                smem, st);
  return (int)cudaErrorInvalidValue;
}

// The flattened route (plan route "mma").  out_dtype: 0 = float32,
// 1 = bfloat16.  s is int8 [N, H, W, C], contiguous, 16-byte aligned; kt is
// bf16 [C][9C]; bias is f32 [C]; C % 16 == 0.  Returns the launch's
// cudaError_t.
int dense3_mma_fwd(int out_dtype, const void* s, const void* kt, const void* bias,
                   void* out, int N, int H, int W, int C, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long P = (long long)N * H * W;
  if (C <= 0 || C % 16 != 0) return (int)cudaErrorInvalidValue;
  if (P == 0) return (int)cudaSuccess;
  const dim3 grid((unsigned)((P + BM - 1) / BM), (unsigned)((C + BNM - 1) / BNM));
  if (out_dtype == 0)
    dense3_mma<float><<<grid, kThreads, 0, st>>>(
        static_cast<const int8_t*>(s), static_cast<const bf16*>(kt),
        static_cast<const float*>(bias), static_cast<float*>(out), P, H, W, C);
  else if (out_dtype == 1)
    dense3_mma<bf16><<<grid, kThreads, 0, st>>>(
        static_cast<const int8_t*>(s), static_cast<const bf16*>(kt),
        static_cast<const float*>(bias), static_cast<bf16*>(out), P, H, W, C);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

const char* dense3_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

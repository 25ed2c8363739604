// Depthwise 3x3 SAME convolution plus bias over a spike plane, for Hopper
// (sm_90a).
//
// Replaces two TPU kernels, which compute one function:
//   * ecs_yolo_tpu/snn/pallas_dw.py:73 binary_dw3_conv (`_dw3_kernel`): the
//     training path's depthwise spread over a binary spike plane, read as
//     int8 (`s.astype(int8)`);
//   * scripts/bench_pallas_dw.py:72 pallas_dw3: the bench prototype of it,
//     over any int8 plane, with an output dtype of its own.
// out[n,h,w,c] = round_once(b[c] + sum_{dy,dx} q(s[n,h+dy-1,w+dx-1,c]) * k[dy,dx,c]):
// the sum in f32 from the bias, the taps in row-major order, zeros outside
// the image, q(v) the int8 value of v.  Two modes:
//   * int8 in (pallas_dw3): s int8 (any values), k and b f32 or bf16,
//     out f32 or bf16;
//   * float in (binary_dw3_conv): s f32 or bf16, read in its own dtype and
//     converted as Tensor.to(torch.int8) does (truncation toward zero: exact
//     for spikes, which are 0 or 1, and for every value in (-129, 128));
//     k, b and out in s's dtype.  The same pass writes the int8 plane s8,
//     which the caller keeps for the backward, so no separate cast runs.
//
// What bounds it: bytes.  Per element it reads 1-4 bytes, writes 2-5 and does
// 18 operations, far below the card's 295 operations a byte; the weights are
// 10 C values shared by every pixel.  The design keeps each byte crossing
// from device memory about once and the weights out of the memory path:
//   * a block is 128 threads: gb channel groups of 8 channels (gb the
//     largest power of two <= 16 dividing C / 8) times tw = 128 / gb columns,
//     over a strip of `rows` output rows of one image;
//   * each thread loads its group's 9 tap vectors and bias once, into
//     registers (bf16 weights stay packed, two to a register, and widen at
//     each use), and walks down its column: each input row it reads (3
//     vectors, the columns x-1..x+1) feeds the three output rows that use
//     it, through three rolling accumulators, so a new output row costs 3
//     vector loads, not 9, and the taps still add in row-major order (dy = 0
//     arrives first, from the row above).  Each row's loads go out two rows
//     before its arithmetic (a one-row strip has its three rows in flight at
//     once);
//   * the rows come from global memory: the horizontal neighbours a thread
//     reads are its block's threads' own vectors, served by L1, so each
//     input byte crosses from device memory about once (a halo window
//     staged in shared memory by cp.async measured slower on the H100 at
//     every training site; PERF.md);
//   * the strip height is planned in Python (snn/spread.py:plan_dw3) so that
//     one wave of blocks covers the SMs (three blocks an SM: 168 registers a
//     thread hold the weights, the accumulators and three rows in flight);
//     32-bit index arithmetic, no division in the walk, 16-byte accesses for
//     bf16 and f32 data (8 bytes for int8).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;     // gb channel groups x tw columns
constexpr int kVec = 8;           // channels of a group
using bf16 = __nv_bfloat16;

// q(v) of a float as f32: truncation toward zero, exact for |v| < 2^22 (the
// sum with +-1.5 * 2^23, rounded toward zero, drops the fraction)
__device__ __forceinline__ float trunc_small(float v) {
  const float m = __int_as_float((__float_as_int(v) & 0x80000000) | 0x4B400000);
  return __fadd_rz(v, m) - m;
}

// 8 values of a plane: raw vector, its q values as f32, a zero vector
template <typename I> struct Plane;

template <> struct Plane<int8_t> {
  struct __align__(8) Raw { uint32_t w[2]; };
  static constexpr bool kFloat = false;
  __device__ static Raw load(const int8_t* p) {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
    return {{u.x, u.y}};
  }
  // a signed byte b as f32: the float with bits 0x4B0000(b ^ 0x80) is
  // 2^23 + 128 + b
  __device__ static void values(const Raw& r, float q[8]) {
    #pragma unroll
    for (int j = 0; j < 2; ++j) {
      const uint32_t u = r.w[j] ^ 0x80808080u;
      #pragma unroll
      for (int i = 0; i < 4; ++i)
        q[4 * j + i] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + i)) - 8388736.0f;
    }
  }
};

template <> struct Plane<bf16> {
  struct __align__(16) Raw { uint32_t w[4]; };
  static constexpr bool kFloat = true;
  __device__ static Raw load(const bf16* p) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    return {{u.x, u.y, u.z, u.w}};
  }
  __device__ static void values(const Raw& r, float q[8]) {
    #pragma unroll
    for (int i = 0; i < 4; ++i) {
      q[2 * i] = trunc_small(__uint_as_float(r.w[i] << 16));
      q[2 * i + 1] = trunc_small(__uint_as_float(r.w[i] & 0xffff0000u));
    }
  }
};

template <> struct Plane<float> {
  struct __align__(16) Raw { float v[8]; };
  static constexpr bool kFloat = true;
  __device__ static Raw load(const float* p) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    const float4 b = __ldg(reinterpret_cast<const float4*>(p + 4));
    return {{a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w}};
  }
  __device__ static void values(const Raw& r, float q[8]) {
    #pragma unroll
    for (int i = 0; i < 8; ++i) q[i] = trunc_small(r.v[i]);
  }
};

// the 9 tap vectors and the bias of one channel group, in registers
template <typename P> struct Taps;

template <> struct Taps<float> {
  float k[9][8], b[8];
  __device__ static void load8(const float* p, float d[8]) {
    const float4 lo = __ldg(reinterpret_cast<const float4*>(p));
    const float4 hi = __ldg(reinterpret_cast<const float4*>(p + 4));
    d[0] = lo.x; d[1] = lo.y; d[2] = lo.z; d[3] = lo.w;
    d[4] = hi.x; d[5] = hi.y; d[6] = hi.z; d[7] = hi.w;
  }
  __device__ void load(const float* kp, const float* bp, int c0, int C) {
    #pragma unroll
    for (int t = 0; t < 9; ++t) load8(kp + t * C + c0, k[t]);
    load8(bp + c0, b);
  }
  __device__ float w(int t, int i) const { return k[t][i]; }
  __device__ void bias(float a[8]) const {
    #pragma unroll
    for (int i = 0; i < 8; ++i) a[i] = b[i];
  }
};

template <> struct Taps<bf16> {
  uint32_t k[9][4], b[4];   // bf16 pairs, element 2j in the low half
  __device__ static void load8(const bf16* p, uint32_t d[4]) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    d[0] = u.x; d[1] = u.y; d[2] = u.z; d[3] = u.w;
  }
  __device__ void load(const bf16* kp, const bf16* bp, int c0, int C) {
    #pragma unroll
    for (int t = 0; t < 9; ++t) load8(kp + t * C + c0, k[t]);
    load8(bp + c0, b);
  }
  __device__ static float widen(uint32_t pair, int i) {
    return __uint_as_float(i & 1 ? pair & 0xffff0000u : pair << 16);
  }
  __device__ float w(int t, int i) const { return widen(k[t][i >> 1], i); }
  __device__ void bias(float a[8]) const {
    #pragma unroll
    for (int i = 0; i < 8; ++i) a[i] = widen(b[i >> 1], i);
  }
};

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
// the int8 bytes of 8 q values (integers in [-128, 127]): the low byte of
// 1.5 * 2^23 + q
__device__ __forceinline__ void store_bytes(int8_t* p, const float q[8]) {
  uint32_t w[2];
  #pragma unroll
  for (int j = 0; j < 2; ++j) {
    uint32_t u[4];
    #pragma unroll
    for (int i = 0; i < 4; ++i) u[i] = __float_as_uint(q[4 * j + i] + 12582912.0f);
    w[j] = __byte_perm(__byte_perm(u[0], u[1], 0x0040), __byte_perm(u[2], u[3], 0x0040),
                       0x5410);
  }
  *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
}

// blocks an SM holds, by the registers a thread needs: 9 tap vectors (40
// registers in bf16, 80 in f32), three accumulators (24) and three rows in
// flight (12 registers a row of bf16, 6 of int8, 24 of f32); the plan
// (snn/spread.py:dw3_blocks_per_sm) sizes its wave by the same rule
template <typename I, typename P>
constexpr int blocks_per_sm() { return sizeof(I) == 4 && sizeof(P) == 4 ? 2 : 3; }

// I: the plane's dtype (int8, bf16, f32); P: the weights'; O: the output's.
// s8 (float-in mode only) receives q(s) as int8.  Blocks in the order
// (channel blocks fastest, then column blocks, strips, images).
template <typename I, typename P, typename O>
__global__ void __launch_bounds__(kThreads, (blocks_per_sm<I, P>()))
spread_dw3_kernel(const I* __restrict__ s, const P* __restrict__ k,
                  const P* __restrict__ b, O* __restrict__ out,
                  int8_t* __restrict__ s8, int H, int W, int C, int rows,
                  int strips, int tw, int gb) {
  using Pl = Plane<I>;
  using Raw = typename Pl::Raw;

  const int gblks = C / kVec / gb, wblks = (W + tw - 1) / tw;
  int blk = blockIdx.x;
  const int gblk = blk % gblks;
  blk /= gblks;
  const int wblk = blk % wblks;
  blk /= wblks;
  const int strip = blk % strips, img = blk / strips * H;   // img: row 0 of image n
  const int gl = threadIdx.x % gb, xl = threadIdx.x / gb;
  const int g0 = gblk * gb, c0 = (g0 + gl) * kVec;
  const int x0 = wblk * tw, x = x0 + xl;
  const int h0 = strip * rows, h1 = min(h0 + rows, H);
  if (x >= W) return;

  Taps<P> taps;
  taps.load(k, b, c0, C);

  // the three vectors of input row y (columns x-1, x, x+1), zeros outside
  auto fetch = [&](int y, Raw (&r)[3]) {
    const bool yin = (unsigned)y < (unsigned)H;
    const I* p = s + (long long)((img + y) * W + x) * C + c0;
    #pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      const int xx = x + dx - 1;
      r[dx] = yin && (unsigned)xx < (unsigned)W ? Pl::load(p + (dx - 1) * C) : Raw{};
    }
  };

  // rows in flight: row y is read two steps before its arithmetic, into a
  // ring of three row buffers that turns with the accumulators
  Raw r0[3], r1[3], r2[3];
  fetch(h0 - 1, r0);
  fetch(h0, r1);
  // input row y (in R): A (output y+1) takes the dy = 0 taps, B (output y)
  // dy = 1, D (output y-1) dy = 2 and is then complete; D restarts from the
  // bias as output y+2's accumulator; row y+2 goes out into F (the buffer
  // the previous step read).  Returns true after the strip's last row.
  auto step = [&](int y, float (&A)[8], float (&B)[8], float (&D)[8], Raw (&R)[3],
                  Raw (&F)[3]) {
    if (y + 2 <= h1) fetch(y + 2, F);
    if ((unsigned)y < (unsigned)H) {
      #pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        float q[8];
        Pl::values(R[dx], q);
        if constexpr (Pl::kFloat) {
          if (dx == 1 && y >= h0 && y < h1)
            store_bytes(s8 + (long long)((img + y) * W + x) * C + c0, q);
        }
        #pragma unroll
        for (int i = 0; i < 8; ++i) {
          A[i] = fmaf(q[i], taps.w(dx, i), A[i]);
          B[i] = fmaf(q[i], taps.w(3 + dx, i), B[i]);
          D[i] = fmaf(q[i], taps.w(6 + dx, i), D[i]);
        }
      }
    }
    if (y > h0) store8(out + (long long)((img + y - 1) * W + x) * C + c0, D);
    taps.bias(D);
    return y >= h1;
  };

  float a0[8], a1[8], a2[8];
  taps.bias(a0);
  taps.bias(a1);
  taps.bias(a2);
  for (int y = h0 - 1;; y += 3)
    if (step(y, a0, a1, a2, r0, r2) || step(y + 1, a2, a0, a1, r1, r0) ||
        step(y + 2, a1, a2, a0, r2, r1))
      break;
}

template <typename I, typename P, typename O>
cudaError_t launch(const void* s, const void* k, const void* b, void* out, void* s8,
                   int H, int W, int C, int rows, int strips, int tw, int gb, int grid,
                   cudaStream_t st) {
  spread_dw3_kernel<I, P, O><<<grid, kThreads, 0, st>>>(
      static_cast<const I*>(s), static_cast<const P*>(k), static_cast<const P*>(b),
      static_cast<O*>(out), static_cast<int8_t*>(s8), H, W, C, rows, strips, tw, gb);
  return cudaGetLastError();
}

int dw3_launch(int in_dtype, int w_dtype, int out_dtype, const void* s, const void* k,
               const void* b, void* out, void* s8, int N, int H, int W, int C, int rows,
               int strips, int tw, int gb, int grid, cudaStream_t st) {
  const cudaError_t bad = cudaErrorInvalidValue;
  if (N < 0 || H < 0 || W < 0 || C <= 0 || C % kVec || gb <= 0 || gb > 16 ||
      (gb & (gb - 1)) || (C / kVec) % gb || gb * tw != kThreads || rows <= 0)
    return (int)bad;
  const long long need = (long long)N * strips * ((W + tw - 1) / tw) * (C / kVec / gb);
  if (strips != (H + rows - 1) / rows || grid != need) return (int)bad;
  const bool int8_in = in_dtype == 2;
  if (int8_in ? (s8 != nullptr || w_dtype < 0 || w_dtype > 1 || out_dtype < 0 ||
                 out_dtype > 1)
              : (s8 == nullptr || in_dtype < 0 || in_dtype > 1 || w_dtype != in_dtype ||
                 out_dtype != in_dtype))
    return (int)bad;
  if (grid == 0) return (int)cudaSuccess;
#define DW3_ARGS s, k, b, out, s8, H, W, C, rows, strips, tw, gb, grid, st
  if (!int8_in) {
    return (int)(in_dtype == 0 ? launch<float, float, float>(DW3_ARGS)
                               : launch<bf16, bf16, bf16>(DW3_ARGS));
  }
  if (w_dtype == 0 && out_dtype == 0) return (int)launch<int8_t, float, float>(DW3_ARGS);
  if (w_dtype == 0 && out_dtype == 1) return (int)launch<int8_t, float, bf16>(DW3_ARGS);
  if (w_dtype == 1 && out_dtype == 0) return (int)launch<int8_t, bf16, float>(DW3_ARGS);
  return (int)launch<int8_t, bf16, bf16>(DW3_ARGS);
#undef DW3_ARGS
}

}  // namespace

extern "C" {

// One launch, its 18 arguments in one block of int64 (one ctypes argument to
// convert, not 18):
//   a[0] in_dtype (of s): 0 = float32, 1 = bfloat16, 2 = int8;
//   a[1] w_dtype (of k and b), a[2] out_dtype: 0 = float32, 1 = bfloat16;
//   a[3..7] pointers s, k, b, out, s8;  a[8..11] N, H, W, C;
//   a[12..16] the plan (snn/spread.py:plan_dw3): rows, strips, tw, gb, grid,
//   checked here;  a[17] the CUDA stream.
// int8 in: any weight and output dtype, s8 null; float in: w_dtype ==
// out_dtype == in_dtype, s8 the int8 plane to write.  s [N, H, W, C]
// contiguous, 16-byte aligned, C % 8 == 0; k [9, C] and b [C] contiguous and
// 16-byte aligned.  Returns the launch's cudaError_t.
int spread_dw3_fwd(const long long* a) {
  auto i = [a](int j) { return static_cast<int>(a[j]); };
  auto p = [a](int j) { return reinterpret_cast<void*>(static_cast<uintptr_t>(a[j])); };
  return dw3_launch(i(0), i(1), i(2), p(3), p(4), p(5), p(6), p(7), i(8), i(9), i(10),
                    i(11), i(12), i(13), i(14), i(15), i(16),
                    static_cast<cudaStream_t>(p(17)));
}

const char* spread_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

// Fused ECS spread pw1x1(dw3x3(s) + dwb) + pwb as one implicit product, for
// Hopper (sm_90a).
//
// Replaces ecs_yolo_tpu/snn/pallas_dw.py:packed_spread_pallas (the TPU kernel
// `_packed_spread_kernel`): out[pos, :] = patches[pos, 9C] @ M[9C, C] + const
// with M[(dy, dx, ci), co] = dw[dy, dx, ci] * pw[ci, co] and
// const = dwb @ pw + pwb, both composed by the caller.  The spike plane
// s [N, H, W, C] holds 0 or 1 and is read as int8 and converted exactly; the
// product accumulates in f32, const is added in f32, and the result is
// rounded once.  The TPU kernel works on a width-packed [N, H, W/2, 2C]
// layout and splits the product into two width phases; on the canonical
// layout there is one product and no phase.
//
// What bounds it: at C = 64, 2 * 9 * C operations per output element against
// one byte read and one element written: operations, narrowly, in bf16 on
// the tensor cores; operations by far in f32 on the CUDA cores.
//
// Design: a block owns a tile of consecutive output pixels (flattened over
// N, H, W) and all C <= 64 output channels.  The patches are never formed:
// for each of the 9 taps the block stages the shifted [pixels, C] spike tile
// (zeros where the neighbour lies outside the image) and M[tap] in shared
// memory and multiplies them into the same accumulators.
//   bf16: 128 pixels a block, 8 warps of 16 pixels x C channels, mma.sync
//         m16n8k16 with f32 accumulation (the product of csrc/ecs_lif.cu);
//         M[tap] arrives as [Cout][Cin].
//   f32:  64 pixels a block, 4x4 outputs a thread, FMA in full f32 (no TF32);
//         M[tap] arrives as [Cin][Cout].
// Requires C % 16 == 0 and C <= 64; the wrapper checks it.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxC = 64;
constexpr int BMT = 128;          // pixels per block, bf16 tensor-core path
constexpr int BMF = 64;           // pixels per block, f32 FMA path
constexpr int LDT = kMaxC + 8;    // padded smem row (halves): ldmatrix conflict-free

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

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

// 8 spikes of the pixel `src` (or zeros), channels c..c+7
__device__ __forceinline__ uint2 load_spikes8(const int8_t* s, long long src, int C, int c,
                                              bool valid) {
  if (!valid) return make_uint2(0u, 0u);
  return *reinterpret_cast<const uint2*>(s + src * C + c);
}

// --- bf16: tensor cores -------------------------------------------------------

// mt is [9][Cout][Cin]
__global__ void __launch_bounds__(kThreads)
spread_gemm_bf16(const int8_t* __restrict__ s, const bf16* __restrict__ mt,
                 const float* __restrict__ cst, bf16* __restrict__ out,
                 long long P, int H, int W, int C) {
  __shared__ __align__(16) bf16 As[BMT][LDT];
  __shared__ __align__(16) bf16 Bs[kMaxC][LDT];

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const long long p0 = (long long)blockIdx.x * BMT;
  const int gpr = C / 8;                 // 8-channel groups per pixel row
  const int a_groups = BMT * gpr;        // <= 1024: at most 4 a thread
  const int b_chunks = C * gpr;          // 16-byte chunks of M[tap]: at most 2 a thread

  // the (up to 4) tile rows this thread stages, and their pixel coordinates
  int rq[4], cq[4], hq[4], wq[4];
  #pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int g = tid + q * kThreads;
    rq[q] = g / gpr;
    cq[q] = (g % gpr) * 8;
    const long long p = p0 + rq[q];
    const bool in = g < a_groups && p < P;
    wq[q] = in ? (int)(p % W) : -4;      // -4: no tap of it is ever valid
    hq[q] = in ? (int)((p / W) % H) : -4;
  }

  float acc[8][4] = {};

  for (int tap = 0; tap < 9; ++tap) {
    const int dy = tap / 3 - 1, dx = tap % 3 - 1;
    __syncthreads();                     // the previous tap's mma is done
    #pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (tid + q * kThreads >= a_groups) continue;
      const int hh = hq[q] + dy, ww = wq[q] + dx;
      const bool valid = hh >= 0 && hh < H && ww >= 0 && ww < W;
      const uint2 raw = load_spikes8(s, p0 + rq[q] + (long long)dy * W + dx, C, cq[q], valid);
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
      const int ch = tid + q * kThreads;
      if (ch >= b_chunks) continue;
      const int n = ch / gpr, kc = (ch % gpr) * 8;
      *reinterpret_cast<uint4*>(&Bs[n][kc]) =
          *reinterpret_cast<const uint4*>(mt + ((long long)tap * C + n) * C + kc);
    }
    __syncthreads();
    #pragma unroll
    for (int ks = 0; ks < kMaxC; ks += 16) {
      if (ks >= C) break;
      uint32_t a[4];
      ldmatrix_x4(a, &As[warp * 16 + lane % 16][ks + (lane / 16) * 8]);
      #pragma unroll
      for (int nj = 0; nj < kMaxC / 16; ++nj) {
        if (nj * 16 >= C) break;
        uint32_t b[4];
        ldmatrix_x4(b, &Bs[nj * 16 + lane % 8 + (lane / 16) * 8][ks + ((lane / 8) % 2) * 8]);
        mma_bf16(acc[2 * nj], a, b[0], b[1]);
        mma_bf16(acc[2 * nj + 1], a, b[2], b[3]);
      }
    }
  }

  // accumulator fragment: rows lane/4 and lane/4 + 8, columns (lane%4)*2, +1
  #pragma unroll
  for (int ni = 0; ni < kMaxC / 8; ++ni) {
    if (ni * 8 >= C) break;
    const int co = ni * 8 + (lane % 4) * 2;
    const float2 cc = *reinterpret_cast<const float2*>(cst + co);
    #pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long p = p0 + warp * 16 + lane / 4 + h * 8;
      if (p >= P) continue;
      *reinterpret_cast<__nv_bfloat162*>(out + p * C + co) =
          __floats2bfloat162_rn(acc[ni][2 * h] + cc.x, acc[ni][2 * h + 1] + cc.y);
    }
  }
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

// dtype: 0 = float32 (m is [9][Cin][Cout]), 1 = bfloat16 (m is [9][Cout][Cin]).
// s is int8 [N, H, W, C], contiguous, 16-byte aligned; cst is float32 [C];
// C % 16 == 0, C <= 64.  Returns the launch's cudaError_t.
int spread_gemm_fwd(int dtype, const void* s, const void* m, const void* cst, void* out,
                    int N, int H, int W, int C, void* stream) {
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
  if (dtype == 1) {
    spread_gemm_bf16<<<(unsigned)((P + BMT - 1) / BMT), kThreads, 0, st>>>(
        static_cast<const int8_t*>(s), static_cast<const bf16*>(m),
        static_cast<const float*>(cst), static_cast<bf16*>(out), P, H, W, C);
    return (int)cudaGetLastError();
  }
  return (int)cudaErrorInvalidValue;
}

const char* spread_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

// Dense 3x3 SAME convolution over an int8 plane as one implicit product, for
// Hopper (sm_90a).
//
// Replaces scripts/bench_pallas_dw.py:pallas_dense3 (the TPU kernel
// `_dense3_kernel`, the prototype of the packed composite spread):
// out[pos, co] = patches[pos, 9C] @ bf16(k9c)[9C, C] + bias, where the patch
// row of a pixel holds its 3x3 neighbourhood in (dy, dx, ci) order with zeros
// outside the image.  The int8 values are converted to bf16 exactly (any
// int8 is exact in bf16), the weights are rounded to bf16 by the caller as
// the TPU kernel does whatever the output dtype, the product accumulates in
// f32, the f32 bias is added, and the result is rounded once to the output
// dtype (f32 or bf16).
//
// What bounds it: operations.  2 * 9 * C operations per output element
// against one byte read and one element written; at C = 128 that is ~1150
// operations a byte, far above the card's ratio.
//
// Design: the patches are never formed.  A block owns 128 consecutive
// output pixels (flattened over N, H, W) and 64 output channels.  For each
// of the 9 taps and each 64-channel slice of the input, it stages the shifted
// [128, 64] int8 tile (zeros where the neighbour lies outside the image) as
// bf16 and the [64 out, 64 in] slice of the weights in shared memory, and
// 8 warps of 16 pixels x 64 channels multiply them on the tensor cores
// (mma.sync m16n8k16, bf16 operands, f32 accumulation), the product of
// csrc/spread_gemm.cu widened from C <= 64 to any C % 16 == 0.  The TPU
// kernel's row blocks (`bh`) are a VMEM device and change nothing here.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int BM = 128;           // pixels per block
constexpr int BN = 64;            // output channels per block
constexpr int BK = 64;            // input channels per staged slice
constexpr int LDT = BK + 8;       // padded smem row (halves): ldmatrix conflict-free

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

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// kt is the weights as [Cout][9C] (row co holds k9c[:, co]), bf16; bias f32
template <typename O>
__global__ void __launch_bounds__(kThreads)
dense3_kernel(const int8_t* __restrict__ s, const bf16* __restrict__ kt,
              const float* __restrict__ bias, O* __restrict__ out, long long P, int H,
              int W, int C) {
  __shared__ __align__(16) bf16 As[BM][LDT];
  __shared__ __align__(16) bf16 Bs[BN][LDT];

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const long long p0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
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
        for (int nj = 0; nj < BN / 16; ++nj) {
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
  for (int ni = 0; ni < BN / 8; ++ni) {
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

// out_dtype: 0 = float32, 1 = bfloat16.  s is int8 [N, H, W, C], contiguous,
// 16-byte aligned; kt is bf16 [C][9C]; bias is f32 [C]; C % 16 == 0.
// Returns the launch's cudaError_t.
int dense3_fwd(int out_dtype, const void* s, const void* kt, const void* bias, void* out,
               int N, int H, int W, int C, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long P = (long long)N * H * W;
  if (C <= 0 || C % 16 != 0) return (int)cudaErrorInvalidValue;
  if (P == 0) return (int)cudaSuccess;
  const dim3 grid((unsigned)((P + BM - 1) / BM), (unsigned)((C + BN - 1) / BN));
  if (out_dtype == 0)
    dense3_kernel<float><<<grid, kThreads, 0, st>>>(
        static_cast<const int8_t*>(s), static_cast<const bf16*>(kt),
        static_cast<const float*>(bias), static_cast<float*>(out), P, H, W, C);
  else if (out_dtype == 1)
    dense3_kernel<bf16><<<grid, kThreads, 0, st>>>(
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

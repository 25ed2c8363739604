// Device helpers shared by the two cooperative ECS-LIF kernels, ecs_lif.cu
// (K1) and ecs_lif_rows.cu (K2): roundings to the storage dtype, the spike,
// bf16-pair arithmetic, cp.async, and the grid-wide barrier.  Both kernels
// drive the same barrier buffer of a (device, stream)
// (snn/ecs_lif.py:_barrier), so its protocol is written once, here.
// _build.py hashes the headers a source includes into its library's name,
// so an edited header rebuilds both kernels.

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

}  // namespace

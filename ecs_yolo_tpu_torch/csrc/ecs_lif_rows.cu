// General-shape fused ECS-LIF forward for Hopper (sm_90a): the whole T-step
// recurrence of one MemUpdate site in one launch, for any H, W, C and any
// strides of x.
//
// Replaces ecs_yolo_tpu/snn/pallas_kernels.py:ecs_lif_fused (the TPU kernel
// `_ecs_kernel`).  Its arithmetic, step for step, in the input dtype:
//   fecs  = beta * tanh(ecs)
//   mem   = mem * decay * (1 - spike_prev) + x_t + fecs
//   spike = (float(mem) > thresh)            (SiLU when act)
//   d     = 0; for dy, dx in row-major order: d += spike[r+dy, w+dx] * dw[dy, dx]
//           (product and sum each rounded to the dtype), then d += dwb
//   p     = round(sum over ci, in f32, of d[ci] * pw[ci, co]) + pwb
//   ecs   = alpha * p + (1 - 1/tau) * ecs
// Every elementwise operation rounds to the storage dtype and nothing is
// contracted into an FMA.  The 1x1 sum runs over ci = 0..C-1 in that order,
// each product and each partial sum rounded to f32: the plain version
// (snn/fused.py:ecs_lif_rows_reference) sums in the same order, so the two
// agree bit for bit apart from tanh/exp.  The TPU kernel also updates ecs
// after the last step; nobody can observe that and it is skipped.
//
// Design.  What the TPU kernel computes, not its blocks: its overlapping row
// windows are copied out beforehand because a BlockSpec cannot overlap; here
// a block reads its halo rows from x in place.  One block per (image, row
// tile).  A tile of `rb` output rows is computed on a window of full-width
// rows grown by halo = T-1 rows each side and clipped to the image: the 3x3
// widens the receptive field one row per step, so after T steps the tile's
// interior is exact.  Rows outside the image are absent from the window,
// which is what the TPU kernel's row mask (zero spikes there) amounts to.
// State per block, in a device workspace the wrapper allocates: mem, ecs and
// the depthwise result d (three planes of window size).  The spike of a
// step is a function of its mem, so no spike plane is kept.  Per step:
//   (1) d = dw3x3(fire(mem)) + dwb over the window, one element a thread;
//   (2) p = d @ pw over 64x64 output tiles (CUDA-core loop in f32 for both
//       dtypes, 4x4 outputs a thread, K slices of 16 through shared memory),
//       whose epilogue finishes the ecs update and the next step's membrane
//       and spike for the same element.
// All accesses are scalar and guarded: no C % 8, no alignment demand.
//
// What bounds it.  The function moves 2 * T*N*H*W*C elements and does
// (T-1)*N*H*W*(2*C*C + 18*C) operations, on CUDA cores in both dtypes, so
// from C >= 64 the product bounds it (against the f32 peak).  Beyond that
// this version pays the halo recompute, the state round trips through the
// workspace, scalar accesses, and two roundings where an FMA has one.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int BM = 64;   // pixels per product tile
constexpr int BN = 64;   // output channels per product tile
constexpr int BK = 16;   // input channels per K slice

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const bf16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(bf16* p, float v) { *p = __float2bfloat16_rn(v); }

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

struct Consts {
  float thresh, decay, alpha, beta, leak;  // already rounded to the dtype
};

// element strides of x: [T, N, H, W, C]
struct Strides {
  long long t, n, h, w, c;
};

// spike (or SiLU) of a membrane value
template <typename T>
__device__ __forceinline__ float fire(float m, float thresh, int act) {
  if (act) return rnd<T>(__fdiv_rn(m, __fadd_rn(1.0f, expf(-m))));
  return m > thresh ? 1.0f : 0.0f;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
ecs_lif_rows_kernel(const T* __restrict__ x, Strides xs, T* __restrict__ out,
                    const T* __restrict__ dw, const T* __restrict__ dwb,
                    const T* __restrict__ pw, const T* __restrict__ pwb,
                    T* __restrict__ ws, long long ws_cap,
                    int Tn, int H, int W, int C, int rb, int halo, Consts k, int act) {
  // +4 pads each K row: the transposed A stores then conflict at most 2-way
  __shared__ __align__(16) float As[BK][BM + 4];
  __shared__ __align__(16) float Bs[BK][BN];

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int n = blockIdx.y;
  const int r0 = blockIdx.x * rb;
  const int r1 = min(H, r0 + rb);
  const int w0 = max(0, r0 - halo);
  const int w1 = min(H, r1 + halo);
  const int nwr = w1 - w0;                 // window rows
  // offsets inside one window fit in an int (the wrapper checks H*W*C < 2^31)
  const int rowel = W * C;
  const int plane = nwr * rowel;
  const int M = nwr * W;                   // window pixels
  const int lo = (r0 - w0) * rowel, hi = (r1 - w0) * rowel;  // interior elements

  const long long blk = (long long)blockIdx.y * gridDim.x + blockIdx.x;
  T* mem = ws + blk * 3 * ws_cap;
  T* ecs = mem + ws_cap;
  T* dbuf = ecs + ws_cap;

  const long long img = (long long)H * rowel;
  const long long out_tstride = (long long)gridDim.y * img;
  const T* xw = x + n * xs.n + w0 * xs.h;                    // window, step 0
  T* ow = out + n * img + (long long)w0 * rowel;

  // step 0: mem = x_0, ecs = 0
  for (int e = tid; e < plane; e += kThreads) {
    const int c = e % C, pix = e / C;
    const float m = ld(xw + (pix / W) * xs.h + (pix % W) * xs.w + c * xs.c);
    st(mem + e, m);
    st(ecs + e, 0.0f);
    if (e >= lo && e < hi) st(ow + e, fire<T>(m, k.thresh, act));
  }
  __syncthreads();

  for (int t = 0; t + 1 < Tn; ++t) {
    // (1) depthwise 3x3 of this step's spikes: tap by tap in the dtype, from
    // zero, row-major; a tap outside the window adds nothing
    for (int e = tid; e < plane; e += kThreads) {
      const int c = e % C, pix = e / C;
      const int w = pix % W, r = pix / W;
      float d = 0.0f;
      #pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        const int rr = r + dy - 1;
        if (rr < 0 || rr >= nwr) continue;
        #pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const int ww = w + dx - 1;
          if (ww < 0 || ww >= W) continue;
          const float s = fire<T>(ld(mem + (rr * W + ww) * C + c), k.thresh, act);
          d = add<T>(d, mul<T>(s, ld(dw + (dy * 3 + dx) * C + c)));
        }
      }
      st(dbuf + e, add<T>(d, ld(dwb + c)));
    }
    __syncthreads();

    // (2) p = d @ pw, then the per-element tail: ecs update, step t+1's
    // membrane and spike
    const T* xn = xw + (long long)(t + 1) * xs.t;
    T* on = ow + (long long)(t + 1) * out_tstride;
    for (int m0 = 0; m0 < M; m0 += BM) {
      for (int n0 = 0; n0 < C; n0 += BN) {
        float acc[4][4] = {};
        for (int k0 = 0; k0 < C; k0 += BK) {
          #pragma unroll
          for (int q = 0; q < (BM * BK) / kThreads; ++q) {
            const int idx = tid + q * kThreads;
            const int kk = idx % BK, mm = idx / BK;
            const int p = m0 + mm;
            As[kk][mm] = (p < M && k0 + kk < C) ? ld(dbuf + p * C + k0 + kk) : 0.0f;
          }
          #pragma unroll
          for (int q = 0; q < (BK * BN) / kThreads; ++q) {
            const int idx = tid + q * kThreads;
            const int nn = idx % BN, kk = idx / BN;
            Bs[kk][nn] = (k0 + kk < C && n0 + nn < C)
                             ? ld(pw + (long long)(k0 + kk) * C + n0 + nn) : 0.0f;
          }
          __syncthreads();
          // the K slices past C hold zeros: adding +0 changes no sum
          #pragma unroll
          for (int kk = 0; kk < BK; ++kk) {
            const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
            const float4 b = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
            const float av[4] = {a.x, a.y, a.z, a.w};
            const float bv[4] = {b.x, b.y, b.z, b.w};
            #pragma unroll
            for (int i = 0; i < 4; ++i)
              #pragma unroll
              for (int j = 0; j < 4; ++j)
                acc[i][j] = __fadd_rn(acc[i][j], __fmul_rn(av[i], bv[j]));
          }
          __syncthreads();
        }
        #pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int p = m0 + ty * 4 + i;
          if (p >= M) continue;
          #pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int co = n0 + tx * 4 + j;
            if (co >= C) continue;
            const int e = p * C + co;
            const float ev = add<T>(rnd<T>(acc[i][j]), ld(pwb + co));
            const float en = add<T>(mul<T>(k.alpha, ev), mul<T>(k.leak, ld(ecs + e)));
            const float fecs = mul<T>(k.beta, rnd<T>(tanhf(en)));
            const float mo = ld(mem + e);
            const float gate = sub<T>(1.0f, fire<T>(mo, k.thresh, act));
            const float xv = ld(xn + (p / W) * xs.h + (p % W) * xs.w + co * xs.c);
            const float mn = add<T>(add<T>(mul<T>(mul<T>(mo, k.decay), gate), xv), fecs);
            st(ecs + e, en);
            st(mem + e, mn);
            if (e >= lo && e < hi) st(on + e, fire<T>(mn, k.thresh, act));
          }
        }
      }
    }
    __syncthreads();
  }
}

template <typename T>
cudaError_t launch(const void* x, Strides xs, void* out, const void* dw, const void* dwb,
                   const void* pw, const void* pwb, void* ws, long long ws_cap, int Tn,
                   int N, int H, int W, int C, int rb, int halo, Consts k, int act,
                   cudaStream_t stream) {
  dim3 grid((H + rb - 1) / rb, N);
  ecs_lif_rows_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), xs, static_cast<T*>(out),
      static_cast<const T*>(dw), static_cast<const T*>(dwb),
      static_cast<const T*>(pw), static_cast<const T*>(pwb),
      static_cast<T*>(ws), ws_cap, Tn, H, W, C, rb, halo, k, act);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  Pointers are device pointers.  x is
// [Tn, N, H, W, C] with the element strides xs_*; out is contiguous; dw is
// [3, 3, C] and pw the 1x1 kernel as [Cin, Cout], both contiguous; ws holds
// 3 * ws_cap elements per block.  The constants are already rounded to the
// dtype by the caller.  Returns the cudaError_t of the launch (0 = launched).
int ecs_lif_rows_fwd(int dtype, const void* x, long long xs_t, long long xs_n,
                     long long xs_h, long long xs_w, long long xs_c, void* out,
                     const void* dw, const void* dwb, const void* pw, const void* pwb,
                     void* ws, long long ws_cap, int Tn, int N, int H, int W, int C,
                     int rb, int halo, float thresh, float decay, float alpha,
                     float beta, float leak, int act, void* stream) {
  Consts k{thresh, decay, alpha, beta, leak};
  Strides xs{xs_t, xs_n, xs_h, xs_w, xs_c};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float>(x, xs, out, dw, dwb, pw, pwb, ws, ws_cap, Tn, N, H, W, C,
                              rb, halo, k, act, s);
  if (dtype == 1)
    return (int)launch<bf16>(x, xs, out, dw, dwb, pw, pwb, ws, ws_cap, Tn, N, H, W, C,
                             rb, halo, k, act, s);
  return (int)cudaErrorInvalidValue;
}

const char* ecs_lif_rows_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

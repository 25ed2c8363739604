// Fused ECS-LIF forward for Hopper (sm_90a): the whole T-step recurrence of
// one MemUpdate site in one launch.
//
// Replaces ecs_yolo_tpu/snn/pallas_ecs_v3.py:ecs_lif_pallas (the TPU kernel
// `_kernel`).  Same recurrence, step for step, in the input dtype:
//   fecs  = beta * tanh(ecs)
//   mem   = mem * decay * (1 - spike_prev) + x_t + fecs
//   spike = (float(mem) > thresh)            (SiLU when act)
//   d     = dw3x3(spike) + dwb               (SAME zero padding)
//   e     = pw1x1(d) + pwb
//   ecs   = alpha * e + (1 - 1/tau) * ecs    (skipped after the last step)
// Each elementwise operation rounds to the storage dtype, as PyTorch's
// elementwise kernels and the plain loop (snn/neuron.py:ecs_lif_scan) do.
// The two convolutions accumulate in f32 and round once, as the library
// convolution and matrix product of the plain loop do; then the bias is
// added in the dtype.
//
// Design.  One block per (image, row tile).  A tile of `rb` output rows is
// computed on a window of full-width rows grown by halo = T-1 rows on each
// side and clipped to the image: the 3x3 spread widens the receptive field
// one row per step, so after T steps the tile's interior is exact.  Rows
// outside the image are simply absent from the window, which is the SAME zero
// padding; full rows mean the width needs no halo.  Per step the block runs
//   (1) the depthwise 3x3 over the window's spikes into a `d` buffer, eight
//       channels a thread with 16-byte loads,
//   (2) the C x C pointwise product d @ pw over 64x64 output tiles, whose
//       epilogue finishes the ecs update AND the next step's membrane update
//       and spike for the same elements, so mem/ecs/spike are touched once
//       per step.  bf16 runs the product on the tensor cores (mma.sync
//       m16n8k16, f32 accumulation; 8 warps of 32x16; K slices of 64 through
//       a 2-stage cp.async pipeline; the accumulator tile staged through
//       shared memory for a row-wise epilogue); float32 runs it as a
//       CUDA-core FMA loop (4x4 outputs a thread), in full f32.
// x is read once per step and spikes are written once; state never leaves
// the block between steps.  Where it lives: a window of full rows holds
// (rb + 2*halo) * W * C elements per state, which does not fit in the 227 KB
// of shared memory at any res10@640 site (the smallest, 20x20x128, needs
// 200 KB per state at rb=1), so at every site mem, ecs, spike and d live in
// a per-block workspace in device memory that the wrapper allocates.  Shared
// memory holds the GEMM tiles.
//
// What bounds it.  The function itself moves 2 * T*N*H*W*C elements (x in,
// spikes out) and does 2*N*H*W*C*C*(T-1) pointwise FLOPs (the 3x3 adds
// 18 per element).  At C <= 128 the bytes bound it; from C >= 512 the C^2
// product does.  This version pays, beyond that: the halo recompute
// ((rb + 2*halo) / rb more work; the wrapper picks rb to balance it against
// filling the SMs), the state round trips through the workspace (mostly L2
// at the small sites, HBM at the 320x320 stem site), and latency: each
// block walks its window's tiles in order, two blocks to an SM.
//
// Requires C % 8 == 0 (every channel count the model parser makes is a
// multiple of 8); the wrapper checks it.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int BM = 64;    // pixels per GEMM tile
constexpr int BN = 64;    // output channels per GEMM tile
constexpr int BK = 16;    // input channels per K slice, f32 FMA path
constexpr int BKT = 64;   // input channels per K slice, bf16 tensor-core path
constexpr int LDT = BKT + 8;  // padded smem row (halves): ldmatrix conflict-free
constexpr int kStages = 2;    // cp.async pipeline depth, bf16 path

using bf16 = __nv_bfloat16;

// 8 consecutive elements (16-byte aligned for bf16, 32 for f32)
__device__ __forceinline__ void load8(const float* p, float v[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(const bf16* p, float v[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
  #pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x; v[2 * i + 1] = f.y;
  }
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
// 2 consecutive elements
__device__ __forceinline__ float2 load2(const float* p) { return *reinterpret_cast<const float2*>(p); }
__device__ __forceinline__ float2 load2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

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

// spike (or SiLU) of a membrane value
template <typename T>
__device__ __forceinline__ float fire(float m, float thresh, int act) {
  if (act) return rnd<T>(__fdiv_rn(m, __fadd_rn(1.0f, expf(-m))));
  return m > thresh ? 1.0f : 0.0f;
}

// The per-element tail of a step: ecs update from the 1x1 product `acc`,
// then the next step's membrane and spike, updated in place.
template <typename T>
__device__ __forceinline__ void finish(float acc, float bias, float& ecs, float& mem,
                                       float& spk, float x, const Consts& k, int act) {
  const float ev = add<T>(rnd<T>(acc), bias);
  ecs = add<T>(mul<T>(k.alpha, ev), mul<T>(k.leak, ecs));
  const float fecs = mul<T>(k.beta, rnd<T>(tanhf(ecs)));
  const float gate = sub<T>(1.0f, spk);
  float m = mul<T>(mul<T>(mem, k.decay), gate);
  mem = add<T>(add<T>(m, x), fecs);
  spk = fire<T>(mem, k.thresh, act);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// 16-byte global -> shared copy, zero-filled when !valid (no global read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

struct Window {
  int M, C, lo, hi;  // GEMM rows (window pixels), channels, interior [lo, hi)
};

// (2) for bf16: tensor-core tile loop.  pwt is the 1x1 kernel as [Cout][Cin].
// K slices of 64 go through a 2-stage cp.async pipeline: the next slice's
// tiles load while the current one feeds the mma.  The finished tile's
// accumulators go through shared memory so that the epilogue reads and
// writes whole rows.
__device__ __forceinline__ void product_and_finish(
    const bf16* dbuf, const bf16* pwt, const bf16* pwb, bf16* mem, bf16* ecs, bf16* spk,
    const bf16* xn, bf16* on, const Window& w, const Consts& k, int act,
    unsigned char* smem) {
  using Tile = bf16[BM][LDT];
  Tile* As = reinterpret_cast<Tile*>(smem);               // [kStages]
  Tile* Bs = reinterpret_cast<Tile*>(smem + kStages * sizeof(Tile));
  float (*Cs)[BN + 4] = reinterpret_cast<float (*)[BN + 4]>(smem);  // over the stages
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = (warp / 4) * 32, wn = (warp % 4) * 16;
  const int M = w.M, C = w.C;
  const int nk = (C + BKT - 1) / BKT;

  // each thread copies two 16-byte chunks of each tile per slice
  auto load_slice = [&](int stage, int m0, int n0, int k0) {
    #pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int chunk = tid + q * kThreads;      // 0..511: row, 8-wide col
      const int r = chunk / (BKT / 8), kc = (chunk % (BKT / 8)) * 8;
      const int p = m0 + r, n = n0 + r, kk = k0 + kc;
      const bool ka = kk < C;
      cp_async16(&As[stage][r][kc], ka && p < M ? dbuf + (long long)p * C + kk : dbuf,
                 ka && p < M);
      cp_async16(&Bs[stage][r][kc], ka && n < C ? pwt + (long long)n * C + kk : pwt,
                 ka && n < C);
    }
    cp_async_commit();
  };

  for (int m0 = 0; m0 < M; m0 += BM) {
    for (int n0 = 0; n0 < C; n0 += BN) {
      float acc[2][2][4] = {};
      load_slice(0, m0, n0, 0);
      for (int kt = 0; kt < nk; ++kt) {
        if (kt + 1 < nk) {
          load_slice((kt + 1) % kStages, m0, n0, (kt + 1) * BKT);
          cp_async_wait<1>();
        } else {
          cp_async_wait<0>();
        }
        __syncthreads();
        const int st = kt % kStages;
        #pragma unroll
        for (int ks = 0; ks < BKT; ks += 16) {
          uint32_t a[2][4], b[4];
          #pragma unroll
          for (int mi = 0; mi < 2; ++mi)
            ldmatrix_x4(a[mi], &As[st][wm + mi * 16 + lane % 16][ks + (lane / 16) * 8]);
          ldmatrix_x4(b, &Bs[st][wn + lane % 8 + (lane / 16) * 8][ks + ((lane / 8) % 2) * 8]);
          #pragma unroll
          for (int mi = 0; mi < 2; ++mi)
            #pragma unroll
            for (int ni = 0; ni < 2; ++ni) mma_bf16(acc[mi][ni], a[mi], b[2 * ni], b[2 * ni + 1]);
        }
        __syncthreads();
      }
      #pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        #pragma unroll
        for (int ni = 0; ni < 2; ++ni)
          #pragma unroll
          for (int h = 0; h < 2; ++h)
            *reinterpret_cast<float2*>(
                &Cs[wm + mi * 16 + lane / 4 + h * 8][wn + ni * 8 + (lane % 4) * 2]) =
                make_float2(acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
      __syncthreads();
      // epilogue: eight consecutive channels of one pixel a thread
      #pragma unroll
      for (int q = 0; q < (BM * BN / 8) / kThreads; ++q) {
        const int g = tid + q * kThreads;
        const int r = g / (BN / 8), cg = (g % (BN / 8)) * 8;
        const int p = m0 + r, co = n0 + cg;
        if (p >= M || co >= C) continue;
        const int e = p * C + co;
        const float4 c0 = *reinterpret_cast<const float4*>(&Cs[r][cg]);
        const float4 c1 = *reinterpret_cast<const float4*>(&Cs[r][cg + 4]);
        const float a[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
        float bias[8], xv[8], ev[8], mv[8], sv[8];
        load8(pwb + co, bias);
        load8(xn + e, xv);
        load8(ecs + e, ev);
        load8(mem + e, mv);
        load8(spk + e, sv);
        #pragma unroll
        for (int i = 0; i < 8; ++i) finish<bf16>(a[i], bias[i], ev[i], mv[i], sv[i], xv[i], k, act);
        store8(ecs + e, ev);
        store8(mem + e, mv);
        store8(spk + e, sv);
        if (e >= w.lo && e < w.hi) store8(on + e, sv);
      }
      __syncthreads();  // Cs aliases the stages the next tile loads into
    }
  }
}

// (2) for float32: CUDA-core FMA tile loop, full f32 products.
__device__ __forceinline__ void product_and_finish(
    const float* dbuf, const float* pwt, const float* pwb, float* mem, float* ecs,
    float* spk, const float* xn, float* on, const Window& w, const Consts& k, int act,
    unsigned char* smem) {
  // +4 pads each K row: the transposed A stores then conflict at most 2-way
  float (*As)[BM + 4] = reinterpret_cast<float (*)[BM + 4]>(smem);
  float (*Bs)[BN] = reinterpret_cast<float (*)[BN]>(smem + BK * (BM + 4) * sizeof(float));
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int M = w.M, C = w.C;
  for (int m0 = 0; m0 < M; m0 += BM) {
    for (int n0 = 0; n0 < C; n0 += BN) {
      float acc[4][4] = {};
      for (int k0 = 0; k0 < C; k0 += BK) {
        #pragma unroll
        for (int q = 0; q < (BM * BK) / kThreads; ++q) {
          const int idx = tid + q * kThreads;
          const int kk = idx % BK, mm = idx / BK;
          const int p = m0 + mm;
          As[kk][mm] = (p < M && k0 + kk < C) ? dbuf[(long long)p * C + k0 + kk] : 0.0f;
        }
        #pragma unroll
        for (int q = 0; q < (BK * BN) / kThreads; ++q) {
          const int idx = tid + q * kThreads;
          const int kk = idx % BK, nn = idx / BK;
          Bs[kk][nn] = (k0 + kk < C && n0 + nn < C)
                           ? pwt[(long long)(n0 + nn) * C + k0 + kk] : 0.0f;
        }
        __syncthreads();
        #pragma unroll
        for (int kk = 0; kk < BK; ++kk) {
          const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
          const float4 b = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
          const float av[4] = {a.x, a.y, a.z, a.w};
          const float bv[4] = {b.x, b.y, b.z, b.w};
          #pragma unroll
          for (int i = 0; i < 4; ++i)
            #pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
        }
        __syncthreads();
      }
      #pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int p = m0 + ty * 4 + i;
        if (p >= M) continue;
        #pragma unroll
        for (int j = 0; j < 4; j += 2) {
          const int co = n0 + tx * 4 + j;
          if (co >= C) continue;
          const int e = p * C + co;
          const float2 b2 = load2(pwb + co), x2 = load2(xn + e);
          const float2 e2 = load2(ecs + e), m2 = load2(mem + e), s2 = load2(spk + e);
          float ea = e2.x, eb = e2.y, ma = m2.x, mb = m2.y, sa = s2.x, sb = s2.y;
          finish<float>(acc[i][j], b2.x, ea, ma, sa, x2.x, k, act);
          finish<float>(acc[i][j + 1], b2.y, eb, mb, sb, x2.y, k, act);
          store2(ecs + e, ea, eb);
          store2(mem + e, ma, mb);
          store2(spk + e, sa, sb);
          if (e >= w.lo && e < w.hi) store2(on + e, sa, sb);
        }
      }
    }
  }
}

constexpr int kSmemTensor = 2 * kStages * BM * LDT * 2;    // bf16 A and B stages
constexpr int kSmemFma = BK * (BM + 4) * 4 + BK * BN * 4;   // f32 A and B tiles
constexpr int kSmemBytes = kSmemTensor > kSmemFma ? kSmemTensor : kSmemFma;

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
ecs_lif_kernel(const T* __restrict__ x, long long x_tstride, T* __restrict__ out,
               const T* __restrict__ dw, const T* __restrict__ dwb,
               const T* __restrict__ pwt, const T* __restrict__ pwb,
               T* __restrict__ ws, long long ws_cap,
               int Tn, int H, int W, int C, int rb, int halo, Consts k, int act) {
  __shared__ __align__(16) unsigned char smem[kSmemBytes];

  const int tid = threadIdx.x;
  const int n = blockIdx.y;
  const int r0 = blockIdx.x * rb;
  const int r1 = min(H, r0 + rb);
  const int w0 = max(0, r0 - halo);
  const int w1 = min(H, r1 + halo);
  const int nwr = w1 - w0;
  // offsets inside one image fit in an int (the wrapper checks H*W*C < 2^31)
  const int rowel = W * C;
  const int plane = nwr * rowel;           // window elements
  const Window win{nwr * W, C, (r0 - w0) * rowel, (r1 - w0) * rowel};
  const long long img = (long long)H * rowel;
  const long long out_tstride = (long long)gridDim.y * img;

  const long long blk = (long long)blockIdx.y * gridDim.x + blockIdx.x;
  T* mem = ws + blk * 4 * ws_cap;
  T* ecs = mem + ws_cap;
  T* spk = ecs + ws_cap;
  T* dbuf = spk + ws_cap;

  const T* xw = x + n * img + (long long)w0 * rowel;    // window of step 0
  T* ow = out + n * img + (long long)w0 * rowel;

  // step 0: mem = x_0, ecs = 0; eight elements a thread
  for (int e = tid * 8; e < plane; e += kThreads * 8) {
    float m[8], s[8];
    const float z[8] = {};
    load8(xw + e, m);
    #pragma unroll
    for (int i = 0; i < 8; ++i) s[i] = fire<T>(m[i], k.thresh, act);
    store8(mem + e, m);
    store8(spk + e, s);
    store8(ecs + e, z);
    if (e >= win.lo && e < win.hi) store8(ow + e, s);
  }
  __syncthreads();

  for (int t = 0; t + 1 < Tn; ++t) {
    // (1) depthwise 3x3 over the window, f32 sum, then + bias in the dtype;
    // eight channels a thread (C % 8 == 0: a group never straddles pixels)
    for (int e = tid * 8; e < plane; e += kThreads * 8) {
      const int c = e % C;
      const int pix = e / C;
      const int w = pix % W;
      const int r = pix / W;
      float acc[8] = {};
      #pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        const int rr = r + dy - 1;
        if (rr < 0 || rr >= nwr) continue;
        #pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const int ww = w + dx - 1;
          if (ww < 0 || ww >= W) continue;
          float s[8], kw[8];
          load8(spk + (rr * W + ww) * C + c, s);
          load8(dw + (dy * 3 + dx) * C + c, kw);
          #pragma unroll
          for (int i = 0; i < 8; ++i) acc[i] = fmaf(s[i], kw[i], acc[i]);
        }
      }
      float b[8], d[8];
      load8(dwb + c, b);
      #pragma unroll
      for (int i = 0; i < 8; ++i) d[i] = add<T>(rnd<T>(acc[i]), b[i]);
      store8(dbuf + e, d);
    }
    __syncthreads();

    // (2) e = d @ pw, epilogue: ecs update, then step t+1's membrane/spike
    const T* xn = xw + (long long)(t + 1) * x_tstride;
    T* on = ow + (long long)(t + 1) * out_tstride;
    product_and_finish(dbuf, pwt, pwb, mem, ecs, spk, xn, on, win, k, act, smem);
    __syncthreads();
  }
}

template <typename T>
cudaError_t launch(const void* x, long long x_tstride, void* out, const void* dw,
                   const void* dwb, const void* pwt, const void* pwb, void* ws,
                   long long ws_cap, int Tn, int N, int H, int W, int C, int rb,
                   int halo, Consts k, int act, cudaStream_t stream) {
  dim3 grid((H + rb - 1) / rb, N);
  ecs_lif_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), x_tstride, static_cast<T*>(out),
      static_cast<const T*>(dw), static_cast<const T*>(dwb),
      static_cast<const T*>(pwt), static_cast<const T*>(pwb),
      static_cast<T*>(ws), ws_cap, Tn, H, W, C, rb, halo, k, act);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  Pointers are device pointers, 16-byte
// aligned; dw is [3, 3, C] and pwt the 1x1 kernel as [Cout, Cin], both
// contiguous; C % 8 == 0; the constants are already rounded to the dtype by
// the caller.  Returns the cudaError_t of the launch (0 = launched).
int ecs_lif_fwd(int dtype, const void* x, long long x_tstride, void* out,
                const void* dw, const void* dwb, const void* pwt, const void* pwb,
                void* ws, long long ws_cap, int Tn, int N, int H, int W, int C,
                int rb, int halo, float thresh, float decay, float alpha,
                float beta, float leak, int act, void* stream) {
  Consts k{thresh, decay, alpha, beta, leak};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float>(x, x_tstride, out, dw, dwb, pwt, pwb, ws, ws_cap,
                              Tn, N, H, W, C, rb, halo, k, act, s);
  if (dtype == 1)
    return (int)launch<bf16>(x, x_tstride, out, dw, dwb, pwt, pwb, ws, ws_cap,
                             Tn, N, H, W, C, rb, halo, k, act, s);
  return (int)cudaErrorInvalidValue;
}

const char* ecs_lif_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

// Fused ECS-LIF forward for Hopper (sm_90a): the whole T-step recurrence of
// one MemUpdate site in ONE COOPERATIVE LAUNCH, with T-1 grid-wide barriers
// and no halo recompute.
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
// The depthwise 3x3 sums its taps in f32 in (dy, dx) order and rounds once;
// the 1x1 product accumulates in f32 and rounds once; each bias is then
// added in the dtype.
//
// Design.  The spikes of step t-1 are the output plane out[t-1], and the
// only thing step t needs from another pixel is the one-pixel halo of those
// spikes.  So the launch runs all T steps with one grid-wide barrier between
// steps (an arrival counter and a generation word in a small device buffer,
// left ready for the next launch; the grid is sized from the occupancy
// query so that cudaLaunchCooperativeKernel guarantees every block is
// resident), and nothing is recomputed across tiles.
//   * Work items are (pixel tile x Cout slice): 128 consecutive pixels of the
//     flattened N*H*W plane times a slice of N = 32, 64 or 128 output
//     channels (snn/ecs_lif.py:plan_grid decides N, the grid and the shared
//     memory).  Block b owns the slice b % slices and every (grid/slices)-th
//     tile from b / slices, for the whole launch: the membrane and ECS state
//     of its items never leave it.  They live between steps in an owner-only
//     workspace [2, P, C] in device memory (mem, ecs), which step 1 does not
//     read (mem_0 = x_0, ecs = 0) and the last step does not write.
//   * Step 0: spike_0 = fire(x_0), written to out[0].
//   * Step t >= 1, per item, K-chunk by K-chunk (64 input channels in bf16,
//     32 in f32): the window of out[t-1] the tile's 3x3 taps reach -- three
//     runs of 130 pixels, or one run of 2W + 130 where they overlap -- comes
//     by cp.async.cg (an L2 load, coherent with the other blocks' stores)
//     into a 2-stage ring in shared memory, 16-byte pieces XOR-swizzled by
//     the slot; d = rnd(sum of 9 taps) + dwb is computed from it in f32.
//       bf16: straight into the A fragments of wgmma m64nNk16 (A from
//       registers; two warpgroups of 64 pixels each).  K stays in channel
//       order, so that each k-step sums the 16 channels a library product
//       over the same layout sums (another grouping rounds otherwise, and a
//       membrane on the threshold flips); a thread reads its 16 channels of
//       a slot as 8 words, and its weights are stored in that order.  B is
//       the block's slice of pw, resident in shared memory for the whole
//       launch in the 128-byte swizzle a K-major wgmma descriptor reads,
//       loaded once from pw in the
//       layout it arrives in: [Cout][Cin] memory (the model's view of its
//       conv weight), [Cin][Cout] (a contiguous JAX-shaped kernel) or any
//       strides; nothing is copied on the host.  Two A register sets
//       alternate, so the depthwise pass of chunk k+1 overlaps the wgmma of
//       chunk k.
//       float32: d into a [32][128] tile in shared memory and a CUDA-core FMA
//       product in full f32 (no TF32) against the chunk of pw, in the same
//       accumulator layout as wgmma's.
//     Epilogue in the accumulator's register layout (a 4x4 transpose within
//     each quad, so that each lane holds 8 consecutive channels of one
//     pixel): e = rnd(acc) + pwb, then ecs, fecs, mem and spike in the order
//     above; spike_{t-1} is read from out[t-1] (ld.global.cg), spike_t
//     written to out[t].  out is read and written by different blocks inside
//     the launch, so it is never read through the non-coherent path.  bf16
//     runs the tail on bf16 pairs (add/sub/mul.rn.bf16x2 give the float32
//     operation's value rounded to bf16 here, see hadd2), without the
//     float-to-bf16 conversions, which ran at a quarter of the FMA rate and
//     took most of the tail's time.
//
// What bounds it.  The function moves 2 * T*N*H*W*C elements (x in, spikes
// out; x once where it is a broadcast over T) and does 2*N*H*W*C*C*(T-1)
// pointwise operations (the 3x3 adds 18 per element).  At C <= 128 the bytes
// bound it, from C >= 512 the C^2 product.  Beyond that this version pays
// the state round trip through the workspace (L2 at the small sites, HBM at
// 320x320 and 160x160), the window's halo (up to 3x the tile's pixels from
// L2 at W >= 130), the depthwise pass repeated once per Cout slice (8-16x at
// C = 512/1024, from shared memory), and the barriers.
//
// Requires C % 8 == 0 (every channel count the model parser makes is a
// multiple of 8) and a 16-byte aligned x; the wrapper checks both.

#include "ecs_lif_common.cuh"

namespace {

constexpr int kThreads = 256;     // two warpgroups
constexpr int kTile = 128;        // pixels of a work item: 64 rows a warpgroup
constexpr int kRun = kTile + 2;   // pixels of one row run of a window
constexpr int kSlot = 128;        // bytes of one window pixel slot (one K-chunk)

template <typename T> struct Chunk;   // input channels of a K-chunk: 128 bytes
template <> struct Chunk<bf16> { static constexpr int K = 64; };
template <> struct Chunk<float> { static constexpr int K = 32; };

struct Params {
  const void* x;          // [T][P][C]; T stride x_ts (0: a broadcast)
  long long x_ts;
  void* out;              // [T][P][C]; out[t-1] is read by every block at step t
  const void* dw;         // dw[dy][dx][c] at dy*dw_sy + dx*dw_sx + c*dw_sc
  long long dw_sy, dw_sx, dw_sc;
  const void* dwb;
  long long dwb_s;
  const void* pw;         // pw[ci][co] at ci*pw_si + co*pw_so
  long long pw_si, pw_so;
  int pw_vec;             // 16-byte reads: 1 along ci (pw_si == 1), 2 along co; 0 none
  const void* pwb;
  long long pwb_s;
  void* ws;               // [2][P][C]: mem, ecs between steps (T > 2)
  unsigned* bar;          // [2]: arrivals, generation
  long long P;            // N*H*W
  int Tn, H, W, C, slices, tiles, act;
  float thresh, decay, alpha, beta, leak;   // rounded to the dtype by the caller
};

// --- bf16: wgmma with A from registers, B resident ------------------------------------

// d of the thread's rows r0, r0 + 8 and the 16 channels of chunk kc that its
// A fragments hold (quad_channel), from the window, in the A fragments of the
// chunk's four k-steps; K in channel order, so that each k-step sums the same
// 16 channels as a product over the plain layout does
__device__ __forceinline__ void d_frags(const uint8_t* win, const bf16* dw_s, const bf16* dwb_s,
                                        int kc, int cp, int S, int r0, int q,
                                        const uint32_t valid[2], uint32_t a[4][4]) {
  float acc[2][16];
  #pragma unroll
  for (int h = 0; h < 2; ++h)
    #pragma unroll
    for (int i = 0; i < 16; ++i) acc[h][i] = 0.f;
  #pragma unroll
  for (int tap = 0; tap < 9; ++tap) {
    float wk[16];
    load8<kPlain>(dw_s + tap * cp + kc * 64 + 16 * q, wk);
    load8<kPlain>(dw_s + tap * cp + kc * 64 + 16 * q + 8, wk + 8);
    #pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (!((valid[h] >> tap) & 1u)) continue;
      const int slot = (tap / 3) * S + r0 + 8 * h + tap % 3;
      const uint8_t* row = win + slot * kSlot + 4 * q;
      #pragma unroll
      for (int ks = 0; ks < 4; ++ks) {   // word q of pieces 2ks and 2ks + 1
        const uint32_t lo = *reinterpret_cast<const uint32_t*>(row + (((2 * ks) ^ (slot & 7)) << 4));
        const uint32_t hi =
            *reinterpret_cast<const uint32_t*>(row + (((2 * ks + 1) ^ (slot & 7)) << 4));
        acc[h][4 * ks] = fmaf(lo_f(lo), wk[4 * ks], acc[h][4 * ks]);
        acc[h][4 * ks + 1] = fmaf(hi_f(lo), wk[4 * ks + 1], acc[h][4 * ks + 1]);
        acc[h][4 * ks + 2] = fmaf(lo_f(hi), wk[4 * ks + 2], acc[h][4 * ks + 2]);
        acc[h][4 * ks + 3] = fmaf(hi_f(hi), wk[4 * ks + 3], acc[h][4 * ks + 3]);
      }
    }
  }
  // d = rnd(sum) + dwb, in bf16 pairs: the A fragments' words
  const uint4 b0 = ldg<kPlain>(dwb_s + kc * 64 + 16 * q);
  const uint4 b1 = ldg<kPlain>(dwb_s + kc * 64 + 16 * q + 8);
  const uint32_t bw[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
  #pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    a[ks][0] = hadd2(pack_bf16x2(acc[0][4 * ks], acc[0][4 * ks + 1]), bw[2 * ks]);
    a[ks][1] = hadd2(pack_bf16x2(acc[1][4 * ks], acc[1][4 * ks + 1]), bw[2 * ks]);
    a[ks][2] = hadd2(pack_bf16x2(acc[0][4 * ks + 2], acc[0][4 * ks + 3]), bw[2 * ks + 1]);
    a[ks][3] = hadd2(pack_bf16x2(acc[1][4 * ks + 2], acc[1][4 * ks + 3]), bw[2 * ks + 1]);
  }
}

// one chunk: its A fragments, then four async k-steps into acc
template <int N>
__device__ __forceinline__ void chunk_mma(float* acc, uint32_t a[4][4], const uint8_t* win,
                                          const bf16* dw_s, const bf16* dwb_s, int kc, int cp,
                                          int S, int r0, int q, const uint32_t valid[2],
                                          uint64_t desc0) {
  d_frags(win, dw_s, dwb_s, kc, cp, S, r0, q, valid, a);
  wgmma_fence();
  #pragma unroll
  for (int ks = 0; ks < 4; ++ks)
    wgmma_rs<N>(acc, a[ks], desc0 + ((kc * N * 128 + ks * 32) >> 4));
  wgmma_commit();
}

// --- float32: d in shared memory, CUDA-core product -------------------------------------

// d of pixel r of the tile and channels 16*half .. +16 of the 32-channel chunk kc
__device__ __forceinline__ void d_tile_f32(const uint8_t* win, const float* dw_s,
                                           const float* dwb_s, int kc, int cp, int S, int r,
                                           int half, uint32_t valid, float* As) {
  float acc[16];
  #pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] = 0.f;
  #pragma unroll
  for (int tap = 0; tap < 9; ++tap) {
    if (!((valid >> tap) & 1u)) continue;
    const int slot = (tap / 3) * S + r + tap % 3;
    const uint8_t* row = win + slot * kSlot;
    #pragma unroll
    for (int c4 = 0; c4 < 4; ++c4) {
      const float4 s = *reinterpret_cast<const float4*>(row + (((4 * half + c4) ^ (slot & 7)) << 4));
      const float4 k = *reinterpret_cast<const float4*>(dw_s + tap * cp + kc * 32 + 16 * half + 4 * c4);
      acc[4 * c4] = fmaf(s.x, k.x, acc[4 * c4]);
      acc[4 * c4 + 1] = fmaf(s.y, k.y, acc[4 * c4 + 1]);
      acc[4 * c4 + 2] = fmaf(s.z, k.z, acc[4 * c4 + 2]);
      acc[4 * c4 + 3] = fmaf(s.w, k.w, acc[4 * c4 + 3]);
    }
  }
  #pragma unroll
  for (int i = 0; i < 16; ++i)
    As[(16 * half + i) * kTile + r] = add<float>(acc[i], dwb_s[kc * 32 + 16 * half + i]);
}

// --- the epilogue, in the accumulator layout --------------------------------------------

// The item's tail of step t: ecs, mem and spike from acc, mem and ecs kept
// in the workspace for the next step (none after the last).  bf16 issues
// every load of a row's sets before it uses one, and computes in bf16 pairs.
template <typename T, int N>
__device__ __forceinline__ void epilogue(const Params& p, const float* acc, int t, long long p0,
                                         int slice, const T* pwb_s, int r0, int q) {
  constexpr int NS = N / 32;
  const T* x = static_cast<const T*>(p.x);
  T* out = static_cast<T*>(p.out);
  const long long pc = p.P * p.C;
  T* mem_ws = static_cast<T*>(p.ws);
  T* ecs_ws = mem_ws + pc;
  const bool keep = t + 1 < p.Tn;
  #pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long px = p0 + r0 + 8 * h;
    float a[NS][8];
    row_sets<N>(acc, h, q, a);
    if constexpr (sizeof(T) == 2) {
      const Pairs k2 = pairs(p);
      uint4 xr[NS], sr[NS], mr[NS], cr[NS];
      #pragma unroll
      for (int s = 0; s < NS; ++s) {
        const int co = slice * N + 32 * s + 8 * q;
        if (px >= p.P || co >= p.C) continue;
        const long long e = px * p.C + co;
        xr[s] = ldg<kNc>(x + t * p.x_ts + e);
        sr[s] = ldg<kCg>(out + (t - 1) * pc + e);
        if (t == 1) {                     // mem_0 = x_0, no field yet
          mr[s] = ldg<kNc>(x + e);
          cr[s] = make_uint4(0u, 0u, 0u, 0u);
        } else {
          mr[s] = ldg<kPlain>(mem_ws + e);
          cr[s] = ldg<kPlain>(ecs_ws + e);
        }
      }
      #pragma unroll
      for (int s = 0; s < NS; ++s) {
        const int co = slice * N + 32 * s + 8 * q;
        if (px >= p.P || co >= p.C) continue;
        const long long e = px * p.C + co;
        const uint4 b = ldg<kPlain>(pwb_s + co);
        const uint32_t bw[4] = {b.x, b.y, b.z, b.w}, xw[4] = {xr[s].x, xr[s].y, xr[s].z, xr[s].w};
        uint32_t sw[4] = {sr[s].x, sr[s].y, sr[s].z, sr[s].w};
        uint32_t mw[4] = {mr[s].x, mr[s].y, mr[s].z, mr[s].w};
        uint32_t cw[4] = {cr[s].x, cr[s].y, cr[s].z, cr[s].w};
        #pragma unroll
        for (int m = 0; m < 4; ++m)
          finish2(pack_bf16x2(a[s][2 * m], a[s][2 * m + 1]), bw[m], cw[m], mw[m], sw[m], xw[m], k2,
                  p.thresh, p.act);
        *reinterpret_cast<uint4*>(out + t * pc + e) = make_uint4(sw[0], sw[1], sw[2], sw[3]);
        if (keep) {
          *reinterpret_cast<uint4*>(mem_ws + e) = make_uint4(mw[0], mw[1], mw[2], mw[3]);
          *reinterpret_cast<uint4*>(ecs_ws + e) = make_uint4(cw[0], cw[1], cw[2], cw[3]);
        }
      }
    } else {
      #pragma unroll
      for (int s = 0; s < NS; ++s) {
        const int co = slice * N + 32 * s + 8 * q;
        if (px >= p.P || co >= p.C) continue;
        const long long e = px * p.C + co;
        float bias[8], xv[8], mv[8], cv[8], sv[8];
        load8<kPlain>(pwb_s + co, bias);
        load8<kNc>(x + t * p.x_ts + e, xv);
        load8<kCg>(out + (t - 1) * pc + e, sv);
        if (t == 1) {
          load8<kNc>(x + e, mv);
          #pragma unroll
          for (int i = 0; i < 8; ++i) cv[i] = 0.f;
        } else {
          load8<kPlain>(mem_ws + e, mv);
          load8<kPlain>(ecs_ws + e, cv);
        }
        #pragma unroll
        for (int i = 0; i < 8; ++i) finish<T>(a[s][i], bias[i], cv[i], mv[i], sv[i], xv[i], p);
        store8(out + t * pc + e, sv);
        if (keep) {
          store8(mem_ws + e, mv);
          store8(ecs_ws + e, cv);
        }
      }
    }
  }
}

// --- the kernel --------------------------------------------------------------------------

template <typename T, int N>
__global__ void __launch_bounds__(kThreads, 1) ecs_lif_kernel(const __grid_constant__ Params p) {
  constexpr int K = Chunk<T>::K;
  constexpr bool kMma = sizeof(T) == 2;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  // B starts on the swizzle's 1024-byte atom (the plan's 1024 bytes of slack)
  uint8_t* base = smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u);
  const int C = p.C;
  const long long pc = p.P * C;
  const int nk = (C + K - 1) / K, cp = nk * K;
  const int S = min(p.W, kRun), NS = 2 * S + kRun;
  const int tid = threadIdx.x, lane = tid & 31, q = lane & 3;
  const int r0 = 64 * (tid >> 7) + 16 * ((tid >> 5) & 3) + (lane >> 2);   // rows r0, r0 + 8
  const int slice = blockIdx.x % p.slices, per = gridDim.x / p.slices;
  const int j0 = blockIdx.x / p.slices;
  const int mine = j0 < p.tiles ? (p.tiles - 1 - j0) / per + 1 : 0;

  // shared memory (snn/ecs_lif.py:k1_smem): [B (bf16)] [2 windows] [As, Bs (f32)]
  // [dw 9 x cp] [dwb cp] [pwb cp]
  uint8_t* bmat = base;
  uint8_t* win = base + (kMma ? nk * N * 128 : 0);
  uint8_t* rest = win + 2 * NS * kSlot;
  float* As = reinterpret_cast<float*>(rest);            // f32: d chunk [K][kTile]
  float* Bs = As + K * kTile;                            // f32: pw chunk [K][N]
  T* dw_s = reinterpret_cast<T*>(kMma ? rest : reinterpret_cast<uint8_t*>(Bs + K * N));
  T* dwb_s = dw_s + 9 * cp;
  T* pwb_s = dwb_s + cp;

  const T* dw = static_cast<const T*>(p.dw);
  const T* dwb = static_cast<const T*>(p.dwb);
  const T* pwb = static_cast<const T*>(p.pwb);
  const T* pw = static_cast<const T*>(p.pw);
  // bf16: the depthwise weights and bias in quad_channel's order
  auto channel = [&](int i) { return kMma ? i / 64 * 64 + quad_channel(i % 64) : i; };
  for (int i = tid; i < 9 * cp; i += kThreads) {
    const int tap = i / cp, c = channel(i % cp);
    dw_s[i] = c < C ? dw[(tap / 3) * p.dw_sy + (tap % 3) * p.dw_sx + c * p.dw_sc] : T{};
  }
  for (int i = tid; i < cp; i += kThreads) {
    const int c = channel(i);
    dwb_s[i] = c < C ? dwb[c * p.dwb_s] : T{};
    pwb_s[i] = i < C ? pwb[i * p.pwb_s] : T{};
  }
  if constexpr (kMma) load_b<N>(p, bmat, slice, nk);
  __syncthreads();

  const T* x = static_cast<const T*>(p.x);
  T* out = static_cast<T*>(p.out);

  // step 0: spike_0 = fire(x_0), the block's own items
  for (int m = 0; m < mine; ++m) {
    const long long p0 = (long long)(j0 + m * per) * kTile;
    for (int g = tid; g < kTile * (N / 8); g += kThreads) {
      const long long px = p0 + g / (N / 8);
      const int co = slice * N + g % (N / 8) * 8;
      if (px >= p.P || co >= C) continue;
      float v[8];
      load8<kNc>(x + px * C + co, v);
      #pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = fire<T>(v[i], p.thresh, p.act);
      store8(out + px * C + co, v);
    }
  }

  const uint32_t win_addr = smem_addr(win);
  const uint64_t desc0 = smem_desc_sw128(smem_addr(bmat));
  float acc[N / 2];
  uint32_t a0[4][4], a1[4][4];
  uint32_t valid[2] = {0u, 0u};
  const int total = mine * nk;
  auto tile_p0 = [&](int s) { return (long long)(j0 + s / nk * per) * kTile; };

  for (int t = 1; t < p.Tn; ++t) {
    grid_sync(p.bar);                    // out[t-1] is complete
    const T* prev = out + (t - 1) * pc;
    if (total > 0) load_window128<T>(prev, win_addr, win, tile_p0(0), 0, p, S, NS, kRun, true);
    cp_async_commit();
    #pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
    for (int s = 0; s < total; ++s) {
      const int kc = s % nk;
      const long long p0 = tile_p0(s);
      __syncthreads();                   // stage (s + 1) & 1 is read by no one
      if (s + 1 < total)
        load_window128<T>(prev, win_addr + ((s + 1) & 1) * NS * kSlot, nullptr, tile_p0(s + 1),
                          (s + 1) % nk * K, p, S, NS, kRun, true);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();                   // window s is in, for every thread
      const uint8_t* w = win + (s & 1) * NS * kSlot;
      if constexpr (kMma) {
        if (kc == 0) {
          valid[0] = tap_mask(p0 + r0, p);
          valid[1] = tap_mask(p0 + r0 + 8, p);
        }
        wgmma_wait<1>();                 // the k-steps that read this A set are done
        if (s & 1)
          chunk_mma<N>(acc, a1, w, dw_s, dwb_s, kc, cp, S, r0, q, valid, desc0);
        else
          chunk_mma<N>(acc, a0, w, dw_s, dwb_s, kc, cp, S, r0, q, valid, desc0);
      } else {
        const int r = tid & (kTile - 1), half = tid >> 7;
        if (kc == 0) valid[0] = tap_mask(p0 + r, p);
        d_tile_f32(w, dw_s, dwb_s, kc, cp, S, r, half, valid[0], As);
        for (int i = tid; i < K * N; i += kThreads) {
          // read along the unit stride of pw where it has one
          const int k = p.pw_si == 1 ? i % K : i / N, n = p.pw_si == 1 ? i / K : i % N;
          const int ci = kc * K + k, co = slice * N + n;
          Bs[k * N + n] = ci < C && co < C ? pw[ci * p.pw_si + co * p.pw_so] : 0.f;
        }
        __syncthreads();
        #pragma unroll 4
        for (int k = 0; k < K; ++k) {
          const float x0 = As[k * kTile + r0], x1 = As[k * kTile + r0 + 8];
          #pragma unroll
          for (int j = 0; j < N / 8; ++j) {
            const float2 b = *reinterpret_cast<const float2*>(Bs + k * N + 8 * j + 2 * q);
            acc[4 * j] = fmaf(x0, b.x, acc[4 * j]);
            acc[4 * j + 1] = fmaf(x0, b.y, acc[4 * j + 1]);
            acc[4 * j + 2] = fmaf(x1, b.x, acc[4 * j + 2]);
            acc[4 * j + 3] = fmaf(x1, b.y, acc[4 * j + 3]);
          }
        }
      }
      if (kc == nk - 1) {
        if constexpr (kMma) {
          wgmma_wait<0>();
          #pragma unroll
          for (int i = 0; i < N / 2; ++i) asm volatile("" : "+f"(acc[i]) :: "memory");
        }
        epilogue<T, N>(p, acc, t, p0, slice, pwb_s, r0, q);
        #pragma unroll
        for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
      }
    }
  }
}

template <typename T, int N>
cudaError_t allow_smem(int smem) {
  static int allowed = 0;   // the dynamic shared memory this instance may take
  if (smem > allowed) {
    const cudaError_t e = cudaFuncSetAttribute(
        ecs_lif_kernel<T, N>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    allowed = smem;
  }
  return cudaSuccess;
}

template <typename T, int N>
cudaError_t launch(Params& prm, int grid, int smem, cudaStream_t st) {
  const cudaError_t e = allow_smem<T, N>(smem);
  if (e != cudaSuccess) return e;
  void* args[] = {&prm};
  return cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(ecs_lif_kernel<T, N>),
                                     dim3(grid), dim3(kThreads), args, (size_t)smem, st);
}

template <typename T, int N>
int occupancy(int smem) {
  cudaError_t e = allow_smem<T, N>(smem);
  int blocks = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, ecs_lif_kernel<T, N>, kThreads,
                                                      (size_t)smem);
  return e == cudaSuccess ? blocks : -(int)e;
}

template <typename T>
cudaError_t dispatch(Params& prm, int n, int grid, int smem, cudaStream_t st) {
  switch (n) {
    case 32: return launch<T, 32>(prm, grid, smem, st);
    case 64: return launch<T, 64>(prm, grid, smem, st);
    case 128: return launch<T, 128>(prm, grid, smem, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// a: 30 int64 values (snn/ecs_lif.py:_launch_args): dtype (0 = float32,
// 1 = bfloat16), slice N, x, x's T stride, out, dw and its dy/dx/c strides,
// dwb and its stride, pw, its ci/co strides and 16-byte mode, pwb and its
// stride, the workspace, the barrier buffer, T, N, H, W, C, slices, tiles,
// grid, shared memory bytes, act, stream.  k: thresh, decay, alpha, beta,
// leak, already rounded to the dtype.  Returns the launch's cudaError_t
// (0 = launched).
int ecs_lif_fwd(const long long* a, const float* k) {
  Params prm;
  const int dtype = (int)a[0], n = (int)a[1];
  prm.x = reinterpret_cast<const void*>(a[2]);
  prm.x_ts = a[3];
  prm.out = reinterpret_cast<void*>(a[4]);
  prm.dw = reinterpret_cast<const void*>(a[5]);
  prm.dw_sy = a[6]; prm.dw_sx = a[7]; prm.dw_sc = a[8];
  prm.dwb = reinterpret_cast<const void*>(a[9]);
  prm.dwb_s = a[10];
  prm.pw = reinterpret_cast<const void*>(a[11]);
  prm.pw_si = a[12]; prm.pw_so = a[13];
  prm.pw_vec = (int)a[14];
  prm.pwb = reinterpret_cast<const void*>(a[15]);
  prm.pwb_s = a[16];
  prm.ws = reinterpret_cast<void*>(a[17]);
  prm.bar = reinterpret_cast<unsigned*>(a[18]);
  prm.Tn = (int)a[19];
  const long long images = a[20];
  prm.H = (int)a[21]; prm.W = (int)a[22]; prm.C = (int)a[23];
  prm.slices = (int)a[24]; prm.tiles = (int)a[25];
  const int grid = (int)a[26], smem = (int)a[27];
  prm.act = (int)a[28];
  cudaStream_t st = reinterpret_cast<cudaStream_t>(a[29]);
  prm.P = images * prm.H * prm.W;
  prm.thresh = k[0]; prm.decay = k[1]; prm.alpha = k[2]; prm.beta = k[3]; prm.leak = k[4];
  if (prm.C % 8 || prm.slices <= 0 || grid < prm.slices || grid % prm.slices ||
      (long long)prm.slices * n < prm.C || (long long)prm.tiles * kTile < prm.P)
    return (int)cudaErrorInvalidValue;
  if (prm.P == 0 || prm.Tn == 0) return (int)cudaSuccess;
  if (dtype == 0) return (int)dispatch<float>(prm, n, grid, smem, st);
  if (dtype == 1) return (int)dispatch<bf16>(prm, n, grid, smem, st);
  return (int)cudaErrorInvalidValue;
}

// Blocks of the (dtype, slice N) instance one SM holds with `smem` bytes of
// dynamic shared memory; a negative cudaError_t on failure.
int ecs_lif_occupancy(int dtype, int n, int smem) {
  if (dtype != 0 && dtype != 1) return -(int)cudaErrorInvalidValue;
  const bool b = dtype == 1;
  switch (n) {
    case 32: return b ? occupancy<bf16, 32>(smem) : occupancy<float, 32>(smem);
    case 64: return b ? occupancy<bf16, 64>(smem) : occupancy<float, 64>(smem);
    case 128: return b ? occupancy<bf16, 128>(smem) : occupancy<float, 128>(smem);
    default: return -(int)cudaErrorInvalidValue;
  }
}

const char* ecs_lif_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

// Fused HiFi-GAN multi-receptive-field stage for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel mimic3_tpu/ops/stage.py::hifigan_stage_fused
// (body _stage_kernel).  One launch computes, for activations x [B, C, T]:
//
//   [optional]  x = ConvTranspose1d(lrelu(x_in))           (fused upsampler)
//   y = mean_r ResBlock1_r(x)      ResBlock1: for each dilation step
//                                  s += conv_k(lrelu(conv_{k,d}(lrelu(s))))
//   [optional]  audio = tanh(conv_post(lrelu(y)))            (fused head)
//
// with torch Conv1d zero padding at the sequence edges: rows outside
// [0, T) are zero at the input of every conv.  Only the stage input is
// read from device memory and only the stage output (or the float32
// waveform) is written back; the 18 intermediate activations stay in
// shared memory.
//
// What bounds it on this card: the unfused stage moves every intermediate
// through HBM (about 40 activation round trips per stage at C = 32).
// Fused, the stage does 2*C*C*sum(K) FLOPs per sample (sum(K) = 126 for
// kernels 3/7/11) against only its input and output bytes, so it is
// bound by operations.
//
// Three paths, by dtype and C (ops/stage.py says which reaches which):
//
// - bf16, C in {16, 32, 64}: every conv of the stage, the upsampler
//   included, on Hopper's warpgroup MMA (stage_mma_kernel<C>, the
//   bf16 section below says how).  Three bf16 buffers [rows][C + 8]
//   (stage input, resblock state, the convs' operand) and an f32
//   [rows][C + 1] sum over resblocks replace the four f32 [C][L] buffers
//   of the FFMA path.  Three consumer warpgroups (one block per SM) own
//   64-row M tiles and accumulate each in f32 registers across a
//   conv's taps, A from the activation buffers (ldmatrix at the tap's row
//   shift), B from a ring of C x C weight blocks in shared memory that one
//   producer warp fills with bulk copies ahead of the MMAs.  Each conv
//   computes only the rows the rest of its resblock needs, in whole
//   64-row tiles.  The wrapper (ops/stage.py) picks the tile from a model
//   of waves fit to the card's times, so short inputs get short tiles and
//   fill the card.  What bounds it now
//   (measured by taking parts out, scripts/ablate_stage.py, PERF.md): at
//   the synth cells' 16 rows x 1024 frames the MMAs take 35-37% of the
//   time (11.21 ms at C = 64, 8.09 at C = 32 on an H100 80GB HBM3 at
//   700 W), the epilogues 28-30%, the ring's waits, fragment loads,
//   barriers and staging the rest; without the ring (each block copied
//   by the consumers, then a barrier) it takes 38-43% longer; one or two
//   consumer warpgroups are slower than three at every tile swept.  Against
//   its 2.26 / 1.13 ms bound it is at 20% / 14%.
// - f32, C in {16, 32, 64}: the same stage on tensor cores in three TF32
//   passes (stage_tf32_kernel; conv_tile.cuh says why three and how the
//   sums stay f32-accurate).  The TF32 here is explicit in the kernel's
//   instructions; torch's TF32 switches govern cuDNN only.  Its buffers
//   are f32 [rows][C + 4] and nothing is rounded below f32, so it holds
//   the port's f32 bar.  What bounds it: per FLOP the TF32 tile issues six
//   times the MMAs and reads four times the weight bytes of the bf16 one,
//   and the f32 buffers take twice the shared memory, so tiles are
//   shorter.  What the design does about it: a warp keeps two 16-row M
//   tiles' accumulators across a conv's taps, so each B fragment read
//   feeds both; each K chunk's three passes land in a fresh accumulator
//   added with FADD (a running MMA accumulator loses up to an ulp of the
//   sum at every MMA, which missed the bar at C = 64); weights come
//   through the read-only cache (a tap is 8 KB at C = 32, shared by the
//   block's 16 warps; a cp.async ring was slower at B = 4).  At C = 64
//   the tile is short (about 100 rows against a 120-row halo) and cuDNN
//   is faster, so the f32 gate stops at 32.  Measured on an H100 80GB
//   HBM3 (700.00 W) for the last decoder stage, x = [1, 64, 16384] f32
//   (128 frames; chip_smoke.py): 0.412 ms against 2.191 ms for the plain
//   cuDNN path, 13% of the 0.053 ms three-pass TF32 bound and 32% of the
//   0.130 ms FFMA bound.  Taking
//   the MMAs out (scripts/ablate_stage.py) leaves 0.07-0.08 ms: the
//   mma.sync loop is 80-87% of the kernel.
// - C = 8 (under the MMA depth), either dtype: FFMA (stage_kernel).

// FFMA design (C = 8; simple and correct first):
// - one thread block per (batch row, time tile); the tile plus a halo of
//   the stage's receptive field (60 samples for k = 11, d = 1/3/5, + 3 for
//   conv_post) is loaded once into shared memory as f32.  The upsampler
//   output is computed directly for every haloed position from a staged
//   copy of lrelu(x_in), so it needs no halo of its own;
// - four f32 buffers [C][tile + 2*halo]: stage input, resblock state,
//   conv1 output, running sum over resblocks.  Every conv is computed
//   over the whole haloed tile; errors from the buffer edge creep inward
//   by one conv padding per conv and never reach the tile's centre;
// - each thread computes 8 output channels at 4 positions in registers;
//   weights are laid out [Cin][K][Cout] and read as float4, warp-uniform,
//   so one load feeds 16 FMAs;
// - bf16 activations are loaded and stored as bf16, all math is f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

#include "conv_tile.cuh"

namespace {

constexpr float kSlope = 0.1f;
// A block is (C / kCoT) channel groups of kPosThreads threads (a whole
// number of warps, so a warp reads one group's weights: a broadcast).
// Each thread computes kCoT output channels at kPos positions
// (lane, lane + kPosThreads, ...): every float4 weight load feeds
// 4 * kPos FMAs and the activation reads are conflict-free.
// (8 channels x 4 positions per thread in 96-thread groups: the fastest of
// the launch shapes measured for the C = 32 stage.)
constexpr int kPosThreads = 96;
template <int C>
constexpr int kCoT = C < 8 ? C : 8;
template <int C>
constexpr int kPos = C > 32 ? 2 : 4;
template <int C>
constexpr int kThreads = (C / kCoT<C>) * kPosThreads;

__device__ __forceinline__ float lrelu(float v) {
  return v >= 0.f ? v : v * kSlope;
}
__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}
__device__ __forceinline__ int floordiv(int a, int b) {  // b > 0
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

// out[co][i] (= or +=) bias[co] + sum_{ci, tap} w[ci][tap][co] *
//     lrelu(in[ci][i + tap*dil - pad]),
// where inputs outside the buffer [0, L) or the sequence [0, T) are zero.
// This thread computes channels [co0, co0 + kCoT) at its positions.
template <int C>
__device__ void conv_pass(const float* __restrict__ in,
                          float* __restrict__ out, bool accumulate,
                          const float* __restrict__ w,
                          const float* __restrict__ bias, int k, int dil,
                          int L, int pos0, int T) {
  constexpr int P = kPos<C>;
  constexpr int CT = kCoT<C>;
  const int lane = threadIdx.x % kPosThreads;
  const int co0 = threadIdx.x / kPosThreads * CT;
  const int pad = dil * (k - 1) / 2;
  for (int base = lane; base < L; base += kPosThreads * P) {
    float acc[P][CT];
#pragma unroll
    for (int c = 0; c < CT; ++c) {
      const float bv = __ldg(bias + co0 + c);
#pragma unroll
      for (int p = 0; p < P; ++p) acc[p][c] = bv;
    }
    for (int tap = 0; tap < k; ++tap) {
      int off[P];
      bool ok[P];
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const int i = base + p * kPosThreads;
        const int j = i + tap * dil - pad;
        ok[p] = i < L && j >= 0 && j < L && pos0 + j >= 0 && pos0 + j < T;
        off[p] = ok[p] ? j : 0;
      }
      const float4* wt = reinterpret_cast<const float4*>(w + tap * C + co0);
#pragma unroll 4
      for (int ci = 0; ci < C; ++ci) {
        float v[P];
#pragma unroll
        for (int p = 0; p < P; ++p)
          v[p] = ok[p] ? lrelu(in[ci * L + off[p]]) : 0.f;
        const float4* wc = wt + ci * k * (C / 4);
#pragma unroll
        for (int q = 0; q < CT / 4; ++q) {
          const float4 wv = __ldg(wc + q);
#pragma unroll
          for (int p = 0; p < P; ++p) {
            acc[p][4 * q + 0] = fmaf(wv.x, v[p], acc[p][4 * q + 0]);
            acc[p][4 * q + 1] = fmaf(wv.y, v[p], acc[p][4 * q + 1]);
            acc[p][4 * q + 2] = fmaf(wv.z, v[p], acc[p][4 * q + 2]);
            acc[p][4 * q + 3] = fmaf(wv.w, v[p], acc[p][4 * q + 3]);
          }
        }
      }
    }
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int i = base + p * kPosThreads;
      if (i >= L) continue;
#pragma unroll
      for (int c = 0; c < CT; ++c) {
        float* o = out + (co0 + c) * L + i;
        *o = accumulate ? *o + acc[p][c] : acc[p][c];
      }
    }
  }
}

template <int C, typename T_io>
__global__ void __launch_bounds__(kThreads<C>)
    stage_kernel(const T_io* __restrict__ x, void* __restrict__ out_ptr,
                 const float* __restrict__ w, const float* __restrict__ b,
                 const int4* __restrict__ plan, int c_in, int t_in, int T,
                 int n_res, int n_steps, int ups_k, int ups_stride,
                 int ups_pad, int has_post, int tile, int halo) {
  extern __shared__ float smem[];
  constexpr int CT = kCoT<C>;
  const int L = tile + 2 * halo;
  float* x0 = smem;         // stage input
  float* s = x0 + C * L;    // resblock state
  float* t1 = s + C * L;    // conv1 output
  float* acc = t1 + C * L;  // sum over resblocks
  const int row = blockIdx.y;
  const int t0 = blockIdx.x * tile;
  const int pos0 = t0 - halo;  // sequence position of buffer index 0
  int conv = 0;

  if (ups_k > 0) {
    // stage lrelu(x_in) for every input row this tile's outputs read;
    // t1 and acc are free until the resblocks start
    const int4 cu = plan[conv++];
    const int m_lo = floordiv(pos0 + ups_pad - (ups_k - 1), ups_stride);
    const int m_hi = floordiv(pos0 + L - 1 + ups_pad, ups_stride);
    const int lin = m_hi - m_lo + 1;
    float* xin = t1;
    const T_io* xb = x + (size_t)row * c_in * t_in;
    for (int idx = threadIdx.x; idx < c_in * lin; idx += blockDim.x) {
      const int ci = idx / lin;
      const int m = m_lo + (idx - ci * lin);
      xin[idx] = (m >= 0 && m < t_in)
                     ? lrelu(load_f(xb + (size_t)ci * t_in + m))
                     : 0.f;
    }
    __syncthreads();
    // out[co][t] = bias[co] + sum over taps j with (t + pad - j) % stride
    // == 0 of sum_ci w[ci][j][co] * xin[ci][(t + pad - j) / stride]
    const int lane = threadIdx.x % kPosThreads;
    const int co0 = threadIdx.x / kPosThreads * CT;
    const float* wu = w + cu.x + co0;
    for (int i = lane; i < L; i += kPosThreads) {
      const int t = pos0 + i;
      float a[CT];
#pragma unroll
      for (int c = 0; c < CT; ++c)
        a[c] = (t >= 0 && t < T) ? __ldg(b + cu.y + co0 + c) : 0.f;
      const int base = t + ups_pad;
      for (int j = (t >= 0 && t < T) ? base % ups_stride : ups_k; j < ups_k;
           j += ups_stride) {
        const int r = (base - j) / ups_stride - m_lo;
        const float4* wj = reinterpret_cast<const float4*>(wu + j * C);
        for (int ci = 0; ci < c_in; ++ci) {
          const float v = xin[ci * lin + r];
          const float4* wc = wj + ci * ups_k * (C / 4);
#pragma unroll
          for (int q = 0; q < CT / 4; ++q) {
            const float4 wv = __ldg(wc + q);
            a[4 * q + 0] = fmaf(wv.x, v, a[4 * q + 0]);
            a[4 * q + 1] = fmaf(wv.y, v, a[4 * q + 1]);
            a[4 * q + 2] = fmaf(wv.z, v, a[4 * q + 2]);
            a[4 * q + 3] = fmaf(wv.w, v, a[4 * q + 3]);
          }
        }
      }
#pragma unroll
      for (int c = 0; c < CT; ++c) x0[(co0 + c) * L + i] = a[c];
    }
  } else {
    const T_io* xb = x + (size_t)row * C * T;
    for (int idx = threadIdx.x; idx < C * L; idx += blockDim.x) {
      const int c = idx / L;
      const int t = pos0 + (idx - c * L);
      x0[idx] = (t >= 0 && t < T) ? load_f(xb + (size_t)c * T + t) : 0.f;
    }
  }
  __syncthreads();

  for (int r = 0; r < n_res; ++r) {
    for (int idx = threadIdx.x; idx < C * L; idx += blockDim.x) s[idx] = x0[idx];
    __syncthreads();
    for (int step = 0; step < n_steps; ++step) {
      const int4 c1 = plan[conv++];
      const int4 c2 = plan[conv++];
      conv_pass<C>(s, t1, false, w + c1.x, b + c1.y, c1.z, c1.w, L, pos0, T);
      __syncthreads();
      conv_pass<C>(t1, s, true, w + c2.x, b + c2.y, c2.z, c2.w, L, pos0, T);
      __syncthreads();
    }
    for (int idx = threadIdx.x; idx < C * L; idx += blockDim.x) {
      const float v = r == 0 ? s[idx] : acc[idx] + s[idx];
      acc[idx] = r == n_res - 1 ? v / (float)n_res : v;
    }
    __syncthreads();
  }

  if (has_post) {
    const int4 cp = plan[conv];
    const int pad = (cp.z - 1) / 2;
    const float* wp = w + cp.x;  // [C][K][1]
    float* outp = (float*)out_ptr + (size_t)row * T;
    for (int i = halo + threadIdx.x; i < halo + tile; i += blockDim.x) {
      const int t = pos0 + i;
      if (t >= T) continue;
      float a = __ldg(b + cp.y);
      for (int tap = 0; tap < cp.z; ++tap) {
        const int j = i + tap - pad;
        const int tt = pos0 + j;
        if (tt < 0 || tt >= T) continue;
        for (int ci = 0; ci < C; ++ci)
          a = fmaf(__ldg(wp + ci * cp.z + tap), lrelu(acc[ci * L + j]), a);
      }
      outp[t] = tanhf(a);
    }
  } else {
    T_io* outp = (T_io*)out_ptr + (size_t)row * C * T;
    for (int idx = threadIdx.x; idx < C * tile; idx += blockDim.x) {
      const int c = idx / tile;
      const int ii = idx - c * tile;
      const int t = t0 + ii;
      if (t < T) store_f(outp + (size_t)c * T + t, acc[c * L + halo + ii]);
    }
  }
}

template <int C, typename T_io>
cudaError_t launch(const void* x, void* out, const float* w, const float* b,
                   const int4* plan, int batch, int c_in, int t_in, int T,
                   int n_res, int n_steps, int ups_k, int ups_stride,
                   int ups_pad, int has_post, int tile, int halo,
                   cudaStream_t stream) {
  auto kernel = stage_kernel<C, T_io>;
  const int smem = 4 * C * (tile + 2 * halo) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((T + tile - 1) / tile, batch);
  kernel<<<grid, kThreads<C>, smem, stream>>>(
      static_cast<const T_io*>(x), out, w, b, plan, c_in, t_in, T, n_res,
      n_steps, ups_k, ups_stride, ups_pad, has_post, tile, halo);
  return cudaGetLastError();
}


// ---------------------------------------------------------------------------
// Tensor cores: what both paths share
// ---------------------------------------------------------------------------

constexpr int kMaxConvs = 64;  // rows of the launch plan a block holds
constexpr int kItemRows = 16;  // rows of an mma.sync M tile (TF32 path)

// Shared-memory plan of one TF32 block, shared by kernel and launcher.
// Buffer row i holds sequence position t0 - halo + i; the stage output y
// covers rows [ylo, ylo + yn) with yn = tile + 2 * post_pad.  Every conv
// computes a whole number of 16-row MMA tiles, so buffers carry 16 rows of
// slack past L = tile + 2 * halo; rows past a conv's needed range feed
// only rows past the next conv's.
//   x0 [lb][ld] f32    stage input (the upsampler's output when fused)
//   s  [lb][ld] f32    resblock state
//   u  [lb][ld] f32    lrelu(conv1 + b), the second conv's operand
//   y  [yn][C + 1] f32 sum over resblocks (odd stride: the transposed
//                      reads of the store and of conv_post spread banks)
//   plan  the launch plan's rows, read once
//   w  w_uint4 staged uint4 (none in the shipped kernel: its weights come
//      through the read-only cache, stage_tf32_kernel says why)
// The upsampler stages lrelu(x_in) as f32 [c_in][lin] over s, u and y.
struct StagePlan {
  int ld, lb, yn, ylo, ldy;
  size_t buf_bytes, plan_offset, w_offset, smem;
  // elt: bytes of an x0 / s / u element; ld pads a row by 16 bytes so
  // that eight rows start in eight bank groups
  __host__ __device__ StagePlan(int c, int tile, int halo, int post_pad,
                                int elt, int w_uint4) {
    ld = c + 16 / elt;
    lb = tile + 2 * halo + kItemRows;
    yn = tile + 2 * post_pad;
    ylo = halo - post_pad;
    ldy = c + 1;
    buf_bytes = (size_t)lb * ld * elt;
    plan_offset = (3 * buf_bytes + (size_t)yn * ldy * 4 + 15) / 16 * 16;
    w_offset = plan_offset + kMaxConvs * 16;
    smem = w_offset + (size_t)w_uint4 * 16;
  }
};

__device__ __forceinline__ void store2(__nv_bfloat16* p, float v0, float v1) {
  *reinterpret_cast<uint32_t*>(p) = conv_tile::pack_bf16x2(v0, v1);
}
__device__ __forceinline__ void store2(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}
__device__ __forceinline__ void store8(float* p, const float (&v)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// x0[i][c] = x[row][c][pos0 + i] for buffer rows [0, L), zero outside
// [0, T): the input tile transposed to [position][channel], two channels a
// thread, neighbouring threads neighbouring positions
template <int C, int kThreads, typename T>
__device__ __forceinline__ void load_input(const T* __restrict__ x, T* x0,
                                           int ld, int T_len, int L,
                                           int pos0, int row) {
  const T* xb = x + (size_t)row * C * T_len;
  for (int idx = threadIdx.x; idx < (C / 2) * L; idx += kThreads) {
    const int ci = idx / L * 2;
    const int i = idx - ci / 2 * L;
    const int t = pos0 + i;
    float v0 = 0.f, v1 = 0.f;
    if (t >= 0 && t < T_len) {
      v0 = load_f(xb + (size_t)ci * T_len + t);
      v1 = load_f(xb + (size_t)(ci + 1) * T_len + t);
    }
    store2(x0 + i * ld + ci, v0, v1);
  }
}

// The TF32 path's x0 = the stage input for buffer rows [0, L), [row][ld]
// f32, zero outside [0, T): the upsampler's output (on FFMA) when ups_k >
// 0, else x transposed.  The upsampler stages lrelu(x_in) as f32
// [c_in][lin] at xin, which must not overlap x0.  Ends with a barrier.
template <int C, int kThreads>
__device__ __forceinline__ void stage_input(
    const float* __restrict__ x, float* x0, int ld, float* xin,
    const float* __restrict__ w, const float* __restrict__ b, int4 cu,
    int c_in, int t_in, int T_len, int ups_k, int ups_stride, int ups_pad,
    int L, int pos0, int row) {
  if (ups_k > 0) {
    // stage lrelu(x_in) for every input row this tile's outputs read
    const int m_lo = floordiv(pos0 + ups_pad - (ups_k - 1), ups_stride);
    const int m_hi = floordiv(pos0 + L - 1 + ups_pad, ups_stride);
    const int lin = m_hi - m_lo + 1;
    const float* xb = x + (size_t)row * c_in * t_in;
    for (int idx = threadIdx.x; idx < c_in * lin; idx += kThreads) {
      const int ci = idx / lin;
      const int m = m_lo + (idx - ci * lin);
      xin[idx] = (m >= 0 && m < t_in) ? lrelu(xb[(size_t)ci * t_in + m])
                                      : 0.f;
    }
    __syncthreads();
    // x0[i][co] = bias[co] + sum over taps j with (t + pad - j) % stride
    // == 0 of sum_ci w[ci][j][co] * xin[ci][(t + pad - j) / stride], on
    // FFMA.  A thread takes 8 channels at kUpsPos positions of one phase
    // (i, i + stride, ...: the same taps, consecutive input rows), so each
    // weight load (warp-uniform, through L1/L2) feeds 8 * kUpsPos FMAs
    constexpr int kUpsPos = 4;
    const int span = ups_stride * kUpsPos;
    const int runs = (L + span - 1) / span;
    for (int item = threadIdx.x; item < (C / 8) * ups_stride * runs;
         item += kThreads) {
      const int co0 = item / (ups_stride * runs) * 8;
      const int rem = item - co0 / 8 * ups_stride * runs;
      const int i0 = rem / runs + (rem % runs) * span;  // phase + run
      const int base0 = pos0 + i0 + ups_pad;
      float a[kUpsPos][8];
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const float bias = __ldg(b + cu.y + co0 + c);
#pragma unroll
        for (int q = 0; q < kUpsPos; ++q) a[q][c] = bias;
      }
      const int j0 = base0 - floordiv(base0, ups_stride) * ups_stride;
      for (int j = j0; j < ups_k; j += ups_stride) {
        // input row of position i0 + q * stride: r0 + q + (taps above j)
        const int r = (base0 - j) / ups_stride - m_lo;
        const float4* wj =
            reinterpret_cast<const float4*>(w + cu.x + j * C + co0);
#pragma unroll 4
        for (int ci = 0; ci < c_in; ++ci) {
          const float4* wc = wj + ci * ups_k * (C / 4);
          const float4 wa = __ldg(wc);
          const float4 wb = __ldg(wc + 1);
          const float* xr = xin + ci * lin + r;
#pragma unroll
          for (int q = 0; q < kUpsPos; ++q) {
            const float v = xr[min(q, lin - 1 - r)];
            a[q][0] = fmaf(wa.x, v, a[q][0]);
            a[q][1] = fmaf(wa.y, v, a[q][1]);
            a[q][2] = fmaf(wa.z, v, a[q][2]);
            a[q][3] = fmaf(wa.w, v, a[q][3]);
            a[q][4] = fmaf(wb.x, v, a[q][4]);
            a[q][5] = fmaf(wb.y, v, a[q][5]);
            a[q][6] = fmaf(wb.z, v, a[q][6]);
            a[q][7] = fmaf(wb.w, v, a[q][7]);
          }
        }
      }
#pragma unroll
      for (int q = 0; q < kUpsPos; ++q) {
        const int i = i0 + q * ups_stride;
        const int t = pos0 + i;
        if (i >= L) break;
        const bool inside = t >= 0 && t < T_len;
        float v[8];
#pragma unroll
        for (int c = 0; c < 8; ++c) v[c] = inside ? a[q][c] : 0.f;
        store8(x0 + i * ld + co0, v);
      }
    }
  } else {
    load_input<C, kThreads>(x, x0, ld, T_len, L, pos0, row);
  }
  __syncthreads();
}

// The stage's result from y, the f32 mean over resblocks [yn][ldy]
// (row 0 = sequence position t0 - post_pad): with conv_post, the f32
// waveform tanh(conv_post(lrelu(y))) of the tile; else y in T_out.
template <int C, int kThreads, typename T_out>
__device__ __forceinline__ void stage_output(
    const float* y, int ldy, void* __restrict__ out_ptr,
    const float* __restrict__ w, const float* __restrict__ b, int4 cp,
    int has_post, int post_pad, int tile, int t0, int T_len, int row) {
  if (has_post) {
    const int pad = (cp.z - 1) / 2;
    const float* wp = w + cp.x;  // [C][K][1]
    float* outp = (float*)out_ptr + (size_t)row * T_len;
    for (int i = threadIdx.x; i < tile; i += kThreads) {
      const int t = t0 + i;
      if (t >= T_len) continue;
      float a = __ldg(b + cp.y);
      for (int tap = 0; tap < cp.z; ++tap) {
        const int j = i + post_pad + tap - pad;  // row of y
        const int tt = t + tap - pad;
        if (tt < 0 || tt >= T_len) continue;
        for (int ci = 0; ci < C; ++ci)
          a = fmaf(__ldg(wp + ci * cp.z + tap), lrelu(y[j * ldy + ci]), a);
      }
      outp[t] = tanhf(a);
    }
  } else {
    T_out* outp = (T_out*)out_ptr + (size_t)row * C * T_len;
    for (int idx = threadIdx.x; idx < C * tile; idx += kThreads) {
      const int c = idx / tile;
      const int i = idx - c * tile;
      const int t = t0 + i;
      if (t < T_len) store_f(outp + (size_t)c * T_len + t, y[i * ldy + c]);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 on Hopper's warpgroup MMA
// ---------------------------------------------------------------------------

// Consumer warpgroups of a block (plus one producer warp): three, the
// fastest of one, two and three at every tile of both cell stages
// (scripts/ablate_stage.py, PERF.md).  kSlots: the 64-row M tiles a
// warpgroup holds per pass, so a pass covers at most 64 * kSlots *
// kWarpgroups rows (its accumulators and two sets of A fragments fit the
// 128 registers a thread has with 13 warps a block).  kRing: slots of the
// weight ring, one C x C bf16 block each.  ops/stage.py WARPGROUPS,
// WG_SLOTS and RING_SLOTS mirror all three.
constexpr int kWarpgroups = 3;
template <int C>
constexpr int kSlots = C == 64 ? 2 : C == 32 ? 4 : 6;
template <int C>
constexpr int kRing = C == 64 ? 4 : C == 32 ? 8 : 16;

// Shared-memory plan of one wgmma block, shared by kernel and launcher.
// Buffer row i holds sequence position t0 - halo + i, i < L = tile +
// 2 * halo; the stage output y covers rows [ylo, ylo + yn), yn = tile +
// 2 * post_pad.  A pass's last M tile reads past its needed rows; those
// reads are clamped to the buffer (they feed only output rows the
// epilogue drops), so the buffers carry no slack.
//   x0 [L][ld] bf16    stage input (the upsampler's output when fused)
//   s  [L][ld] bf16    resblock state
//   u  [L][ld] bf16    every resblock conv's operand: lrelu(x0), lrelu(s)
//                      or lrelu(conv1 + b)
//   y  [yn][C + 1] f32 sum over resblocks
//   xin [lin][ldi] bf16  lrelu(x_in) for the upsampler, over s, u and y
//                      (room): ldi = c_in rounded up to C, + 8
//   ring  kRing C x C bf16 weight blocks
//   full, empty  one mbarrier each per ring slot
//   plan  the launch plan's rows, read once
struct WgmmaPlan {
  int ld, L, yn, ylo, ldy, ldi;
  size_t buf_bytes, room, ring_offset, bar_offset, plan_offset, smem;
  __host__ __device__ WgmmaPlan(int c, int tile, int halo, int post_pad,
                                int c_in, int ring) {
    ld = c + 8;
    L = tile + 2 * halo;
    yn = tile + 2 * post_pad;
    ylo = halo - post_pad;
    ldy = c + 1;
    ldi = (c_in + c - 1) / c * c + 8;
    buf_bytes = (size_t)L * ld * 2;
    const size_t y_bytes = (size_t)yn * ldy * 4;
    room = 2 * buf_bytes + y_bytes;
    ring_offset = (3 * buf_bytes + y_bytes + 127) / 128 * 128;
    bar_offset = ring_offset + (size_t)ring * c * c * 2;
    plan_offset = bar_offset + (size_t)ring * 16;
    smem = plan_offset + kMaxConvs * 16;
  }
};

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(conv_tile::smem_addr(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = conv_tile::smem_addr(bar);
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(conv_tile::smem_addr(bar)) : "memory");
}
// one thread: arrive on bar and expect `bytes` from a bulk copy into dst
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          int bytes, uint64_t* bar) {
  const uint32_t b = conv_tile::smem_addr(bar);
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(b), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(conv_tile::smem_addr(dst)), "l"(src), "r"(bytes), "r"(b)
      : "memory");
}
// the consumer warpgroups' barrier (the producer warp does not take part)
template <int NWG>
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(128 * NWG) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// until at most N of this warpgroup's committed MMA groups are pending
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// Pin registers an MMA reads or writes to this point of the program: the
// compiler may not move their other uses across it (so every write of an
// operand lands before the fence that hands it to the MMAs, and the
// accumulators are read only after the wait that completes them).
template <int S, int NT>
__device__ __forceinline__ void pin(float (&r)[S][NT][4]) {
#pragma unroll
  for (int s = 0; s < S; ++s)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(r[s][j][e])::"memory");
}
template <int S, int NT>
__device__ __forceinline__ void pin(uint32_t (&r)[S][NT][4]) {
#pragma unroll
  for (int s = 0; s < S; ++s)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[s][j][e])::"memory");
}
// v as the compiler can see it is the same in every lane of the warp
__device__ __forceinline__ int warp_uniform(int v) {
  return __shfl_sync(0xffffffffu, v, 0);
}

// Descriptor of a B operand in shared memory, K-major without swizzle:
// core matrices of 8 output channels x 16 bytes (8 input channels), each
// 128 contiguous bytes; the K neighbour of a core matrix lies 128 bytes on
// (leading byte offset), the next 8 output channels 256 bytes on (stride
// byte offset).  ops/mma.py pack_wgmma_block lays a block out so.
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(256 >> 4) << 32);
}

// d += A . B for one m64nNk16 tile: A (64 x 16) from registers, each warp
// of the warpgroup 16 rows in the mma.sync m16n8k16 A layout; B (16 x N)
// from shared memory; d in the m16n8 accumulator layout per 8 columns
__device__ __forceinline__ void wgmma_rs(float (&d)[2][4],
                                         const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
__device__ __forceinline__ void wgmma_rs(float (&d)[4][4],
                                         const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
__device__ __forceinline__ void wgmma_rs(float (&d)[8][4],
                                         const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// The weight ring as the consumers see it: block i of the launch's stream
// sits in slot i % R once full[slot] has completed phase i / R; every warp
// of the consumers arrives on empty[slot] when its MMAs are done with it.
// Blocks are taken and given back in stream order.
template <int C, int R>
struct Ring {
  const unsigned char* slots;
  uint64_t* full;
  uint64_t* empty;
  int next = 0;  // blocks taken so far
  int freed = 0;  // blocks given back so far
  // shared-memory address of the next block, once it has landed
  __device__ __forceinline__ uint32_t acquire() {
    const int slot = next % R;
    mbar_wait(full + slot, (next / R) & 1);
    __syncwarp();
    ++next;
    return conv_tile::smem_addr(slots + (size_t)slot * C * C * 2);
  }
  // the oldest block taken and not given back
  __device__ __forceinline__ void release() {
    if ((threadIdx.x & 31) == 0) mbar_arrive(empty + freed % R);
    ++freed;
  }
};

// One pass of the stage on the warpgroup MMA: acc[s] = sum over taps and
// K blocks of A_tap . B_block for this warpgroup's 64-row M tiles m = g +
// s * NWG < mt, where row r of M tile m reads activation row row0 +
// tap * step + 64 m + r (clamped to [0, rows)) and K block kb its
// channels [kb C, kb C + C).  The blocks come from the ring in the
// order (tap, kb).  A fragments come from ldmatrix.x4 at any row, so a
// tap's shift is a row offset.  Each 16-deep K chunk's MMAs are one
// group, its fragments in one of two register sets by the chunk's parity:
// before a set is loaded again, the group that read it is waited for
// (wait_group 1), which also completes every MMA of the previous block,
// whose ring slot then goes back.  One group stays in flight across
// blocks and taps; the pass ends by waiting for all.
// Everything that steers the MMAs is warp-uniform, and visibly so to the
// compiler (which otherwise serialises the MMAs).
template <int C, int NWG, int S, int R>
__device__ __forceinline__ void wgmma_pass(float (&acc)[S][C / 8][4],
                                           const __nv_bfloat16* act, int ld,
                                           int rows, int row0, int step,
                                           int taps, int kbs, int mt,
                                           Ring<C, R>& ring) {
  const int lane = threadIdx.x & 31;
  const int g = warp_uniform(threadIdx.x / 128);  // warpgroup
  const int wq = (threadIdx.x / 32) & 3;          // warp in the warpgroup
  taps = warp_uniform(taps);
  kbs = warp_uniform(kbs);
  mt = warp_uniform(mt);
#pragma unroll
  for (int s = 0; s < S; ++s)
#pragma unroll
    for (int j = 0; j < C / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[s][j][e] = 0.f;
  pin(acc);
  // ldmatrix.x4: lanes 0-15 give rows 0-15 of the K chunk's first 8
  // channels, lanes 16-31 the same rows' next 8
  const int lane_row = row0 + 16 * wq + (lane & 15);
  const int lane_col = (lane >> 4) * 8;
  uint32_t a[2][S][1][4];  // fragments, by K chunk parity
  for (int tap = 0; tap < taps; ++tap) {
    for (int kb = 0; kb < kbs; ++kb) {
      const uint32_t wb = ring.acquire();
      uint32_t base[S];
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const int r = min(max(lane_row + tap * step + 64 * (g + s * NWG), 0),
                          rows - 1);
        base[s] = conv_tile::smem_addr(act + r * ld + kb * C + lane_col);
      }
#pragma unroll
      for (int kc = 0; kc < C / 16; ++kc) {
        if (C / 16 == 1)
          wgmma_wait<0>();
        else
          wgmma_wait<1>();
        if (kc == (C / 16 == 1 ? 0 : 1) && ring.freed + 1 < ring.next)
          ring.release();
        uint32_t (&ak)[S][1][4] = a[kc & 1];
#pragma unroll
        for (int s = 0; s < S; ++s) {
          if (g + s * NWG >= mt) continue;
          conv_tile::ldmatrix_x4(ak[s][0], base[s] + kc * 32);
        }
        pin(ak);
        wgmma_fence();
#pragma unroll
        for (int s = 0; s < S; ++s) {
          if (g + s * NWG >= mt) continue;
          wgmma_rs(acc[s], ak[s][0], b_desc(wb + kc * (C / 8) * 256));
        }
        wgmma_commit();
      }
    }
  }
  wgmma_wait<0>();
  pin(acc);
  while (ring.freed < ring.next) ring.release();
}

// f(row, co, v0, v1) for each pair of this thread's accumulators (row of
// the pass < n, channels co and co + 1) with the pass's bias added
template <int C, int NWG, int S, typename F>
__device__ __forceinline__ void each_pair(const float (&acc)[S][C / 8][4],
                                          const float* __restrict__ bias,
                                          int mt, int n, F&& f) {
  const int lane = threadIdx.x & 31;
  const int g = threadIdx.x / 128;
  const int wq = (threadIdx.x / 32) & 3;
  float bb[C / 8][2];
#pragma unroll
  for (int j = 0; j < C / 8; ++j) {
    bb[j][0] = __ldg(bias + conv_tile::acc_col(j, 0));
    bb[j][1] = __ldg(bias + conv_tile::acc_col(j, 1));
  }
#pragma unroll
  for (int s = 0; s < S; ++s) {
    if (g + s * NWG >= mt) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 64 * (g + s * NWG) + 16 * wq + (lane >> 2) + 8 * h;
      if (r >= n) continue;
#pragma unroll
      for (int j = 0; j < C / 8; ++j)
        f(r, conv_tile::acc_col(j, 0), acc[s][j][2 * h] + bb[j][0],
          acc[s][j][2 * h + 1] + bb[j][1]);
    }
  }
}

// The stage on the warpgroup MMA.  Every conv of the stage, the upsampler
// included, is a sum over taps of [rows x C_in] . [C_in x C] products:
// consumer warpgroups own 64-row M tiles and accumulate each in f32
// registers across the conv's taps, A from the bf16 activation buffers
// (ldmatrix at the tap's row shift), B from the weight ring.  One producer
// warp streams the launch's weight blocks (pack_stage_weights: C x C bf16
// each, already in the B layout, back to back in the order the passes
// take them) into the ring with 1-D bulk copies, each slot signalled
// through an mbarrier, so the next blocks land while the current ones'
// MMAs run, across conv boundaries too.
//
// The upsampler (ConvTranspose1d, stride s, kernel K) is polyphase: the
// outputs t with (t + pad) % s == r are a conv over input rows
// floor((t + pad) / s) - a with the taps j = r + s a < K, one pass per
// phase r, its input lrelu(x_in) staged as bf16 [row][channel] (rounded
// as torch's bf16 leaky_relu), its weights rounded to bf16 (the plain
// bf16 path computes the transposed conv in x's dtype) and its sum f32,
// rounded to bf16 into x0.  Then the resblocks as in the TF32 path, each
// conv computing only the rows the rest of its resblock needs, except
// that every MMA reads its A operand from u as it stands and each conv's
// input is activated once, not once per tap: u = lrelu(x0) at a
// resblock's start; the first conv of a step writes lrelu(conv + b) into
// u, zero outside [0, T); the second adds bias and residual into the
// state s (rounded to bf16, as the plain path does) and writes lrelu(s)
// into u, or at a resblock's last step adds into the f32 sum.  An
// epilogue writes u only after a barrier that ends the pass's reads of
// it.  conv_post and its tanh stay on FFMA (stage_output).
template <int C>
__global__ void __launch_bounds__(128 * kWarpgroups + 32, 1)
    stage_mma_kernel(const __nv_bfloat16* __restrict__ x,
                     void* __restrict__ out_ptr, const float* __restrict__ w,
                     const float* __restrict__ b, const int4* plan,
                     const __nv_bfloat16* __restrict__ blocks, int c_in,
                     int t_in, int T, int n_res, int n_steps, int ups_k,
                     int ups_stride, int ups_pad, int has_post, int post_pad,
                     int tile, int halo) {
  constexpr int NWG = kWarpgroups;
  constexpr int kThreads = 128 * NWG;  // the consumers
  constexpr int S = kSlots<C>;
  constexpr int R = kRing<C>;
  constexpr int kBlock = C * C * 2;  // bytes of one weight block
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const WgmmaPlan p(C, tile, halo, post_pad, c_in, R);
  __nv_bfloat16* x0 = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* s = x0 + p.L * p.ld;
  __nv_bfloat16* u = s + p.L * p.ld;
  float* y = reinterpret_cast<float*>(smem_raw + 3 * p.buf_bytes);
  unsigned char* slots = smem_raw + p.ring_offset;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_raw + p.bar_offset);
  uint64_t* empty = full + R;
  int4* plan_s = reinterpret_cast<int4*>(smem_raw + p.plan_offset);
  const int n_convs = (ups_k > 0) + 2 * n_res * n_steps + has_post;
  for (int i = threadIdx.x; i < n_convs; i += blockDim.x) plan_s[i] = plan[i];
  if (threadIdx.x == 0) {
    for (int i = 0; i < R; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, kThreads / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  plan = plan_s;
  const int kb_ups = (c_in + C - 1) / C;  // K blocks of an upsampler tap
  int n_blocks = ups_k * kb_ups;
  for (int m = ups_k > 0; m < (ups_k > 0) + 2 * n_res * n_steps; ++m)
    n_blocks += plan[m].z;

  if (threadIdx.x >= kThreads) {
    // the producer warp: one lane keeps the ring full
    if (threadIdx.x == kThreads) {
      for (int i = 0; i < n_blocks; ++i) {
        const int slot = i % R;
        if (i >= R) mbar_wait(empty + slot, (i / R - 1) & 1);
        bulk_load(slots + (size_t)slot * kBlock,
                  blocks + (size_t)i * (kBlock / 2), kBlock, full + slot);
      }
    }
    return;
  }

  const int L = p.L;
  const int row = blockIdx.y;
  const int t0 = blockIdx.x * tile;
  const int pos0 = t0 - halo;  // sequence position of buffer row 0
  Ring<C, R> ring{slots, full, empty};
  float acc[S][C / 8][4];
  int conv = ups_k > 0;  // plan row of the next conv
  if (ups_k > 0) {
    // lrelu(x_in) for every input row this tile's outputs read, as bf16
    // [row][channel] over s, u and y, channels past c_in zero
    const int m_lo = floordiv(pos0 + ups_pad - (ups_k - 1), ups_stride);
    const int m_hi = floordiv(pos0 + L - 1 + ups_pad, ups_stride);
    const int lin = m_hi - m_lo + 1;
    const int cw = p.ldi - 8;
    __nv_bfloat16* xin = s;
    const __nv_bfloat16* xb = x + (size_t)row * c_in * t_in;
    for (int idx = threadIdx.x; idx < (cw / 2) * lin; idx += kThreads) {
      const int ci = idx / lin * 2;
      const int m = m_lo + (idx - ci / 2 * lin);
      float v0 = 0.f, v1 = 0.f;
      if (m >= 0 && m < t_in) {
        if (ci < c_in) v0 = lrelu(load_f(xb + (size_t)ci * t_in + m));
        if (ci + 1 < c_in) v1 = lrelu(load_f(xb + (size_t)(ci + 1) * t_in + m));
      }
      store2(xin + (m - m_lo) * p.ldi + ci, v0, v1);
    }
    consumers_sync<NWG>();
    const float* bias = b + plan[0].y;
    for (int r = 0; r < ups_stride; ++r) {
      // this phase's buffer rows i0 + s q, q < n, read input rows
      // q0 + q - a for the taps j = r + s a
      const int i0 = ((r - pos0 - ups_pad) % ups_stride + ups_stride) %
                     ups_stride;
      const int n = i0 < L ? (L - i0 + ups_stride - 1) / ups_stride : 0;
      const int q0 = (pos0 + i0 + ups_pad - r) / ups_stride;
      const int taps = r < ups_k ? (ups_k - r + ups_stride - 1) / ups_stride
                                 : 0;
      const int mt = (n + 63) / 64;
      wgmma_pass<C, NWG, S, R>(acc, xin, p.ldi, lin, q0 - m_lo, -1, taps,
                               kb_ups, mt, ring);
      each_pair<C, NWG, S>(acc, bias, mt, n,
                           [&](int q, int co, float v0, float v1) {
        const int i = i0 + q * ups_stride;
        const int t = pos0 + i;
        const bool inside = t >= 0 && t < T;
        store2(x0 + i * p.ld + co, inside ? v0 : 0.f, inside ? v1 : 0.f);
      });
    }
  } else {
    load_input<C, kThreads>(x, x0, p.ld, T, L, pos0, row);
  }
  consumers_sync<NWG>();

  for (int r = 0; r < n_res; ++r) {
    // u = lrelu(x0), the first conv's operand (rounded to bf16, as
    // torch's bf16 leaky_relu): every MMA reads its A operand from u as
    // it stands, each conv's input activated once and not per tap
    for (int i = threadIdx.x; i < L * (C / 8); i += kThreads) {
      const int off = i / (C / 8) * p.ld + i % (C / 8) * 8;
      uint4 v = *reinterpret_cast<const uint4*>(x0 + off);
      v.x = conv_tile::lrelu_bf16x2(v.x);
      v.y = conv_tile::lrelu_bf16x2(v.y);
      v.z = conv_tile::lrelu_bf16x2(v.z);
      v.w = conv_tile::lrelu_bf16x2(v.w);
      *reinterpret_cast<uint4*>(u + off) = v;
    }
    consumers_sync<NWG>();
    // the rows each conv must produce shrink by the padding of the convs
    // after it: ext = the resblock's receptive half-width still ahead
    int ext = 0;
    for (int m = 0; m < 2 * n_steps; ++m) {
      const int4 cm = plan[conv + m];
      ext += cm.w * (cm.z - 1) / 2;
    }
    for (int step = 0; step < n_steps; ++step) {
      const __nv_bfloat16* src = step == 0 ? x0 : s;
      for (int half = 0; half < 2; ++half) {
        const int4 cc = plan[conv++];
        const int pad = cc.w * (cc.z - 1) / 2;
        ext -= pad;
        const int lo = p.ylo - ext;
        const int n = p.yn + 2 * ext;
        const int mt = (n + 63) / 64;
        const bool last = step == n_steps - 1 && half == 1;
        wgmma_pass<C, NWG, S, R>(acc, u, p.ld, L, lo - pad, cc.w, cc.z, 1,
                                 mt, ring);
        consumers_sync<NWG>();  // every MMA is done reading u
        if (half == 0) {
          // u = lrelu(conv1 + b), zero outside [0, T)
          each_pair<C, NWG, S>(acc, b + cc.y, mt, n,
                               [&](int q, int co, float v0, float v1) {
            const int i = lo + q;
            const bool inside = pos0 + i >= 0 && pos0 + i < T;
            store2(u + i * p.ld + co, inside ? lrelu(v0) : 0.f,
                   inside ? lrelu(v1) : 0.f);
          });
        } else {
          each_pair<C, NWG, S>(acc, b + cc.y, mt, n,
                               [&](int q, int co, float v0, float v1) {
            const int i = lo + q;
            const bool inside = pos0 + i >= 0 && pos0 + i < T;
            // residual add onto the state
            const float2 prev = conv_tile::unpack_bf16x2(
                *reinterpret_cast<const uint32_t*>(src + i * p.ld + co));
            v0 = inside ? prev.x + v0 : 0.f;
            v1 = inside ? prev.y + v1 : 0.f;
            if (!last) {
              // the state, and u = lrelu(state), the next conv's operand
              const uint32_t h = conv_tile::pack_bf16x2(v0, v1);
              *reinterpret_cast<uint32_t*>(s + i * p.ld + co) = h;
              *reinterpret_cast<uint32_t*>(u + i * p.ld + co) =
                  conv_tile::lrelu_bf16x2(h);
              return;
            }
            // the resblock's output, into the mean over resblocks
            float* yr = y + (i - p.ylo) * p.ldy + co;
            if (r > 0) {
              v0 += yr[0];
              v1 += yr[1];
            }
            if (r == n_res - 1) {
              v0 /= (float)n_res;
              v1 /= (float)n_res;
            }
            yr[0] = v0;
            yr[1] = v1;
          });
        }
        consumers_sync<NWG>();  // the next conv reads what this one wrote
      }
    }
  }

  stage_output<C, kThreads, __nv_bfloat16>(y, p.ldy, out_ptr, w, b,
                                           plan[conv], has_post, post_pad,
                                           tile, t0, T, row);
}

template <int C>
cudaError_t launch_wgmma(const void* x, void* out, const float* w,
                         const float* b, const int4* plan, const void* blocks,
                         int batch, int c_in, int t_in, int T, int n_res,
                         int n_steps, int ups_k, int ups_stride, int ups_pad,
                         int has_post, int post_pad, int tile, int halo,
                         cudaStream_t stream) {
  const WgmmaPlan p(C, tile, halo, post_pad, c_in, kRing<C>);
  // a pass's rows (at most L; an upsampler phase's fewer) must fit the
  // warpgroups' M-tile slots, and the upsampler's staged input its room
  if ((p.L + 63) / 64 > kSlots<C> * kWarpgroups)
    return cudaErrorInvalidValue;
  if (ups_k > 0 &&
      (size_t)((p.L + ups_k - 2) / ups_stride + 2) * p.ldi * 2 > p.room)
    return cudaErrorInvalidValue;
  auto kernel = stage_mma_kernel<C>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((T + tile - 1) / tile, batch);
  kernel<<<grid, 128 * kWarpgroups + 32, p.smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), out, w, b, plan,
      static_cast<const __nv_bfloat16*>(blocks), c_in, t_in, T, n_res,
      n_steps, ups_k, ups_stride, ups_pad, has_post, post_pad, tile, halo);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// float32 on tensor cores: three TF32 passes
// ---------------------------------------------------------------------------

// Warps of a block (one block per SM) and the 16-row M tiles a warp holds
// per conv: its tiles are warp, warp + W, ..., so a conv covers at most
// 16 * kTf32Slots * W rows (the launcher checks tile + 2 * halo against
// it; ops/stage.py mma_warps and TF32_SLOTS mirror both).
template <int C>
constexpr int kTf32Warps = C <= 32 ? 16 : 8;
constexpr int kTf32Slots = 2;

// The stage of stage_mma_kernel in f32: x0, s, u are f32 [rows][C + 4],
// the state and the intermediate are never rounded below f32, and each
// resblock conv is three TF32 passes (conv_tile::tap_tf32).  A conv's
// TF32 fragments take four times the bytes of its bf16 ones (90 KB for a
// K=11 conv at C=32) and do not fit beside the f32 tile, so the loop runs
// tap by tap, each warp holding the accumulators of all its M tiles
// (kTf32Slots x C channels) across the conv's taps: every B fragment
// read feeds up to kTf32Slots M tiles.  Weights: every resblock conv's
// taps, back to back in launch order, read from device memory through the
// read-only cache (one tap is 2 / 8 / 32 KB at C = 16 / 32 / 64, shared
// by every warp of the block).  Streaming each tap through a two-slot
// cp.async ring in shared memory instead was faster only for one-wave
// launches and slower at B = 4 (scripts/ablate_stage.py builds it;
// PERF.md).
template <int C>
__global__ void __launch_bounds__(32 * kTf32Warps<C>, 1)
    stage_tf32_kernel(const float* __restrict__ x, void* __restrict__ out_ptr,
                      const float* __restrict__ w,
                      const float* __restrict__ b, const int4* plan,
                      const uint4* __restrict__ frags, int c_in, int t_in,
                      int T, int n_res, int n_steps, int ups_k,
                      int ups_stride, int ups_pad, int has_post,
                      int post_pad, int tile, int halo) {
  constexpr int W = kTf32Warps<C>;
  constexpr int kThreads = 32 * W;
  constexpr int NW = C / 8;   // N tiles: all C output channels
  constexpr int kcs = C / 8;  // 8-deep K chunks
  constexpr int kTap = kcs * NW * 32;  // uint4 of one tap's fragments
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const StagePlan p(C, tile, halo, post_pad, 4, 0);
  float* x0 = reinterpret_cast<float*>(smem_raw);
  float* s = x0 + p.lb * p.ld;
  float* u = s + p.lb * p.ld;
  float* y = reinterpret_cast<float*>(smem_raw + 3 * p.buf_bytes);
  int4* plan_s = reinterpret_cast<int4*>(smem_raw + p.plan_offset);
  const int n_convs = (ups_k > 0) + 2 * n_res * n_steps + has_post;
  for (int i = threadIdx.x; i < n_convs; i += kThreads) plan_s[i] = plan[i];
  __syncthreads();
  plan = plan_s;
  const int L = tile + 2 * halo;
  const int row = blockIdx.y;
  const int t0 = blockIdx.x * tile;
  const int pos0 = t0 - halo;  // sequence position of buffer row 0
  int conv = ups_k > 0;        // plan row of the next conv
  stage_input<C, kThreads>(x, x0, p.ld, s, w, b, plan[0], c_in, t_in, T,
                           ups_k, ups_stride, ups_pad, L, pos0, row);

  const int warp = threadIdx.x / 32;
  int g = 0;  // tap block: the resblock convs' taps in launch order
  for (int r = 0; r < n_res; ++r) {
    // the rows each conv must produce shrink by the padding of the convs
    // after it: ext = the resblock's receptive half-width still ahead
    int ext = 0;
    for (int m = 0; m < 2 * n_steps; ++m) {
      const int4 cm = plan[conv + m];
      ext += cm.w * (cm.z - 1) / 2;
    }
    for (int step = 0; step < n_steps; ++step) {
      const float* src = step == 0 ? x0 : s;
      for (int half = 0; half < 2; ++half) {
        const int4 cc = plan[conv++];
        const int pad = cc.w * (cc.z - 1) / 2;
        ext -= pad;
        const int lo = p.ylo - ext;
        const int n = p.yn + 2 * ext;
        const bool last = step == n_steps - 1 && half == 1;
        // this warp's M tiles: warp, warp + W, ... below ceil(n / 16)
        const int mtiles = (n + kItemRows - 1) / kItemRows;
        const int mvalid = mtiles > warp ? (mtiles - warp + W - 1) / W : 0;
        float acc[kTf32Slots][NW][4];
        conv_tile::zero(acc);
        const int row0 = lo - pad + warp * kItemRows;
        for (int tap = 0; tap < cc.z; ++tap, ++g) {
          const uint4* wt = frags + (size_t)g * kTap;
          const int r_tap = row0 + tap * cc.w;
          if (half == 0)
            conv_tile::tap_tf32<kTf32Slots, NW, true>(
                acc, src, p.ld, r_tap, kItemRows * W, mvalid, kcs, wt, NW,
                0);
          else
            conv_tile::tap_tf32<kTf32Slots, NW, false>(
                acc, u, p.ld, r_tap, kItemRows * W, mvalid, kcs, wt, NW, 0);
        }
        // this lane's biases (after the MMAs: registers are scarce here)
        float bias[NW][2];
#pragma unroll
        for (int ni = 0; ni < NW; ++ni) {
          bias[ni][0] = __ldg(b + cc.y + conv_tile::acc_col(ni, 0));
          bias[ni][1] = __ldg(b + cc.y + conv_tile::acc_col(ni, 1));
        }
#pragma unroll
        for (int mi = 0; mi < kTf32Slots; ++mi) {
          if (mi >= mvalid) continue;
          const int r0 = lo + (warp + mi * W) * kItemRows;
#pragma unroll
          for (int ni = 0; ni < NW; ++ni)
#pragma unroll
            for (int e = 0; e < 4; e += 2) {
              const int i = r0 + conv_tile::acc_row(0, e);
              const int co = conv_tile::acc_col(ni, e);
              const int t = pos0 + i;
              const bool inside = t >= 0 && t < T;
              float v0 = acc[mi][ni][e] + bias[ni][0];
              float v1 = acc[mi][ni][e + 1] + bias[ni][1];
              if (half == 0) {
                // lrelu(conv1), zero outside [0, T)
                store2(u + i * p.ld + co, inside ? lrelu(v0) : 0.f,
                       inside ? lrelu(v1) : 0.f);
                continue;
              }
              // residual add onto the state
              const float2 prev = load2(src + i * p.ld + co);
              v0 = inside ? prev.x + v0 : 0.f;
              v1 = inside ? prev.y + v1 : 0.f;
              if (!last) {
                store2(s + i * p.ld + co, v0, v1);
                continue;
              }
              // the resblock's output, into the mean over resblocks
              float* yr = y + (i - p.ylo) * p.ldy + co;
              if (r > 0) {
                v0 += yr[0];
                v1 += yr[1];
              }
              if (r == n_res - 1) {
                v0 /= (float)n_res;
                v1 /= (float)n_res;
              }
              yr[0] = v0;
              yr[1] = v1;
            }
        }
        __syncthreads();  // the next conv reads what this one wrote
      }
    }
  }

  stage_output<C, kThreads, float>(y, p.ldy, out_ptr, w, b, plan[conv],
                                   has_post, post_pad, tile, t0, T, row);
}

template <int C>
cudaError_t launch_tf32(const void* x, void* out, const float* w,
                        const float* b, const int4* plan, const void* frags,
                        int batch, int c_in, int t_in, int T, int n_res,
                        int n_steps, int ups_k, int ups_stride, int ups_pad,
                        int has_post, int post_pad, int tile, int halo,
                        cudaStream_t stream) {
  if ((tile + 2 * halo + kItemRows - 1) / kItemRows >
      kTf32Slots * kTf32Warps<C>)
    return cudaErrorInvalidValue;  // a conv's rows exceed the warps' slots
  auto kernel = stage_tf32_kernel<C>;
  const StagePlan p(C, tile, halo, post_pad, 4, 0);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((T + tile - 1) / tile, batch);
  kernel<<<grid, 32 * kTf32Warps<C>, p.smem, stream>>>(
      static_cast<const float*>(x), out, w, b, plan,
      static_cast<const uint4*>(frags), c_in, t_in, T, n_res, n_steps, ups_k,
      ups_stride, ups_pad, has_post, post_pad, tile, halo);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry points (bound with ctypes).  Each returns a cudaError_t
// value: 0 when the launch was accepted.
//
// FFMA, C = 8 (under the MMA depth of both tensor-core paths), f32 or
// bf16 (is_bf16).  Wider stages run on tensor cores:
// hifigan_stage_mma_launch (bf16) and hifigan_stage_tf32_launch (f32).
extern "C" int hifigan_stage_launch(const void* x, void* out, const void* w,
                                    const void* b, const void* plan,
                                    int batch, int c, int c_in, int t_in,
                                    int t_out, int n_res, int n_steps,
                                    int ups_k, int ups_stride, int ups_pad,
                                    int has_post, int tile, int halo,
                                    int is_bf16, void* stream) {
  const float* wf = static_cast<const float*>(w);
  const float* bf = static_cast<const float*>(b);
  const int4* pl = static_cast<const int4*>(plan);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (c != 8) return (int)cudaErrorInvalidValue;
  if (is_bf16)
    return (int)launch<8, __nv_bfloat16>(x, out, wf, bf, pl, batch, c_in,
                                         t_in, t_out, n_res, n_steps, ups_k,
                                         ups_stride, ups_pad, has_post, tile,
                                         halo, st);
  return (int)launch<8, float>(x, out, wf, bf, pl, batch, c_in, t_in, t_out,
                               n_res, n_steps, ups_k, ups_stride, ups_pad,
                               has_post, tile, halo, st);
}

// bf16 on the warpgroup MMA, C in {16, 32, 64}.  blocks: the stage's
// weight blocks (ops/stage.py pack_stage_weights: C x C bf16 each in the
// wgmma B layout, the upsampler's taps by phase then the resblock convs'
// taps, in launch order); w, b, plan as above (w is read for conv_post
// only).  post_pad: (K - 1) / 2 of conv_post (0 without it).
extern "C" int hifigan_stage_mma_launch(const void* x, void* out,
                                        const void* w, const void* b,
                                        const void* plan, const void* blocks,
                                        int batch, int c, int c_in, int t_in,
                                        int t_out, int n_res, int n_steps,
                                        int ups_k, int ups_stride,
                                        int ups_pad, int has_post,
                                        int post_pad, int tile, int halo,
                                        void* stream) {
  const float* wf = static_cast<const float*>(w);
  const float* bf = static_cast<const float*>(b);
  const int4* pl = static_cast<const int4*>(plan);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tile <= 0 || post_pad < 0 || (!has_post && post_pad != 0) ||
      (ups_k > 0 && ups_stride <= 0) ||
      (ups_k > 0) + 2 * n_res * n_steps + has_post > kMaxConvs)
    return (int)cudaErrorInvalidValue;
#define STAGE_WGMMA_CASE(CH)                                               \
  case CH:                                                                 \
    return (int)launch_wgmma<CH>(x, out, wf, bf, pl, blocks, batch, c_in,  \
                                 t_in, t_out, n_res, n_steps, ups_k,       \
                                 ups_stride, ups_pad, has_post, post_pad,  \
                                 tile, halo, st);
  switch (c) {
    STAGE_WGMMA_CASE(16)
    STAGE_WGMMA_CASE(32)
    STAGE_WGMMA_CASE(64)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef STAGE_WGMMA_CASE
}

// f32 on tensor cores (three TF32 passes), C in {16, 32, 64}.  frags: the
// resblock convs' TF32 hi/lo fragments (ops/mma.py) in launch order.
// Other arguments as hifigan_stage_mma_launch.
extern "C" int hifigan_stage_tf32_launch(const void* x, void* out,
                                         const void* w, const void* b,
                                         const void* plan, const void* frags,
                                         int batch, int c, int c_in, int t_in,
                                         int t_out, int n_res, int n_steps,
                                         int ups_k, int ups_stride,
                                         int ups_pad, int has_post,
                                         int post_pad, int tile, int halo,
                                         void* stream) {
  const float* wf = static_cast<const float*>(w);
  const float* bf = static_cast<const float*>(b);
  const int4* pl = static_cast<const int4*>(plan);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tile <= 0 || post_pad < 0 || (!has_post && post_pad != 0) ||
      (tile + 2 * post_pad) % kItemRows != 0 ||
      (ups_k > 0) + 2 * n_res * n_steps + has_post > kMaxConvs)
    return (int)cudaErrorInvalidValue;
#define STAGE_TF32_CASE(CH)                                                \
  case CH:                                                                 \
    return (int)launch_tf32<CH>(x, out, wf, bf, pl, frags, batch, c_in,    \
                                t_in, t_out, n_res, n_steps, ups_k,        \
                                ups_stride, ups_pad, has_post, post_pad,   \
                                tile, halo, st);
  switch (c) {
    STAGE_TF32_CASE(16)
    STAGE_TF32_CASE(32)
    STAGE_TF32_CASE(64)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef STAGE_TF32_CASE
}

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
// - bf16, C in {16, 32, 64}: every resblock conv on tensor cores
//   (stage_mma_kernel), the implicit-GEMM tile of csrc/conv_tile.cuh.
//   Three bf16 buffers [rows][C + 8] (stage input, resblock state, first
//   conv's output) and an f32 [rows][C + 1] sum over resblocks replace the
//   four f32 [C][L] buffers of the FFMA path, so a block holds a tile of
//   up to 458 samples at C = 32 with conv_post.  Each conv computes only
//   the rows the rest of its resblock needs (the tile plus the receptive
//   half-width of the convs after it, rounded up to 16 rows), so the
//   halo's recompute is about 1.13x at C = 32 (1.49x on the FFMA path,
//   which runs every conv over the whole haloed tile).  The first conv of
//   a step applies lrelu to its A fragments in registers (rounded to
//   bf16, as torch's bf16 leaky_relu), its epilogue writes
//   lrelu(conv + b), zero outside [0, T); the second adds the bias and
//   the residual into the state (rounded to bf16, as the plain path
//   does) or, at a resblock's last step, into the f32 sum.  The
//   upsampler and conv_post stay on FFMA inside the same launch.  A
//   warp item is 16 rows x all C channels; 16 warps (12 at C = 64), one
//   block per SM.  At C <= 32 each conv's fragments are staged in shared
//   memory once per block, and the launch plan is read once.  The
//   upsampler gives a thread 8 channels at 4 positions of one phase, so a
//   weight load feeds 32 FMAs.  The wrapper (ops/stage.py) picks the tile
//   from a model of waves and warp rounds, so short inputs get short
//   tiles and fill the card.  What bounds it now (measured by taking
//   parts out, PERF.md): the MMA loop (mma.sync, not wgmma, 16-row items)
//   takes about half the time, the FFMA upsampler about a fifth, the
//   epilogues, barriers and staging the rest.
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
// Tensor cores: the block plan and the phases both paths share
// ---------------------------------------------------------------------------

// Warps of a block (one block per SM): 16 at C <= 32, 12 at C = 64 (the
// fastest of 8/12/16 warps and 16/32-row items measured on the decoder's
// stages; ops/stage.py mma_warps mirrors it).  A warp item is 16 rows x
// all C channels.
template <int C>
constexpr int kMmaWarps = C <= 32 ? 16 : 12;
constexpr int kItemRows = 16;

// Shared-memory plan of one block, shared by kernel and launcher.  Buffer
// row i holds sequence position t0 - halo + i; the stage output y covers
// rows [ylo, ylo + yn) with yn = tile + 2 * post_pad.  Every conv computes
// a whole number of 16-row MMA tiles, so buffers carry 16 rows of slack
// past L = tile + 2 * halo; rows past a conv's needed range feed only
// rows past the next conv's.
//   x0 [lb][ld] T      stage input (the upsampler's output when fused)
//   s  [lb][ld] T      resblock state
//   u  [lb][ld] T      lrelu(conv1 + b), the second conv's operand
//   y  [yn][C + 1] f32 sum over resblocks (odd stride: the transposed
//                      reads of the store and of conv_post spread banks)
//   plan  the launch plan's rows, read once
//   w  staged weight fragments:
//      bf16: at C <= 32, the current conv's (max_k taps, at most
//      22.5 KB), staged from device memory once per conv: every warp item
//      reads them, and through L1 (which shared memory leaves small) they
//      would come from L2 again and again.  At C = 64 a conv's fragments
//      (90 KB) would cost the tile more than the L2 reads cost, so warps
//      read them from device memory.  f32: none (stage_tf32_kernel says
//      why).
// T is bf16 or f32, the path's operand type.  The upsampler stages
// lrelu(x_in) as f32 [c_in][lin] over s, u and y.
constexpr int kMaxConvs = 64;  // rows of the launch plan a block holds
template <int C>
constexpr bool kStageWeights = C <= 32;

struct StagePlan {
  int ld, lb, yn, ylo, ldy;
  size_t buf_bytes, plan_offset, w_offset, smem;
  // elt: bytes of an x0 / s / u element (2 for bf16, 4 for f32); ld pads
  // a row by 16 bytes so that eight rows start in eight bank groups.
  // w_uint4: the staged weight fragments.
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

// bf16: at C <= 32 the largest conv's fragments (max_k taps)
__host__ __device__ inline int bf16_w_uint4(int c, int max_k) {
  return c <= 32 ? max_k * (c / 16) * (c / 16) * 32 : 0;
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float v0, float v1) {
  *reinterpret_cast<uint32_t*>(p) = conv_tile::pack_bf16x2(v0, v1);
}
__device__ __forceinline__ void store2(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}
// eight channels in one 16-byte store (two for f32)
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&v)[8]) {
  uint4 packed;
  packed.x = conv_tile::pack_bf16x2(v[0], v[1]);
  packed.y = conv_tile::pack_bf16x2(v[2], v[3]);
  packed.z = conv_tile::pack_bf16x2(v[4], v[5]);
  packed.w = conv_tile::pack_bf16x2(v[6], v[7]);
  *reinterpret_cast<uint4*>(p) = packed;
}
__device__ __forceinline__ void store8(float* p, const float (&v)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return conv_tile::unpack_bf16x2(*reinterpret_cast<const uint32_t*>(p));
}
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// x0 = the stage input for buffer rows [0, L), [row][ld] in T, zero
// outside [0, T): the upsampler's output (on FFMA) when ups_k > 0, else x
// transposed.  The upsampler stages lrelu(x_in) as f32 [c_in][lin] at
// xin, which must not overlap x0.  Ends with a barrier.
template <int C, int kThreads, typename T>
__device__ __forceinline__ void stage_input(
    const T* __restrict__ x, T* x0, int ld, float* xin,
    const float* __restrict__ w, const float* __restrict__ b, int4 cu,
    int c_in, int t_in, int T_len, int ups_k, int ups_stride, int ups_pad,
    int L, int pos0, int row) {
  if (ups_k > 0) {
    // stage lrelu(x_in) for every input row this tile's outputs read
    const int m_lo = floordiv(pos0 + ups_pad - (ups_k - 1), ups_stride);
    const int m_hi = floordiv(pos0 + L - 1 + ups_pad, ups_stride);
    const int lin = m_hi - m_lo + 1;
    const T* xb = x + (size_t)row * c_in * t_in;
    for (int idx = threadIdx.x; idx < c_in * lin; idx += kThreads) {
      const int ci = idx / lin;
      const int m = m_lo + (idx - ci * lin);
      xin[idx] = (m >= 0 && m < t_in)
                     ? lrelu(load_f(xb + (size_t)ci * t_in + m))
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
    // transpose the input tile to [position][channel], two channels a
    // thread, neighbouring threads neighbouring positions
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
// bf16 on tensor cores
// ---------------------------------------------------------------------------

template <int C>
__global__ void __launch_bounds__(32 * kMmaWarps<C>, 1)
    stage_mma_kernel(const __nv_bfloat16* __restrict__ x,
                     void* __restrict__ out_ptr, const float* __restrict__ w,
                     const float* __restrict__ b,
                     const int4* plan, const uint4* __restrict__ frags,
                     int c_in, int t_in,
                     int T, int n_res, int n_steps, int ups_k,
                     int ups_stride, int ups_pad, int has_post, int post_pad,
                     int tile, int halo, int max_k) {
  constexpr int NW = C / 8;  // one warp item: 16 rows x all C channels
  constexpr int kcs = C / 16;
  constexpr int kThreads = 32 * kMmaWarps<C>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const StagePlan p(C, tile, halo, post_pad, 2, bf16_w_uint4(C, max_k));
  __nv_bfloat16* x0 = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* s = x0 + p.lb * p.ld;
  __nv_bfloat16* u = s + p.lb * p.ld;
  float* y = reinterpret_cast<float*>(smem_raw + 3 * p.buf_bytes);
  uint4* wsm = reinterpret_cast<uint4*>(smem_raw + p.w_offset);
  int4* plan_s = reinterpret_cast<int4*>(smem_raw + p.plan_offset);
  const int n_convs = (ups_k > 0) + 2 * n_res * n_steps + has_post;
  for (int i = threadIdx.x; i < n_convs; i += kThreads) plan_s[i] = plan[i];
  __syncthreads();
  plan = plan_s;
  const int L = tile + 2 * halo;
  const int row = blockIdx.y;
  const int t0 = blockIdx.x * tile;
  const int pos0 = t0 - halo;  // sequence position of buffer row 0
  int conv = ups_k > 0;  // plan row of the next conv
  stage_input<C, kThreads>(x, x0, p.ld, reinterpret_cast<float*>(s), w, b,
                           plan[0], c_in, t_in, T, ups_k, ups_stride,
                           ups_pad, L, pos0, row);

  const int warp = threadIdx.x / 32;
  const uint4* wf = frags;
  for (int r = 0; r < n_res; ++r) {
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
        const bool last = step == n_steps - 1 && half == 1;
        // stage the conv's fragments (the last barrier ended every read
        // of the previous conv's); this lane's biases into registers
        if (kStageWeights<C>) {
          for (int i = threadIdx.x; i < cc.z * kcs * kcs * 32;
               i += kThreads)
            wsm[i] = __ldg(wf + i);
        }
        float bias[NW][2];
#pragma unroll
        for (int ni = 0; ni < NW; ++ni) {
          bias[ni][0] = __ldg(b + cc.y + conv_tile::acc_col(ni, 0));
          bias[ni][1] = __ldg(b + cc.y + conv_tile::acc_col(ni, 1));
        }
        __syncthreads();
        for (int item = warp; item * kItemRows < n; item += kMmaWarps<C>) {
          const int r0 = lo + item * kItemRows;
          float acc[1][NW][4];
          conv_tile::zero(acc);
          const uint4* wc = kStageWeights<C> ? wsm : wf;
          if (half == 0)
            conv_tile::conv_mma<1, NW, true, kStageWeights<C>>(
                acc, src, p.ld, r0 - pad, cc.z, cc.w, kcs, wc, kcs, 0);
          else
            conv_tile::conv_mma<1, NW, false, kStageWeights<C>>(
                acc, u, p.ld, r0 - pad, cc.z, cc.w, kcs, wc, kcs, 0);
#pragma unroll
          for (int ni = 0; ni < NW; ++ni)
#pragma unroll
            for (int e = 0; e < 4; e += 2) {
              const int i = r0 + conv_tile::acc_row(0, e);
              const int co = conv_tile::acc_col(ni, e);
              const int t = pos0 + i;
              const bool inside = t >= 0 && t < T;
              float v0 = acc[0][ni][e] + bias[ni][0];
              float v1 = acc[0][ni][e + 1] + bias[ni][1];
              if (half == 0) {
                // lrelu(conv1), zero outside [0, T)
                *reinterpret_cast<uint32_t*>(u + i * p.ld + co) =
                    conv_tile::pack_bf16x2(inside ? lrelu(v0) : 0.f,
                                           inside ? lrelu(v1) : 0.f);
                continue;
              }
              // residual add onto the state
              const float2 prev = conv_tile::unpack_bf16x2(
                  *reinterpret_cast<const uint32_t*>(src + i * p.ld + co));
              v0 = inside ? prev.x + v0 : 0.f;
              v1 = inside ? prev.y + v1 : 0.f;
              if (!last) {
                *reinterpret_cast<uint32_t*>(s + i * p.ld + co) =
                    conv_tile::pack_bf16x2(v0, v1);
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
        wf += (size_t)cc.z * kcs * kcs * 32;
        __syncthreads();
      }
    }
  }

  stage_output<C, kThreads, __nv_bfloat16>(y, p.ldy, out_ptr, w, b,
                                           plan[conv], has_post, post_pad,
                                           tile, t0, T, row);
}

template <int C>
cudaError_t launch_mma(const void* x, void* out, const float* w,
                       const float* b, const int4* plan, const void* frags,
                       int batch, int c_in, int t_in, int T, int n_res,
                       int n_steps, int ups_k, int ups_stride, int ups_pad,
                       int has_post, int post_pad, int tile, int halo,
                       int max_k, cudaStream_t stream) {
  auto kernel = stage_mma_kernel<C>;
  const StagePlan p(C, tile, halo, post_pad, 2, bf16_w_uint4(C, max_k));
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((T + tile - 1) / tile, batch);
  kernel<<<grid, 32 * kMmaWarps<C>, p.smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), out, w, b, plan,
      static_cast<const uint4*>(frags), c_in, t_in, T, n_res, n_steps, ups_k,
      ups_stride, ups_pad, has_post, post_pad, tile, halo, max_k);
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

// bf16 on tensor cores, C in {16, 32, 64}.  frags: the resblock convs'
// MMA fragments (ops/mma.py) in launch order; w, b, plan as above (w is
// read for the upsampler and conv_post only).  post_pad: (K - 1) / 2 of
// conv_post (0 without it).  The tile plus 2 * post_pad is a multiple of
// 16.  max_k: the largest K of the resblock convs.
extern "C" int hifigan_stage_mma_launch(const void* x, void* out,
                                        const void* w, const void* b,
                                        const void* plan, const void* frags,
                                        int batch, int c, int c_in, int t_in,
                                        int t_out, int n_res, int n_steps,
                                        int ups_k, int ups_stride,
                                        int ups_pad, int has_post,
                                        int post_pad, int tile, int halo,
                                        int max_k, void* stream) {
  const float* wf = static_cast<const float*>(w);
  const float* bf = static_cast<const float*>(b);
  const int4* pl = static_cast<const int4*>(plan);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tile <= 0 || post_pad < 0 || (!has_post && post_pad != 0) ||
      (tile + 2 * post_pad) % kItemRows != 0 || max_k <= 0 ||
      (ups_k > 0) + 2 * n_res * n_steps + has_post > kMaxConvs)
    return (int)cudaErrorInvalidValue;
#define STAGE_MMA_CASE(CH)                                                 \
  case CH:                                                                 \
    return (int)launch_mma<CH>(x, out, wf, bf, pl, frags, batch, c_in,     \
                               t_in, t_out, n_res, n_steps, ups_k,         \
                               ups_stride, ups_pad, has_post, post_pad,    \
                               tile, halo, max_k, st);
  switch (c) {
    STAGE_MMA_CASE(16)
    STAGE_MMA_CASE(32)
    STAGE_MMA_CASE(64)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef STAGE_MMA_CASE
}

// f32 on tensor cores (three TF32 passes), C in {16, 32, 64}.  frags: the
// resblock convs' TF32 hi/lo fragments (ops/mma.py) in launch order.
// Other arguments as hifigan_stage_mma_launch, less max_k.
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

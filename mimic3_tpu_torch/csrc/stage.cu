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
// bound by instruction issue: f32 FMAs plus the shared-memory activation
// reads and L1-broadcast weight reads that feed them.  The four f32
// buffers fill a block's shared memory, so one block (12 warps at C = 32)
// runs per SM and latency is hidden by warps plus per-thread register
// blocking.  Measured on an H100 80GB HBM3 (700 W) for the last decoder
// stage, x = [1, 64, 32768] f32: 1.56 ms, about 25% of the 67 TFLOP/s f32
// peak counting the 1.49x halo recompute.  No tensor cores yet: a later
// version would run each conv as an MMA over [tile, Cin*K] x [Cin*K, C].
//
// Design (simple and correct first):
// - one thread block per (batch row, time tile); the tile plus a halo of
//   the stage's receptive field (60 samples for k = 11, d = 1/3/5, + 3 for
//   conv_post) is loaded once into shared memory as f32.  The upsampler
//   output is computed directly for every haloed position from a staged
//   copy of lrelu(x_in), so it needs no halo of its own;
// - four f32 buffers [C][tile + 2*halo]: stage input, resblock state,
//   conv1 output, running sum over resblocks.  Every conv is computed
//   over the whole haloed tile; errors from the buffer edge creep inward
//   by one conv padding per conv and never reach the tile's centre;
// - each thread computes 8 output channels at 4 positions (2 at C = 64)
//   in registers; weights are laid out [Cin][K][Cout] and read as float4,
//   warp-uniform, so one load feeds 16 FMAs;
// - bf16 activations are loaded and stored as bf16, all math is f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

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

template <typename T_io>
cudaError_t dispatch(int c, const void* x, void* out, const float* w,
                     const float* b, const int4* plan, int batch, int c_in,
                     int t_in, int T, int n_res, int n_steps, int ups_k,
                     int ups_stride, int ups_pad, int has_post, int tile,
                     int halo, cudaStream_t stream) {
#define STAGE_CASE(CH)                                                     \
  case CH:                                                                 \
    return launch<CH, T_io>(x, out, w, b, plan, batch, c_in, t_in, T,      \
                            n_res, n_steps, ups_k, ups_stride, ups_pad,    \
                            has_post, tile, halo, stream);
  switch (c) {
    STAGE_CASE(8)
    STAGE_CASE(16)
    STAGE_CASE(32)
    STAGE_CASE(64)
    default:
      return cudaErrorInvalidValue;
  }
#undef STAGE_CASE
}

}  // namespace

// Plain C entry point (bound with ctypes).  Returns a cudaError_t value:
// 0 when the launch was accepted.
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
  if (is_bf16)
    return (int)dispatch<__nv_bfloat16>(c, x, out, wf, bf, pl, batch, c_in,
                                        t_in, t_out, n_res, n_steps, ups_k,
                                        ups_stride, ups_pad, has_post, tile,
                                        halo, st);
  return (int)dispatch<float>(c, x, out, wf, bf, pl, batch, c_in, t_in,
                              t_out, n_res, n_steps, ups_k, ups_stride,
                              ups_pad, has_post, tile, halo, st);
}

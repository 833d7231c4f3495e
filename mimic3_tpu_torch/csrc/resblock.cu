// Fused HiFi-GAN ResBlock1 dilation step for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel mimic3_tpu/ops/resblock.py::
// fused_resblock_subblock (body _subblock_kernel).  For x [B, C, T] and
// conv weights packed as [Cin][K][Cout]:
//
//   h   = lrelu(conv_{K,d}(lrelu(x)) + b1), zero outside [0, T)
//   out = x + conv_K(h) + b2
//
// with torch Conv1d zero padding: lrelu(x) is zero outside [0, T), and so
// is h before the second conv.  Only x is read from device memory (once
// for the haloed tile, once for the residual) and only out is written;
// lrelu(x) and h stay in shared memory.
//
// What bounds it on this card: the step does 4*C*C*K FLOPs per sample
// against 2*C activations read and C written (at C = 128, K = 3 in bf16,
// 384 FLOPs per byte), so it is bound by instruction issue, not by
// memory: f32 FMAs plus the shared-memory activation reads and L1
// weight reads that feed them.  No tensor cores yet: a later version
// would run each conv as an MMA over [tile, Cin*K] x [Cin*K, C].
//
// Design (simple and correct first):
// - one block per (batch row, time tile).  The tile plus the exact halos
//   (d*(K-1)/2 for the first conv, (K-1)/2 for the second) of lrelu(x) is
//   loaded into shared memory as f32, then the first conv writes the
//   masked intermediate over the tile plus the second halo, then the
//   second conv adds the residual and writes the tile.  No halo rounding
//   and no tiling constraint on T: the last tile is masked;
// - the wrapper picks the time tile from C and the halo so that two
//   blocks fit in an SM's shared memory where a tile of 64 allows, else
//   one (C = 256, K = 11, d = 5: tile 64, 203 KB);
// - a warp computes 8 output channels at 128 positions (4 per lane), so
//   its weight reads are warp-uniform float4 broadcasts (two loads feed
//   32 FMAs) and its activation reads are conflict-free.  The 8 warps of
//   a block walk over the (channel group, position chunk) items, so any C
//   that is a multiple of 8 up to 256 works with one launch shape;
// - weights arrive rounded to x's dtype and widened to f32; bf16
//   activations are loaded and stored as bf16; all math is f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr float kSlope = 0.1f;
constexpr int kThreads = 256;
constexpr int kWarp = 32;
constexpr int kWarps = kThreads / kWarp;
constexpr int kCoT = 8;              // output channels per warp item
constexpr int kPos = 4;              // positions per lane
constexpr int kSpan = kWarp * kPos;  // positions per warp item
constexpr int kMaxChannels = 256;

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

// acc[p][j] += sum_{ci, tap} w[ci][tap][co0 + j] * in[ci][i_p + tap*dil]
// for this lane's positions i_p = base + lane + 32p.  in has rows of
// l_in floats and the caller guarantees i + (k-1)*dil < l_in for every
// i < n; positions i >= n read row index 0 and are not stored.
__device__ __forceinline__ void conv_item(const float* __restrict__ in,
                                          int l_in,
                                          const float* __restrict__ w, int c,
                                          int k, int dil, int co0, int base,
                                          int n, float (&acc)[kPos][kCoT]) {
  const int lane = threadIdx.x % kWarp;
  int off[kPos];
#pragma unroll
  for (int p = 0; p < kPos; ++p) {
    const int i = base + lane + p * kWarp;
    off[p] = i < n ? i : 0;
  }
  for (int tap = 0; tap < k; ++tap) {
    const float* in_tap = in + tap * dil;
    const float4* w_tap = reinterpret_cast<const float4*>(w + tap * c + co0);
#pragma unroll 4
    for (int ci = 0; ci < c; ++ci) {
      const float* row = in_tap + ci * l_in;
      float v[kPos];
#pragma unroll
      for (int p = 0; p < kPos; ++p) v[p] = row[off[p]];
      const float4* wc = w_tap + ci * k * (c / 4);
      const float4 wa = __ldg(wc);
      const float4 wb = __ldg(wc + 1);
#pragma unroll
      for (int p = 0; p < kPos; ++p) {
        acc[p][0] = fmaf(wa.x, v[p], acc[p][0]);
        acc[p][1] = fmaf(wa.y, v[p], acc[p][1]);
        acc[p][2] = fmaf(wa.z, v[p], acc[p][2]);
        acc[p][3] = fmaf(wa.w, v[p], acc[p][3]);
        acc[p][4] = fmaf(wb.x, v[p], acc[p][4]);
        acc[p][5] = fmaf(wb.y, v[p], acc[p][5]);
        acc[p][6] = fmaf(wb.z, v[p], acc[p][6]);
        acc[p][7] = fmaf(wb.w, v[p], acc[p][7]);
      }
    }
  }
}

__device__ __forceinline__ void init_bias(const float* __restrict__ b,
                                          int co0,
                                          float (&acc)[kPos][kCoT]) {
#pragma unroll
  for (int j = 0; j < kCoT; ++j) {
    const float bv = __ldg(b + co0 + j);
#pragma unroll
    for (int p = 0; p < kPos; ++p) acc[p][j] = bv;
  }
}

template <typename T_io>
__global__ void __launch_bounds__(kThreads)
    subblock_kernel(const T_io* __restrict__ x, T_io* __restrict__ out,
                    const float* __restrict__ w1,
                    const float* __restrict__ b1,
                    const float* __restrict__ w2,
                    const float* __restrict__ b2, int c, int T, int k,
                    int dil, int tile) {
  extern __shared__ float smem[];
  const int h1 = dil * (k - 1) / 2;
  const int h2 = (k - 1) / 2;
  const int l2 = tile + 2 * h2;  // intermediate positions per row
  const int l1 = l2 + 2 * h1;    // input positions per row
  float* a = smem;               // lrelu(x)          [c][l1]
  float* h = smem + c * l1;      // masked lrelu(y1)  [c][l2]
  const int row = blockIdx.y;
  const int t0 = blockIdx.x * tile;
  const int pos_h = t0 - h2;      // sequence position of h[.][0]
  const int pos_a = pos_h - h1;   // sequence position of a[.][0]
  const T_io* xb = x + (size_t)row * c * T;
  T_io* ob = out + (size_t)row * c * T;

  for (int idx = threadIdx.x; idx < c * l1; idx += kThreads) {
    const int ci = idx / l1;
    const int t = pos_a + (idx - ci * l1);
    a[idx] = (t >= 0 && t < T) ? lrelu(load_f(xb + (size_t)ci * T + t)) : 0.f;
  }
  __syncthreads();

  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int groups = c / kCoT;

  // first conv over the tile and the second conv's halo
  const int chunks1 = (l2 + kSpan - 1) / kSpan;
  for (int item = warp; item < groups * chunks1; item += kWarps) {
    const int co0 = (item / chunks1) * kCoT;
    const int base = (item % chunks1) * kSpan;
    float acc[kPos][kCoT];
    init_bias(b1, co0, acc);
    conv_item(a, l1, w1, c, k, dil, co0, base, l2, acc);
#pragma unroll
    for (int p = 0; p < kPos; ++p) {
      const int i = base + lane + p * kWarp;
      if (i >= l2) continue;
      const int t = pos_h + i;
      const bool inside = t >= 0 && t < T;
#pragma unroll
      for (int j = 0; j < kCoT; ++j)
        h[(co0 + j) * l2 + i] = inside ? lrelu(acc[p][j]) : 0.f;
    }
  }
  __syncthreads();

  // second conv + residual over the tile's valid positions
  const int n = min(tile, T - t0);
  const int chunks2 = (n + kSpan - 1) / kSpan;
  for (int item = warp; item < groups * chunks2; item += kWarps) {
    const int co0 = (item / chunks2) * kCoT;
    const int base = (item % chunks2) * kSpan;
    float acc[kPos][kCoT];
    init_bias(b2, co0, acc);
    conv_item(h, l2, w2, c, k, 1, co0, base, n, acc);
#pragma unroll
    for (int p = 0; p < kPos; ++p) {
      const int i = base + lane + p * kWarp;
      if (i >= n) continue;
#pragma unroll
      for (int j = 0; j < kCoT; ++j) {
        const size_t g = (size_t)(co0 + j) * T + t0 + i;
        store_f(ob + g, load_f(xb + g) + acc[p][j]);
      }
    }
  }
}

template <typename T_io>
cudaError_t launch(const void* x, void* out, const float* w1, const float* b1,
                   const float* w2, const float* b2, int batch, int c, int T,
                   int k, int dil, int tile, cudaStream_t stream) {
  auto kernel = subblock_kernel<T_io>;
  const int h1 = dil * (k - 1) / 2;
  const int h2 = (k - 1) / 2;
  const int smem =
      c * ((tile + 2 * h2 + 2 * h1) + (tile + 2 * h2)) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((T + tile - 1) / tile, batch);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T_io*>(x), static_cast<T_io*>(out), w1, b1, w2, b2, c,
      T, k, dil, tile);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes).  Returns a cudaError_t value:
// 0 when the launch was accepted.
extern "C" int resblock_subblock_launch(const void* x, void* out,
                                        const void* w1, const void* b1,
                                        const void* w2, const void* b2,
                                        int batch, int c, int T, int k,
                                        int dil, int tile, int is_bf16,
                                        void* stream) {
  if (c <= 0 || c % kCoT != 0 || c > kMaxChannels || T <= 0 || k <= 0 ||
      k % 2 == 0 || dil <= 0 || tile <= 0 || batch <= 0)
    return (int)cudaErrorInvalidValue;
  const float* w1f = static_cast<const float*>(w1);
  const float* b1f = static_cast<const float*>(b1);
  const float* w2f = static_cast<const float*>(w2);
  const float* b2f = static_cast<const float*>(b2);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return (int)launch<__nv_bfloat16>(x, out, w1f, b1f, w2f, b2f, batch, c,
                                      T, k, dil, tile, st);
  return (int)launch<float>(x, out, w1f, b1f, w2f, b2f, batch, c, T, k, dil,
                            tile, st);
}

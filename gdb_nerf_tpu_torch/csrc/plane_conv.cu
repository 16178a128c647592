// Plane-layout direct convolutions for NVIDIA Hopper (sm_90a).
//
// Replaces the three Pallas kernels of tools/microbench_pallas_conv.py:
//   plane_conv1      <- pallas_conv1 (conv1_kernel):
//                       out = relu(conv3x3(x) + b), x pre-padded by 1
//   plane_convchain  <- pallas_convchain (convchain_kernel):
//                       n chained relu(conv3x3 + b), c -> c, each
//                       intermediate rounded to x's dtype and zero outside
//                       the image (the Pallas scratch's zero ring)
//   plane_fpnprim    <- pallas_fpnprim (fpnprim_kernel):
//                       o1 = conv5x5 stride 2 (x pre-padded by 2) + b, no ReLU;
//                       o2 = nearest 2x upsample of o1's float32 value, rows
//                       >= H - 3 set to 0
// Planes are (c, H, W) row-major, float32 or bf16; weights and bias are
// float32 in the JAX layout (co, ci, ky, kx); accumulation is float32 and
// every output is written in x's dtype.
//
// Bound: at the FPN's widths (c = 8, 512x640) each conv does ~1.2 kFLOP per
// output pixel against 2-4 bytes read and written per channel, so all three
// are bound by device memory (bf16 and float32 alike; float32 convchain with
// n = 4 is the exception, bound by float32 FMA issue).  Design: one block per
// output tile; the tile's input, with its halo, is loaded once into shared
// memory as float32, so device memory is read about once (the halo's re-reads
// hit L2); the weights are staged per block in shared memory in groups of 8
// output channels ([group][ci][tap][8]), so every thread of a warp reads the
// same 8 weights (a broadcast) while it keeps 8 float32 sums in registers.
// convchain keeps its intermediates on chip: a tile of (16+2n) x (32+2n)
// pixels is loaded and each layer's output region shrinks by one pixel per
// side (a halo of n pixels recomputed per tile), ping-ponging between two
// shared-memory buffers.  Positions of an intermediate outside the image are
// forced to 0 after each layer, as the Pallas kernel's zero ring is.  Tensor
// cores, TMA and wider per-thread tiles are later work.
//
// Interface: plain C, loaded with ctypes; launches on the caller's stream
// and returns the cudaError_t of the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kGroup = 8;             // output channels summed per pass
constexpr int kMaxSmem = 232448;      // bytes a block may use on sm_90
// Output tiles (rows x cols): conv1 and fpnprim give each thread one output
// pixel; convchain loops its threads over each layer's region.
constexpr int kConvTH = 8, kConvTW = 32;
constexpr int kChainTH = 16, kChainTW = 32;
constexpr int kPrimTH = 8, kPrimTW = 32;  // in o1 pixels

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// v rounded to T's precision, kept as float32.
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

__host__ __device__ inline int groups(int c) { return (c + kGroup - 1) / kGroup; }

// Copies planes src (c, rows, cols) into dst [c][tr][tc] as float32, from
// (r0, c0) of src on; positions outside src become 0.
template <typename T>
__device__ void load_tile(float* dst, const T* __restrict__ src, int c, int rows, int cols, int r0,
                          int c0, int tr, int tc) {
  const int n = c * tr * tc;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int ch = i / (tr * tc), rem = i - ch * tr * tc;
    const int r = r0 + rem / tc, q = c0 + rem % tc;
    dst[i] = (r >= 0 && r < rows && q >= 0 && q < cols)
                 ? to_f32(src[(static_cast<long long>(ch) * rows + r) * cols + q])
                 : 0.f;
  }
}

// Stages weights w (c_out, c_in, taps) as [group][ci][tap][kGroup], zero for
// the padding channels of the last group, then the bias as [group*kGroup].
__device__ void load_weights(float* dst, const float* __restrict__ w, const float* __restrict__ b,
                             int c_out, int c_in, int taps) {
  const int n = groups(c_out) * c_in * taps * kGroup;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int j = i % kGroup, rest = i / kGroup;
    const int tap = rest % taps, ci = (rest / taps) % c_in, g = rest / (taps * c_in);
    const int co = g * kGroup + j;
    dst[i] = co < c_out ? w[(co * c_in + ci) * taps + tap] : 0.f;
  }
  for (int i = threadIdx.x; i < groups(c_out) * kGroup; i += blockDim.x)
    dst[n + i] = i < c_out ? b[i] : 0.f;
}

// acc[j] += 3x3 conv of the float32 tile src [c_in][tr][tc] at (r, q) (the
// tap's top-left) with the staged weights of one group sw [ci][9][kGroup].
__device__ __forceinline__ void conv3x3_group(float (&acc)[kGroup], const float* src, int c_in,
                                              int tr, int tc, int r, int q, const float* sw) {
  for (int ci = 0; ci < c_in; ++ci) {
    const float* p = src + (ci * tr + r) * tc + q;
#pragma unroll
    for (int ky = 0; ky < 3; ++ky)
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
        const float v = p[ky * tc + kx];
        const float* wk = sw + (ci * 9 + ky * 3 + kx) * kGroup;
#pragma unroll
        for (int j = 0; j < kGroup; ++j) acc[j] = fmaf(v, wk[j], acc[j]);
      }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
conv1_kernel(const T* __restrict__ x, const float* __restrict__ w, const float* __restrict__ b,
             T* __restrict__ out, int c_in, int c_out, int H, int W) {
  extern __shared__ float smem[];
  constexpr int tr = kConvTH + 2, tc = kConvTW + 2;
  float* sx = smem;
  float* sw = sx + c_in * tr * tc;
  float* sb = sw + groups(c_out) * c_in * 9 * kGroup;
  const int oy = blockIdx.y * kConvTH, ox = blockIdx.x * kConvTW;
  load_tile(sx, x, c_in, H + 2, W + 2, oy, ox, tr, tc);
  load_weights(sw, w, b, c_out, c_in, 9);
  __syncthreads();
  const int ty = threadIdx.x / kConvTW, tx = threadIdx.x % kConvTW;
  const int y = oy + ty, xx = ox + tx;
  if (y >= H || xx >= W) return;
  for (int g = 0; g < groups(c_out); ++g) {
    float acc[kGroup] = {};
    conv3x3_group(acc, sx, c_in, tr, tc, ty, tx, sw + g * c_in * 9 * kGroup);
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      const int co = g * kGroup + j;
      if (co < c_out)
        out[(static_cast<long long>(co) * H + y) * W + xx] =
            from_f32<T>(fmaxf(acc[j] + sb[co], 0.f));
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
convchain_kernel(const T* __restrict__ x, const float* __restrict__ w, const float* __restrict__ b,
                 T* __restrict__ out, int c, int H, int W, int n) {
  extern __shared__ float smem[];
  // Frame of the tile: frame row f is image row oy - n + f (x's padded row
  // oy - n + f + 1); likewise for columns.  Layer k writes frame rows
  // [k + 1, R - k - 1), so the last one writes exactly the output tile.
  const int R = kChainTH + 2 * n, C = kChainTW + 2 * n;
  const int G = groups(c), layer_w = G * c * 9 * kGroup;
  float* buf0 = smem;
  float* buf1 = smem + c * R * C;
  float* sw = smem + 2 * c * R * C;
  const int oy = blockIdx.y * kChainTH, ox = blockIdx.x * kChainTW;
  load_tile(buf0, x, c, H + 2, W + 2, oy - n + 1, ox - n + 1, R, C);
  for (int k = 0; k < n; ++k)
    load_weights(sw + k * (layer_w + G * kGroup), w + k * c * c * 9, b + k * c, c, c, 9);
  __syncthreads();
  for (int k = 0; k < n; ++k) {
    const float* src = (k & 1) ? buf1 : buf0;
    float* dst = (k & 1) ? buf0 : buf1;
    const float* lw = sw + k * (layer_w + G * kGroup);
    const float* lb = lw + layer_w;
    const bool last = k == n - 1;
    const int rr = R - 2 * (k + 1), rc = C - 2 * (k + 1);
    for (int i = threadIdx.x; i < rr * rc; i += blockDim.x) {
      const int fr = k + 1 + i / rc, fc = k + 1 + i % rc;
      const int y = oy - n + fr, xx = ox - n + fc;
      const bool inside = y >= 0 && y < H && xx >= 0 && xx < W;
      if (last && !inside) continue;
      for (int g = 0; g < G; ++g) {
        float acc[kGroup] = {};
        conv3x3_group(acc, src, c, R, C, fr - 1, fc - 1, lw + g * c * 9 * kGroup);
#pragma unroll
        for (int j = 0; j < kGroup; ++j) {
          const int co = g * kGroup + j;
          if (co >= c) continue;
          const float v = fmaxf(acc[j] + lb[co], 0.f);
          if (last)
            out[(static_cast<long long>(co) * H + y) * W + xx] = from_f32<T>(v);
          else
            dst[(co * R + fr) * C + fc] = inside ? round_to<T>(v) : 0.f;
        }
      }
    }
    __syncthreads();
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
fpnprim_kernel(const T* __restrict__ x, const float* __restrict__ w, const float* __restrict__ b,
               T* __restrict__ o1, T* __restrict__ o2, int c, int H, int W) {
  extern __shared__ float smem[];
  constexpr int tr = 2 * kPrimTH + 3, tc = 2 * kPrimTW + 3;
  const int G = groups(c);
  float* sx = smem;
  float* sw = sx + c * tr * tc;
  float* sb = sw + G * c * 25 * kGroup;
  const int oy = blockIdx.y * kPrimTH, ox = blockIdx.x * kPrimTW;  // o1 pixels
  load_tile(sx, x, c, H + 4, W + 4, 2 * oy, 2 * ox, tr, tc);
  load_weights(sw, w, b, c, c, 25);
  __syncthreads();
  const int ty = threadIdx.x / kPrimTW, tx = threadIdx.x % kPrimTW;
  const int Ho = H / 2, Wo = W / 2;
  const int i = oy + ty, j = ox + tx;
  if (i >= Ho || j >= Wo) return;
  for (int g = 0; g < G; ++g) {
    const float* gw = sw + g * c * 25 * kGroup;
    float acc[kGroup] = {};
    // Per tap a sum over input channels, then the taps in order, as the
    // Pallas kernel's grouped formulation sums.
    for (int ky = 0; ky < 5; ++ky)
      for (int kx = 0; kx < 5; ++kx) {
        float s[kGroup] = {};
        for (int ci = 0; ci < c; ++ci) {
          const float v = sx[(ci * tr + 2 * ty + ky) * tc + 2 * tx + kx];
          const float* wk = gw + (ci * 25 + ky * 5 + kx) * kGroup;
#pragma unroll
          for (int q = 0; q < kGroup; ++q) s[q] = fmaf(v, wk[q], s[q]);
        }
#pragma unroll
        for (int q = 0; q < kGroup; ++q) acc[q] += s[q];
      }
#pragma unroll
    for (int q = 0; q < kGroup; ++q) {
      const int co = g * kGroup + q;
      if (co >= c) continue;
      const float y = acc[q] + sb[co];
      const T v = from_f32<T>(y);
      o1[(static_cast<long long>(co) * Ho + i) * Wo + j] = v;
#pragma unroll
      for (int dy = 0; dy < 2; ++dy) {
        const int r = 2 * i + dy;
        const T u = r < H - 3 ? v : from_f32<T>(0.f);
        T* row = o2 + (static_cast<long long>(co) * H + r) * W + 2 * j;
        row[0] = u;
        row[1] = u;
      }
    }
  }
}

// Raises the kernel's dynamic shared-memory limit to `bytes` where that is
// above the 48 KB default; refuses what no block may hold.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes > static_cast<size_t>(kMaxSmem)) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T>
cudaError_t launch_conv1(const T* x, const float* w, const float* b, T* out, int c_in, int c_out,
                         int H, int W, cudaStream_t stream) {
  const size_t smem = (static_cast<size_t>(c_in) * (kConvTH + 2) * (kConvTW + 2) +
                       groups(c_out) * kGroup * (c_in * 9 + 1)) *
                      sizeof(float);
  cudaError_t err = allow_smem(conv1_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((W + kConvTW - 1) / kConvTW, (H + kConvTH - 1) / kConvTH);
  conv1_kernel<T><<<grid, kThreads, smem, stream>>>(x, w, b, out, c_in, c_out, H, W);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_convchain(const T* x, const float* w, const float* b, T* out, int c, int H,
                             int W, int n, cudaStream_t stream) {
  const size_t R = kChainTH + 2 * n, C = kChainTW + 2 * n;
  const size_t smem =
      (2 * static_cast<size_t>(c) * R * C + n * groups(c) * kGroup * (c * 9 + 1)) * sizeof(float);
  cudaError_t err = allow_smem(convchain_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((W + kChainTW - 1) / kChainTW, (H + kChainTH - 1) / kChainTH);
  convchain_kernel<T><<<grid, kThreads, smem, stream>>>(x, w, b, out, c, H, W, n);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_fpnprim(const T* x, const float* w, const float* b, T* o1, T* o2, int c, int H,
                           int W, cudaStream_t stream) {
  const size_t smem = (static_cast<size_t>(c) * (2 * kPrimTH + 3) * (2 * kPrimTW + 3) +
                       groups(c) * kGroup * (c * 25 + 1)) *
                      sizeof(float);
  cudaError_t err = allow_smem(fpnprim_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((W / 2 + kPrimTW - 1) / kPrimTW, (H / 2 + kPrimTH - 1) / kPrimTH);
  fpnprim_kernel<T><<<grid, kThreads, smem, stream>>>(x, w, b, o1, o2, c, H, W);
  return cudaGetLastError();
}

}  // namespace

// Each entry point returns a cudaError_t: cudaErrorInvalidValue for sizes
// the kernel does not take (non-positive sizes, odd H or W for fpnprim, a
// tile that needs more shared memory than a block has).

extern "C" int plane_conv1(const void* x, const void* w, const void* b, void* out, int c_in,
                           int c_out, int H, int W, int is_bf16, void* stream) {
  if (c_in < 1 || c_out < 1 || H < 1 || W < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  const float* bf = static_cast<const float*>(b);
  if (is_bf16) {
    using T = __nv_bfloat16;
    return launch_conv1<T>(static_cast<const T*>(x), wf, bf, static_cast<T*>(out), c_in, c_out, H,
                           W, s);
  }
  return launch_conv1<float>(static_cast<const float*>(x), wf, bf, static_cast<float*>(out), c_in,
                             c_out, H, W, s);
}

extern "C" int plane_convchain(const void* x, const void* w, const void* b, void* out, int c,
                               int H, int W, int n, int is_bf16, void* stream) {
  if (c < 1 || H < 1 || W < 1 || n < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  const float* bf = static_cast<const float*>(b);
  if (is_bf16) {
    using T = __nv_bfloat16;
    return launch_convchain<T>(static_cast<const T*>(x), wf, bf, static_cast<T*>(out), c, H, W, n,
                               s);
  }
  return launch_convchain<float>(static_cast<const float*>(x), wf, bf, static_cast<float*>(out), c,
                                 H, W, n, s);
}

extern "C" int plane_fpnprim(const void* x, const void* w, const void* b, void* o1, void* o2,
                             int c, int H, int W, int is_bf16, void* stream) {
  if (c < 1 || H < 2 || W < 2 || H % 2 || W % 2) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  const float* bf = static_cast<const float*>(b);
  if (is_bf16) {
    using T = __nv_bfloat16;
    return launch_fpnprim<T>(static_cast<const T*>(x), wf, bf, static_cast<T*>(o1),
                             static_cast<T*>(o2), c, H, W, s);
  }
  return launch_fpnprim<float>(static_cast<const float*>(x), wf, bf, static_cast<float*>(o1),
                               static_cast<float*>(o2), c, H, W, s);
}

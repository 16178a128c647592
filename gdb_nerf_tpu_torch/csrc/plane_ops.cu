// Plane primitives for NVIDIA Hopper (sm_90a): slices, resampling, a
// batched product with one shared matrix, a grouped 3x3 conv, a row mask and
// a pad.
//
// Replaces the nine Pallas kernels of tools/probe_mosaic_ops.py, one Mosaic
// primitive each, with six entry points (planes are float32 (C, H, W),
// row-major):
//   plane_strided_slice  <- probe_sublane_stride2 (sh = 2, sw = 1) and
//                           probe_lane_stride2 (sh = 1, sw = 2):
//                           out = x[:, ::sh, ::sw]
//   plane_select_matmul  <- probe_lane_downsample_matmul (x[c] @ S),
//                           probe_sublane_downsample_matmul (S @ x[c]) and
//                           probe_upsample_matmul (Sh @ (x[c] @ Sw), two
//                           launches): out[c] = A[c] @ B[c], either operand
//                           shared by every c; a general product, the 0/1
//                           structure of a selection matrix is not read
//   plane_repeat_upsample <- probe_repeat_upsample: nearest 2x along H and W
//   plane_grouped_conv3  <- probe_grouped_conv3: the valid 3x3 conv of
//                           x (C, H+2, W+2) with w (C, 9, C, 1):
//                           out[co,h,w] = sum_t sum_ci x[ci,h+ky,w+kx] w[co,t,ci]
//   plane_row_mask       <- probe_dyn_row_mask: o1 = x with rows >= limit
//                           zeroed; o2 (C, H/2, W/2), whose row block i of
//                           H/4 rows is x's rows [i H/2, i H/2 + H/4), columns
//                           [0, W/2)
//   plane_pad            <- probe_pad_value: a zero ring of one pixel
//
// Bound: at the FPN's plane size (C8, 512x640) the copies move 10-21 MB and
// do no arithmetic, so they are bound by device memory: one thread per
// element (per two for the upsample's stores), consecutive threads on
// consecutive addresses, 64-bit offsets.  The products do up to 10.7 GFLOP
// a launch and are bound by float32 FMA issue: 64x64 output tiles, a K-step
// of 16 staged in shared memory (A transposed), 4x4 sums a thread in
// registers, read from shared memory as 16-byte vectors; each sum runs over
// k in order with fmaf, so a 0/1 matrix gives the selected value exactly.
// Tensor cores (TF32) would change the result and are not used.  The conv is
// K2's scheme (plane_conv.cu): an output tile of 8x32 with its halo in
// shared memory, weights staged in groups of 8 output channels, 8 sums a
// thread; per tap the input channels are summed first, then the taps in
// order, as the Pallas body sums.
//
// Interface: plain C, loaded with ctypes; launches on the caller's stream,
// allocates nothing and returns the cudaError_t of the launch
// (cudaErrorInvalidValue for sizes it does not take).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 1 << 20;   // grid-stride loops cover the rest
constexpr int kMaxSmem = 232448;      // bytes a block may use on sm_90
// Product tiles: a block computes kTileM x kTileN outputs of one batch
// entry, each of its 256 threads a 4x4 patch.
constexpr int kTileM = 64, kTileN = 64, kTileK = 16, kMicro = 4;
// Conv tiles, as plane_conv.cu's conv1.
constexpr int kConvTH = 8, kConvTW = 32, kGroup = 8;

int blocks_for(long long n) {
  const long long b = (n + kThreads - 1) / kThreads;
  return static_cast<int>(b < kMaxBlocks ? b : kMaxBlocks);
}

__global__ void __launch_bounds__(kThreads)
strided_slice_kernel(const float* __restrict__ x, float* __restrict__ out, int H, int W, int Ho,
                     int Wo, int sh, int sw, long long n) {
  for (long long i = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x; i < n;
       i += static_cast<long long>(gridDim.x) * kThreads) {
    const int j = static_cast<int>(i % Wo);
    const long long cr = i / Wo;  // c * Ho + r
    const long long c = cr / Ho;
    const int r = static_cast<int>(cr - c * Ho);
    out[i] = __ldg(x + (c * H + static_cast<long long>(r) * sh) * W + static_cast<long long>(j) * sw);
  }
}

// out[b] (M, N) = A[b] (M, K) @ B[b] (K, N), all row-major; an operand with
// batch stride 0 is shared by every b (blockIdx.z).
__global__ void __launch_bounds__(kThreads)
select_matmul_kernel(const float* __restrict__ A, const float* __restrict__ B,
                     float* __restrict__ out, int M, int K, int N, long long a_stride,
                     long long b_stride) {
  // A's tile, transposed; 4 floats of padding a row spread the transposing
  // stores over the banks and keep each row 16-byte aligned.
  __shared__ __align__(16) float sa[kTileK][kTileM + 4];
  __shared__ __align__(16) float sb[kTileK][kTileN];
  const int b = blockIdx.z;
  const float* a = A + b * a_stride;
  const float* bm = B + b * b_stride;
  const int m0 = blockIdx.y * kTileM, n0 = blockIdx.x * kTileN;
  const int t = threadIdx.x;
  const int tm = (t / (kTileN / kMicro)) * kMicro, tn = (t % (kTileN / kMicro)) * kMicro;
  float acc[kMicro][kMicro] = {};
  for (int k0 = 0; k0 < K; k0 += kTileK) {
#pragma unroll
    for (int q = 0; q < kTileM * kTileK / kThreads; ++q) {
      const int e = t + q * kThreads;
      const int r = e / kTileK, k = e % kTileK;  // neighbouring threads: neighbouring k
      const int gm = m0 + r, gk = k0 + k;
      sa[k][r] = (gm < M && gk < K) ? __ldg(a + static_cast<long long>(gm) * K + gk) : 0.f;
    }
#pragma unroll
    for (int q = 0; q < kTileK * kTileN / kThreads; ++q) {
      const int e = t + q * kThreads;
      const int k = e / kTileN, c = e % kTileN;
      const int gk = k0 + k, gn = n0 + c;
      sb[k][c] = (gk < K && gn < N) ? __ldg(bm + static_cast<long long>(gk) * N + gn) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kTileK; ++k) {
      const float4 av = *reinterpret_cast<const float4*>(&sa[k][tm]);
      const float4 bv = *reinterpret_cast<const float4*>(&sb[k][tn]);
      const float ar[kMicro] = {av.x, av.y, av.z, av.w};
      const float br[kMicro] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < kMicro; ++i)
#pragma unroll
        for (int j = 0; j < kMicro; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* o = out + static_cast<long long>(b) * M * N;
#pragma unroll
  for (int i = 0; i < kMicro; ++i) {
    const int gm = m0 + tm + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < kMicro; ++j) {
      const int gn = n0 + tn + j;
      if (gn < N) o[static_cast<long long>(gm) * N + gn] = acc[i][j];
    }
  }
}

// One thread per input element: its value goes to a 2x2 block of out,
// written as two 8-byte stores (rows of 2W floats keep them aligned).
__global__ void __launch_bounds__(kThreads)
repeat_upsample_kernel(const float* __restrict__ x, float* __restrict__ out, int H, int W,
                       long long n) {
  for (long long i = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x; i < n;
       i += static_cast<long long>(gridDim.x) * kThreads) {
    const int j = static_cast<int>(i % W);
    const long long cr = i / W;  // c * H + r
    const float v = __ldg(x + i);
    const float2 vv = make_float2(v, v);
    float2* row = reinterpret_cast<float2*>(out + 2 * cr * (2LL * W)) + j;
    row[0] = vv;
    row[W] = vv;  // the next output row: 2W floats on
  }
}

// Stages w (C, 9, C) as [group][tap][ci][kGroup], zero for the padding
// channels of the last group.
__device__ void load_conv3_weights(float* dst, const float* __restrict__ w, int c) {
  const int groups = (c + kGroup - 1) / kGroup;
  const int n = groups * 9 * c * kGroup;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int j = i % kGroup, rest = i / kGroup;
    const int ci = rest % c, tap = (rest / c) % 9, g = rest / (9 * c);
    const int co = g * kGroup + j;
    dst[i] = co < c ? w[(co * 9 + tap) * c + ci] : 0.f;
  }
}

__global__ void __launch_bounds__(kThreads)
grouped_conv3_kernel(const float* __restrict__ x, const float* __restrict__ w,
                     float* __restrict__ out, int c, int H, int W) {
  extern __shared__ float smem[];
  constexpr int tr = kConvTH + 2, tc = kConvTW + 2;
  float* sx = smem;
  float* sw = sx + c * tr * tc;
  const int oy = blockIdx.y * kConvTH, ox = blockIdx.x * kConvTW;
  const int Hp = H + 2, Wp = W + 2;
  for (int i = threadIdx.x; i < c * tr * tc; i += blockDim.x) {
    const int ch = i / (tr * tc), rem = i - ch * tr * tc;
    const int r = oy + rem / tc, q = ox + rem % tc;
    sx[i] = (r < Hp && q < Wp) ? __ldg(x + (static_cast<long long>(ch) * Hp + r) * Wp + q) : 0.f;
  }
  load_conv3_weights(sw, w, c);
  __syncthreads();
  const int ty = threadIdx.x / kConvTW, tx = threadIdx.x % kConvTW;
  const int y = oy + ty, xx = ox + tx;
  if (y >= H || xx >= W) return;
  for (int g = 0; g * kGroup < c; ++g) {
    const float* gw = sw + g * 9 * c * kGroup;
    float acc[kGroup] = {};
#pragma unroll
    for (int ky = 0; ky < 3; ++ky)
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
        const float* wt = gw + (ky * 3 + kx) * c * kGroup;
        float s[kGroup] = {};
        for (int ci = 0; ci < c; ++ci) {
          const float v = sx[(ci * tr + ty + ky) * tc + tx + kx];
#pragma unroll
          for (int q = 0; q < kGroup; ++q) s[q] = fmaf(v, wt[ci * kGroup + q], s[q]);
        }
#pragma unroll
        for (int q = 0; q < kGroup; ++q) acc[q] += s[q];
      }
#pragma unroll
    for (int q = 0; q < kGroup; ++q) {
      const int co = g * kGroup + q;
      if (co < c) out[(static_cast<long long>(co) * H + y) * W + xx] = acc[q];
    }
  }
}

// One pass over x (C, H, W): o1 everywhere, o2 from the elements that its
// two row blocks take.
__global__ void __launch_bounds__(kThreads)
row_mask_kernel(const float* __restrict__ x, float* __restrict__ o1, float* __restrict__ o2,
                int H, int W, int limit, long long n) {
  const int half = H / 2, quarter = H / 4, Wo = W / 2;
  for (long long i = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x; i < n;
       i += static_cast<long long>(gridDim.x) * kThreads) {
    const int j = static_cast<int>(i % W);
    const long long cr = i / W;
    const long long c = cr / H;
    const int r = static_cast<int>(cr - c * H);
    const float v = __ldg(x + i);
    o1[i] = r < limit ? v : 0.f;
    const int blk = r / half, rr = r - blk * half;
    if (rr < quarter && j < Wo)
      o2[(c * half + blk * quarter + rr) * Wo + j] = v;
  }
}

__global__ void __launch_bounds__(kThreads)
pad_kernel(const float* __restrict__ x, float* __restrict__ out, int H, int W, long long n) {
  const int Hp = H + 2, Wp = W + 2;
  for (long long i = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x; i < n;
       i += static_cast<long long>(gridDim.x) * kThreads) {
    const int q = static_cast<int>(i % Wp);
    const long long cr = i / Wp;
    const long long c = cr / Hp;
    const int r = static_cast<int>(cr - c * Hp);
    out[i] = (r >= 1 && r <= H && q >= 1 && q <= W)
                 ? __ldg(x + (c * H + r - 1) * W + q - 1)
                 : 0.f;
  }
}

}  // namespace

extern "C" int plane_strided_slice(const void* x, void* out, int C, int H, int W, int sh, int sw,
                                   void* stream) {
  if (C < 1 || H < 1 || W < 1 || sh < 1 || sw < 1) return cudaErrorInvalidValue;
  const int Ho = (H + sh - 1) / sh, Wo = (W + sw - 1) / sw;
  const long long n = static_cast<long long>(C) * Ho * Wo;
  strided_slice_kernel<<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), H, W, Ho, Wo, sh, sw, n);
  return cudaGetLastError();
}

// a_batched / b_batched: 1 if that operand holds one matrix per batch entry,
// 0 if its one matrix is shared.
extern "C" int plane_select_matmul(const void* a, const void* b, void* out, int batch, int M,
                                   int K, int N, int a_batched, int b_batched, void* stream) {
  if (batch < 1 || M < 1 || K < 1 || N < 1 || batch > 65535) return cudaErrorInvalidValue;
  const dim3 grid((N + kTileN - 1) / kTileN, (M + kTileM - 1) / kTileM, batch);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  select_matmul_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b), static_cast<float*>(out), M, K,
      N, a_batched ? static_cast<long long>(M) * K : 0, b_batched ? static_cast<long long>(K) * N : 0);
  return cudaGetLastError();
}

extern "C" int plane_repeat_upsample(const void* x, void* out, int C, int H, int W, void* stream) {
  if (C < 1 || H < 1 || W < 1) return cudaErrorInvalidValue;
  const long long n = static_cast<long long>(C) * H * W;
  repeat_upsample_kernel<<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), H, W, n);
  return cudaGetLastError();
}

// H, W: the output's size; x is (C, H+2, W+2).
extern "C" int plane_grouped_conv3(const void* x, const void* w, void* out, int C, int H, int W,
                                   void* stream) {
  if (C < 1 || H < 1 || W < 1) return cudaErrorInvalidValue;
  const size_t groups = (C + kGroup - 1) / kGroup;
  const size_t smem =
      (static_cast<size_t>(C) * (kConvTH + 2) * (kConvTW + 2) + groups * kGroup * 9 * C) *
      sizeof(float);
  if (smem > static_cast<size_t>(kMaxSmem)) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      grouped_conv3_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((W + kConvTW - 1) / kConvTW, (H + kConvTH - 1) / kConvTH);
  grouped_conv3_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w), static_cast<float*>(out), C, H,
      W);
  return cudaGetLastError();
}

// H % 4 == 0 and W % 2 == 0: the probe's two row blocks of H/2, each giving
// o2 a block of H/4 rows and W/2 columns.
extern "C" int plane_row_mask(const void* x, void* o1, void* o2, int C, int H, int W, int limit,
                              void* stream) {
  if (C < 1 || H < 4 || W < 2 || H % 4 || W % 2) return cudaErrorInvalidValue;
  const long long n = static_cast<long long>(C) * H * W;
  row_mask_kernel<<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(o1), static_cast<float*>(o2), H, W, limit,
      n);
  return cudaGetLastError();
}

// H, W: x's size; out is (C, H+2, W+2).
extern "C" int plane_pad(const void* x, void* out, int C, int H, int W, void* stream) {
  if (C < 1 || H < 1 || W < 1) return cudaErrorInvalidValue;
  const long long n = static_cast<long long>(C) * (H + 2) * (W + 2);
  pad_kernel<<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), H, W, n);
  return cudaGetLastError();
}

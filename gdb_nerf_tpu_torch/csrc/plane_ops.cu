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
// do no arithmetic, so they are bound by device memory.  The upsample, the
// row mask and the pad run one thread per element (per two for the
// upsample's stores), consecutive threads on consecutive addresses, 64-bit
// offsets.  The strided slice runs a 2-D grid: blockIdx.y and threadIdx.y
// walk output rows, with one 32-bit division a row, and blockIdx.x and
// threadIdx.x walk the row in 16-byte pieces where every row is 16-byte
// aligned (sw = 1, W % 4 == 0: a contiguous copy; sw = 2, W % 8 == 0: two
// loads, the four even values stored as one), in 4-byte elements otherwise.
//
// The products do up to 10.7 GFLOP a launch and are bound by the float32
// FMA rate (67 TFLOP/s on the card; tensor cores, TF32 or 3xTF32, would change
// the bits and are not used): every output is one fmaf chain over k in
// order, so a 0/1 matrix gives the selected value exactly.  No split-K.  A
// block computes one tile of a table of two (64x128 with 8x8 outputs a
// thread, 32x128 with 4x8; the wrapper picks the larger unless the smaller's
// blocks fill the SMs more evenly by more than a fifth, and passes its
// index), each thread's outputs in 4x4 patches, so that per k it reads one
// 16-byte vector of each operand per patch row or column (4 FMAs per float
// read from shared memory at 8x8; a warp's 4x8 threads read 64 and 128
// contiguous bytes: no bank conflict).  K runs in stages of 8 or 32 through
// a ring of two in shared memory: B's next stage is copied with cp.async
// (16-byte pieces where K % 4 == 0 and N % 4 == 0, else 4-byte ones,
// zero-filled past the edges) while this stage computes; A's next stage is
// loaded into registers before this stage's FMAs and stored transposed
// (K-major) after them, so that A's fragments too are 16-byte reads along
// M.  A right product (planes @ one matrix) folds the batch into M: the
// planes are one (batch*M, K) matrix; a left product keeps the batch on
// blockIdx.z.  What bounds it on the card: registers.  At 128 a thread (512
// threads an SM) 64 sums and their fragments leave no room
// for stages of 16, so the 8x8 tile takes stages of 8; the 4x8 tile trades
// FMAs per staged byte for blocks on every SM and takes stages of 32 (fewer
// barriers).  The ring takes 41 KB at most: static shared memory.
//
// The conv is K2's scheme (plane_conv.cu): an output tile of 8x32 with its
// halo in shared memory, weights staged in groups of 8 output channels, 8
// sums a thread; per tap the input channels are summed first, then the taps
// in order, as the Pallas body sums.
//
// Interface: plain C, loaded with ctypes; launches on the caller's stream,
// allocates nothing and returns the cudaError_t of the launch
// (cudaErrorInvalidValue for sizes it does not take).

#include <cuda_runtime.h>

#include <algorithm>
#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 1 << 20;   // grid-stride loops cover the rest
constexpr int kMaxSmem = 232448;      // bytes a block may use on sm_90
// Product tiles by the index the wrapper passes (kernels/plane_ops.py
// MATMUL_TILES holds the same table): a block computes kTile<i>M x kTile<i>N
// outputs, each thread kTile<i>TM x kTile<i>TN of them in 4x4 patches, K in
// stages of kTile<i>K through a ring of kStages.  The 8x8 row takes stages
// of 8: with 16, 64 sums and a stage's fragments spill past 128 registers.
constexpr int kTile0M = 64, kTile0N = 128, kTile0TM = 8, kTile0TN = 8, kTile0K = 8;
constexpr int kTile1M = 32, kTile1N = 128, kTile1TM = 4, kTile1TN = 8, kTile1K = 32;
constexpr int kMatmulTiles = 2;
constexpr int kStages = 2;
// Threads an SM holds under each tile's launch bounds: 128 registers a
// thread on the 16-byte path; twice the registers on the 4-byte path
// (ragged sizes only), whose per-element addresses would spill at 128.
constexpr int kMatmulThreadsPerSM = 512;
// Strided-slice paths (a launch takes one for all of its rows) and the row
// pieces a thread takes before more blocks go along a row.
constexpr int kSliceScalar = 0, kSliceRows = 1, kSlicePairs = 2;
constexpr int kSliceUnits = 4;
// Conv tiles, as plane_conv.cu's conv1.
constexpr int kConvTH = 8, kConvTW = 32, kGroup = 8;

int blocks_for(long long n) {
  const long long b = (n + kThreads - 1) / kThreads;
  return static_cast<int>(b < kMaxBlocks ? b : kMaxBlocks);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// out = x[:, ::sh, ::sw] as rows (c, r) of Wo values; `units` pieces a row:
// Wo / 4 vectors on the vector paths, Wo values on the scalar one.  32-bit
// offsets: the entry point takes C * H * W < 2^31.
template <int kPath>
__global__ void __launch_bounds__(kThreads)
strided_slice_kernel(const float* __restrict__ x, float* __restrict__ out, int H, int W, int Ho,
                     int Wo, int sh, int sw, int rows, int units) {
  for (int row = blockIdx.y * blockDim.y + threadIdx.y; row < rows;
       row += gridDim.y * blockDim.y) {
    const int c = row / Ho;  // one division a row
    const float* in = x + (c * H + (row - c * Ho) * sh) * W;
    float* o = out + row * Wo;
    for (int u = blockIdx.x * blockDim.x + threadIdx.x; u < units; u += gridDim.x * blockDim.x) {
      if (kPath == kSliceRows) {
        reinterpret_cast<float4*>(o)[u] = __ldg(reinterpret_cast<const float4*>(in) + u);
      } else if (kPath == kSlicePairs) {
        const float4 p = __ldg(reinterpret_cast<const float4*>(in) + 2 * u);
        const float4 q = __ldg(reinterpret_cast<const float4*>(in) + 2 * u + 1);
        reinterpret_cast<float4*>(o)[u] = make_float4(p.x, p.z, q.x, q.z);
      } else {
        o[u] = __ldg(in + u * sw);
      }
    }
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// An asynchronous copy of 16 (4) bytes from global src to shared dst; when
// `ok` is false nothing is read and dst is zero-filled.
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(smem_u32(dst)), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(smem_u32(dst)), "l"(src),
               "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Waits until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

template <int BM, int BN, int TM, int TN, int BK>
struct MatmulTile {
  static constexpr int kThreads = (BM / TM) * (BN / TN);
  static constexpr int kWarpsN = BN / TN / 8;  // a warp: 4 x 8 threads along M x N
  static constexpr int kLdA = BM + 4;          // a row of A's transposed stage
  static constexpr int kAPieces = BM * BK / 4 / kThreads;  // 16-byte pieces a thread
  static constexpr int kBPieces = BK * BN / 4 / kThreads;
  static_assert(TM % 4 == 0 && TN % 4 == 0 && kThreads % 32 == 0 && BN % (8 * TN) == 0 &&
                    BM % (4 * TM) == 0,
                "4x4 patches, whole warps of 4 x 8 threads");
  static_assert((BK == 8 || BK == 16 || BK == 32) && BM % 16 == 0 && kAPieces * kThreads * 4 == BM * BK &&
                    kBPieces * kThreads * 4 == BK * BN,
                "a stage's pieces split evenly over the threads, 16 rows x 2 k-quads a warp");
};

// out[b] (M, N) = A[b] (M, K) @ B[b] (K, N), all row-major; an operand with
// batch stride 0 is shared by every b (blockIdx.z).  Block (x, y) computes
// rows [x BM, x BM + BM) and columns [y BN, y BN + BN).  kVec: K % 4 == 0,
// N % 4 == 0 and A, B and out 16-byte aligned, so that A's and B's pieces
// are 16-byte vectors; otherwise 4-byte elements.  Offsets into A[b] and
// B[b] are 32-bit (the entry point takes M K and K N < 2^31).
template <int BM, int BN, int TM, int TN, int BK, bool kVec>
__global__ void __launch_bounds__(MatmulTile<BM, BN, TM, TN, BK>::kThreads,
                                  kMatmulThreadsPerSM / (kVec ? 1 : 2) /
                                      MatmulTile<BM, BN, TM, TN, BK>::kThreads)
select_matmul_kernel(const float* __restrict__ A, const float* __restrict__ B,
                     float* __restrict__ out, int M, int K, int N, long long a_stride,
                     long long b_stride) {
  using T = MatmulTile<BM, BN, TM, TN, BK>;
  constexpr int PM = BM / (TM / 4), PN = BN / (TN / 4);  // patch p starts at row p PM
  // A's stages transposed (K-major); 4 floats of padding a row put the two
  // k-quads of a warp's transposing stores on other banks and keep each row
  // 16-byte aligned.
  __shared__ __align__(16) float sa[kStages][BK][T::kLdA];
  __shared__ __align__(16) float sb[kStages][BK][BN];
  const float* a = A + blockIdx.z * a_stride;
  const float* b = B + blockIdx.z * b_stride;
  float* o = out + blockIdx.z * static_cast<long long>(M) * N;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  // The thread's outputs: rows p PM + ty*4 + i, columns q PN + tx*4 + j
  // (p < TM/4, q < TN/4, i, j < 4).
  const int ty = (warp / T::kWarpsN) * 4 + lane / 8;
  const int tx = (warp % T::kWarpsN) * 8 + lane % 8;

  // A's piece q of a stage: row a_row(q), k-quad a_quad(q).  A warp takes 16
  // rows x 2 quads: its loads read 32 contiguous bytes of each row, and its
  // transposing stores hit 32 distinct banks.
  auto a_row = [&](int q) {
    const int e = t + q * T::kThreads;
    return e % 16 + 16 * ((e / 32) % (BM / 16));
  };
  auto a_quad = [&](int q) {
    const int e = t + q * T::kThreads;
    return (e % 32) / 16 + 2 * ((e / 32) / (BM / 16));
  };
  float4 ra[T::kAPieces];  // A's next stage, held until it is stored transposed
  auto load_a = [&](int k0) {
#pragma unroll
    for (int q = 0; q < T::kAPieces; ++q) {
      const int m = m0 + a_row(q), k = k0 + 4 * a_quad(q);
      const bool row = m < M;
      const float* p = a + (row ? m * K + k : 0);
      if (kVec) {
        ra[q] = row && k < K ? __ldg(reinterpret_cast<const float4*>(p))
                             : make_float4(0.f, 0.f, 0.f, 0.f);
      } else {
        ra[q].x = row && k < K ? __ldg(p) : 0.f;
        ra[q].y = row && k + 1 < K ? __ldg(p + 1) : 0.f;
        ra[q].z = row && k + 2 < K ? __ldg(p + 2) : 0.f;
        ra[q].w = row && k + 3 < K ? __ldg(p + 3) : 0.f;
      }
    }
  };
  auto store_a = [&](int s) {
#pragma unroll
    for (int q = 0; q < T::kAPieces; ++q) {
      const int m = a_row(q), k = 4 * a_quad(q);
      sa[s][k][m] = ra[q].x;
      sa[s][k + 1][m] = ra[q].y;
      sa[s][k + 2][m] = ra[q].z;
      sa[s][k + 3][m] = ra[q].w;
    }
  };
  // B's pieces: 16-byte vectors along a row, or 4-byte elements.
  constexpr int kWidth = kVec ? 4 : 1;
  auto load_b = [&](int s, int k0) {
#pragma unroll
    for (int q = 0; q < T::kBPieces * (4 / kWidth); ++q) {
      const int e = t + q * T::kThreads;
      const int k = e / (BN / kWidth), c = kWidth * (e % (BN / kWidth));
      const bool ok = k0 + k < K && n0 + c < N;
      const float* src = ok ? b + ((k0 + k) * N + n0 + c) : b;
      if (kVec)
        cp_async16(&sb[s][k][c], src, ok);
      else
        cp_async4(&sb[s][k][c], src, ok);
    }
  };

  float acc[TM][TN] = {};
  const int stages = (K + BK - 1) / BK;
  // B's first kStages - 1 stages in flight, one copy group a stage (empty
  // past K, so that the count of groups stays the stage's).
#pragma unroll
  for (int f = 0; f < kStages - 1; ++f) {
    if (f < stages) load_b(f, f * BK);
    cp_async_commit();
  }
  load_a(0);
  store_a(0);
  for (int step = 0; step < stages; ++step) {
    const int s = step % kStages;
    cp_async_wait<kStages - 2>();  // this stage's copies have landed
    __syncthreads();  // ... for every thread; the slot refilled below was read last step
    const int fill = step + kStages - 1;
    if (fill < stages) load_b(fill % kStages, fill * BK);
    cp_async_commit();
    const bool next = step + 1 < stages;
    if (next) load_a((step + 1) * BK);
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float ar[TM], br[TN];
#pragma unroll
      for (int p = 0; p < TM / 4; ++p) {
        const float4 v = *reinterpret_cast<const float4*>(&sa[s][k][p * PM + ty * 4]);
        ar[4 * p] = v.x, ar[4 * p + 1] = v.y, ar[4 * p + 2] = v.z, ar[4 * p + 3] = v.w;
      }
#pragma unroll
      for (int q = 0; q < TN / 4; ++q) {
        const float4 v = *reinterpret_cast<const float4*>(&sb[s][k][q * PN + tx * 4]);
        br[4 * q] = v.x, br[4 * q + 1] = v.y, br[4 * q + 2] = v.z, br[4 * q + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
    if (next) store_a((step + 1) % kStages);
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + (i / 4) * PM + ty * 4 + i % 4;
    if (m >= M) continue;
    float* row = o + static_cast<long long>(m) * N;
#pragma unroll
    for (int h = 0; h < TN / 4; ++h) {
      const int n = n0 + h * PN + tx * 4;
      if (kVec) {
        if (n < N)
          *reinterpret_cast<float4*>(row + n) =
              make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (n + j < N) row[n + j] = acc[i][4 * h + j];
      }
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

// x (C, H, W) with C * H * W < 2^31.  Rows of threads (blockDim.y of them)
// walk output rows, the threads of a row its pieces: as many threads as a
// row has pieces, rounded up to whole warps, up to kThreads.
extern "C" int plane_strided_slice(const void* x, void* out, int C, int H, int W, int sh, int sw,
                                   void* stream) {
  if (C < 1 || H < 1 || W < 1 || sh < 1 || sw < 1 ||
      static_cast<long long>(C) * H * W > INT_MAX)
    return cudaErrorInvalidValue;
  const int Ho = (H + sh - 1) / sh, Wo = (W + sw - 1) / sw, rows = C * Ho;
  const bool aligned = aligned16(x) && aligned16(out);
  const int path = !aligned                   ? kSliceScalar
                   : sw == 1 && W % 4 == 0 ? kSliceRows
                   : sw == 2 && W % 8 == 0 ? kSlicePairs
                                           : kSliceScalar;
  const int units = path == kSliceScalar ? Wo : Wo / 4;
  const int bx = std::min(kThreads, (units + 31) / 32 * 32), by = kThreads / bx;
  const dim3 block(bx, by);
  const dim3 grid((units + bx * kSliceUnits - 1) / (bx * kSliceUnits),
                  std::min((rows + by - 1) / by, 65535));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  float* of = static_cast<float*>(out);
  if (path == kSliceRows)
    strided_slice_kernel<kSliceRows><<<grid, block, 0, s>>>(xf, of, H, W, Ho, Wo, sh, sw, rows, units);
  else if (path == kSlicePairs)
    strided_slice_kernel<kSlicePairs><<<grid, block, 0, s>>>(xf, of, H, W, Ho, Wo, sh, sw, rows, units);
  else
    strided_slice_kernel<kSliceScalar><<<grid, block, 0, s>>>(xf, of, H, W, Ho, Wo, sh, sw, rows, units);
  return cudaGetLastError();
}

template <int BM, int BN, int TM, int TN, int BK>
int launch_select_matmul(const float* a, const float* b, float* out, int batch, int M, int K,
                         int N, long long a_stride, long long b_stride, bool vec,
                         cudaStream_t stream) {
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN, batch);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  constexpr int threads = MatmulTile<BM, BN, TM, TN, BK>::kThreads;
  if (vec)
    select_matmul_kernel<BM, BN, TM, TN, BK, true><<<grid, threads, 0, stream>>>(
        a, b, out, M, K, N, a_stride, b_stride);
  else
    select_matmul_kernel<BM, BN, TM, TN, BK, false><<<grid, threads, 0, stream>>>(
        a, b, out, M, K, N, a_stride, b_stride);
  return cudaGetLastError();
}

// a_batched / b_batched: 1 if that operand holds one matrix per batch entry,
// 0 if its one matrix is shared.  tile: the row of the tile table
// (kTile<tile>M x kTile<tile>N), picked by the wrapper.
extern "C" int plane_select_matmul(const void* a, const void* b, void* out, int batch, int M,
                                   int K, int N, int a_batched, int b_batched, int tile,
                                   void* stream) {
  if (batch < 1 || M < 1 || K < 1 || N < 1 || tile < 0 || tile >= kMatmulTiles)
    return cudaErrorInvalidValue;
  const long long a_stride = a_batched ? static_cast<long long>(M) * K : 0;
  const long long b_stride = b_batched ? static_cast<long long>(K) * N : 0;
  if (a_batched && !b_batched) {  // a right product: the planes are one (batch*M, K) matrix
    if (static_cast<long long>(M) * batch > INT_MAX) return cudaErrorInvalidValue;
    M *= batch;
    batch = 1;
  }
  if (batch > 65535 || static_cast<long long>(M) * K > INT_MAX ||
      static_cast<long long>(K) * N > INT_MAX)
    return cudaErrorInvalidValue;
  const bool vec = K % 4 == 0 && N % 4 == 0 && aligned16(a) && aligned16(b) && aligned16(out);
  const float* af = static_cast<const float*>(a);
  const float* bf = static_cast<const float*>(b);
  float* of = static_cast<float*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tile == 0)
    return launch_select_matmul<kTile0M, kTile0N, kTile0TM, kTile0TN, kTile0K>(
        af, bf, of, batch, M, K, N, a_stride, b_stride, vec, s);
  return launch_select_matmul<kTile1M, kTile1N, kTile1TM, kTile1TN, kTile1K>(
      af, bf, of, batch, M, K, N, a_stride, b_stride, vec, s);
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

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
// n = 4 is the exception, bound by float32 FMA issue).  conv1 and fpnprim:
// one block per output tile; the tile's input, with its halo, is loaded once
// into shared memory as float32, so device memory is read about once (the
// halo's re-reads hit L2); the weights are staged per block in shared memory
// in groups of 8 output channels ([group][ci][tap][8]), so every thread of a
// warp reads the same 8 weights (a broadcast) while it keeps 8 float32 sums
// in registers.
//
// convchain keeps its intermediates on chip: a frame of (th + 2n) x (tw + 2n)
// pixels is loaded per output tile and each layer's output region shrinks by
// one pixel per side (a halo of n pixels recomputed per tile), ping-ponging
// between two shared-memory buffers.  Positions of an intermediate outside
// the image are forced to 0 after each layer, as the Pallas kernel's zero
// ring is.  The last layer writes its region into shared memory too, and a
// final pass stores the tile as planar (c, H, W) rows, neighbouring threads
// on neighbouring pixels.  Each layer's weights are staged while the layer
// before it runs, into the buffer that the layer before that read.  The tile
// (th, tw, threads) is the row of the dtype's table (kBf16Tiles, kF32Tiles)
// that fits a block's shared memory and has the least ceil(blocks / SMs) x
// pixel-layers a block (pick_tile).  Each table has two rows: the first
// covers the bench plane (512x640, n = 4) in one wave (float32 40 x 64: 130
// blocks on 132 SMs; bf16 32 x 40: 256 blocks, 2 an SM), the second, 16 x
// 32, takes small planes (the microbench check's 32x256) and sets the line
// of the shapes the chain takes: it fits every float32 shape the chain took
// before these tables, and the wrapper refuses what it does not fit.  Two
// kernels behind one entry point:
//   convchain_bf16_kernel  an implicit GEMM on the tensor cores
//       (mma.sync m16n8k16, bf16 operands, float32 sums).  Frames are bf16
//       and channel-last: a pixel is one 16-byte row of 8 channels (zeros
//       past c), one frame plane per group of 8 channels.  M is 16 pixels of
//       the layer's region taken in row-major order, N is 8 output channels
//       (one n8 tile per group), K runs over (tap pair, 8 channels): steps
//       0-3 take taps (2s, 2s+1) on m16n8k16, step 4 takes tap 8 on
//       m16n8k8 (the tenth tap would be zero).  A fragment comes from one
//       ldmatrix: lane l gives the row address of pixel l % 16 at tap
//       2s + l / 16.  The weights arrive as float32 and may not be bf16
//       values, so each layer is staged as B fragments of hi = bf16(w) and
//       lo = bf16(w - hi) and every step runs a second MMA on lo; a
//       block-uniform flag set while staging skips the lo MMAs when every lo
//       of the layer is 0 (weights that are bf16 values), which is exact.  A
//       warp loads all five A fragments of its M tile, then runs the MMAs in
//       two accumulator chains (step s's hi MMA in chain s & 1, its lo MMA in
//       the other), summed before the bias: the latency of one M tile's
//       chain, not the tensor cores, bounds a warp.  The epilogue
//       takes the accumulator fragment (pixels g and g + 8, channels 2t and
//       2t + 1), adds the bias and applies the ReLU in float32, zeroes
//       positions outside the image, rounds to bf16 once and stores the pair
//       into the other frame: the plain version's rounding points.  The
//       input planes' rows (2(W + 2) bytes) need not be 16-byte aligned, so
//       the frame is loaded with 2-byte reads, a pixel's 8 channels to a
//       thread, and transposed to channel-last on the way in.  c <= 16.
//   convchain_f32_kernel   float32 FMAs only (no TF32).  Frames are planar
//       float32 with an odd row pitch, copied in by 4-byte cp.async (zero
//       fill outside x); a thread holds a register tile of kF32Px pixels
//       along a row x 8 output channels, slides the 3-wide window along its
//       row (kF32Px + 2 loads per (ci, ky)) and reads each tap's 8 weights
//       as two float4 broadcasts: 9.2 FMAs per shared-memory load, not 1.
//       Neighbouring threads take neighbouring rows, which the odd pitch
//       spreads over the banks.  Sums run in (ci, ky, kx) order, as the
//       plain version's.  The layers are bound by FMA issue; the load and
//       store passes do not overlap them.
//
// Interface: plain C, loaded with ctypes; launches on the caller's stream
// and returns the cudaError_t of the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kGroup = 8;             // output channels summed per pass
constexpr int kMaxSmem = 232448;      // bytes a block may use on sm_90
// Output tiles (rows x cols): conv1 and fpnprim give each thread one output
// pixel.
constexpr int kConvTH = 8, kConvTW = 32;
constexpr int kPrimTH = 8, kPrimTW = 32;  // in o1 pixels

// convchain's output tiles and threads a block; each launch takes the row
// of its dtype's table that fits a block's shared memory and is estimated
// fastest (pick_tile).  The last row is the smallest.
struct Tile {
  int th, tw, threads;
};
constexpr Tile kBf16Tiles[] = {{32, 40, 256}, {16, 32, 256}};
constexpr Tile kF32Tiles[] = {{40, 64, 640}, {16, 32, 256}};
constexpr int kChainThreads = 256;  // bf16: threads a block
constexpr int kF32MaxThreads = 640;
constexpr int kSteps = 5;      // bf16: K steps of a layer, taps (0,1) (2,3) (4,5) (6,7), then 8
constexpr int kMaxGroups = 2;  // bf16: channel groups of 8 a frame may hold (c <= 16)
constexpr int kF32Px = 5;      // f32: pixels along a row in a thread's register tile
constexpr int kLoadBatch = 4;  // bf16: pixels whose loads a thread keeps in flight

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

// ---- convchain ----

// (plane, row, col) of index i = (plane * rows + row) * cols + col of a
// [planes][rows][cols] grid, walked from `start` by a fixed `step` with no
// division per step.
struct GridWalk {
  int plane, row, col, drow, dcol, rows, cols;
  __device__ GridWalk(int start, int step, int rows_, int cols_) : rows(rows_), cols(cols_) {
    const int r = start / cols;
    col = start - r * cols;
    plane = r / rows;
    row = r - plane * rows;
    drow = step / cols;
    dcol = step - drow * cols;
  }
  __device__ void next() {
    col += dcol;
    row += drow;
    if (col >= cols) {
      col -= cols;
      ++row;
    }
    while (row >= rows) {
      row -= rows;
      ++plane;
    }
  }
};

// ---- convchain, bf16: an implicit GEMM on mma.sync ----

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8x8 b16 matrices (x4) or two (x2) from shared memory: lane l gives
// the address of row l % 8 of matrix l / 8.
__device__ __forceinline__ void ldsm_x4(uint32_t (&a)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x2(uint32_t (&a)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(a[0]), "=r"(a[1])
               : "r"(addr));
}

// d += a (16x16, row) * b (16x8, col): bf16 operands, float32 accumulation.
__device__ __forceinline__ void mma_k16(float (&d)[4], const uint32_t (&a)[4], uint2 b) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}
// d += a (16x8, row) * b (8x8, col).
__device__ __forceinline__ void mma_k8(float (&d)[4], const uint32_t (&a)[2], uint32_t b) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5}, {%6}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(b));
}

__device__ __forceinline__ void sts32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 h) {
  return *reinterpret_cast<const uint32_t*>(&h);
}

// B fragment entries of one layer ([nt][cg][step][lane]) and how many
// each thread stages.
template <int G>
constexpr int kLayerFrags = G * G * kSteps * 32;
template <int G>
constexpr int kStageIters = (kLayerFrags<G> + kChainThreads - 1) / kChainThreads;

// Bytes of convchain_bf16_kernel's shared memory: two frames of G planes of
// R x C pixels of 16 bytes, then two layers' B fragments (hi and lo) and
// bias.
__host__ __device__ inline size_t chain_bf16_smem(int c, int n, Tile t) {
  const size_t G = groups(c), R = t.th + 2 * n, C = t.tw + 2 * n;
  return 2 * G * R * C * 16 + 2 * (2 * G * G * kSteps * 32 * sizeof(uint2) + G * kGroup * 4);
}

// This thread's share of layer k's weights, read from device memory: entry
// e = threadIdx.x + j * kChainThreads of [nt][cg][step][lane] holds, for
// lane (g, t), w[co][ci][tap] of co = nt * 8 + g at (tap 2s, ci 2t and
// 2t + 1) and (tap 2s + 1, the same ci), ci counted from cg * 8; zero past c
// and for tap 9.  Thread j < 8 G also takes bias[j].
template <int G>
__device__ __forceinline__ void fetch_layer(float (&v)[kStageIters<G>][4], float& bias,
                                            const float* __restrict__ w,
                                            const float* __restrict__ b, int c, int k) {
#pragma unroll
  for (int j = 0; j < kStageIters<G>; ++j) {
    const int e = threadIdx.x + j * kChainThreads;
    const int l = e & 31, s = (e >> 5) % kSteps, rest = (e >> 5) / kSteps;
    const int co = (rest / G) * kGroup + (l >> 2), ci = (rest % G) * kGroup + 2 * (l & 3);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int tap = 2 * s + (q >> 1), cc = ci + (q & 1);
      v[j][q] = (e < kLayerFrags<G> && co < c && cc < c && tap < 9)
                    ? __ldg(w + ((k * c + co) * c + cc) * 9 + tap)
                    : 0.f;
    }
  }
  const int j = threadIdx.x;
  bias = j < c && j < G * kGroup ? __ldg(b + k * c + j) : 0.f;
}

// Stores the fetched layer as B fragments hi = bf16(w) (entries [0, E)) and
// lo = bf16(w - hi) (entries [E, 2E)), and the bias; returns whether any of
// this thread's lo is nonzero.
template <int G>
__device__ __forceinline__ int commit_layer(uint2* frags, float* sb,
                                            const float (&v)[kStageIters<G>][4], float bias) {
  int any_lo = 0;
#pragma unroll
  for (int j = 0; j < kStageIters<G>; ++j) {
    const int e = threadIdx.x + j * kChainThreads;
    if (e >= kLayerFrags<G>) break;
    const __nv_bfloat162 h0 = __floats2bfloat162_rn(v[j][0], v[j][1]);
    const __nv_bfloat162 h1 = __floats2bfloat162_rn(v[j][2], v[j][3]);
    const __nv_bfloat162 l0 =
        __floats2bfloat162_rn(v[j][0] - __low2float(h0), v[j][1] - __high2float(h0));
    const __nv_bfloat162 l1 =
        __floats2bfloat162_rn(v[j][2] - __low2float(h1), v[j][3] - __high2float(h1));
    frags[e] = make_uint2(bits(h0), bits(h1));
    frags[kLayerFrags<G> + e] = make_uint2(bits(l0), bits(l1));
    any_lo |= ((bits(l0) | bits(l1)) & 0x7fff7fffu) != 0;
  }
  if (static_cast<int>(threadIdx.x) < G * kGroup) sb[threadIdx.x] = bias;
  return any_lo;
}

// G channel groups of 8 (c <= 8 G).  Block (bx, by) computes the output tile
// at (by * th, bx * tw).  Shared memory: frame buffers 0 and 1 ([G][R][C]
// pixels of 8 bf16), then per layer parity the B fragments (hi, then lo;
// uint2 (k = 2t, 2t + 1; k = 2t + 8, 2t + 9) of lane (g, t)) and the bias
// [G * 8].  Layer k + 1's weights are fetched into registers before layer k
// runs and staged into the other buffer after it.
template <int G>
__global__ void __launch_bounds__(kChainThreads)
convchain_bf16_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ w,
                      const float* __restrict__ b, __nv_bfloat16* __restrict__ out, int c, int H,
                      int W, int n, int th, int tw) {
  extern __shared__ __align__(128) unsigned char bsm[];
  // Frame row f is image row oy - n + f (x's padded row oy - n + f + 1);
  // likewise for columns.  Layer k writes frame rows [k + 1, R - k - 1).
  const int R = th + 2 * n, C = tw + 2 * n, plane = R * C * 16;
  // Buffers of layer parity k: frame k & 1 (its input), then B fragments
  // and bias k & 1.
  unsigned char* const frames = bsm;
  uint2* const frags = reinterpret_cast<uint2*>(bsm + 2 * G * plane);
  float* const sb = reinterpret_cast<float*>(frags + 4 * kLayerFrags<G>);
  const int oy = blockIdx.y * th, ox = blockIdx.x * tw;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;

  float staged[kStageIters<G>][4], staged_bias;
  fetch_layer<G>(staged, staged_bias, w, b, c, 0);
  // The frame: pixel p of group cg gets x's 8 channels cg * 8 .. + 7 (zero
  // past c and outside x), read as 2-byte values along x's rows,
  // kLoadBatch pixels' loads in flight at once.
  const unsigned short* xs = reinterpret_cast<const unsigned short*>(x);
  const int xplane = (H + 2) * (W + 2), pixels = G * R * C;
  GridWalk at(threadIdx.x, kChainThreads, R, C);  // (group, frame row, frame column)
  for (int i0 = threadIdx.x; i0 < pixels; i0 += kLoadBatch * kChainThreads) {
    uint32_t v[kLoadBatch][kGroup] = {};
#pragma unroll
    for (int u = 0; u < kLoadBatch; ++u, at.next()) {
      const int i = i0 + u * kChainThreads;
      const int r = oy - n + 1 + at.row, q = ox - n + 1 + at.col;
      if (i < pixels && r >= 0 && r < H + 2 && q >= 0 && q < W + 2) {
        const unsigned short* src = xs + (at.plane * kGroup) * xplane + r * (W + 2) + q;
#pragma unroll
        for (int j = 0; j < kGroup; ++j)
          if (at.plane * kGroup + j < c) v[u][j] = __ldg(src + j * xplane);
      }
    }
#pragma unroll
    for (int u = 0; u < kLoadBatch; ++u) {
      const int i = i0 + u * kChainThreads;
      if (i < pixels)
        *reinterpret_cast<uint4*>(frames + i * 16) =
            make_uint4(v[u][0] | (v[u][1] << 16), v[u][2] | (v[u][3] << 16),
                       v[u][4] | (v[u][5] << 16), v[u][6] | (v[u][7] << 16));
    }
  }
  int any_lo = commit_layer<G>(frags, sb, staged, staged_bias);
  // Block-uniform: whether any lo fragment of the layer is nonzero.
  bool has_lo = __syncthreads_or(any_lo);

  // Byte offset of this lane's tap at step s from a pixel's row: taps 2s and
  // 2s + 1 for the x4 loads (lanes 0-15 and 16-31), tap 8 for the x2 load.
  int toff[kSteps];
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    const int tap = s < kSteps - 1 ? 2 * s + (lane >> 4) : 8;
    toff[s] = ((tap / 3 - 1) * C + tap % 3 - 1) * 16;
  }
  for (int k = 0; k < n; ++k) {
    if (k + 1 < n) fetch_layer<G>(staged, staged_bias, w, b, c, k + 1);
    const uint32_t src = smem_u32(frames + (k & 1) * G * plane);
    unsigned char* dst = frames + ((k + 1) & 1) * G * plane;
    const uint2* hi = frags + (k & 1) * 2 * kLayerFrags<G>;
    const uint2* lo = hi + kLayerFrags<G>;
    const bool last = k == n - 1;
    const int rr = R - 2 * (k + 1), rc = C - 2 * (k + 1), np = rr * rc;
    uint2 rhi[kSteps];  // one group: the layer's hi B fragments in registers
    if constexpr (G == 1) {
#pragma unroll
      for (int s = 0; s < kSteps; ++s) rhi[s] = hi[s * 32 + lane];
    }
    float bias[G][2];
#pragma unroll
    for (int nt = 0; nt < G; ++nt) {
      bias[nt][0] = sb[(k & 1) * G * kGroup + nt * kGroup + 2 * t];
      bias[nt][1] = sb[(k & 1) * G * kGroup + nt * kGroup + 2 * t + 1];
    }
    const uint32_t dst_s = smem_u32(dst);
    // Warp w takes M tiles w, w + 8, ...  This lane's ldmatrix pixel, l % 16
    // of the tile, as (region row, region column), advanced by kStride
    // pixels a tile with no division; past the region's end the region's
    // last pixel is read instead.
    constexpr int kStride = kChainThreads / 32 * 16;
    const int row_step = kStride / rc, col_step = kStride - row_step * rc;
    const int last_pix = (R - k - 2) * C + C - k - 2;
    int rrow = (warp * 16 + (lane & 15)) / rc;
    int rcol = warp * 16 + (lane & 15) - rrow * rc;
    for (int m = warp; m * 16 < np; m += kChainThreads / 32) {
      const int fr = k + 1 + rrow, fc = k + 1 + rcol;
      const int y = oy - n + fr, xx = ox - n + fc;
      const int pix = rrow < rr ? fr * C + fc : last_pix;
      const int inside = y >= 0 && y < H && xx >= 0 && xx < W;
      rrow += row_step;
      rcol += col_step;
      if (rcol >= rc) {
        rcol -= rc;
        ++rrow;
      }
      // Every K step's A fragment first (m16n8k16 on the tap pairs, m16n8k8
      // on tap 8), then the MMAs in two chains an n8 tile: step s's hi MMA
      // into chain s & 1, its lo MMA into the other; summed before the bias.
      float acc[G][2][4] = {};
#pragma unroll
      for (int cg = 0; cg < G; ++cg) {
        uint32_t a[kSteps][4];
#pragma unroll
        for (int s = 0; s < kSteps; ++s) {
          const uint32_t addr = src + cg * plane + pix * 16 + toff[s];
          if (s == kSteps - 1)
            ldsm_x2(reinterpret_cast<uint32_t(&)[2]>(a[s]), addr);
          else
            ldsm_x4(a[s], addr);
        }
#pragma unroll
        for (int s = 0; s < kSteps; ++s)
#pragma unroll
          for (int nt = 0; nt < G; ++nt) {
            const int f = ((nt * G + cg) * kSteps + s) * 32 + lane;
            const uint2 bh = G == 1 ? rhi[s] : hi[f];
            float(&c0)[4] = acc[nt][s & 1];
            float(&c1)[4] = acc[nt][(s + 1) & 1];
            if (s == kSteps - 1) {
              const uint32_t(&a8)[2] = reinterpret_cast<const uint32_t(&)[2]>(a[s]);
              mma_k8(c0, a8, bh.x);
              if (has_lo) mma_k8(c1, a8, lo[f].x);
            } else {
              mma_k16(c0, a[s], bh);
              if (has_lo) mma_k16(c1, a[s], lo[f]);
            }
          }
      }
      // Accumulator rows g and g + 8 are the pixels of lanes g and g + 8:
      // the shuffles first, then the stores.
      int qpix[2], qin[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        qpix[h] = __shfl_sync(0xffffffffu, pix, g + 8 * h);
        qin[h] = __shfl_sync(0xffffffffu, inside, g + 8 * h);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const bool store = m * 16 + g + 8 * h < np;
#pragma unroll
        for (int nt = 0; nt < G; ++nt) {
          const float(&c0)[4] = acc[nt][0];
          const float(&c1)[4] = acc[nt][1];
          const float v0 = fmaxf(c0[2 * h] + c1[2 * h] + bias[nt][0], 0.f);
          const float v1 = fmaxf(c0[2 * h + 1] + c1[2 * h + 1] + bias[nt][1], 0.f);
          const uint32_t pair = !last && !qin[h] ? 0u : bits(__floats2bfloat162_rn(v0, v1));
          if (store) sts32(dst_s + nt * plane + qpix[h] * 16 + 4 * t, pair);
        }
      }
    }
    // Layer k + 1's weights go into the buffer that layer k - 1 read.
    const int next = (k + 1) & 1;
    any_lo = k + 1 < n ? commit_layer<G>(frags + next * 2 * kLayerFrags<G>,
                                         sb + next * G * kGroup, staged, staged_bias)
                       : 0;
    has_lo = __syncthreads_or(any_lo);
  }
  // The tile, from the last frame to the planar output: neighbouring threads
  // store neighbouring pixels of one row.
  const unsigned char* fin = frames + (n & 1) * G * plane;
  unsigned short* os = reinterpret_cast<unsigned short*>(out);
  GridWalk o(threadIdx.x, kChainThreads, th, tw);  // (group, tile row, tile column)
  for (int i = threadIdx.x; i < G * th * tw; i += kChainThreads, o.next()) {
    const int y = oy + o.row, xx = ox + o.col;
    if (y >= H || xx >= W) continue;
    const uint4 v = *reinterpret_cast<const uint4*>(fin + o.plane * plane +
                                                    ((n + o.row) * C + n + o.col) * 16);
    const uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      const int ch = o.plane * kGroup + j;
      if (ch < c) os[(ch * H + y) * W + xx] = static_cast<unsigned short>(u[j / 2] >> (16 * (j % 2)));
    }
  }
}

// ---- convchain, float32: register tiles of FMAs ----

// A 4-byte copy from global src to shared dst that does not pass through
// registers; 0 is written where `valid` is false (src is then not read).
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Bytes of convchain_f32_kernel's shared memory: two layers' weights and
// bias, then two frames of c planes of R rows at an odd pitch, each with
// kF32Px floats of slack (a thread's window may run past its region).
__host__ __device__ inline int chain_f32_pitch(int C) { return C | 1; }
__host__ __device__ inline size_t chain_f32_smem(int c, int n, Tile t) {
  const size_t G = groups(c), R = t.th + 2 * n, S = chain_f32_pitch(t.tw + 2 * n);
  return (2 * G * kGroup * (9 * static_cast<size_t>(c) + 1) + 2 * (c * R * S + kF32Px)) *
         sizeof(float);
}

// acc[p][j] += 3x3 conv at pixels q .. q + P - 1 of row r of the float32
// frame src [c][R][S] (each pixel's tap (0, 0) at (r - 1, q - 1)) with the
// staged weights of one group sw [ci][9][kGroup], in (ci, ky, kx) order.
template <int P>
__device__ __forceinline__ void conv3x3_strip(float (&acc)[P][kGroup], const float* src, int c,
                                              int R, int S, int r, int q, const float* sw) {
  for (int ci = 0; ci < c; ++ci) {
    const float* row = src + (ci * R + r - 1) * S + q - 1;
    const float* wc = sw + ci * 9 * kGroup;
#pragma unroll
    for (int ky = 0; ky < 3; ++ky) {
      float in[P + 2];
#pragma unroll
      for (int e = 0; e < P + 2; ++e) in[e] = row[ky * S + e];
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
        const float4 w0 = *reinterpret_cast<const float4*>(wc + (ky * 3 + kx) * kGroup);
        const float4 w1 = *reinterpret_cast<const float4*>(wc + (ky * 3 + kx) * kGroup + 4);
        const float wv[kGroup] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
        for (int p = 0; p < P; ++p)
#pragma unroll
          for (int j = 0; j < kGroup; ++j) acc[p][j] = fmaf(in[p + kx], wv[j], acc[p][j]);
      }
    }
  }
}

// Layer k's weights [group][ci][tap][8] (zero past c) and bias [group * 8]
// into dst by cp.async, as load_weights stages them.
__device__ void stage_f32_layer(float* dst, const float* __restrict__ w,
                                const float* __restrict__ b, int c, int k) {
  const int G = groups(c), layer_w = G * c * 9 * kGroup;
  GridWalk e(threadIdx.x, blockDim.x, c * 9, kGroup);  // (group, ci * 9 + tap, j)
  for (int i = threadIdx.x; i < layer_w; i += blockDim.x, e.next()) {
    const int co = e.plane * kGroup + e.col, ci = e.row / 9, tap = e.row - ci * 9;
    cp_async4(dst + i, w + ((k * c + min(co, c - 1)) * c + ci) * 9 + tap, co < c);
  }
  for (int co = threadIdx.x; co < G * kGroup; co += blockDim.x)
    cp_async4(dst + layer_w + co, b + k * c + min(co, c - 1), co < c);
}

// Block (bx, by) computes the output tile at (by * th, bx * tw) with
// blockDim.x threads.  Shared memory: layer parity k's weights and bias at
// k & 1, then frames 0 and 1 ([c][R][S] floats and the slack).  Layer k +
// 1's weights are copied into the other buffer while layer k runs.
__global__ void __launch_bounds__(kF32MaxThreads)
convchain_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                     const float* __restrict__ b, float* __restrict__ out, int c, int H, int W,
                     int n, int th, int tw) {
  extern __shared__ __align__(128) float fsm[];
  const int R = th + 2 * n, C = tw + 2 * n, S = chain_f32_pitch(C), T = blockDim.x;
  const int G = groups(c), layer_w = G * c * 9 * kGroup, layer = layer_w + G * kGroup;
  float* const frames = fsm + 2 * layer;  // frame k & 1 at frames + (k & 1) * frame
  const int frame = c * R * S + kF32Px;
  const int oy = blockIdx.y * th, ox = blockIdx.x * tw;
  // Layer 0's weights and the frame by 4-byte cp.async copies, all in flight
  // at once (zero-filled outside x, as load_tile does).
  stage_f32_layer(fsm, w, b, c, 0);
  GridWalk at(threadIdx.x, T, R, C);  // (channel, frame row, frame column)
  for (int i = threadIdx.x; i < c * R * C; i += T, at.next()) {
    const int r = oy - n + 1 + at.row, q = ox - n + 1 + at.col;
    const bool in_x = r >= 0 && r < H + 2 && q >= 0 && q < W + 2;
    cp_async4(frames + (at.plane * R + at.row) * S + at.col,
              x + (in_x ? (at.plane * (H + 2) + r) * (W + 2) + q : 0), in_x);
  }
  cp_async_wait_all();
  __syncthreads();
  for (int k = 0; k < n; ++k) {
    if (k + 1 < n) stage_f32_layer(fsm + ((k + 1) & 1) * layer, w, b, c, k + 1);
    const float* src = frames + (k & 1) * frame;
    float* dst = frames + ((k + 1) & 1) * frame;
    const float* lw = fsm + (k & 1) * layer;
    const float* lb = lw + layer_w;
    const bool last = k == n - 1;
    // Items (row, strip of kF32Px pixels) of the region, rows fastest, so
    // that neighbouring threads take neighbouring rows.
    const int rr = R - 2 * (k + 1), rc = C - 2 * (k + 1), end = C - k - 1;
    const int items = rr * ((rc + kF32Px - 1) / kF32Px);
    for (int i = threadIdx.x; i < items; i += T) {
      const int strip = i / rr, fr = k + 1 + i - strip * rr, fc = k + 1 + strip * kF32Px;
      const int y = oy - n + fr;
      for (int gi = 0; gi < G; ++gi) {
        float acc[kF32Px][kGroup] = {};
        conv3x3_strip<kF32Px>(acc, src, c, R, S, fr, fc, lw + gi * c * 9 * kGroup);
#pragma unroll
        for (int p = 0; p < kF32Px; ++p) {
          const int xx = ox - n + fc + p;
          if (fc + p >= end) break;
          const bool inside = y >= 0 && y < H && xx >= 0 && xx < W;
#pragma unroll
          for (int j = 0; j < kGroup; ++j) {
            const int co = gi * kGroup + j;
            if (co >= c) break;
            const float v = fmaxf(acc[p][j] + lb[co], 0.f);
            dst[(co * R + fr) * S + fc + p] = (last || inside) ? v : 0.f;
          }
        }
      }
    }
    cp_async_wait_all();
    __syncthreads();
  }
  const float* fin = frames + (n & 1) * frame;
  GridWalk o(threadIdx.x, T, th, tw);  // (channel, tile row, tile column)
  for (int i = threadIdx.x; i < c * th * tw; i += T, o.next()) {
    const int y = oy + o.row, xx = ox + o.col;
    if (y < H && xx < W)
      out[(o.plane * H + y) * W + xx] = fin[(o.plane * R + n + o.row) * S + n + o.col];
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

// Pixel-layers a convchain block computes at tile t: every layer's region,
// the halo included.
long long chain_cost(int n, Tile t) {
  long long px = 0;
  for (int k = 0; k < n; ++k)
    px += static_cast<long long>(t.th + 2 * (n - k - 1)) * (t.tw + 2 * (n - k - 1));
  return px;
}

// The row of `tiles` that a convchain launch takes: among the rows whose
// shared memory (`smem(c, n, tile)`) fits a block, the one with the least
// ceil(blocks / SMs) * chain_cost, the pixel-layers of the SM that gets the
// most tiles; a tile of 0 x 0 where none fits.
template <size_t Rows, typename F>
Tile pick_tile(const Tile (&tiles)[Rows], F smem, int c, int n, int H, int W) {
  int dev = 0, sms = 1;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    sms = 1;
  Tile best{0, 0, 0};
  long long best_cost = 0;
  for (const Tile& t : tiles) {
    if (smem(c, n, t) > static_cast<size_t>(kMaxSmem)) continue;
    const long long blocks = static_cast<long long>((H + t.th - 1) / t.th) * ((W + t.tw - 1) / t.tw);
    const long long cost = (blocks + sms - 1) / sms * chain_cost(n, t);
    if (best.th == 0 || cost < best_cost) {
      best = t;
      best_cost = cost;
    }
  }
  return best;
}

template <int G>
cudaError_t launch_chain_bf16(const __nv_bfloat16* x, const float* w, const float* b,
                              __nv_bfloat16* out, int c, int H, int W, int n, Tile t,
                              cudaStream_t stream) {
  const size_t smem = chain_bf16_smem(c, n, t);
  cudaError_t err = allow_smem(convchain_bf16_kernel<G>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((W + t.tw - 1) / t.tw, (H + t.th - 1) / t.th);
  convchain_bf16_kernel<G><<<grid, kChainThreads, smem, stream>>>(x, w, b, out, c, H, W, n, t.th,
                                                                   t.tw);
  return cudaGetLastError();
}

cudaError_t launch_convchain_bf16(const __nv_bfloat16* x, const float* w, const float* b,
                                  __nv_bfloat16* out, int c, int H, int W, int n,
                                  cudaStream_t stream) {
  if (groups(c) > kMaxGroups) return cudaErrorInvalidValue;
  const Tile t = pick_tile(kBf16Tiles, chain_bf16_smem, c, n, H, W);
  if (t.th == 0) return cudaErrorInvalidValue;
  if (groups(c) == 1) return launch_chain_bf16<1>(x, w, b, out, c, H, W, n, t, stream);
  return launch_chain_bf16<2>(x, w, b, out, c, H, W, n, t, stream);
}

cudaError_t launch_convchain_f32(const float* x, const float* w, const float* b, float* out, int c,
                                 int H, int W, int n, cudaStream_t stream) {
  const Tile t = pick_tile(kF32Tiles, chain_f32_smem, c, n, H, W);
  if (t.th == 0) return cudaErrorInvalidValue;
  const size_t smem = chain_f32_smem(c, n, t);
  cudaError_t err = allow_smem(convchain_f32_kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((W + t.tw - 1) / t.tw, (H + t.th - 1) / t.th);
  convchain_f32_kernel<<<grid, t.threads, smem, stream>>>(x, w, b, out, c, H, W, n, t.th, t.tw);
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
// tile that needs more shared memory than a block has, bf16 convchain with
// c > 16).

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
    return launch_convchain_bf16(static_cast<const T*>(x), wf, bf, static_cast<T*>(out), c, H, W,
                                 n, s);
  }
  return launch_convchain_f32(static_cast<const float*>(x), wf, bf, static_cast<float*>(out), c, H,
                              W, n, s);
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

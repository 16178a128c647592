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
// n = 4 is the exception, bound by float32 FMA issue).  float32 fpnprim and
// conv1 do 55 % and 90 % of their bytes bound's time in FMAs at the float32
// peak, so bf16 is where the bytes can be reached: on the tensor cores.
//
// conv1 and fpnprim are single-pass convs on one kernel template a dtype
// (conv_bf16_kernel, conv_f32_kernel; a kind struct gives the kernel size,
// stride and tile): conv1 takes c_in -> c_out.  The chain at n = 1 computes
// conv1 too (c -> c), but was no faster than the kernel before it in
// float32, and slower than conv_bf16_kernel in bf16.
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
// conv1 and fpnprim: one block per output tile (fpnprim: o1's), whose
// frame is x's rows and columns that the tile's taps read.  Both dtypes
// stage the tile's output (bias added, conv1's ReLU, rounded to x's dtype
// once) as planar rows in shared memory, then a store pass writes it as
// 16-byte row pieces (store_tile_rows), and fpnprim's o2 as two rows per o1
// row (store_prim_tile: a vector of o2 holds 16 / 2 sizeof(T) o1 values,
// each twice; the rows >= H - 3 are zeros), narrower where a row's address
// is not 16-byte aligned or the tile's last piece is cut (odd widths).
// Duplicating the rounded o1 is exact: rounding commutes with the copy.
//
// conv_bf16_kernel: an implicit GEMM on mma.sync built from the chain's
// parts: M = 16 output pixels of the tile in row-major order, N = 8 output
// channels, K = (tap pair, 8 input channels): the tap pairs on m16n8k16,
// the last tap alone on m16n8k8 (conv1: 5 steps as the chain's; fpnprim:
// 12 steps over taps 0-23, then tap 24, 200 of 208 K slots used), hi and
// lo B fragments as the chain's, GI input and GO output groups of 8 (c <=
// 16 a side).  The frame is channel-last bf16; at stride 2 its columns are
// stored by parity (even columns, then odd): a tap's 16 pixels, 2 columns
// apart in x, are 16 consecutive 16-byte rows, so an ldmatrix phase reads
// 128 contiguous bytes (stride-2 rows would span 256 bytes: 2-way bank
// conflicts).  x's bf16 rows (2 Wp bytes) are 4-byte aligned where Wp is
// even, never 16 at the bench widths (TMA cannot describe them), so the
// frame is read as 4-byte column pairs (2-byte halves where Wp is odd),
// kLoadBatch pairs of 8 channels in flight a thread, and split and
// transposed to channel-last in registers.  Tiles (ConvBf16): fpnprim 4 x
// 80 o1 pixels, 256 blocks at the bench plane, 2 an SM, one wave (8 x 80
// and 4 x 64 were slower); conv1 16 x 80, 256 blocks, 2 an SM.
//
// conv_f32_kernel: float32 FMAs only (no TF32, no tensor cores).  One block per output tile of 32 rows x TW
// columns (ConvF32: conv1 32 x 40, 256 blocks at 512x640, 2 an SM; fpnprim
// 32 x 20 o1 pixels, 128 blocks); a thread holds kPx = 4 pixels along a row
// x CO output channels, a warp the tile's 32 rows.  The frame comes in by
// 8-byte cp.async of column pairs where x allows (Wp even, x 8-byte
// aligned; 4-byte copies otherwise), zero-filled outside x, planar, with
// stride 2's rows stored by parity, so that neighbouring threads, on
// neighbouring output rows, read neighbouring stored rows; a row pitch of
// 2 mod 4 floats makes each half-warp's float2 loads conflict-free.  Per
// (ci, ky) a thread reads the window its pixels' taps span (conv1 6 values,
// fpnprim 11) and each tap's CO weights as float4 broadcasts: conv1 96 FMAs
// for 9 shared-memory loads (CO = 8), fpnprim 80 for 11 (CO = 4).  Sums run in (ci, ky, kx)
// order: conv1's plain version's; fpnprim's sums per tap the channels
// first, within the smoke's float32 tolerance (1e-5 absolute, 1e-4
// relative) of it.  Then bias (conv1: ReLU) into the output stage and the
// store pass.  fpnprim gives each thread half a group's channels (CO = 4):
// 10 warps a block, not 5, were faster at 512x640.
//
// Interface: plain C, loaded with ctypes; launches on the caller's stream
// and returns the cudaError_t of the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kGroup = 8;             // output channels summed per pass
constexpr int kMaxSmem = 232448;      // bytes a block may use on sm_90

// convchain's output tiles and threads a block; each launch takes the row
// of its dtype's table that fits a block's shared memory and is estimated
// fastest (pick_tile).  The last row is the smallest.
struct Tile {
  int th, tw, threads;
};
constexpr Tile kBf16Tiles[] = {{32, 40, 256}, {16, 32, 256}};
constexpr Tile kF32Tiles[] = {{40, 64, 640}, {16, 32, 256}};
constexpr int kChainThreads = 256;  // bf16 kernels: threads a block
constexpr int kF32MaxThreads = 640;
constexpr int kSteps = 5;      // bf16: K steps of a layer, taps (0,1) (2,3) (4,5) (6,7), then 8
constexpr int kMaxGroups = 2;  // bf16: channel groups of 8 a frame may hold (c <= 16)
constexpr int kF32Px = 5;      // f32: pixels along a row in a thread's register tile
constexpr int kLoadBatch = 4;  // bf16: pixels (column pairs) whose loads a thread keeps in flight

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__host__ __device__ constexpr int groups(int c) { return (c + kGroup - 1) / kGroup; }

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

// ---- the tensor-core parts (the bf16 kernels) ----

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

// B fragment entries of one layer ([nt][cg][step][lane]: GO output groups,
// GI input groups, S steps) and how many each thread stages.
template <int GI, int GO, int S>
constexpr int kLayerFrags = GO * GI * S * 32;
template <int GI, int GO, int S>
constexpr int kStageIters = (kLayerFrags<GI, GO, S> + kChainThreads - 1) / kChainThreads;

// This thread's share of layer k's weights w (layers, c_out, c_in, TAPS),
// read from device memory: entry e = threadIdx.x + j * kChainThreads of
// [nt][cg][step][lane] holds, for lane (g, t), w[co][ci][tap] of co = nt * 8
// + g at (tap 2s, ci 2t and 2t + 1) and (tap 2s + 1, the same ci), ci
// counted from cg * 8; zero past c_in, c_out and TAPS.  Thread j < 8 GO
// also takes bias[j].
template <int GI, int GO, int S, int TAPS>
__device__ __forceinline__ void fetch_layer(float (&v)[kStageIters<GI, GO, S>][4], float& bias,
                                            const float* __restrict__ w,
                                            const float* __restrict__ b, int c_in, int c_out,
                                            int k) {
#pragma unroll
  for (int j = 0; j < kStageIters<GI, GO, S>; ++j) {
    const int e = threadIdx.x + j * kChainThreads;
    const int l = e & 31, s = (e >> 5) % S, rest = (e >> 5) / S;
    const int co = (rest / GI) * kGroup + (l >> 2), ci = (rest % GI) * kGroup + 2 * (l & 3);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int tap = 2 * s + (q >> 1), cc = ci + (q & 1);
      v[j][q] = (e < kLayerFrags<GI, GO, S> && co < c_out && cc < c_in && tap < TAPS)
                    ? __ldg(w + ((k * c_out + co) * c_in + cc) * TAPS + tap)
                    : 0.f;
    }
  }
  const int j = threadIdx.x;
  bias = j < c_out && j < GO * kGroup ? __ldg(b + k * c_out + j) : 0.f;
}

// Stores the fetched layer as B fragments hi = bf16(w) (entries [0, E)) and
// lo = bf16(w - hi) (entries [E, 2E)), and the bias; returns whether any of
// this thread's lo is nonzero.
template <int GI, int GO, int S>
__device__ __forceinline__ int commit_layer(uint2* frags, float* sb,
                                            const float (&v)[kStageIters<GI, GO, S>][4],
                                            float bias) {
  int any_lo = 0;
#pragma unroll
  for (int j = 0; j < kStageIters<GI, GO, S>; ++j) {
    const int e = threadIdx.x + j * kChainThreads;
    if (e >= kLayerFrags<GI, GO, S>) break;
    const __nv_bfloat162 h0 = __floats2bfloat162_rn(v[j][0], v[j][1]);
    const __nv_bfloat162 h1 = __floats2bfloat162_rn(v[j][2], v[j][3]);
    const __nv_bfloat162 l0 =
        __floats2bfloat162_rn(v[j][0] - __low2float(h0), v[j][1] - __high2float(h0));
    const __nv_bfloat162 l1 =
        __floats2bfloat162_rn(v[j][2] - __low2float(h1), v[j][3] - __high2float(h1));
    frags[e] = make_uint2(bits(h0), bits(h1));
    frags[kLayerFrags<GI, GO, S> + e] = make_uint2(bits(l0), bits(l1));
    any_lo |= ((bits(l0) | bits(l1)) & 0x7fff7fffu) != 0;
  }
  if (static_cast<int>(threadIdx.x) < GO * kGroup) sb[threadIdx.x] = bias;
  return any_lo;
}

// One input group's A fragments of an M tile: step s < S - 1 by an x4
// ldmatrix (taps 2s and 2s + 1), the last by an x2 (one tap); lane l gives
// the row address `pix + toff[s]`.
template <int S>
__device__ __forceinline__ void load_a(uint32_t (&a)[S][4], uint32_t pix, const int (&toff)[S]) {
#pragma unroll
  for (int s = 0; s < S; ++s) {
    if (s == S - 1)
      ldsm_x2(reinterpret_cast<uint32_t(&)[2]>(a[s]), pix + toff[s]);
    else
      ldsm_x4(a[s], pix + toff[s]);
  }
}

// The MMAs of input group cg on its A fragments, in two chains an n8 tile:
// step s's hi MMA into chain s & 1, its lo MMA (if has_lo) into the other;
// the last step on m16n8k8.  B fragments from hi and lo ([nt][cg][step]
// [lane]), or rhi (one group each way: the hi fragments in registers).
template <int GI, int GO, int S>
__device__ __forceinline__ void mma_group(float (&acc)[GO][2][4], const uint32_t (&a)[S][4],
                                          const uint2* hi, const uint2* lo, const uint2 (&rhi)[S],
                                          int cg, int lane, bool has_lo) {
#pragma unroll
  for (int s = 0; s < S; ++s)
#pragma unroll
    for (int nt = 0; nt < GO; ++nt) {
      const int f = ((nt * GI + cg) * S + s) * 32 + lane;
      const uint2 bh = GI == 1 && GO == 1 ? rhi[s] : hi[f];
      float(&c0)[4] = acc[nt][s & 1];
      float(&c1)[4] = acc[nt][(s + 1) & 1];
      if (s == S - 1) {
        const uint32_t(&a8)[2] = reinterpret_cast<const uint32_t(&)[2]>(a[s]);
        mma_k8(c0, a8, bh.x);
        if (has_lo) mma_k8(c1, a8, lo[f].x);
      } else {
        mma_k16(c0, a[s], bh);
        if (has_lo) mma_k16(c1, a[s], lo[f]);
      }
    }
}

// ---- convchain, bf16: an implicit GEMM on mma.sync ----

// Bytes of convchain_bf16_kernel's shared memory: two frames of G planes of
// R x C pixels of 16 bytes, then two layers' B fragments (hi and lo) and
// bias.
__host__ __device__ inline size_t chain_bf16_smem(int c, int n, Tile t) {
  const size_t G = groups(c), R = t.th + 2 * n, C = t.tw + 2 * n;
  return 2 * G * R * C * 16 + 2 * (2 * G * G * kSteps * 32 * sizeof(uint2) + G * kGroup * 4);
}

// G channel groups of 8 (c <= 8 G).  Block (bx, by) computes the output
// tile at (by * th, bx * tw).  Shared memory: frame buffers 0 and 1
// ([G][R][C] pixels of 8 bf16), then per layer parity the B fragments (hi,
// then lo; uint2 (k = 2t, 2t + 1; k = 2t + 8, 2t + 9) of lane (g, t)) and
// the bias [G * 8].  Layer k + 1's weights are fetched into registers
// before layer k runs and staged into the other buffer after it.
template <int G>
__global__ void __launch_bounds__(kChainThreads)
convchain_bf16_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ w,
                      const float* __restrict__ b, __nv_bfloat16* __restrict__ out, int c, int H,
                      int W, int n, int th, int tw) {
  constexpr int E = kLayerFrags<G, G, kSteps>;
  extern __shared__ __align__(128) unsigned char bsm[];
  // Frame row f is image row oy - n + f (x's padded row oy - n + f + 1);
  // likewise for columns.  Layer k writes frame rows [k + 1, R - k - 1).
  const int R = th + 2 * n, C = tw + 2 * n, plane = R * C * 16;
  // Buffers of layer parity k: frame k & 1 (its input), then B fragments
  // and bias k & 1.
  unsigned char* const frames = bsm;
  uint2* const frags = reinterpret_cast<uint2*>(bsm + 2 * G * plane);
  float* const sb = reinterpret_cast<float*>(frags + 4 * E);
  const int oy = blockIdx.y * th, ox = blockIdx.x * tw;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;

  float staged[kStageIters<G, G, kSteps>][4], staged_bias;
  fetch_layer<G, G, kSteps, 9>(staged, staged_bias, w, b, c, c, 0);
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
  int any_lo = commit_layer<G, G, kSteps>(frags, sb, staged, staged_bias);
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
    if (k + 1 < n) fetch_layer<G, G, kSteps, 9>(staged, staged_bias, w, b, c, c, k + 1);
    const uint32_t src = smem_u32(frames + (k & 1) * G * plane);
    unsigned char* dst = frames + ((k + 1) & 1) * G * plane;
    const uint2* hi = frags + (k & 1) * 2 * E;
    const uint2* lo = hi + E;
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
      // on tap 8), then the MMAs in two chains an n8 tile, summed before
      // the bias.
      float acc[G][2][4] = {};
#pragma unroll
      for (int cg = 0; cg < G; ++cg) {
        uint32_t a[kSteps][4];
        load_a<kSteps>(a, src + cg * plane + pix * 16, toff);
        mma_group<G, G, kSteps>(acc, a, hi, lo, rhi, cg, lane, has_lo);
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
    any_lo = k + 1 < n ? commit_layer<G, G, kSteps>(frags + next * 2 * E, sb + next * G * kGroup,
                                                    staged, staged_bias)
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

// An N-byte copy (N = 4, 8 or 16) from global src to shared dst that does
// not pass through registers; 0 is written where `valid` is false (src is
// then not read).
template <int N>
__device__ __forceinline__ void cp_async(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(smem_u32(dst)), "l"(src),
               "n"(N), "r"(valid ? N : 0)
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

// Layer k's weights w (layers, c_out, c_in, TAPS) as [group][ci][tap][8]
// (zero past c_out) and bias [group * 8] into dst by 4-byte cp.async.
template <int TAPS>
__device__ void stage_f32_weights(float* dst, const float* __restrict__ w,
                                  const float* __restrict__ b, int c_in, int c_out, int k) {
  const int G = groups(c_out), layer_w = G * c_in * TAPS * kGroup;
  GridWalk e(threadIdx.x, blockDim.x, c_in * TAPS, kGroup);  // (group, ci * TAPS + tap, j)
  for (int i = threadIdx.x; i < layer_w; i += blockDim.x, e.next()) {
    const int co = e.plane * kGroup + e.col, ci = e.row / TAPS, tap = e.row - ci * TAPS;
    cp_async<4>(dst + i, w + ((k * c_out + min(co, c_out - 1)) * c_in + ci) * TAPS + tap,
                co < c_out);
  }
  for (int co = threadIdx.x; co < G * kGroup; co += blockDim.x)
    cp_async<4>(dst + layer_w + co, b + k * c_out + min(co, c_out - 1), co < c_out);
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
  // at once (zero-filled outside x).
  stage_f32_weights<9>(fsm, w, b, c, c, 0);
  GridWalk at(threadIdx.x, T, R, C);  // (channel, frame row, frame column)
  for (int i = threadIdx.x; i < c * R * C; i += T, at.next()) {
    const int r = oy - n + 1 + at.row, q = ox - n + 1 + at.col;
    const bool in_x = r >= 0 && r < H + 2 && q >= 0 && q < W + 2;
    cp_async<4>(frames + (at.plane * R + at.row) * S + at.col,
                x + (in_x ? (at.plane * (H + 2) + r) * (W + 2) + q : 0), in_x);
  }
  cp_async_wait_all();
  __syncthreads();
  for (int k = 0; k < n; ++k) {
    if (k + 1 < n) stage_f32_weights<9>(fsm + ((k + 1) & 1) * layer, w, b, c, c, k + 1);
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

// ---- conv1 and fpnprim: the output stage's store pass ----

// 8 bytes of o1 values (4 bf16 or 2 float32) as 16 bytes of o2, each value
// twice.
template <typename T>
__device__ __forceinline__ uint4 twice(uint2 v) {
  if constexpr (sizeof(T) == 2)
    return make_uint4(__byte_perm(v.x, 0, 0x1010), __byte_perm(v.x, 0, 0x3232),
                      __byte_perm(v.y, 0, 0x1010), __byte_perm(v.y, 0, 0x3232));
  else
    return make_uint4(v.x, v.x, v.y, v.y);
}

// v twice at d, as one 4-byte (bf16) or 8-byte (float32) store: o2's value
// pairs start at even columns, so they are that aligned.
template <typename T>
__device__ __forceinline__ void store_twice(T* d, T v) {
  if constexpr (sizeof(T) == 2)
    *reinterpret_cast<uint32_t*>(d) = *reinterpret_cast<const unsigned short*>(&v) * 0x10001u;
  else
    *reinterpret_cast<float2*>(d) = make_float2(v, v);
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Stores an output tile at (oy, ox) of planes (c, Ho, Wo), staged in shared
// memory as c planes of PS values (row-major th x tw, rounded to T), in
// pieces of 16 bytes (V1 values) a row.  A piece cut by the tile's valid
// width, or whose address is not 16-byte aligned (odd widths), is stored
// value by value.
template <typename T>
__device__ void store_tile_rows(const T* stage, int PS, int th, int tw, T* __restrict__ out, int c,
                                int Ho, int Wo, int oy, int ox) {
  constexpr int V1 = 16 / sizeof(T);
  const int nr = min(th, Ho - oy), nc = min(tw, Wo - ox);
  GridWalk a(threadIdx.x, blockDim.x, th, tw / V1);  // (channel, tile row, piece)
  for (int i = threadIdx.x; i < c * th * (tw / V1); i += blockDim.x, a.next()) {
    const int col = a.col * V1;
    if (a.row >= nr || col >= nc) continue;
    const T* s = stage + a.plane * PS + a.row * tw + col;
    T* d = out + (a.plane * Ho + oy + a.row) * Wo + ox + col;
    if (col + V1 <= nc && aligned16(d)) {
      *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(s);
    } else {
      for (int e = 0; e < min(V1, nc - col); ++e) d[e] = s[e];
    }
  }
}

// Stores the block's o1 tile at (oy, ox), staged as store_tile_rows takes
// it, into o1, then into o2: o2's two rows per o1 row in pieces of 16 bytes
// (V2 o1 values, each twice; rows >= H - 3 zero), value by value (a value's
// pair at a time) where a piece is cut or not 16-byte aligned (W not a
// multiple of 8 / sizeof(T)).
template <typename T>
__device__ void store_prim_tile(const T* stage, int PS, int th, int tw, T* __restrict__ o1,
                                T* __restrict__ o2, int c, int H, int W, int oy, int ox) {
  constexpr int V2 = 8 / sizeof(T);
  const int Ho = H / 2, Wo = W / 2;
  store_tile_rows(stage, PS, th, tw, o1, c, Ho, Wo, oy, ox);
  const int nr = min(th, Ho - oy), nc = min(tw, Wo - ox);
  const T zero = from_f32<T>(0.f);
  GridWalk u(threadIdx.x, blockDim.x, 2 * th, tw / V2);  // (channel, o2 row in the tile, o2 piece)
  for (int i = threadIdx.x; i < c * 2 * th * (tw / V2); i += blockDim.x, u.next()) {
    const int r = u.row >> 1, col = u.col * V2, y = 2 * (oy + r) + (u.row & 1);
    if (r >= nr || col >= nc) continue;
    const bool masked = y >= H - 3;
    const T* s = stage + u.plane * PS + r * tw + col;
    T* d = o2 + (u.plane * H + y) * W + 2 * (ox + col);
    if (col + V2 <= nc && aligned16(d)) {
      *reinterpret_cast<uint4*>(d) =
          masked ? make_uint4(0, 0, 0, 0) : twice<T>(*reinterpret_cast<const uint2*>(s));
    } else {
      for (int e = 0; e < min(V2, nc - col); ++e) store_twice(d + 2 * e, masked ? zero : s[e]);
    }
  }
}

// ---- conv1 and fpnprim, bf16: an implicit GEMM on mma.sync ----

// The two bf16 single-pass convs: kernel size, stride, output tile (TH x TW
// pixels; M tiles of 16 in row-major order), ReLU.  Derived: the K steps
// (tap pairs on m16n8k16, the last tap alone on m16n8k8), the frame's rows
// and column pairs, a frame row's bytes (2 CE pixels of 16 bytes: stride 2
// stores its columns by parity, column q at pixel slot(q)), and the output
// stage's plane pitch (8 mod 32 bf16, so that the epilogue's four channel
// pairs fall on distinct banks).
template <int K_, int STRIDE_, int TH_, int TW_, bool RELU_>
struct ConvBf16 {
  static constexpr int K = K_, STRIDE = STRIDE_, TH = TH_, TW = TW_;
  static constexpr bool RELU = RELU_;
  static constexpr int TAPS = K * K, STEPS = (TAPS + 1) / 2;
  static constexpr int FR = STRIDE * (TH - 1) + K;              // frame rows
  static constexpr int CE = (STRIDE * (TW - 1) + K + 1) / 2;    // column pairs
  static constexpr int PITCH = 2 * CE * 16, PLANE = FR * PITCH;  // bytes a row, a group
  static constexpr int PS = TH * TW + 8;
  static_assert(TAPS % 2 == 1 && TH * TW % 32 == 0 && TW % 8 == 0,
                "a lone last tap, whole M tiles, 16-byte output pieces, a stage pitch of 8 mod 32");
  __host__ __device__ static constexpr int slot(int q) {
    return STRIDE == 2 ? (q & 1) * CE + (q >> 1) : q;
  }
};
using Conv1Bf16 = ConvBf16<3, 1, 16, 80, true>;  // 256 blocks at 512x640, 2 an SM
using PrimBf16 = ConvBf16<5, 2, 4, 80, false>;   // 256 o1 blocks at 512x640, 2 an SM

// Bytes of conv_bf16_kernel<C, GI, GO>'s shared memory: the frame (GI
// planes), the B fragments (hi and lo) and bias, the output stage (8 GO
// planes).
template <class C>
__host__ __device__ inline size_t conv_bf16_smem(int c_in, int c_out) {
  const size_t GI = groups(c_in), GO = groups(c_out);
  return GI * C::PLANE + 2 * GI * GO * C::STEPS * 32 * sizeof(uint2) + GO * kGroup * 4 +
         GO * kGroup * C::PS * 2;
}

// The frame of the output tile at (oy, ox) of x's padded planes (c_in, Hp,
// Wp) into bsm ([GI][FR][2 CE] pixels): frame row f is x's padded row
// STRIDE * oy + f, column pair q its columns STRIDE * ox + 2q and + 1, read
// as one 4-byte value a channel (PAIRS: Wp even, x 4-byte aligned) or two
// 2-byte ones, zero past c_in and outside x, kLoadBatch pairs in flight a
// thread; its columns become pixels slot(2q) and slot(2q + 1).
template <class C, int GI, bool PAIRS>
__device__ __forceinline__ void load_frame_bf16(unsigned char* bsm, const __nv_bfloat16* x,
                                                int c_in, int Hp, int Wp, int oy, int ox) {
  constexpr int kOdd = (C::slot(1) - C::slot(0)) * 16;  // bytes from a pair's even pixel to its odd
  const unsigned short* xs = reinterpret_cast<const unsigned short*>(x);
  const int xplane = Hp * Wp, items = GI * C::FR * C::CE;
  const int r0 = C::STRIDE * oy, q0 = C::STRIDE * ox;  // q0 is even: TW % 8 == 0
  GridWalk at(threadIdx.x, kChainThreads, C::FR, C::CE);  // (group, frame row, column pair)
  for (int i0 = threadIdx.x; i0 < items; i0 += kLoadBatch * kChainThreads) {
    uint32_t v[kLoadBatch][kGroup] = {};
    int off[kLoadBatch];
#pragma unroll
    for (int u = 0; u < kLoadBatch; ++u, at.next()) {
      const int i = i0 + u * kChainThreads;
      const int r = r0 + at.row, q = q0 + 2 * at.col;
      off[u] = at.plane * C::PLANE + at.row * C::PITCH + C::slot(2 * at.col) * 16;
      if (i < items && r < Hp && q < Wp) {
        const int src = at.plane * kGroup * xplane + r * Wp + q;
#pragma unroll
        for (int j = 0; j < kGroup; ++j) {
          if (at.plane * kGroup + j < c_in) {
            if constexpr (PAIRS)
              v[u][j] = __ldg(reinterpret_cast<const unsigned*>(xs) + (src + j * xplane) / 2);
            else
              v[u][j] = __ldg(xs + src + j * xplane) |
                        (q + 1 < Wp ? static_cast<uint32_t>(__ldg(xs + src + j * xplane + 1)) << 16
                                    : 0u);
          }
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kLoadBatch; ++u) {
      if (i0 + u * kChainThreads >= items) break;
      uint32_t even[4], odd[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        even[k] = __byte_perm(v[u][2 * k], v[u][2 * k + 1], 0x5410);
        odd[k] = __byte_perm(v[u][2 * k], v[u][2 * k + 1], 0x7632);
      }
      *reinterpret_cast<uint4*>(bsm + off[u]) = make_uint4(even[0], even[1], even[2], even[3]);
      *reinterpret_cast<uint4*>(bsm + off[u] + kOdd) = make_uint4(odd[0], odd[1], odd[2], odd[3]);
    }
  }
}

// GI input and GO output channel groups of 8.  Block (bx, by) computes the
// output tile at (by * TH, bx * TW) of x's padded planes (c_in, Hp, Wp)
// (conv1: pad 1, stride 1; fpnprim: pad 2, stride 2, o1's tile) from the
// frame load_frame_bf16 stages.  Warp w takes M tiles w, w + 8, ...
template <class C, int GI, int GO>
__global__ void __launch_bounds__(kChainThreads)
conv_bf16_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ w,
                 const float* __restrict__ b, __nv_bfloat16* __restrict__ o1,
                 __nv_bfloat16* __restrict__ o2, int c_in, int c_out, int Hp, int Wp, int Ho,
                 int Wo, bool pairs) {
  constexpr int TH = C::TH, TW = C::TW, S = C::STEPS, E = kLayerFrags<GI, GO, S>;
  extern __shared__ __align__(128) unsigned char bsm[];
  uint2* const frags = reinterpret_cast<uint2*>(bsm + GI * C::PLANE);
  float* const sb = reinterpret_cast<float*>(frags + 2 * E);
  __nv_bfloat16* const stage = reinterpret_cast<__nv_bfloat16*>(sb + GO * kGroup);
  const int oy = blockIdx.y * TH, ox = blockIdx.x * TW;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;

  float staged[kStageIters<GI, GO, S>][4], staged_bias;
  fetch_layer<GI, GO, S, C::TAPS>(staged, staged_bias, w, b, c_in, c_out, 0);
  if (pairs)
    load_frame_bf16<C, GI, true>(bsm, x, c_in, Hp, Wp, oy, ox);
  else
    load_frame_bf16<C, GI, false>(bsm, x, c_in, Hp, Wp, oy, ox);
  const bool has_lo =
      __syncthreads_or(commit_layer<GI, GO, S>(frags, sb, staged, staged_bias));

  // Byte offset of this lane's tap at step s from its pixel's address
  // (frame row STRIDE pr, pixel pc): lane l takes tap 2s + l / 16 (the last
  // step: the last tap), (ky, kx) at frame row STRIDE pr + ky, column
  // STRIDE pc + kx, i.e. pixel pc + slot(kx).
  int toff[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int tap = s < S - 1 ? 2 * s + (lane >> 4) : C::TAPS - 1, ky = tap / C::K;
    toff[s] = ky * C::PITCH + C::slot(tap - ky * C::K) * 16;
  }
  const uint2* hi = frags;
  const uint2* lo = frags + E;
  uint2 rhi[S];
  if constexpr (GI == 1 && GO == 1) {
#pragma unroll
    for (int s = 0; s < S; ++s) rhi[s] = hi[s * 32 + lane];
  }
  float bias[GO][2];
#pragma unroll
  for (int nt = 0; nt < GO; ++nt) {
    bias[nt][0] = sb[nt * kGroup + 2 * t];
    bias[nt][1] = sb[nt * kGroup + 2 * t + 1];
  }
  const uint32_t frame = smem_u32(bsm);
  for (int m = warp; m < TH * TW / 16; m += kChainThreads / 32) {
    const int p = m * 16 + (lane & 15), pr = p / TW, pc = p - pr * TW;
    const uint32_t pix = frame + C::STRIDE * pr * C::PITCH + pc * 16;
    float acc[GO][2][4] = {};
#pragma unroll
    for (int cg = 0; cg < GI; ++cg) {
      uint32_t a[S][4];
      load_a<S>(a, pix + cg * C::PLANE, toff);
      mma_group<GI, GO, S>(acc, a, hi, lo, rhi, cg, lane, has_lo);
    }
    // Accumulator rows g and g + 8 are the tile's pixels m * 16 + g (+ 8):
    // bias (and ReLU) in float32, rounded to bf16 once, staged at [co][pixel].
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int q = m * 16 + g + 8 * h;
#pragma unroll
      for (int nt = 0; nt < GO; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float v = acc[nt][0][2 * h + e] + acc[nt][1][2 * h + e] + bias[nt][e];
          stage[(nt * kGroup + 2 * t + e) * C::PS + q] = __float2bfloat16(C::RELU ? fmaxf(v, 0.f) : v);
        }
    }
  }
  __syncthreads();
  if (o2)
    store_prim_tile(stage, C::PS, TH, TW, o1, o2, c_out, 2 * Ho, 2 * Wo, oy, ox);
  else
    store_tile_rows(stage, C::PS, TH, TW, o1, c_out, Ho, Wo, oy, ox);
}

// ---- conv1 and fpnprim, float32: register tiles of FMAs ----

// The two float32 single-pass convs: kernel size, stride, output tile (TH
// rows x TW columns; TH = 32: a warp on the tile's rows), output channels
// a thread (CO of each group of 8), ReLU, and the pixels a thread takes
// along a row (kPx).  Derived: the frame's rows (stored by parity where the
// stride is 2), its column pairs, its row pitch (2 mod 4 floats, at least
// the pairs), the window of frame values a thread's pixels span in a row,
// and the threads a block.
template <int K_, int STRIDE_, int TW_, int CO_, bool RELU_>
struct ConvF32 {
  static constexpr int K = K_, STRIDE = STRIDE_, TH = 32, TW = TW_, CO = CO_;
  static constexpr bool RELU = RELU_;
  static constexpr int kPx = 4;
  static constexpr int FR = STRIDE * (TH - 1) + K;               // frame rows
  static constexpr int RH = STRIDE == 2 ? (FR + 1) / 2 : FR;      // stored rows a parity
  static constexpr int ROWS = STRIDE * RH;                        // stored rows
  static constexpr int PAIRS = (STRIDE * (TW - 1) + K + 1) / 2;   // column pairs
  static constexpr int S = 2 * (PAIRS | 1);                      // row pitch
  static constexpr int WIN = STRIDE * (kPx - 1) + K;              // window a row
  static constexpr int THREADS = TH * (TW / kPx) * (kGroup / CO);
  static_assert(TW % kPx == 0 && kGroup % CO == 0 && S % 4 == 2 && S >= 2 * PAIRS, "tile");
  // Stored row of frame row STRIDE * r + ky.
  __device__ static int row(int r, int ky) {
    return STRIDE == 2 ? (ky & 1) * RH + r + (ky >> 1) : r + ky;
  }
};
using Conv1F32 = ConvF32<3, 1, 40, 8, true>;    // 256 tiles at 512x640, 2 blocks an SM
using PrimF32 = ConvF32<5, 2, 20, 4, false>;    // 128 o1 tiles at 512x640, one an SM

// Bytes of conv_f32_kernel<C>'s shared memory: the frame (c_in planes),
// the weights [group][ci][tap][8] and bias, the output stage (c_out planes
// of TH * TW).
template <class C>
__host__ __device__ inline size_t conv_f32_smem(int c_in, int c_out) {
  return (static_cast<size_t>(c_in) * C::ROWS * C::S +
          groups(c_out) * kGroup * (C::K * C::K * static_cast<size_t>(c_in) + 1) +
          static_cast<size_t>(c_out) * C::TH * C::TW) *
         sizeof(float);
}

// Block (bx, by) computes the output tile at (by * TH, bx * TW) of x's
// padded planes (c_in, Hp, Wp) (conv1: pad 1, stride 1; fpnprim: pad 2,
// stride 2, o1's tile).  Frame row f is x's padded row STRIDE * oy + f,
// column q its column STRIDE * ox + q, copied in as column pairs by 8-byte
// cp.async (`pairs`: x 8-byte aligned, Wp even) or as single columns by
// 4-byte ones, zero-filled outside x.  Thread i takes half (i / (THREADS /
// (8 / CO))) of each group's channels, tile row i % TH and columns kPx *
// (i / TH % (TW / kPx)) ..  + kPx - 1: per (ci, ky) it reads its window
// (WIN values, float2 loads) and each tap's CO weights as float4
// broadcasts; sums run in (ci, ky, kx) order.  Then bias (and ReLU) into
// the stage, and the store pass: conv1's rows, or fpnprim's o1 and o2.
template <class C>
__global__ void __launch_bounds__(C::THREADS)
conv_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                const float* __restrict__ b, float* __restrict__ o1, float* __restrict__ o2,
                int c_in, int c_out, int Hp, int Wp, int Ho, int Wo, bool pairs) {
  constexpr int TH = C::TH, TW = C::TW, P = C::kPx, CO = C::CO, KK = C::K * C::K;
  extern __shared__ __align__(128) float fsm[];
  const int G = groups(c_out);
  float* const frame = fsm;
  float* const sw = frame + c_in * C::ROWS * C::S;
  float* const stage = sw + G * kGroup * (KK * c_in + 1);
  const int oy = blockIdx.y * TH, ox = blockIdx.x * TW;
  stage_f32_weights<KK>(sw, w, b, c_in, c_out, 0);
  const int r0 = C::STRIDE * oy, q0 = C::STRIDE * ox;
  auto dst_row = [&](int ch, int f) {
    return frame + (ch * C::ROWS + (C::STRIDE == 2 ? (f & 1) * C::RH + (f >> 1) : f)) * C::S;
  };
  if (pairs) {
    GridWalk at(threadIdx.x, blockDim.x, C::FR, C::PAIRS);  // (channel, frame row, column pair)
    for (int i = threadIdx.x; i < c_in * C::FR * C::PAIRS; i += blockDim.x, at.next()) {
      const int r = r0 + at.row, q = q0 + 2 * at.col;
      const bool in_x = r < Hp && q < Wp;
      cp_async<8>(dst_row(at.plane, at.row) + 2 * at.col,
                  x + (in_x ? (at.plane * Hp + r) * Wp + q : 0), in_x);
    }
  } else {
    GridWalk at(threadIdx.x, blockDim.x, C::FR, 2 * C::PAIRS);  // (channel, frame row, column)
    for (int i = threadIdx.x; i < c_in * C::FR * 2 * C::PAIRS; i += blockDim.x, at.next()) {
      const int r = r0 + at.row, q = q0 + at.col;
      const bool in_x = r < Hp && q < Wp;
      cp_async<4>(dst_row(at.plane, at.row) + at.col,
                  x + (in_x ? (at.plane * Hp + r) * Wp + q : 0), in_x);
    }
  }
  cp_async_wait_all();
  __syncthreads();
  constexpr int kStrips = TW / P;
  const int half = threadIdx.x / (TH * kStrips), rest = threadIdx.x - half * TH * kStrips;
  const int row = rest % TH, j0 = rest / TH * P;
  const float* bias = sw + G * kGroup * KK * c_in;
  for (int gi = 0; gi < G; ++gi) {
    const float* gw = sw + gi * c_in * KK * kGroup + half * CO;
    float acc[P][CO] = {};
    for (int ci = 0; ci < c_in; ++ci) {
#pragma unroll
      for (int ky = 0; ky < C::K; ++ky) {
        const float* src = frame + (ci * C::ROWS + C::row(row, ky)) * C::S + C::STRIDE * j0;
        float in[C::WIN];
#pragma unroll
        for (int e = 0; e < C::WIN / 2; ++e) {
          const float2 v = reinterpret_cast<const float2*>(src)[e];
          in[2 * e] = v.x;
          in[2 * e + 1] = v.y;
        }
        if constexpr (C::WIN % 2) in[C::WIN - 1] = src[C::WIN - 1];
#pragma unroll
        for (int kx = 0; kx < C::K; ++kx) {
          const float* wk = gw + (ci * KK + ky * C::K + kx) * kGroup;
          float wv[CO];
#pragma unroll
          for (int j = 0; j < CO; j += 4) {
            const float4 v = *reinterpret_cast<const float4*>(wk + j);
            wv[j] = v.x;
            wv[j + 1] = v.y;
            wv[j + 2] = v.z;
            wv[j + 3] = v.w;
          }
#pragma unroll
          for (int p = 0; p < P; ++p)
#pragma unroll
            for (int j = 0; j < CO; ++j)
              acc[p][j] = fmaf(in[C::STRIDE * p + kx], wv[j], acc[p][j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < CO; ++j) {
      const int co = gi * kGroup + half * CO + j;
      if (co >= c_out) break;
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const float v = acc[p][j] + bias[co];
        stage[co * TH * TW + row * TW + j0 + p] = C::RELU ? fmaxf(v, 0.f) : v;
      }
    }
  }
  __syncthreads();
  if (o2)
    store_prim_tile(stage, TH * TW, TH, TW, o1, o2, c_out, 2 * Ho, 2 * Wo, oy, ox);
  else
    store_tile_rows(stage, TH * TW, TH, TW, o1, c_out, Ho, Wo, oy, ox);
}

// ---- launches ----

// Raises the kernel's dynamic shared-memory limit to `bytes` where that is
// above the 48 KB default; refuses what no block may hold.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes > static_cast<size_t>(kMaxSmem)) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
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

template <class C, int GI, int GO>
cudaError_t launch_conv_bf16(const __nv_bfloat16* x, const float* w, const float* b,
                             __nv_bfloat16* o1, __nv_bfloat16* o2, int c_in, int c_out, int Hp,
                             int Wp, int Ho, int Wo, cudaStream_t stream) {
  const size_t smem = conv_bf16_smem<C>(c_in, c_out);
  cudaError_t err = allow_smem(conv_bf16_kernel<C, GI, GO>, smem);
  if (err != cudaSuccess) return err;
  const bool pairs = Wp % 2 == 0 && reinterpret_cast<uintptr_t>(x) % 4 == 0;
  const dim3 grid((Wo + C::TW - 1) / C::TW, (Ho + C::TH - 1) / C::TH);
  conv_bf16_kernel<C, GI, GO><<<grid, kChainThreads, smem, stream>>>(x, w, b, o1, o2, c_in, c_out,
                                                                     Hp, Wp, Ho, Wo, pairs);
  return cudaGetLastError();
}

// conv_f32_kernel<C> on x's padded planes (c_in, Hp, Wp) into (c_out, Ho,
// Wo) (and fpnprim's o2 where given).
template <class C>
cudaError_t launch_conv_f32(const float* x, const float* w, const float* b, float* o1, float* o2,
                            int c_in, int c_out, int Hp, int Wp, int Ho, int Wo,
                            cudaStream_t stream) {
  const size_t smem = conv_f32_smem<C>(c_in, c_out);
  cudaError_t err = allow_smem(conv_f32_kernel<C>, smem);
  if (err != cudaSuccess) return err;
  const bool pairs = Wp % 2 == 0 && reinterpret_cast<uintptr_t>(x) % 8 == 0;
  const dim3 grid((Wo + C::TW - 1) / C::TW, (Ho + C::TH - 1) / C::TH);
  conv_f32_kernel<C><<<grid, C::THREADS, smem, stream>>>(x, w, b, o1, o2, c_in, c_out, Hp, Wp, Ho,
                                                         Wo, pairs);
  return cudaGetLastError();
}

}  // namespace

// Each entry point returns a cudaError_t: cudaErrorInvalidValue for sizes
// the kernel does not take (non-positive sizes; odd H or W, c > 16 in bf16,
// a shared-memory need above a block's, or x not aligned to 4 (bf16) or 8
// (float32) bytes for fpnprim; bf16 convchain or conv1 with c > 16 a side;
// a chain whose smallest tile needs more shared memory than a block has).

extern "C" int plane_conv1(const void* x, const void* w, const void* b, void* out, int c_in,
                           int c_out, int H, int W, int is_bf16, void* stream) {
  if (c_in < 1 || c_out < 1 || H < 1 || W < 1) return cudaErrorInvalidValue;
  const float* wf = static_cast<const float*>(w);
  const float* bf = static_cast<const float*>(b);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!is_bf16)
    return launch_conv_f32<Conv1F32>(static_cast<const float*>(x), wf, bf,
                                     static_cast<float*>(out), nullptr, c_in, c_out, H + 2, W + 2,
                                     H, W, s);
  using T = __nv_bfloat16;
  const T* xb = static_cast<const T*>(x);
  T* ob = static_cast<T*>(out);
  const int gi = groups(c_in), go = groups(c_out);
  if (gi > kMaxGroups || go > kMaxGroups) return cudaErrorInvalidValue;
  if (gi == 1 && go == 1)
    return launch_conv_bf16<Conv1Bf16, 1, 1>(xb, wf, bf, ob, nullptr, c_in, c_out, H + 2, W + 2,
                                             H, W, s);
  if (gi == 1)
    return launch_conv_bf16<Conv1Bf16, 1, 2>(xb, wf, bf, ob, nullptr, c_in, c_out, H + 2, W + 2,
                                             H, W, s);
  if (go == 1)
    return launch_conv_bf16<Conv1Bf16, 2, 1>(xb, wf, bf, ob, nullptr, c_in, c_out, H + 2, W + 2,
                                             H, W, s);
  return launch_conv_bf16<Conv1Bf16, 2, 2>(xb, wf, bf, ob, nullptr, c_in, c_out, H + 2, W + 2, H,
                                           W, s);
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
  if (reinterpret_cast<uintptr_t>(x) % (is_bf16 ? 4 : 8)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  const float* bf = static_cast<const float*>(b);
  if (!is_bf16)
    return launch_conv_f32<PrimF32>(static_cast<const float*>(x), wf, bf, static_cast<float*>(o1),
                                    static_cast<float*>(o2), c, c, H + 4, W + 4, H / 2, W / 2, s);
  using T = __nv_bfloat16;
  const T* xb = static_cast<const T*>(x);
  T* p1 = static_cast<T*>(o1);
  T* p2 = static_cast<T*>(o2);
  const int G = groups(c);
  if (G > kMaxGroups) return cudaErrorInvalidValue;
  if (G == 1)
    return launch_conv_bf16<PrimBf16, 1, 1>(xb, wf, bf, p1, p2, c, c, H + 4, W + 4, H / 2, W / 2, s);
  return launch_conv_bf16<PrimBf16, 2, 2>(xb, wf, bf, p1, p2, c, c, H + 4, W + 4, H / 2, W / 2, s);
}

// Fused BundleNeRF head for NVIDIA Hopper (sm_90a).
//
// Replaces gdb_nerf_tpu/ops/pallas/fused_nerf.py::fused_bundle_nerf.  For
// every bundle sample it runs the whole head of models/nerf_head.py:
//   view aggregation  ifr_v = frd_v[:F] + relu(view_fc(frd_v[F:F+4]))
//                     var (unbiased), mean over views
//                     gf_v = relu(W_pv ifr_v + W_var var + W_mean mean + b)
//                     pooled = softmax_v(relu(agg_w gf_v)) . gf_v
//                     img = relu(fc pooled)
//   density           x = relu(lr0 [vox, img]);  sigma = softplus(w_s x)
//   payload blend     h_v = relu(W0s [x, vox, img] + W0v frd_v)
//                     l_v = relu(w1 h_v);  feat[:P] = softmax_v(l_v) . payload_v
//   feature head      feat[P:] = relu(feat_head x)
//
// Bound: ~32.6 kFLOP per sample at V = 3 against ~0.84 KB of float32 traffic
// (~0.42 KB in bf16).  float32 FMAs outside the tensor cores make float32
// bound by arithmetic issue; on the tensor cores bf16 has its bytes as bound.
// Both kernels take the same 11,930-float weight pack and restage it in
// shared memory once per resident block, in the layout each one reads.
//
// float32 (bundle_head_f32_kernel): one thread per sample, float32 FMAs only
// (no TF32).  Every weight row is restaged zero-padded to a multiple of 4
// floats at a 16-byte-aligned offset, so one broadcast float4 load from
// shared memory feeds four FMAs (a 4-byte load per FMA would cap the kernel
// at a quarter of the FMA rate: shared memory serves one wavefront a clock,
// the SM issues four warp-FMAs).  Layers of up to 32 outputs are unrolled;
// the 64-wide ones run as rolled loops over kRows output rows.  A column of
// shared memory per thread holds global_fc's view-shared half during the
// aggregation (and each view's output of it), weight.0's shared half during
// the blend, so neither sits in registers beside the per-view activations
// (fully unrolled, the per-view layer spilled 2.9 KB at 255 registers).
//
// bf16 (bundle_head_bf16_kernel): a warp owns a tile of 16 samples and runs
// every dense layer on the tensor cores (mma.sync m16n8k16, bf16 in, float32
// accumulate).  A layer's float32 accumulator fragment (m16n8) becomes the
// next layer's bf16 A fragment (m16k16) in registers.  K is zero-padded to a
// multiple of 16 and N to a multiple of 8; lr0 and weight.0 take their
// inputs in the order [img, vox] and [x, img, vox], so that each block starts
// on a fragment.  The weights sit in shared memory as bf16 in B-fragment
// order (one 8-byte load a lane a fragment); the one-wide layers (agg_w,
// sigma, weight.2) are float32 dot products over the accumulator fragment,
// finished by two shuffles within the quad of lanes that holds a row.
// Values are rounded to bf16 where the plain version rounds them (each
// layer's output, the sums of two layers, the softmax weights of the blend),
// and the Welford statistics and softmaxes run in float32.  Each tile's frd,
// payload and vox rows are contiguous byte runs of the (V, N, C) slabs: 16-
// byte cp.async copies them into the warp's stage, double-buffered across
// the persistent loop; feat goes out through the same stage as coalesced
// 16-byte stores.  Roundings go two values to one paired conversion.  One
// block of 12 warps an SM: the stages (15 KB a warp) and the registers
// (65,536 / 384 threads) hold no more, and the kernel is bound by issue and
// latency, not by its bytes, so warps an SM move its time most.
//
// Interface: plain C, loaded with ctypes; launches on the caller's stream
// and returns the cudaError_t of the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <math.h>

namespace {

// Widths of the dtu_eval head.
constexpr int kF = 19;            // feature 16 + rgb 3
constexpr int kF4 = kF + 4;       // ++ ray difference
constexpr int kP = 31;            // payload: 2*2 member RGBs ++ feature ++ rgb
constexpr int kVox = 8;           // cost-volume feature
constexpr int kHid = 64;          // hidden width
constexpr int kG = 32;            // aggregation width
constexpr int kImg = 16;          // pooled image feature
constexpr int kW0sIn = kHid + kVox + kImg;  // shared part of weight.0
constexpr int kOut = kP + kVox;
constexpr int kMaxViews = 4;

constexpr int pad4(int n) { return (n + 3) / 4 * 4; }

// Packed weight layout (float32, row-major [out][in]); must match
// gdb_nerf_tpu_torch/kernels/bundle_head.py::pack_weights.
constexpr int OFF_VIEW_W = 0;
constexpr int OFF_VIEW_B = OFF_VIEW_W + kF * 4;
constexpr int OFF_GPV_W = OFF_VIEW_B + kF;
constexpr int OFF_GVAR_W = OFF_GPV_W + kG * kF;
constexpr int OFF_GMEAN_W = OFF_GVAR_W + kG * kF;
constexpr int OFF_G_B = OFF_GMEAN_W + kG * kF;
constexpr int OFF_AGG_W = OFF_G_B + kG;
constexpr int OFF_AGG_B = OFF_AGG_W + kG;
constexpr int OFF_FC_W = OFF_AGG_B + 1;
constexpr int OFF_FC_B = OFF_FC_W + kImg * kG;
constexpr int OFF_LR0_W = OFF_FC_B + kImg;
constexpr int OFF_LR0_B = OFF_LR0_W + kHid * (kVox + kImg);
constexpr int OFF_SIG_W = OFF_LR0_B + kHid;
constexpr int OFF_SIG_B = OFF_SIG_W + kHid;
constexpr int OFF_W0S_W = OFF_SIG_B + 1;
constexpr int OFF_W0S_B = OFF_W0S_W + kHid * kW0sIn;
constexpr int OFF_W0V_W = OFF_W0S_B + kHid;
constexpr int OFF_W1_W = OFF_W0V_W + kHid * kF4;
constexpr int OFF_W1_B = OFF_W1_W + kHid;
constexpr int OFF_FH_W = OFF_W1_B + 1;
constexpr int OFF_FH_B = OFF_FH_W + kVox * kHid;
constexpr int kNumWeights = OFF_FH_B + kVox;
static_assert(kNumWeights == 11930, "dtu_eval head has 11,930 weights");

// A block of the pack ([rows][cols], contiguous) and where it is staged
// ([rows][ld], zero past cols).
struct Block {
  int src, rows, cols, dst, ld;
};

__device__ void stage_blocks(const float* __restrict__ w, float* dst, const Block* blocks,
                             int num_blocks) {
  for (int b = 0; b < num_blocks; ++b) {
    const Block k = blocks[b];
    for (int i = threadIdx.x; i < k.rows * k.ld; i += blockDim.x) {
      const int r = i / k.ld, c = i - r * k.ld;
      dst[k.dst + i] = c < k.cols ? w[k.src + r * k.cols + c] : 0.f;
    }
  }
}

__device__ __forceinline__ float relu(float v) { return fmaxf(v, 0.f); }
__device__ __forceinline__ float softplus(float v) { return fmaxf(v, 0.f) + log1pf(expf(-fabsf(v))); }

// ======================= float32: one thread per sample =======================

constexpr int kBlock = 128;
constexpr int kRows = 4;          // output rows per step of the rolled layers
// Staged layout (floats): every row padded to LD_* = pad4(in), every block
// at a multiple of 4 floats.
constexpr int LD_VIEW = 4;
constexpr int LD_G = pad4(kF);
constexpr int LD_FC = kG;
constexpr int LD_LR0 = kVox + kImg;   // [vox, img]
constexpr int LD_W0S = kW0sIn;        // [x, vox, img]
constexpr int LD_W0V = pad4(kF4);
constexpr int LD_FH = kHid;
constexpr int S_VIEW_W = 0;
constexpr int S_VIEW_B = S_VIEW_W + kF * LD_VIEW;
constexpr int S_GPV_W = S_VIEW_B + pad4(kF);
constexpr int S_GVAR_W = S_GPV_W + kG * LD_G;
constexpr int S_GMEAN_W = S_GVAR_W + kG * LD_G;
constexpr int S_G_B = S_GMEAN_W + kG * LD_G;
constexpr int S_AGG_W = S_G_B + kG;
constexpr int S_AGG_B = S_AGG_W + kG;
constexpr int S_FC_W = S_AGG_B + 4;
constexpr int S_FC_B = S_FC_W + kImg * LD_FC;
constexpr int S_LR0_W = S_FC_B + kImg;
constexpr int S_LR0_B = S_LR0_W + kHid * LD_LR0;
constexpr int S_SIG_W = S_LR0_B + kHid;
constexpr int S_SIG_B = S_SIG_W + kHid;
constexpr int S_W0S_W = S_SIG_B + 4;
constexpr int S_W0S_B = S_W0S_W + kHid * LD_W0S;
constexpr int S_W0V_W = S_W0S_B + kHid;
constexpr int S_W1_W = S_W0V_W + kHid * LD_W0V;
constexpr int S_W1_B = S_W1_W + kHid;
constexpr int S_FH_W = S_W1_B + 4;
constexpr int S_FH_B = S_FH_W + kVox * LD_FH;
constexpr int kStagedF32 = S_FH_B + kVox;
static_assert(kHid % kRows == 0 && kG % kRows == 0, "rolled layers step kRows rows");
static_assert(2 * kG <= kHid, "the column holds the shared half and gf_v");
static_assert(LD_LR0 % 4 == 0 && LD_W0S % 4 == 0 && kVox % 4 == 0 && kHid % 4 == 0,
              "input blocks start on a float4");

constexpr int kNumF32Blocks = 21;
__constant__ Block kF32Blocks[kNumF32Blocks] = {
    {OFF_VIEW_W, kF, 4, S_VIEW_W, LD_VIEW},    {OFF_VIEW_B, 1, kF, S_VIEW_B, pad4(kF)},
    {OFF_GPV_W, kG, kF, S_GPV_W, LD_G},        {OFF_GVAR_W, kG, kF, S_GVAR_W, LD_G},
    {OFF_GMEAN_W, kG, kF, S_GMEAN_W, LD_G},    {OFF_G_B, 1, kG, S_G_B, kG},
    {OFF_AGG_W, 1, kG, S_AGG_W, kG},           {OFF_AGG_B, 1, 1, S_AGG_B, 4},
    {OFF_FC_W, kImg, kG, S_FC_W, LD_FC},       {OFF_FC_B, 1, kImg, S_FC_B, kImg},
    {OFF_LR0_W, kHid, kVox + kImg, S_LR0_W, LD_LR0}, {OFF_LR0_B, 1, kHid, S_LR0_B, kHid},
    {OFF_SIG_W, 1, kHid, S_SIG_W, kHid},       {OFF_SIG_B, 1, 1, S_SIG_B, 4},
    {OFF_W0S_W, kHid, kW0sIn, S_W0S_W, LD_W0S}, {OFF_W0S_B, 1, kHid, S_W0S_B, kHid},
    {OFF_W0V_W, kHid, kF4, S_W0V_W, LD_W0V},   {OFF_W1_W, 1, kHid, S_W1_W, kHid},
    {OFF_W1_B, 1, 1, S_W1_B, 4},               {OFF_FH_W, kVox, kHid, S_FH_W, LD_FH},
    {OFF_FH_B, 1, kVox, S_FH_B, kVox},
};
// Shared memory: the staged weights, then kHid floats per thread
// ([row][thread], conflict-free): global_fc's shared half and gf_v, later hs.
constexpr size_t kSmemF32 = (kStagedF32 + kHid * kBlock) * sizeof(float);

// Element j of x (IN values), for the unrolled float4 steps.
template <int IN>
__device__ __forceinline__ float elem(const float (&x)[IN], int j) {
  return x[j < IN ? j : IN - 1];
}

// y[o] += sum_i w[o * LD + i] * x[i]: float4 loads along a padded row.
template <int OUT, int IN, int LD>
__device__ __forceinline__ void matvec4(const float* w, const float (&x)[IN], float (&y)[OUT]) {
  static_assert(LD % 4 == 0 && IN <= LD, "rows are padded to a float4");
#pragma unroll
  for (int o = 0; o < OUT; ++o) {
    float acc = y[o];
#pragma unroll
    for (int i = 0; i < IN; i += 4) {
      const float4 q = *reinterpret_cast<const float4*>(w + o * LD + i);
      acc = fmaf(q.x, x[i], acc);
      if (i + 1 < IN) acc = fmaf(q.y, elem(x, i + 1), acc);
      if (i + 2 < IN) acc = fmaf(q.z, elem(x, i + 2), acc);
      if (i + 3 < IN) acc = fmaf(q.w, elem(x, i + 3), acc);
    }
    y[o] = acc;
  }
}

// acc[r] += sum_i w[r * LD + i] * x[i] for R consecutive rows: R chains.
template <int R, int IN, int LD>
__device__ __forceinline__ void rows4(const float* w, const float (&x)[IN], float (&acc)[R]) {
  static_assert(LD % 4 == 0 && IN <= LD, "rows are padded to a float4");
#pragma unroll
  for (int i = 0; i < IN; i += 4) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float4 q = *reinterpret_cast<const float4*>(w + r * LD + i);
      acc[r] = fmaf(q.x, x[i], acc[r]);
      if (i + 1 < IN) acc[r] = fmaf(q.y, elem(x, i + 1), acc[r]);
      if (i + 2 < IN) acc[r] = fmaf(q.z, elem(x, i + 2), acc[r]);
      if (i + 3 < IN) acc[r] = fmaf(q.w, elem(x, i + 3), acc[r]);
    }
  }
}

template <int N>
__device__ __forceinline__ void init(float (&y)[N], const float* b) {
#pragma unroll
  for (int i = 0; i < N; ++i) y[i] = b[i];
}

template <int N>
__device__ __forceinline__ void load_row(float (&y)[N], const float* p) {
#pragma unroll
  for (int i = 0; i < N; ++i) y[i] = p[i];
}

// ifr = frd[:F] + relu(view_fc(frd[F:F+4])) for one view's row.
__device__ __forceinline__ void view_features(const float* sw, const float* row, float (&ifr)[kF]) {
  float rd[4];
  load_row(rd, row + kF);
  float h[kF];
  init(h, sw + S_VIEW_B);
  matvec4<kF, 4, LD_VIEW>(sw + S_VIEW_W, rd, h);
#pragma unroll
  for (int i = 0; i < kF; ++i) ifr[i] = row[i] + relu(h[i]);
}

__device__ void head_sample_f32(const float* sw, const float* __restrict__ vox,
                                const float* __restrict__ payload, const float* __restrict__ frd,
                                float* __restrict__ sigma_out, float* __restrict__ feat_out,
                                long long n, int num_views, long long s, float* col) {
  // --- view aggregation: Welford mean / M2 over views ---
  float mean[kF], m2[kF];
#pragma unroll
  for (int i = 0; i < kF; ++i) mean[i] = m2[i] = 0.f;
#pragma unroll 1
  for (int v = 0; v < num_views; ++v) {
    float ifr[kF];
    view_features(sw, frd + (v * n + s) * kF4, ifr);
    const float inv_k = 1.f / (v + 1);
#pragma unroll
    for (int i = 0; i < kF; ++i) {
      const float d = ifr[i] - mean[i];
      mean[i] += d * inv_k;
      m2[i] += d * (ifr[i] - mean[i]);
    }
  }
  {
    const float inv_dof = 1.f / (num_views > 1 ? num_views - 1 : 1);
    float var[kF];
#pragma unroll
    for (int i = 0; i < kF; ++i) var[i] = m2[i] * inv_dof;
    float shared_g[kG];
    init(shared_g, sw + S_G_B);
    matvec4<kG, kF, LD_G>(sw + S_GVAR_W, var, shared_g);
    matvec4<kG, kF, LD_G>(sw + S_GMEAN_W, mean, shared_g);
#pragma unroll
    for (int i = 0; i < kG; ++i) col[i * kBlock] = shared_g[i];
  }
  // Online softmax over views of relu(agg_w gf_v), pooling gf_v.  gf_v goes
  // to the column beside the shared half, kRows rows a step, so that the
  // per-view layer's loads are not all in flight beside pooled.
  float pooled[kG];
#pragma unroll
  for (int i = 0; i < kG; ++i) pooled[i] = 0.f;
  float run_max = -INFINITY, denom = 0.f;
#pragma unroll 1
  for (int v = 0; v < num_views; ++v) {
    float ifr[kF];
    view_features(sw, frd + (v * n + s) * kF4, ifr);
    float logit = sw[S_AGG_B];
#pragma unroll 1
    for (int o = 0; o < kG; o += kRows) {
      float gf[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) gf[r] = col[(o + r) * kBlock];
      rows4<kRows, kF, LD_G>(sw + S_GPV_W + o * LD_G, ifr, gf);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        gf[r] = relu(gf[r]);
        logit = fmaf(sw[S_AGG_W + o + r], gf[r], logit);
        col[(kG + o + r) * kBlock] = gf[r];
      }
    }
    logit = relu(logit);
    const float new_max = fmaxf(run_max, logit);
    const float rescale = expf(run_max - new_max);
    const float e = expf(logit - new_max);
    denom = denom * rescale + e;
#pragma unroll
    for (int i = 0; i < kG; ++i) pooled[i] = fmaf(e, col[(kG + i) * kBlock], pooled[i] * rescale);
    run_max = new_max;
  }
  float img[kImg];
  {
    const float inv = 1.f / denom;
#pragma unroll
    for (int i = 0; i < kG; ++i) pooled[i] *= inv;
    init(img, sw + S_FC_B);
    matvec4<kImg, kG, LD_FC>(sw + S_FC_W, pooled, img);
#pragma unroll
    for (int i = 0; i < kImg; ++i) img[i] = relu(img[i]);
  }

  // --- density and the feature head ---
  float vx[kVox];
  load_row(vx, vox + s * kVox);
  float x[kHid];
  init(x, sw + S_LR0_B);
  matvec4<kHid, kVox, LD_LR0>(sw + S_LR0_W, vx, x);
  matvec4<kHid, kImg, LD_LR0>(sw + S_LR0_W + kVox, img, x);
  float sg = sw[S_SIG_B];
#pragma unroll
  for (int i = 0; i < kHid; ++i) {
    x[i] = relu(x[i]);
    sg = fmaf(sw[S_SIG_W + i], x[i], sg);
  }
  sigma_out[s] = softplus(sg);
  float* out = feat_out + s * kOut;
  {
    float extra[kVox];
    init(extra, sw + S_FH_B);
    matvec4<kVox, kHid, LD_FH>(sw + S_FH_W, x, extra);
#pragma unroll
    for (int i = 0; i < kVox; ++i) out[kP + i] = relu(extra[i]);
  }

  // --- the shared half of weight.0 into this thread's column ---
#pragma unroll 1
  for (int o = 0; o < kHid; o += kRows) {
    float acc[kRows];
    init(acc, sw + S_W0S_B + o);
    const float* w = sw + S_W0S_W + o * LD_W0S;
    rows4<kRows, kHid, LD_W0S>(w, x, acc);
    rows4<kRows, kVox, LD_W0S>(w + kHid, vx, acc);
    rows4<kRows, kImg, LD_W0S>(w + kHid + kVox, img, acc);
#pragma unroll
    for (int r = 0; r < kRows; ++r) col[(o + r) * kBlock] = acc[r];
  }

  // --- payload blend: online softmax over views of relu(w1 h_v) ---
  float blended[kP];
#pragma unroll
  for (int i = 0; i < kP; ++i) blended[i] = 0.f;
  run_max = -INFINITY;
  denom = 0.f;
#pragma unroll 1
  for (int v = 0; v < num_views; ++v) {
    float f[kF4];
    load_row(f, frd + (v * n + s) * kF4);
    float logit = sw[S_W1_B];
#pragma unroll 1
    for (int o = 0; o < kHid; o += kRows) {
      float acc[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = col[(o + r) * kBlock];
      rows4<kRows, kF4, LD_W0V>(sw + S_W0V_W + o * LD_W0V, f, acc);
#pragma unroll
      for (int r = 0; r < kRows; ++r) logit = fmaf(sw[S_W1_W + o + r], relu(acc[r]), logit);
    }
    logit = relu(logit);
    const float new_max = fmaxf(run_max, logit);
    const float rescale = expf(run_max - new_max);
    const float e = expf(logit - new_max);
    denom = denom * rescale + e;
    const float* p = payload + (v * n + s) * kP;
#pragma unroll
    for (int i = 0; i < kP; ++i) blended[i] = fmaf(e, p[i], blended[i] * rescale);
    run_max = new_max;
  }
  const float inv = 1.f / denom;
#pragma unroll
  for (int i = 0; i < kP; ++i) out[i] = blended[i] * inv;
}

__global__ void __launch_bounds__(kBlock)
bundle_head_f32_kernel(const float* __restrict__ weights, const float* __restrict__ vox,
                       const float* __restrict__ payload, const float* __restrict__ frd,
                       float* __restrict__ sigma_out, float* __restrict__ feat_out, int n,
                       int num_views) {
  extern __shared__ float4 smem_f32[];
  float* sw = reinterpret_cast<float*>(smem_f32);
  stage_blocks(weights, sw, kF32Blocks, kNumF32Blocks);
  __syncthreads();
  const int num_tiles = (n + kBlock - 1) / kBlock;
  for (int tile = blockIdx.x; tile < num_tiles; tile += gridDim.x) {
    const long long s = static_cast<long long>(tile) * kBlock + threadIdx.x;
    if (s < n)
      head_sample_f32(sw, vox, payload, frd, sigma_out, feat_out, n, num_views, s,
                      sw + kStagedF32 + threadIdx.x);
  }
}

// ================ bf16: a warp per 16 samples on the tensor cores ================

constexpr int kWarps = 12;        // warps per block: one block an SM (shared memory, registers)
constexpr int kTile = 16;         // samples per warp tile: the mma's M
// Tensor-core layers: K tiles of 16 inputs, N tiles of 8 outputs.  A layer's
// fragment (nt, kt) is B fragment FT_* + nt * KT_* + kt.
constexpr int KT_VIEW = 1;
constexpr int NT_VIEW = 3;
constexpr int KT_G = 2;
constexpr int NT_G = 4;
constexpr int KT_FC = 2;
constexpr int NT_FC = 2;
constexpr int KT_LR0 = 2;
constexpr int NT_LR0 = 8;
constexpr int KT_FH = 4;
constexpr int NT_FH = 1;
constexpr int KT_W0S = 6;
constexpr int NT_W0S = 8;
constexpr int KT_W0V = 2;
constexpr int NT_W0V = 8;
constexpr int FT_VIEW = 0;
constexpr int FT_GPV = FT_VIEW + KT_VIEW * NT_VIEW;
constexpr int FT_GVAR = FT_GPV + KT_G * NT_G;
constexpr int FT_GMEAN = FT_GVAR + KT_G * NT_G;
constexpr int FT_FC = FT_GMEAN + KT_G * NT_G;
constexpr int FT_LR0 = FT_FC + KT_FC * NT_FC;
constexpr int FT_FH = FT_LR0 + KT_LR0 * NT_LR0;
constexpr int FT_W0S = FT_FH + KT_FH * NT_FH;
constexpr int FT_W0V = FT_W0S + KT_W0S * NT_W0S;
constexpr int kNumFrags = FT_W0V + KT_W0V * NT_W0V;
// Input order of the two concatenating layers (the K index of each block).
constexpr int LR0_K_IMG = 0;
constexpr int LR0_K_VOX = LR0_K_IMG + kImg;
constexpr int W0S_K_X = 0;
constexpr int W0S_K_IMG = W0S_K_X + kHid;
constexpr int W0S_K_VOX = W0S_K_IMG + kImg;
static_assert(KT_VIEW * 16 >= 4 && NT_VIEW * 8 >= kF && KT_G * 16 >= kF && NT_G * 8 == kG &&
                  KT_FC * 16 == kG && NT_FC * 8 == kImg && KT_LR0 * 16 >= LR0_K_VOX + kVox &&
                  NT_LR0 * 8 == kHid && KT_FH * 16 == kHid && NT_FH * 8 == kVox &&
                  KT_W0S * 16 >= W0S_K_VOX + kVox && NT_W0S * 8 == kHid && KT_W0V * 16 >= kF4 &&
                  NT_W0V * 8 == kHid,
              "padded layer shapes");
// float32 vectors (biases, one-wide layers) after the fragments.
constexpr int V_VIEW_B = 0;
constexpr int V_G_B = V_VIEW_B + NT_VIEW * 8;
constexpr int V_AGG_W = V_G_B + kG;
constexpr int V_AGG_B = V_AGG_W + kG;
constexpr int V_FC_B = V_AGG_B + 4;
constexpr int V_LR0_B = V_FC_B + kImg;
constexpr int V_SIG_W = V_LR0_B + kHid;
constexpr int V_SIG_B = V_SIG_W + kHid;
constexpr int V_W0S_B = V_SIG_B + 4;
constexpr int V_W1_W = V_W0S_B + kHid;
constexpr int V_W1_B = V_W1_W + kHid;
constexpr int V_FH_B = V_W1_B + 4;
constexpr int kNumVec = V_FH_B + kVox;
constexpr int kNumVecBlocks = 12;
__constant__ Block kVecBlocks[kNumVecBlocks] = {
    {OFF_VIEW_B, 1, kF, V_VIEW_B, NT_VIEW * 8}, {OFF_G_B, 1, kG, V_G_B, kG},
    {OFF_AGG_W, 1, kG, V_AGG_W, kG},            {OFF_AGG_B, 1, 1, V_AGG_B, 4},
    {OFF_FC_B, 1, kImg, V_FC_B, kImg},          {OFF_LR0_B, 1, kHid, V_LR0_B, kHid},
    {OFF_SIG_W, 1, kHid, V_SIG_W, kHid},        {OFF_SIG_B, 1, 1, V_SIG_B, 4},
    {OFF_W0S_B, 1, kHid, V_W0S_B, kHid},        {OFF_W1_W, 1, kHid, V_W1_W, kHid},
    {OFF_W1_B, 1, 1, V_W1_B, 4},                {OFF_FH_B, 1, kVox, V_FH_B, kVox},
};
// A warp's stage: for each view the tile's frd rows, then for each view its
// payload rows, then the vox rows, each run copied in 16-byte pieces from the
// 16-byte boundary at or below its first byte (so a run takes up to 15 bytes
// more).  Two stages a warp.  The first kMaxViews * kFrdRun bytes of a stage
// hold the tile's feat rows on the way out (16 * 78 bytes).
constexpr int kFrdRun = 768;
constexpr int kPayRun = 1024;
constexpr int kVoxRun = 288;
constexpr int kStageBytes = kMaxViews * (kFrdRun + kPayRun) + kVoxRun;
static_assert(kFrdRun >= kTile * kF4 * 2 + 30 && kPayRun >= kTile * kP * 2 + 30 &&
                  kVoxRun >= kTile * kVox * 2 + 30 && kFrdRun % 16 == 0 && kPayRun % 16 == 0 &&
                  kMaxViews * kFrdRun >= kTile * kOut * 2,
              "stage runs hold a tile");
constexpr size_t kSmemBf16 =
    kNumFrags * 256 + kNumVec * sizeof(float) + 2 * kWarps * static_cast<size_t>(kStageBytes);
static_assert((kNumFrags * 256 + kNumVec * sizeof(float)) % 16 == 0, "stages start on 16 bytes");

typedef __nv_bfloat16 bf16;


__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ float2 unpack(uint32_t u) {
  return make_float2(__uint_as_float(u << 16), __uint_as_float(u & 0xffff0000u));
}

// d += a (16x16, row) * b (16x8, col): bf16 operands, float32 accumulation.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint2 b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void cp_async_wait1() { asm volatile("cp.async.wait_group 1;\n" ::: "memory"); }

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// The pack's weight of layer fragment tile ``ft`` at padded output n and
// padded (permuted) input k; zero in the padding.
__device__ float frag_weight(const float* __restrict__ w, int ft, int n, int k) {
  if (ft < FT_GPV) return n < kF && k < 4 ? w[OFF_VIEW_W + n * 4 + k] : 0.f;
  if (ft < FT_FC) {
    const int off = ft < FT_GVAR ? OFF_GPV_W : ft < FT_GMEAN ? OFF_GVAR_W : OFF_GMEAN_W;
    return k < kF ? w[off + n * kF + k] : 0.f;
  }
  if (ft < FT_LR0) return w[OFF_FC_W + n * kG + k];
  if (ft < FT_FH) {  // pack columns [vox, img]
    if (k >= LR0_K_IMG && k < LR0_K_IMG + kImg) return w[OFF_LR0_W + n * (kVox + kImg) + kVox + k - LR0_K_IMG];
    if (k >= LR0_K_VOX && k < LR0_K_VOX + kVox) return w[OFF_LR0_W + n * (kVox + kImg) + k - LR0_K_VOX];
    return 0.f;
  }
  if (ft < FT_W0S) return w[OFF_FH_W + n * kHid + k];
  if (ft < FT_W0V) {  // pack columns [x, vox, img]
    if (k < W0S_K_X + kHid) return w[OFF_W0S_W + n * kW0sIn + k - W0S_K_X];
    if (k >= W0S_K_IMG && k < W0S_K_IMG + kImg) return w[OFF_W0S_W + n * kW0sIn + kHid + kVox + k - W0S_K_IMG];
    if (k >= W0S_K_VOX && k < W0S_K_VOX + kVox) return w[OFF_W0S_W + n * kW0sIn + kHid + k - W0S_K_VOX];
    return 0.f;
  }
  return k < kF4 ? w[OFF_W0V_W + n * kF4 + k] : 0.f;
}

__device__ __forceinline__ int frag_base(int ft, int* kt_count) {
  const int starts[] = {FT_VIEW, FT_GPV, FT_GVAR, FT_GMEAN, FT_FC, FT_LR0, FT_FH, FT_W0S, FT_W0V};
  const int kts[] = {KT_VIEW, KT_G, KT_G, KT_G, KT_FC, KT_LR0, KT_FH, KT_W0S, KT_W0V};
  int base = 0, kt = KT_VIEW;
#pragma unroll
  for (int i = 0; i < 9; ++i)
    if (ft >= starts[i]) base = starts[i], kt = kts[i];
  *kt_count = kt;
  return base;
}

// Every B fragment as bf16, in the lane order of mma's B operand: lane (g, t)
// holds rows k = 2t, 2t + 1 (register 0) and 2t + 8, 2t + 9 (register 1) of
// column n = g.  Exact for a head whose weights are bf16 values.
__device__ void stage_fragments(const float* __restrict__ w, uint32_t* frags) {
  for (int i = threadIdx.x; i < kNumFrags * 64; i += blockDim.x) {
    const int ft = i >> 6, lane = (i >> 1) & 31, reg = i & 1;
    int kt_count;
    const int base = frag_base(ft, &kt_count);
    const int nt = (ft - base) / kt_count, kt = (ft - base) - nt * kt_count;
    const int n = nt * 8 + (lane >> 2), k = kt * 16 + 2 * (lane & 3) + 8 * reg;
    frags[i] = pack(frag_weight(w, ft, n, k), frag_weight(w, ft, n, k + 1));
  }
}

__device__ __forceinline__ uint32_t ld_shared_u16(uint32_t addr) {
  unsigned short v;
  asm volatile("ld.shared.u16 %0, [%1];\n" : "=h"(v) : "r"(addr));
  return v;
}

// A staged run of rows W elements wide, seen from one lane (g, t): the
// elements of rows g and g + 8 from column 2t on, at offsets known when
// compiling (no per-element address arithmetic), through a 32-bit
// shared-memory address.  ``at(h, j)`` is row g + 8h, column 2t + j; zero
// past the row.
template <int W>
struct Run {
  uint32_t q;  // row g, column 2t
  int t;
  __device__ __forceinline__ uint32_t raw(int h, int j) const {
    return j < W - 2 * t ? ld_shared_u16(q + 2 * (h * 8 * W + j)) : 0u;
  }
  __device__ __forceinline__ float at(int h, int j) const { return __uint_as_float(raw(h, j) << 16); }
  // Columns 2t + j, 2t + j + 1 of row g + 8h as an A-fragment register.
  __device__ __forceinline__ uint32_t pair(int h, int j) const { return raw(h, j) | (raw(h, j + 1) << 16); }
};

template <int W>
__device__ __forceinline__ Run<W> run_at(const char* stage_run, const bf16* first, int g, int t) {
  const int lead = static_cast<int>(reinterpret_cast<uintptr_t>(first) & 15);
  const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(stage_run));
  return Run<W>{base + lead + 2 * (g * W + 2 * t), t};
}

// The 16-byte pieces that cover [begin, end) into dst.
__device__ __forceinline__ void copy_run(char* dst, const bf16* begin, const bf16* end, int lane) {
  const uintptr_t a0 = reinterpret_cast<uintptr_t>(begin) & ~uintptr_t(15);
  const uintptr_t a1 = (reinterpret_cast<uintptr_t>(end) + 15) & ~uintptr_t(15);
  const int pieces = static_cast<int>((a1 - a0) >> 4);
  for (int c = lane; c < pieces; c += 32)
    cp_async16(dst + 16 * c, reinterpret_cast<const void*>(a0 + 16 * static_cast<uintptr_t>(c)));
}

struct Bf16Args {
  const bf16* vox;
  const bf16* payload;
  const bf16* frd;
  float* sigma;
  bf16* feat;
  int n, num_views;
};

__device__ void load_tile(const Bf16Args& a, char* stage, long long s0, int lane) {
  const int rows = static_cast<int>(min(static_cast<long long>(kTile), a.n - s0));
  for (int v = 0; v < a.num_views; ++v) {
    const bf16* f = a.frd + (v * static_cast<long long>(a.n) + s0) * kF4;
    copy_run(stage + v * kFrdRun, f, f + rows * kF4, lane);
    const bf16* p = a.payload + (v * static_cast<long long>(a.n) + s0) * kP;
    copy_run(stage + kMaxViews * kFrdRun + v * kPayRun, p, p + rows * kP, lane);
  }
  copy_run(stage + kMaxViews * (kFrdRun + kPayRun), a.vox + s0 * kVox, a.vox + (s0 + rows) * kVox,
           lane);
  cp_async_commit();
}

// The bf16 A fragment (m16k16) of K tile kt from C-layout values c[nt][4]
// (rows g, g + 8; columns 8 nt + 2t, + 1); N tiles past NT are zero.
template <int NT>
__device__ __forceinline__ void to_a(const float (&c)[NT][4], int kt, uint32_t (&a)[4]) {
  const int j0 = 2 * kt, j1 = 2 * kt + 1;
  a[0] = j0 < NT ? pack(c[j0 < NT ? j0 : 0][0], c[j0 < NT ? j0 : 0][1]) : 0u;
  a[1] = j0 < NT ? pack(c[j0 < NT ? j0 : 0][2], c[j0 < NT ? j0 : 0][3]) : 0u;
  a[2] = j1 < NT ? pack(c[j1 < NT ? j1 : 0][0], c[j1 < NT ? j1 : 0][1]) : 0u;
  a[3] = j1 < NT ? pack(c[j1 < NT ? j1 : 0][2], c[j1 < NT ? j1 : 0][3]) : 0u;
}

// x, y rounded to bf16 in place with one paired conversion; returns the pair.
__device__ __forceinline__ uint32_t round2(float& x, float& y) {
  const uint32_t u = pack(x, y);
  x = __uint_as_float(u << 16);
  y = __uint_as_float(u & 0xffff0000u);
  return u;
}

// A C fragment rounded to bf16: rows g and g + 8.
__device__ __forceinline__ void round4(float (&c)[4]) {
  round2(c[0], c[1]);
  round2(c[2], c[3]);
}

__device__ __forceinline__ uint2 frag(const uint32_t* frags, int ft, int lane) {
  return reinterpret_cast<const uint2*>(frags)[ft * 32 + lane];
}

__device__ __forceinline__ void bias_init(float (&acc)[4], const float* b) {
  const float2 q = *reinterpret_cast<const float2*>(b);
  acc[0] = acc[2] = q.x;
  acc[1] = acc[3] = q.y;
}

// ifr = round(frd[:F] + relu(round(view_fc(rd)))) of one view, C layout over
// N tiles 0..2 (zero past F).
__device__ __forceinline__ void view_features_mma(const Run<kF4>& f, const uint32_t* frags,
                                                  const float* sv, int t, int lane,
                                                  float (&ifr)[NT_VIEW][4]) {
  uint32_t a[4];
  a[0] = f.pair(0, kF);  // rd: columns F + 2t, + 1; zero for t >= 2
  a[1] = f.pair(1, kF);
  a[2] = a[3] = 0u;
  const int flim = kF - 2 * t;
#pragma unroll
  for (int nt = 0; nt < NT_VIEW; ++nt) {
    float acc[4];
    bias_init(acc, sv + V_VIEW_B + nt * 8 + 2 * t);
    mma(acc, a, frag(frags, FT_VIEW + nt, lane));
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[e] = relu(acc[e]);
    round4(acc);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = nt * 8 + (e & 1);
      ifr[nt][e] = j < flim ? f.at(e >> 1, j) + acc[e] : 0.f;
    }
    round4(ifr[nt]);
  }
}

__device__ void head_tile_bf16(const Bf16Args& a, const char* stage, char* out_stage,
                               const uint32_t* frags, const float* sv, long long s0, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const int V = a.num_views;
  Run<kF4> frd[kMaxViews];
  Run<kP> pay[kMaxViews];
#pragma unroll
  for (int v = 0; v < kMaxViews; ++v) {
    const int vv = v < V ? v : 0;
    frd[v] = run_at<kF4>(stage + v * kFrdRun,
                         a.frd + (vv * static_cast<long long>(a.n) + s0) * kF4, g, t);
    pay[v] = run_at<kP>(stage + kMaxViews * kFrdRun + v * kPayRun,
                        a.payload + (vv * static_cast<long long>(a.n) + s0) * kP, g, t);
  }
  const Run<kVox> vox =
      run_at<kVox>(stage + kMaxViews * (kFrdRun + kPayRun), a.vox + s0 * kVox, g, t);

  // --- view aggregation: Welford statistics, then global_fc's shared half ---
  float mean[NT_VIEW][4] = {}, m2[NT_VIEW][4] = {};
#pragma unroll
  for (int v = 0; v < kMaxViews; ++v) {
    if (v >= V) break;
    float ifr[NT_VIEW][4];
    view_features_mma(frd[v], frags, sv, t, lane, ifr);
    const float inv_k = 1.f / (v + 1);
#pragma unroll
    for (int j = 0; j < NT_VIEW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float d = ifr[j][e] - mean[j][e];
        mean[j][e] += d * inv_k;
        m2[j][e] += d * (ifr[j][e] - mean[j][e]);
      }
  }
  float shared_g[NT_G][4];
  {
    const float inv_dof = 1.f / (V > 1 ? V - 1 : 1);
#pragma unroll
    for (int j = 0; j < NT_VIEW; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) m2[j][e] *= inv_dof;  // the variance
      round4(mean[j]);
      round4(m2[j]);
    }
    uint32_t a_var[KT_G][4], a_mean[KT_G][4];
#pragma unroll
    for (int kt = 0; kt < KT_G; ++kt) {
      to_a(m2, kt, a_var[kt]);
      to_a(mean, kt, a_mean[kt]);
    }
#pragma unroll
    for (int nt = 0; nt < NT_G; ++nt) {
      float acc_var[4] = {}, acc_mean[4];
      bias_init(acc_mean, sv + V_G_B + nt * 8 + 2 * t);
#pragma unroll
      for (int kt = 0; kt < KT_G; ++kt) {
        mma(acc_var, a_var[kt], frag(frags, FT_GVAR + nt * KT_G + kt, lane));
        mma(acc_mean, a_mean[kt], frag(frags, FT_GMEAN + nt * KT_G + kt, lane));
      }
      round4(acc_var);
      round4(acc_mean);
#pragma unroll
      for (int e = 0; e < 4; ++e) shared_g[nt][e] = acc_var[e] + acc_mean[e];
      round4(shared_g[nt]);
    }
  }
  // Online softmax over views of relu(agg_w gf_v), pooling gf_v (float32).
  float pooled[NT_G][4] = {};
  float run_max[2] = {-INFINITY, -INFINITY}, denom[2] = {0.f, 0.f};
#pragma unroll
  for (int v = 0; v < kMaxViews; ++v) {
    if (v >= V) break;
    uint32_t a_ifr[KT_G][4];  // recomputed: kept from the first pass it costs 12 warps an SM
    {
      float ifr[NT_VIEW][4];
      view_features_mma(frd[v], frags, sv, t, lane, ifr);
#pragma unroll
      for (int kt = 0; kt < KT_G; ++kt) to_a(ifr, kt, a_ifr[kt]);
    }
    float gf[NT_G][4];
    float part[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < NT_G; ++nt) {
      float acc[4] = {};
#pragma unroll
      for (int kt = 0; kt < KT_G; ++kt)
        mma(acc, a_ifr[kt], frag(frags, FT_GPV + nt * KT_G + kt, lane));
      round4(acc);
#pragma unroll
      for (int e = 0; e < 4; ++e) gf[nt][e] = relu(acc[e] + shared_g[nt][e]);
      round4(gf[nt]);
      const float2 w = *reinterpret_cast<const float2*>(sv + V_AGG_W + nt * 8 + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) part[e >> 1] = fmaf(gf[nt][e], (e & 1) ? w.y : w.x, part[e >> 1]);
    }
    float logit[2] = {relu(quad_sum(part[0]) + sv[V_AGG_B]), relu(quad_sum(part[1]) + sv[V_AGG_B])};
    round2(logit[0], logit[1]);
    float e_h[2], rescale[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float new_max = fmaxf(run_max[h], logit[h]);
      rescale[h] = expf(run_max[h] - new_max);
      e_h[h] = expf(logit[h] - new_max);
      denom[h] = denom[h] * rescale[h] + e_h[h];
      run_max[h] = new_max;
    }
#pragma unroll
    for (int nt = 0; nt < NT_G; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        pooled[nt][e] = fmaf(e_h[e >> 1], gf[nt][e], pooled[nt][e] * rescale[e >> 1]);
  }
  uint32_t a_img[4];
  {
    const float inv[2] = {1.f / denom[0], 1.f / denom[1]};
#pragma unroll
    for (int nt = 0; nt < NT_G; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) pooled[nt][e] *= inv[e >> 1];
      round4(pooled[nt]);
    }
    float img[NT_FC][4];
#pragma unroll
    for (int nt = 0; nt < NT_FC; ++nt) {
      bias_init(img[nt], sv + V_FC_B + nt * 8 + 2 * t);
#pragma unroll
      for (int kt = 0; kt < KT_FC; ++kt) {
        uint32_t ap[4];
        to_a(pooled, kt, ap);
        mma(img[nt], ap, frag(frags, FT_FC + nt * KT_FC + kt, lane));
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) img[nt][e] = relu(img[nt][e]);
    }
    a_img[0] = pack(img[0][0], img[0][1]);  // rounds: img's first N tile, rows g and g + 8
    a_img[1] = pack(img[0][2], img[0][3]);
    a_img[2] = pack(img[1][0], img[1][1]);
    a_img[3] = pack(img[1][2], img[1][3]);
  }
  uint32_t a_vox[4];
  a_vox[0] = vox.pair(0, 0);
  a_vox[1] = vox.pair(1, 0);
  a_vox[2] = a_vox[3] = 0u;

  // --- density: x = relu(lr0 [img, vox]); sigma from x in float32 ---
  uint32_t a_x[KT_FH][4];
  float sig[2] = {0.f, 0.f};
#pragma unroll
  for (int nt = 0; nt < NT_LR0; ++nt) {
    float acc[4];
    bias_init(acc, sv + V_LR0_B + nt * 8 + 2 * t);
    mma(acc, a_img, frag(frags, FT_LR0 + nt * KT_LR0 + LR0_K_IMG / 16, lane));
    mma(acc, a_vox, frag(frags, FT_LR0 + nt * KT_LR0 + LR0_K_VOX / 16, lane));
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[e] = relu(acc[e]);
    a_x[nt >> 1][(nt & 1) * 2] = round2(acc[0], acc[1]);
    a_x[nt >> 1][(nt & 1) * 2 + 1] = round2(acc[2], acc[3]);
    const float2 w = *reinterpret_cast<const float2*>(sv + V_SIG_W + nt * 8 + 2 * t);
#pragma unroll
    for (int e = 0; e < 4; ++e) sig[e >> 1] = fmaf(acc[e], (e & 1) ? w.y : w.x, sig[e >> 1]);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float sg = softplus(quad_sum(sig[h]) + sv[V_SIG_B]);
    const long long s = s0 + g + 8 * h;
    if (t == 0 && s < a.n) a.sigma[s] = sg;
  }
  float extra[4];
  bias_init(extra, sv + V_FH_B + 2 * t);
#pragma unroll
  for (int kt = 0; kt < KT_FH; ++kt) mma(extra, a_x[kt], frag(frags, FT_FH + kt, lane));
  // --- hs = weight.0's shared half over [x, img, vox], kept as bf16 pairs ---
  uint32_t hs[NT_W0S][2];
#pragma unroll
  for (int nt = 0; nt < NT_W0S; ++nt) {
    float acc[4];
    bias_init(acc, sv + V_W0S_B + nt * 8 + 2 * t);
#pragma unroll
    for (int kt = 0; kt < kHid / 16; ++kt)
      mma(acc, a_x[kt], frag(frags, FT_W0S + nt * KT_W0S + W0S_K_X / 16 + kt, lane));
    mma(acc, a_img, frag(frags, FT_W0S + nt * KT_W0S + W0S_K_IMG / 16, lane));
    mma(acc, a_vox, frag(frags, FT_W0S + nt * KT_W0S + W0S_K_VOX / 16, lane));
    hs[nt][0] = pack(acc[0], acc[1]);
    hs[nt][1] = pack(acc[2], acc[3]);
  }
  // --- payload blend: logits of every view, then the softmax weights ---
  float logit[kMaxViews][2];
#pragma unroll
  for (int v = 0; v < kMaxViews; ++v) {
    if (v >= V) break;
    uint32_t a_f[KT_W0V][4];
#pragma unroll
    for (int kt = 0; kt < KT_W0V; ++kt) {
      a_f[kt][0] = frd[v].pair(0, kt * 16);
      a_f[kt][1] = frd[v].pair(1, kt * 16);
      a_f[kt][2] = frd[v].pair(0, kt * 16 + 8);
      a_f[kt][3] = frd[v].pair(1, kt * 16 + 8);
    }
    float part[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < NT_W0V; ++nt) {
      float acc[4] = {};
#pragma unroll
      for (int kt = 0; kt < KT_W0V; ++kt)
        mma(acc, a_f[kt], frag(frags, FT_W0V + nt * KT_W0V + kt, lane));
      round4(acc);
      const float2 h0 = unpack(hs[nt][0]), h1 = unpack(hs[nt][1]);
      float h[4] = {relu(h0.x + acc[0]), relu(h0.y + acc[1]), relu(h1.x + acc[2]),
                    relu(h1.y + acc[3])};
      round4(h);
      const float2 w = *reinterpret_cast<const float2*>(sv + V_W1_W + nt * 8 + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) part[e >> 1] = fmaf(h[e], (e & 1) ? w.y : w.x, part[e >> 1]);
    }
    logit[v][0] = relu(quad_sum(part[0]) + sv[V_W1_B]);
    logit[v][1] = relu(quad_sum(part[1]) + sv[V_W1_B]);
    round2(logit[v][0], logit[v][1]);
  }
  float wv[kMaxViews][2];
  {
    float m[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m[h] = logit[0][h];
#pragma unroll
      for (int v = 1; v < kMaxViews; ++v)
        if (v < V) m[h] = fmaxf(m[h], logit[v][h]);
#pragma unroll
      for (int v = 0; v < kMaxViews; ++v)
        if (v < V) sum[h] += (wv[v][h] = expf(logit[v][h] - m[h]));
    }
#pragma unroll
    for (int v = 0; v < kMaxViews; ++v)
      if (v < V) {
        wv[v][0] /= sum[0];
        wv[v][1] /= sum[1];
        round2(wv[v][0], wv[v][1]);
      }
  }
  // feat rows into the stage over the frd runs, which every lane has read.
  __syncwarp();
  unsigned short* out = reinterpret_cast<unsigned short*>(out_stage) + g * kOut + 2 * t;
  const int plim = kP - 2 * t;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float acc[2] = {0.f, 0.f};
#pragma unroll
      for (int v = 0; v < kMaxViews; ++v)
        if (v < V) {
          float p0 = pay[v].at(h, j * 8) * wv[v][h], p1 = pay[v].at(h, j * 8 + 1) * wv[v][h];
          round2(p0, p1);
          acc[0] += p0;
          acc[1] += p1;
        }
      const uint32_t u = pack(acc[0], acc[1]);
      if (j * 8 < plim) out[h * 8 * kOut + j * 8] = static_cast<unsigned short>(u);
      if (j * 8 + 1 < plim) out[h * 8 * kOut + j * 8 + 1] = static_cast<unsigned short>(u >> 16);
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const uint32_t u = pack(relu(extra[2 * h]), relu(extra[2 * h + 1]));
    out[h * 8 * kOut + kP] = static_cast<unsigned short>(u);
    out[h * 8 * kOut + kP + 1] = static_cast<unsigned short>(u >> 16);
  }
  __syncwarp();
  // The tile's feat rows are one contiguous run from a 16-byte boundary
  // (16 rows of 78 bytes; feat is 16-byte aligned): 16-byte stores, and
  // 2-byte ones for a ragged tail.
  const unsigned short* tile_out = reinterpret_cast<const unsigned short*>(out_stage);
  const int rows = static_cast<int>(min(static_cast<long long>(kTile), a.n - s0));
  const int bytes = rows * kOut * 2;
  char* dst = reinterpret_cast<char*>(a.feat + s0 * kOut);
  const int vec = bytes / 16;
  for (int c = lane; c < vec; c += 32)
    reinterpret_cast<uint4*>(dst)[c] = reinterpret_cast<const uint4*>(out_stage)[c];
  for (int c = vec * 8 + lane; c < bytes / 2; c += 32)
    reinterpret_cast<unsigned short*>(dst)[c] = tile_out[c];
}

__global__ void __launch_bounds__(kWarps * 32)
bundle_head_bf16_kernel(const float* __restrict__ weights, Bf16Args a) {
  extern __shared__ float4 smem_bf16[];
  uint32_t* frags = reinterpret_cast<uint32_t*>(smem_bf16);
  float* sv = reinterpret_cast<float*>(frags + kNumFrags * 64);
  stage_fragments(weights, frags);
  stage_blocks(weights, sv, kVecBlocks, kNumVecBlocks);
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  char* stages = reinterpret_cast<char*>(sv + kNumVec) + warp * 2 * kStageBytes;
  const int num_tiles = (a.n + kTile - 1) / kTile;
  const int stride = gridDim.x * kWarps;
  int tile = blockIdx.x * kWarps + warp, buf = 0;
  if (tile < num_tiles) load_tile(a, stages, static_cast<long long>(tile) * kTile, lane);
  for (; tile < num_tiles; tile += stride, buf ^= 1) {
    char* stage = stages + buf * kStageBytes;
    if (tile + stride < num_tiles)
      load_tile(a, stages + (buf ^ 1) * kStageBytes, static_cast<long long>(tile + stride) * kTile,
                lane);
    else
      cp_async_commit();  // an empty group keeps one group per tile in flight
    cp_async_wait1();
    __syncwarp();
    head_tile_bf16(a, stage, stage, frags, sv, static_cast<long long>(tile) * kTile, lane);
    __syncwarp();
  }
}

template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, size_t smem, int threads, int work_per_block, int n,
                   cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int device = 0, num_sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&num_sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem)) !=
      cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int blocks = (n + work_per_block - 1) / work_per_block;
  const int grid = blocks < num_sms * per_sm ? blocks : num_sms * per_sm;
  kernel<<<grid, threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace

extern "C" int bundle_head_num_weights() { return kNumWeights; }

// Returns a cudaError_t; cudaErrorInvalidValue for widths or view counts the
// kernel was not compiled for, or a bf16 feat not 16-byte aligned.
extern "C" int bundle_head_forward(const void* weights, const void* vox, const void* payload,
                                   const void* frd, void* sigma, void* feat, int n, int num_views,
                                   int feat_rgb_dim, int payload_dim, int voxel_dim, int hidden_dim,
                                   int is_bf16, void* stream) {
  if (feat_rgb_dim != kF || payload_dim != kP || voxel_dim != kVox || hidden_dim != kHid ||
      num_views < 2 || num_views > kMaxViews || n < 0)
    return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* w = static_cast<const float*>(weights);
  if (is_bf16) {
    if (reinterpret_cast<uintptr_t>(feat) & 15) return cudaErrorInvalidValue;
    const Bf16Args a{static_cast<const bf16*>(vox), static_cast<const bf16*>(payload),
                     static_cast<const bf16*>(frd), static_cast<float*>(sigma),
                     static_cast<bf16*>(feat), n, num_views};
    return launch(bundle_head_bf16_kernel, kSmemBf16, kWarps * 32, kWarps * kTile, n, s, w, a);
  }
  return launch(bundle_head_f32_kernel, kSmemF32, kBlock, kBlock, n, s, w,
                static_cast<const float*>(vox), static_cast<const float*>(payload),
                static_cast<const float*>(frd), static_cast<float*>(sigma),
                static_cast<float*>(feat), n, num_views);
}

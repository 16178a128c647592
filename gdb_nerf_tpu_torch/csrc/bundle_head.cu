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
// Bound: ~32.5 kFLOP per sample against ~0.84 KB of float32 traffic, so
// arithmetic issue bounds it once the intermediates stay on chip.  Design:
// one thread per sample; all weights staged once per block in shared memory
// as float32 (every thread of a warp reads the same address: a broadcast);
// activations in registers; both view softmaxes are online (running max
// and rescaled sums), so no per-view activation is kept and the hidden-64
// layer of the blend is streamed straight into w1's dot.  The two largest
// layers run as rolled loops over 4 output rows, with the blend layer's
// shared half in a per-thread shared-memory column, so the live register
// set stays small enough not to spill.  The view loop is a
// runtime loop (2..4 views).  Blocks stride over 128-sample tiles.  Inputs
// are float32 or bf16; accumulation is float32; sigma is written as
// float32, feat in the input dtype.  The ragged tail is masked.
//
// Interface: plain C, loaded with ctypes; launches on the caller's stream
// and returns the cudaError_t of the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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
constexpr int kBlock = 128;
constexpr int kRows = 4;          // output rows per step of the rolled layers

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
static_assert(kHid % kRows == 0, "rolled layers step kRows rows");
// Shared memory: the weights, then kHid floats per thread ([row][thread],
// conflict-free) holding the shared half of the blend layer.
constexpr size_t kSmemBytes = (kNumWeights + kHid * kBlock) * sizeof(float);

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

__device__ __forceinline__ float relu(float v) { return fmaxf(v, 0.f); }

// y[o] += sum_i w[o * ld + i] * x[i]: a column block of a row-major weight.
template <int OUT, int IN>
__device__ __forceinline__ void matvec_acc(const float* w, int ld, const float (&x)[IN],
                                           float (&y)[OUT]) {
#pragma unroll
  for (int o = 0; o < OUT; ++o) {
    float acc = y[o];
#pragma unroll
    for (int i = 0; i < IN; ++i) acc = fmaf(w[o * ld + i], x[i], acc);
    y[o] = acc;
  }
}

// acc[r] += sum_i w[r * ld + i] * x[i] for R consecutive rows of a
// row-major weight: R independent accumulation chains.
template <int R, int IN>
__device__ __forceinline__ void rows_acc(const float* w, int ld, const float (&x)[IN],
                                         float (&acc)[R]) {
#pragma unroll
  for (int i = 0; i < IN; ++i) {
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = fmaf(w[r * ld + i], x[i], acc[r]);
  }
}

template <int N>
__device__ __forceinline__ void init(float (&y)[N], const float* b) {
#pragma unroll
  for (int i = 0; i < N; ++i) y[i] = b[i];
}

template <int N, typename T>
__device__ __forceinline__ void load_row(float (&y)[N], const T* p) {
#pragma unroll
  for (int i = 0; i < N; ++i) y[i] = load(p + i);
}

// ifr = frd[:F] + relu(view_fc(frd[F:F+4])) for one view's row.
template <typename T>
__device__ __forceinline__ void view_features(const float* sw, const T* row, float (&ifr)[kF]) {
  float rd[4];
  load_row(rd, row + kF);
  float h[kF];
  init(h, sw + OFF_VIEW_B);
  matvec_acc(sw + OFF_VIEW_W, 4, rd, h);
#pragma unroll
  for (int i = 0; i < kF; ++i) ifr[i] = load(row + i) + relu(h[i]);
}

template <typename T>
__device__ void head_sample(const float* sw, const T* __restrict__ vox, const T* __restrict__ payload,
                            const T* __restrict__ frd, float* __restrict__ sigma_out,
                            T* __restrict__ feat_out, long long n, int num_views, long long s,
                            float* hs) {
  // --- view aggregation: Welford mean / M2 over views ---
  float mean[kF], m2[kF];
#pragma unroll
  for (int i = 0; i < kF; ++i) mean[i] = m2[i] = 0.f;
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
  float shared_g[kG];
  {
    const float inv_dof = 1.f / (num_views > 1 ? num_views - 1 : 1);
    float var[kF];
#pragma unroll
    for (int i = 0; i < kF; ++i) var[i] = m2[i] * inv_dof;
    init(shared_g, sw + OFF_G_B);
    matvec_acc(sw + OFF_GVAR_W, kF, var, shared_g);
    matvec_acc(sw + OFF_GMEAN_W, kF, mean, shared_g);
  }
  // Online softmax over views of relu(agg_w gf_v), pooling gf_v.
  float pooled[kG];
#pragma unroll
  for (int i = 0; i < kG; ++i) pooled[i] = 0.f;
  float run_max = -INFINITY, denom = 0.f;
  for (int v = 0; v < num_views; ++v) {
    float ifr[kF];
    view_features(sw, frd + (v * n + s) * kF4, ifr);
    float gf[kG];
#pragma unroll
    for (int i = 0; i < kG; ++i) gf[i] = shared_g[i];
    matvec_acc(sw + OFF_GPV_W, kF, ifr, gf);
    float logit = sw[OFF_AGG_B];
#pragma unroll
    for (int i = 0; i < kG; ++i) {
      gf[i] = relu(gf[i]);
      logit = fmaf(sw[OFF_AGG_W + i], gf[i], logit);
    }
    logit = relu(logit);
    const float new_max = fmaxf(run_max, logit);
    const float rescale = expf(run_max - new_max);
    const float e = expf(logit - new_max);
    denom = denom * rescale + e;
#pragma unroll
    for (int i = 0; i < kG; ++i) pooled[i] = fmaf(e, gf[i], pooled[i] * rescale);
    run_max = new_max;
  }
  float img[kImg];
  {
    const float inv = 1.f / denom;
#pragma unroll
    for (int i = 0; i < kG; ++i) pooled[i] *= inv;
    init(img, sw + OFF_FC_B);
    matvec_acc(sw + OFF_FC_W, kG, pooled, img);
#pragma unroll
    for (int i = 0; i < kImg; ++i) img[i] = relu(img[i]);
  }

  // --- density ---
  float vx[kVox];
  load_row(vx, vox + s * kVox);
  float x[kHid];
  init(x, sw + OFF_LR0_B);
  matvec_acc(sw + OFF_LR0_W, kVox + kImg, vx, x);
  matvec_acc(sw + OFF_LR0_W + kVox, kVox + kImg, img, x);
  float sg = sw[OFF_SIG_B];
#pragma unroll
  for (int i = 0; i < kHid; ++i) {
    x[i] = relu(x[i]);
    sg = fmaf(sw[OFF_SIG_W + i], x[i], sg);
  }
  sigma_out[s] = fmaxf(sg, 0.f) + log1pf(expf(-fabsf(sg)));  // softplus

  // --- feature head and the shared half of weight.0 ---
  float extra[kVox];
  init(extra, sw + OFF_FH_B);
  matvec_acc(sw + OFF_FH_W, kHid, x, extra);
  // The big layers run as rolled loops over kRows output rows (small code,
  // few live registers); hs goes to this thread's shared-memory column.
  {
    float in[kW0sIn];
#pragma unroll
    for (int i = 0; i < kHid; ++i) in[i] = x[i];
#pragma unroll
    for (int i = 0; i < kVox; ++i) in[kHid + i] = vx[i];
#pragma unroll
    for (int i = 0; i < kImg; ++i) in[kHid + kVox + i] = img[i];
#pragma unroll 1
    for (int o = 0; o < kHid; o += kRows) {
      float acc[kRows];
      init(acc, sw + OFF_W0S_B + o);
      rows_acc(sw + OFF_W0S_W + o * kW0sIn, kW0sIn, in, acc);
#pragma unroll
      for (int r = 0; r < kRows; ++r) hs[(o + r) * kBlock] = acc[r];
    }
  }

  // --- payload blend: online softmax over views of relu(w1 h_v) ---
  float blended[kP];
#pragma unroll
  for (int i = 0; i < kP; ++i) blended[i] = 0.f;
  run_max = -INFINITY;
  denom = 0.f;
  for (int v = 0; v < num_views; ++v) {
    float f[kF4];
    load_row(f, frd + (v * n + s) * kF4);
    float logit = sw[OFF_W1_B];
#pragma unroll 1
    for (int o = 0; o < kHid; o += kRows) {
      float acc[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = hs[(o + r) * kBlock];
      rows_acc(sw + OFF_W0V_W + o * kF4, kF4, f, acc);
#pragma unroll
      for (int r = 0; r < kRows; ++r) logit = fmaf(sw[OFF_W1_W + o + r], relu(acc[r]), logit);
    }
    logit = relu(logit);
    const float new_max = fmaxf(run_max, logit);
    const float rescale = expf(run_max - new_max);
    const float e = expf(logit - new_max);
    denom = denom * rescale + e;
    const T* p = payload + (v * n + s) * kP;
#pragma unroll
    for (int i = 0; i < kP; ++i) blended[i] = fmaf(e, load(p + i), blended[i] * rescale);
    run_max = new_max;
  }
  const float inv = 1.f / denom;
  T* out = feat_out + s * kOut;
#pragma unroll
  for (int i = 0; i < kP; ++i) store(out + i, blended[i] * inv);
#pragma unroll
  for (int i = 0; i < kVox; ++i) store(out + kP + i, relu(extra[i]));
}

template <typename T>
__global__ void __launch_bounds__(kBlock)
bundle_head_kernel(const float* __restrict__ weights, const T* __restrict__ vox,
                   const T* __restrict__ payload, const T* __restrict__ frd,
                   float* __restrict__ sigma_out, T* __restrict__ feat_out, int n, int num_views) {
  extern __shared__ float sw[];
  for (int i = threadIdx.x; i < kNumWeights; i += blockDim.x) sw[i] = weights[i];
  __syncthreads();
  const int num_tiles = (n + kBlock - 1) / kBlock;
  for (int tile = blockIdx.x; tile < num_tiles; tile += gridDim.x) {
    const long long s = static_cast<long long>(tile) * kBlock + threadIdx.x;
    if (s < n)
      head_sample(sw, vox, payload, frd, sigma_out, feat_out, n, num_views, s,
                  sw + kNumWeights + threadIdx.x);
  }
}

template <typename T>
cudaError_t launch(const float* weights, const T* vox, const T* payload, const T* frd,
                   float* sigma, T* feat, int n, int num_views, cudaStream_t stream) {
  auto kernel = bundle_head_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return err;
  int device = 0, num_sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&num_sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kBlock, kSmemBytes)) !=
      cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int num_tiles = (n + kBlock - 1) / kBlock;
  const int grid = num_tiles < num_sms * per_sm ? num_tiles : num_sms * per_sm;
  bundle_head_kernel<T><<<grid, kBlock, kSmemBytes, stream>>>(weights, vox, payload, frd, sigma,
                                                              feat, n, num_views);
  return cudaGetLastError();
}

}  // namespace

extern "C" int bundle_head_num_weights() { return kNumWeights; }

// Returns a cudaError_t; cudaErrorInvalidValue for widths or view counts the
// kernel was not compiled for.
extern "C" int bundle_head_forward(const void* weights, const void* vox, const void* payload,
                                   const void* frd, void* sigma, void* feat, int n, int num_views,
                                   int feat_rgb_dim, int payload_dim, int voxel_dim, int hidden_dim,
                                   int is_bf16, void* stream) {
  if (feat_rgb_dim != kF || payload_dim != kP || voxel_dim != kVox || hidden_dim != kHid ||
      num_views < 2 || num_views > 4 || n < 0)
    return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* w = static_cast<const float*>(weights);
  if (is_bf16) {
    using T = __nv_bfloat16;
    return launch<T>(w, static_cast<const T*>(vox), static_cast<const T*>(payload),
                     static_cast<const T*>(frd), static_cast<float*>(sigma), static_cast<T*>(feat),
                     n, num_views, s);
  }
  return launch<float>(w, static_cast<const float*>(vox), static_cast<const float*>(payload),
                       static_cast<const float*>(frd), static_cast<float*>(sigma),
                       static_cast<float*>(feat), n, num_views, s);
}

// Row gathers from a table for NVIDIA Hopper (sm_90a).
//
// Replaces the four Pallas kernels of the two gather probes:
//   gather_take        <- tools/microbench_pallas_gather.py::pallas_take
//                         (take_kernel): jnp.take of the table per index tile
//   gather_take_along  <- ::pallas_taa (taa_kernel): take_along_axis over the
//                         index broadcast to (TILE, C), one index per element
//   gather_row_loop    <- tools/microbench_pallas_rowgather.py::pallas_vmem_loop
//                         (vmem_loop_kernel): a scalar loop of row copies
//   gather_dma_ring    <- ::pallas_dma_ring (dma_ring_kernel): a ring of
//                         DEPTH = 8 in-flight per-row copies into a scratch,
//                         each drained to the output
// All four compute out[i, :] = table[clamp(idx[i], 0, rows - 1), :] for a
// table (rows, C) of float32 or bf16 and int32 indices (N,); out is (N, C)
// in the table's type.  A gather copies bits, so the kernels move bytes and
// only the element size matters.  Out-of-range indices are clamped, as the
// Pallas loop's pl.ds clamps: no kernel reads outside the table.  Any N,
// rows >= 1 and C >= 1 are taken; the ragged tail is masked.
//
// Bound: device memory.  A call writes N * C * e bytes and reads 4N bytes of
// indices; the table (256 KB for the gather probe, 2 MB for the row-gather
// probe) is read from device memory about once and then hits the 50 MB L2,
// which takes the place of the TPU kernels' VMEM-resident table.  Copying it
// into each block's shared memory would read it once per block, so the
// kernels read rows straight from L2.  Designs:
//   take       one thread per 16-byte piece of an output row (a 32-byte bf16
//              row is two pieces); the thread reads its row's index, loads
//              the piece through the read-only path (ld.global.nc.v4) and
//              stores it, so a warp's stores cover 512 contiguous bytes.
//              Rows whose width (or the pointers) are not a multiple of 16
//              bytes take 8-, 4- or 2-byte pieces.
//   take_along the same function as the probe's element gather, redesigned
//              to read each row's index once: a warp walks chunks of 32
//              output rows.  Lane l loads the index of row l of the chunk
//              (one coalesced 128-byte load) and clamps it; the chunk's 32 P
//              pieces of U then go in P rounds of 32 contiguous pieces, so
//              each round's stores cover 32 x 16 = 512 contiguous bytes.
//              Piece t = 32 j + lane of the chunk is piece t % P of row
//              t / P, whose index comes from lane t / P by __shfl_sync; the
//              lane's (row, piece) advances by (32 / P, 32 % P) a round, so
//              the per-piece loop holds no division and no 64-bit arithmetic
//              but the address's wide multiply of 32-bit operands.  Loads go
//              through the read-only path (ld.global.nc), stores are
//              evict-first (st.global.cs) so that the output stream does not
//              push the table out of L2.  Rows or pointers that are not
//              16-byte multiples take 8-, 4- or 2-byte pieces, as take does.
//   row_loop   each warp walks the rows of its block's tile one at a time:
//              it reads the row's index once (one broadcast load for the
//              warp) and copies the row with its lanes in 16-byte pieces (a
//              256-byte bf16 row is 16 lanes x 16 B).  kLoopTile rows per
//              block, kLoopWarps warps, row j of the tile on warp j % kLoopWarps.
//   dma_ring   one warp per block and a tile of kRingTile rows: the tile's
//              clamped indices are loaded into shared memory first (the
//              Pallas kernel's scalar prefetch); then one elected lane keeps
//              kRingDepth one-row bulk copies in flight
//              (cp.async.bulk ... mbarrier::complete_tx, after
//              mbarrier.arrive.expect_tx) into a ring of kRingDepth slots,
//              each with its mbarrier.  For row j the warp waits on slot
//              j % kRingDepth with parity (j / kRingDepth) & 1 (the phase
//              flips on every reuse), stores the slot to the output, meets
//              at __syncwarp so that its generic-proxy reads are done, and
//              the elected lane refills the slot with row j + kRingDepth if
//              the tile has one: no wait is left on a copy never issued.
//              Bulk copies need 16-byte aligned addresses and sizes: the
//              entry point refuses rows that are not a multiple of 16 bytes
//              or a table that is not 16-byte aligned.  Small blocks (one
//              warp, about 2 KB of shared memory for 256-byte rows) let up
//              to 32 rings share an SM, which hides the copies' L2 latency
//              that a 2048-row tile per block would leave serial.
//
// Interface: plain C, loaded with ctypes; launches on the caller's stream
// and returns the cudaError_t of the launch.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;      // take: threads per block
constexpr int kAlongWarps = 8;     // take_along: warps per block, a chunk of 32 rows each
constexpr int kMaxBlocks = 1 << 20;  // grid cap; the kernels stride over the rest
constexpr int kLoopWarps = 8;      // row_loop: warps per block
constexpr int kLoopTile = 256;     // row_loop: rows per block
constexpr int kRingDepth = 8;      // dma_ring: copies in flight per block
constexpr int kRingTile = 64;      // dma_ring: rows per block (one warp)
constexpr int kRingThreads = 32;
constexpr int kMaxSmem = 232448;   // bytes a block may use on sm_90

__device__ __forceinline__ int clamp_row(int r, int rows) { return min(max(r, 0), rows - 1); }

// Widest piece (16, 8, 4 or 2 bytes) that divides the row and both pointers.
int piece_bytes(const void* a, const void* b, long long row_bytes) {
  const unsigned long long m = reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
                               static_cast<unsigned long long>(row_bytes);
  return m % 16 == 0 ? 16 : m % 8 == 0 ? 8 : m % 4 == 0 ? 4 : 2;
}

int grid_for(long long work, int per_block) {
  const long long g = (work + per_block - 1) / per_block;
  return static_cast<int>(g < kMaxBlocks ? g : kMaxBlocks);
}

// take: piece t of the output is piece t % P of row idx[t / P], P pieces of
// type U a row.
template <typename U>
__global__ void __launch_bounds__(kThreads)
take_kernel(const U* __restrict__ table, const int* __restrict__ idx, U* __restrict__ out, int rows,
            int P, long long total) {
  for (long long t = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x; t < total;
       t += static_cast<long long>(gridDim.x) * kThreads) {
    const long long i = t / P;
    const int p = static_cast<int>(t - i * P);
    const int r = clamp_row(__ldg(idx + i), rows);
    out[t] = __ldg(table + static_cast<long long>(r) * P + p);
  }
}

// take_along: warp w of block b takes chunks b * kAlongWarps + w + k *
// gridDim.x * kAlongWarps of 32 rows; P pieces of type U a row.
template <typename U>
__global__ void __launch_bounds__(kAlongWarps * 32)
take_along_kernel(const U* __restrict__ table, const int* __restrict__ idx, U* __restrict__ out,
                  int rows, int P, int N) {
  const int lane = threadIdx.x & 31;
  const int chunks = N / 32 + (N % 32 != 0);
  const int row0 = lane / P, piece0 = lane % P;  // this lane's piece of round 0
  const int row_step = 32 / P, piece_step = 32 % P;
  for (int ch = blockIdx.x * kAlongWarps + (threadIdx.x >> 5); ch < chunks;
       ch += gridDim.x * kAlongWarps) {
    const int base = ch * 32, n = min(32, N - base), pieces = n * P;
    const int r = lane < n ? clamp_row(__ldg(idx + base + lane), rows) : 0;
    U* dst = out + static_cast<long long>(base) * P;
    int row = row0, piece = piece0;
    for (int t = lane; t - lane < pieces; t += 32) {
      const unsigned src = static_cast<unsigned>(__shfl_sync(0xffffffffu, r, row));
      const unsigned long long at = static_cast<unsigned long long>(src) * static_cast<unsigned>(P);
      if (t < pieces) __stcs(dst + t, __ldg(table + at + piece));
      row += row_step;
      piece += piece_step;
      if (piece >= P) {
        piece -= P;
        ++row;
      }
    }
  }
}

// row_loop: warp w of block b copies rows b * kLoopTile + w + k * kLoopWarps.
template <typename U>
__global__ void __launch_bounds__(kLoopWarps * 32)
row_loop_kernel(const U* __restrict__ table, const int* __restrict__ idx, U* __restrict__ out,
                int rows, int P, int N) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long base = static_cast<long long>(blockIdx.x) * kLoopTile;
  const int n = static_cast<int>(min(static_cast<long long>(kLoopTile), N - base));
  for (int j = warp; j < n; j += kLoopWarps) {
    const long long i = base + j;
    const int r = clamp_row(__ldg(idx + i), rows);  // one address for the warp
    const U* src = table + static_cast<long long>(r) * P;
    U* dst = out + i * P;
    for (int p = lane; p < P; p += 32) dst[p] = __ldg(src + p);
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// One arrival that also expects `bytes` of transactions in this phase, then
// a bulk copy of `bytes` from global src to shared dst completing on `bar`.
__device__ __forceinline__ void bulk_row(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.b32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

// dma_ring: block b copies rows [b * kRingTile, min(N, (b + 1) * kRingTile))
// through the ring.  Shared memory: kRingDepth mbarriers, the tile's clamped
// indices, then kRingDepth slots of row_bytes each (16-byte aligned).
__global__ void __launch_bounds__(kRingThreads)
dma_ring_kernel(const unsigned char* __restrict__ table, const int* __restrict__ idx,
                uint4* __restrict__ out, int rows, int row_bytes, int N) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  int* rids = reinterpret_cast<int*>(smem + kRingDepth * sizeof(uint64_t));
  unsigned char* slots = smem + kRingDepth * sizeof(uint64_t) + kRingTile * sizeof(int);
  const int lane = threadIdx.x;
  const long long base = static_cast<long long>(blockIdx.x) * kRingTile;
  const int n = static_cast<int>(min(static_cast<long long>(kRingTile), N - base));
  for (int j = lane; j < n; j += kRingThreads) rids[j] = clamp_row(__ldg(idx + base + j), rows);
  if (lane == 0) {
    for (int s = 0; s < kRingDepth; ++s) mbar_init(bars + s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncwarp();
  const int P = row_bytes / 16;
  if (lane == 0)
    for (int j = 0; j < min(kRingDepth, n); ++j)
      bulk_row(slots + j * row_bytes, table + static_cast<long long>(rids[j]) * row_bytes,
               row_bytes, bars + j);
  __syncwarp();
  for (int j = 0; j < n; ++j) {
    const int slot = j % kRingDepth;
    mbar_wait(bars + slot, (j / kRingDepth) & 1);
    const uint4* src = reinterpret_cast<const uint4*>(slots + slot * row_bytes);
    uint4* dst = out + (base + j) * P;
    for (int p = lane; p < P; p += kRingThreads) dst[p] = src[p];
    __syncwarp();  // the slot's reads are done before the async proxy refills it
    const int next = j + kRingDepth;
    if (lane == 0 && next < n)
      bulk_row(slots + slot * row_bytes, table + static_cast<long long>(rids[next]) * row_bytes,
               row_bytes, bars + slot);
    __syncwarp();
  }
}

size_t ring_smem(long long row_bytes) {
  return kRingDepth * sizeof(uint64_t) + kRingTile * sizeof(int) +
         static_cast<size_t>(kRingDepth) * static_cast<size_t>(row_bytes);
}

template <typename U>
cudaError_t launch_take(const void* table, const int* idx, void* out, int rows, long long row_bytes,
                        int N, cudaStream_t s) {
  const int P = static_cast<int>(row_bytes / sizeof(U));
  const long long total = static_cast<long long>(N) * P;
  take_kernel<U><<<grid_for(total, kThreads), kThreads, 0, s>>>(
      static_cast<const U*>(table), idx, static_cast<U*>(out), rows, P, total);
  return cudaGetLastError();
}

template <typename U>
cudaError_t launch_take_along(const void* table, const int* idx, void* out, int rows,
                              long long row_bytes, int N, cudaStream_t s) {
  const int P = static_cast<int>(row_bytes / sizeof(U));
  take_along_kernel<U><<<grid_for(N / 32 + (N % 32 != 0), kAlongWarps), kAlongWarps * 32, 0, s>>>(
      static_cast<const U*>(table), idx, static_cast<U*>(out), rows, P, N);
  return cudaGetLastError();
}

template <typename U>
cudaError_t launch_row_loop(const void* table, const int* idx, void* out, int rows,
                            long long row_bytes, int N, cudaStream_t s) {
  const int P = static_cast<int>(row_bytes / sizeof(U));
  row_loop_kernel<U><<<(N + kLoopTile - 1) / kLoopTile, kLoopWarps * 32, 0, s>>>(
      static_cast<const U*>(table), idx, static_cast<U*>(out), rows, P, N);
  return cudaGetLastError();
}

bool bad_sizes(int rows, int C, int N) { return rows < 1 || C < 1 || N < 1; }

}  // namespace

// Each entry point returns a cudaError_t: cudaErrorInvalidValue for sizes it
// does not take (rows, C or N below 1; for take_along a row of 64 MB or
// more; for dma_ring a row that is not a
// multiple of 16 bytes, a table that is not 16-byte aligned, or a ring that
// does not fit in a block's shared memory).

extern "C" int gather_take(const void* table, const void* idx, void* out, int rows, int C, int N,
                           int is_bf16, void* stream) {
  if (bad_sizes(rows, C, N)) return cudaErrorInvalidValue;
  const long long row_bytes = static_cast<long long>(C) * (is_bf16 ? 2 : 4);
  const int* ix = static_cast<const int*>(idx);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (piece_bytes(table, out, row_bytes)) {
    case 16: return launch_take<uint4>(table, ix, out, rows, row_bytes, N, s);
    case 8: return launch_take<uint2>(table, ix, out, rows, row_bytes, N, s);
    case 4: return launch_take<unsigned int>(table, ix, out, rows, row_bytes, N, s);
    default: return launch_take<unsigned short>(table, ix, out, rows, row_bytes, N, s);
  }
}

extern "C" int gather_take_along(const void* table, const void* idx, void* out, int rows, int C,
                                 int N, int is_bf16, void* stream) {
  if (bad_sizes(rows, C, N)) return cudaErrorInvalidValue;
  const long long row_bytes = static_cast<long long>(C) * (is_bf16 ? 2 : 4);
  if (row_bytes >= (1LL << 26)) return cudaErrorInvalidValue;  // a chunk's pieces fit an int
  const int* ix = static_cast<const int*>(idx);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (piece_bytes(table, out, row_bytes)) {
    case 16: return launch_take_along<uint4>(table, ix, out, rows, row_bytes, N, s);
    case 8: return launch_take_along<uint2>(table, ix, out, rows, row_bytes, N, s);
    case 4: return launch_take_along<unsigned int>(table, ix, out, rows, row_bytes, N, s);
    default: return launch_take_along<unsigned short>(table, ix, out, rows, row_bytes, N, s);
  }
}

extern "C" int gather_row_loop(const void* table, const void* idx, void* out, int rows, int C,
                               int N, int is_bf16, void* stream) {
  if (bad_sizes(rows, C, N)) return cudaErrorInvalidValue;
  const long long row_bytes = static_cast<long long>(C) * (is_bf16 ? 2 : 4);
  const int* ix = static_cast<const int*>(idx);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (piece_bytes(table, out, row_bytes)) {
    case 16: return launch_row_loop<uint4>(table, ix, out, rows, row_bytes, N, s);
    case 8: return launch_row_loop<uint2>(table, ix, out, rows, row_bytes, N, s);
    case 4: return launch_row_loop<unsigned int>(table, ix, out, rows, row_bytes, N, s);
    default: return launch_row_loop<unsigned short>(table, ix, out, rows, row_bytes, N, s);
  }
}

extern "C" int gather_dma_ring(const void* table, const void* idx, void* out, int rows, int C,
                               int N, int is_bf16, void* stream) {
  if (bad_sizes(rows, C, N)) return cudaErrorInvalidValue;
  const long long row_bytes = static_cast<long long>(C) * (is_bf16 ? 2 : 4);
  if (row_bytes % 16 || piece_bytes(table, out, 16) != 16) return cudaErrorInvalidValue;
  const size_t smem = ring_smem(row_bytes);
  if (smem > static_cast<size_t>(kMaxSmem)) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(dma_ring_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dma_ring_kernel<<<(N + kRingTile - 1) / kRingTile, kRingThreads, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(table), static_cast<const int*>(idx),
      static_cast<uint4*>(out), rows, static_cast<int>(row_bytes), N);
  return cudaGetLastError();
}

// Batched double-single matvec on Hopper: y[s] = (hi[s] + lo[s]) @ d[s].
//
// Replaces the Pallas TPU kernel ddm_tpu/kernels/ddmatvec.py:dd_matvec_pallas
// (body _kernel), which the TPU package's double-single subdomain inverse
// (ddm_tpu/solvers/direct.py:BatchedInverseDD) computes as three f32 matvecs
// combined in f64.
//
//   hi, lo : (n_sub, P, P) float32, row-major, contiguous
//   d      : (n_sub, q) float64, q <= P (only the leading q x q block is read)
//   y      : (n_sub, q) float64
//
// What bounds it on an H100: bytes.  Every entry of hi and lo is read once
// and used for two multiply-adds, 8 bytes per 4 flops; at the fine shape
// (256, 848, 848) that is 1.47 GB per call, about 0.44 ms at 3.35 TB/s; at
// the dd coarse solve's (1, 2048, 2048) 33.6 MB, about 0.010 ms.  FP64
// arithmetic is far from a limit, so the sum is accumulated in f64:
// (double)hi * d + (double)lo * d.  The TPU kernel kept f32 partial sums
// only because Pallas on the TPU has no f64; its rounding noise costs
// Krylov iterations.
//
// Design.  The grid is sized to the card, not to the rows: the launch plan
// (ddm_tpu_torch/kernels/ddmatvec.py:plan, from n_sub, q and the SM count)
// picks `rows` rows per block and splits the columns into `chunks` chunks
// of `cols` columns, as finely as a grid of at most two blocks per SM
// allows:
//
//   (256, 848, 848): 64 rows x 1 chunk -> 3,584 blocks, no cluster
//   (1, 2048, 2048): 32 rows x 4 chunks of 512 -> 256 blocks, clusters of 4
//
// One block covers one (subdomain, row tile, column chunk); it stages only
// its chunk of d in shared memory, and each warp streams a row's chunk with
// kUnroll independent 16-byte loads of hi and of lo in flight per lane
// before the FMAs (ld.global.nc with no L1 allocation and a 256-byte L2
// prefetch: the matrix is read once), then reduces across the warp by
// shuffles.  A row that is not 16-byte aligned (a ragged P) takes 4-byte
// loads.
//
// Tried at the coarse shape (chip_smoke.py --plans, one H100): the first
// design (64 rows x 1 chunk for every shape, a loop of one 16-byte load of
// hi and one of lo per trip: 32 blocks, 100 of 132 SMs idle) ran at 15 % of
// the bound; that tiling with the unrolled loads, at 23-26 %.  Grids of
// about 256 blocks (two per SM) were the fastest, by a few per cent over
// 128 and 512, whatever the split.  Issuing a warp's first loads before d is
// staged gained nothing, and two rows in flight per warp (128 registers)
// lost; both were dropped.  The load hints gained ~10 % at the coarse shape
// and ~1.5 % at the fine one.
//
// The column split is reduced in a fixed order, never with float atomics:
// the `chunks` blocks of one row tile are launched as one thread-block
// cluster; each writes its rows' partial sums to its shared memory, and
// after cluster.sync() rank 0 reads its partners' partials through
// distributed shared memory in rank order, adds them and writes y.  One
// launch, no workspace, and two launches on the same inputs give the same
// bits.  With one chunk the cluster step is skipped.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 8;       // warps per block (ddmatvec.py: LADDER's 8 rows)
constexpr int kMaxCluster = 8;  // portable cluster size (ddmatvec.py: MAX_CLUSTER)
constexpr int kUnroll = 4;      // 16-byte loads of hi and of lo in flight per lane

// A 16-byte load of data read once: read-only path, no L1 allocation, and
// the L2 fetches the whole 256-byte block around it.
__device__ __forceinline__ float4 ld_stream(const float4* p) {
  float4 v;
  asm("ld.global.nc.L1::no_allocate.L2::256B.v4.f32 {%0, %1, %2, %3}, [%4];"
      : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "l"(p));
  return v;
}

// One lane's share of sum_c (hi[c] + lo[c]) * dv[c] over c in [0, n): the
// row chunk h, l (global) against its d chunk dv (shared).
template <bool kVec4>
__device__ __forceinline__ double row_chunk(const float* __restrict__ h,
                                            const float* __restrict__ l,
                                            const double* dv, int n, int lane) {
  double acc = 0.0;
  int c0 = 0;
  if (kVec4) {
    const float4* h4 = reinterpret_cast<const float4*>(h);
    const float4* l4 = reinterpret_cast<const float4*>(l);
    const int n4 = n >> 2;
    for (int base = lane; base < n4; base += 32 * kUnroll) {
      float4 a[kUnroll], b[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {  // every load issued before any FMA
        const int i = base + 32 * u;
        a[u] = i < n4 ? ld_stream(h4 + i) : make_float4(0.f, 0.f, 0.f, 0.f);
        b[u] = i < n4 ? ld_stream(l4 + i) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = base + 32 * u;
        if (i < n4) {
          const double* x = dv + 4 * i;
          acc = fma((double)a[u].x, x[0], acc);
          acc = fma((double)b[u].x, x[0], acc);
          acc = fma((double)a[u].y, x[1], acc);
          acc = fma((double)b[u].y, x[1], acc);
          acc = fma((double)a[u].z, x[2], acc);
          acc = fma((double)b[u].z, x[2], acc);
          acc = fma((double)a[u].w, x[3], acc);
          acc = fma((double)b[u].w, x[3], acc);
        }
      }
    }
    c0 = n4 << 2;
  }
  constexpr int kScalar = kVec4 ? 1 : 4 * kUnroll;  // the tail, or a whole ragged row
  for (int base = c0 + lane; base < n; base += 32 * kScalar) {
    float a[kScalar], b[kScalar];
#pragma unroll
    for (int u = 0; u < kScalar; ++u) {
      const int c = base + 32 * u;
      a[u] = c < n ? __ldg(h + c) : 0.f;
      b[u] = c < n ? __ldg(l + c) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kScalar; ++u) {
      const int c = base + 32 * u;
      if (c < n) {
        acc = fma((double)a[u], dv[c], acc);
        acc = fma((double)b[u], dv[c], acc);
      }
    }
  }
  return acc;
}

// Block (tile * chunks + chunk, s): rows [tile * rows, +rows) of subdomain
// s against columns [chunk * cols, +cols), all clipped to q.  With
// chunks > 1 the grid's x dimension is clustered by `chunks`, so a block's
// cluster rank is its chunk.
template <bool kVec4>
__global__ void __launch_bounds__(kWarps * 32)
dd_matvec_kernel(const float* __restrict__ hi, const float* __restrict__ lo,
                 const double* __restrict__ d, double* __restrict__ y,
                 int P, int q, int rows, int chunks, int cols) {
  extern __shared__ double smem[];
  double* ds = smem;           // cols doubles: this chunk of d
  double* part = smem + cols;  // rows doubles: this block's partial sums
  const int s = blockIdx.y;
  const int tile = blockIdx.x / chunks;
  const int chunk = blockIdx.x % chunks;
  const int c_begin = chunk * cols;
  const int n = min(cols, q - c_begin);
  const int r_begin = tile * rows;
  const int n_rows = min(rows, q - r_begin);

  const double* d_s = d + (size_t)s * q + c_begin;
  for (int c = threadIdx.x; c < n; c += blockDim.x) ds[c] = d_s[c];
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  double* y_s = y + (size_t)s * q + r_begin;
  for (int i = warp; i < n_rows; i += kWarps) {
    const size_t off = ((size_t)s * P + r_begin + i) * (size_t)P + c_begin;
    double acc = row_chunk<kVec4>(hi + off, lo + off, ds, n, lane);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, o);
    if (lane == 0) {
      if (chunks == 1) y_s[i] = acc;
      else part[i] = acc;
    }
  }
  if (chunks == 1) return;  // uniform over the grid

  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every chunk's partials are in its shared memory
  if (cluster.block_rank() == 0) {
    for (int i = threadIdx.x; i < n_rows; i += blockDim.x) {
      double acc = 0.0;
      for (int k = 0; k < chunks; ++k) acc += cluster.map_shared_rank(part, k)[i];
      y_s[i] = acc;
    }
  }
  cluster.sync();  // partners keep their shared memory until rank 0 has read it
}

}  // namespace

// The plan (rows, chunks, cols) comes from ddmatvec.py:plan; it must tile
// [0, q) with chunks of whole float4s.  Returns a cudaError_t.
extern "C" int ddm_dd_matvec(const float* hi, const float* lo, const double* d,
                             double* y, int n_sub, int P, int q, int rows,
                             int chunks, int cols, void* stream) {
  if (n_sub <= 0 || q <= 0) return (int)cudaSuccess;
  if (rows < 1 || chunks < 1 || chunks > kMaxCluster || cols < 1 ||
      (long long)cols * chunks < q || (long long)cols * (chunks - 1) >= q ||
      (chunks > 1 && cols % 4 != 0))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((q + rows - 1) / rows * chunks, n_sub);
  const dim3 block(kWarps * 32);
  const size_t smem = (size_t)(cols + rows) * sizeof(double);
  // 16-byte loads need every row start 16-byte aligned
  const bool vec4 = (P % 4 == 0) && ((uintptr_t)hi % 16 == 0) &&
                    ((uintptr_t)lo % 16 == 0);
  auto kernel = vec4 ? dd_matvec_kernel<true> : dd_matvec_kernel<false>;
  cudaStream_t st = (cudaStream_t)stream;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (chunks == 1) {
    kernel<<<grid, block, smem, st>>>(hi, lo, d, y, P, q, rows, chunks, cols);
  } else {
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = chunks;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = grid;
    cfg.blockDim = block;
    cfg.dynamicSmemBytes = smem;
    cfg.stream = st;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, hi, lo, d, y, P, q, rows,
                                       chunks, cols);
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaGetLastError();
}

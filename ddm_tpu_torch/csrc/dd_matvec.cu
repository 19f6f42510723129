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
// and used for two multiply-adds, 8 bytes per 4 flops; at the main path's
// shape (256, 848, 848) that is 256 * 848^2 * 8 B = 1.47 GB per call, about
// 0.44 ms at 3.35 TB/s.  FP64 arithmetic is far from a limit, so the sum is
// accumulated in f64: (double)hi * d + (double)lo * d.  The TPU kernel kept
// f32 partial sums only because Pallas on the TPU has no f64; its rounding
// noise costs Krylov iterations.
//
// Design (simple first): one block per (row tile, subdomain); d staged once
// per block in shared memory; one warp per row reading the hi and lo rows
// with coalesced 16-byte loads (4-byte loads when a row is not 16-byte
// aligned); a warp-shuffle f64 reduction; the ragged row and column edges
// masked.  No 128-alignment of P is needed: that was a TPU tiling rule.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;          // warps per block
constexpr int kRowsPerBlock = 64;  // rows per block, kRowsPerBlock / kWarps per warp

template <bool kVec4>
__global__ void __launch_bounds__(kWarps * 32)
dd_matvec_kernel(const float* __restrict__ hi, const float* __restrict__ lo,
                 const double* __restrict__ d, double* __restrict__ y,
                 int P, int q) {
  extern __shared__ double ds[];  // q doubles: this subdomain's d
  const int s = blockIdx.y;
  const double* d_s = d + (size_t)s * q;
  for (int c = threadIdx.x; c < q; c += blockDim.x) ds[c] = d_s[c];
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row_end = min((int)(blockIdx.x + 1) * kRowsPerBlock, q);
  for (int r = blockIdx.x * kRowsPerBlock + warp; r < row_end; r += kWarps) {
    const size_t off = ((size_t)s * P + r) * (size_t)P;
    const float* h = hi + off;
    const float* l = lo + off;
    double acc = 0.0;
    int c0 = 0;
    if (kVec4) {
      const float4* h4 = reinterpret_cast<const float4*>(h);
      const float4* l4 = reinterpret_cast<const float4*>(l);
      const int q4 = q >> 2;
      for (int i = lane; i < q4; i += 32) {
        const float4 a = __ldg(h4 + i);
        const float4 b = __ldg(l4 + i);
        const double* dv = ds + 4 * i;
        acc = fma((double)a.x, dv[0], acc);
        acc = fma((double)b.x, dv[0], acc);
        acc = fma((double)a.y, dv[1], acc);
        acc = fma((double)b.y, dv[1], acc);
        acc = fma((double)a.z, dv[2], acc);
        acc = fma((double)b.z, dv[2], acc);
        acc = fma((double)a.w, dv[3], acc);
        acc = fma((double)b.w, dv[3], acc);
      }
      c0 = q4 << 2;
    }
    for (int c = c0 + lane; c < q; c += 32) {
      acc = fma((double)__ldg(h + c), ds[c], acc);
      acc = fma((double)__ldg(l + c), ds[c], acc);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, o);
    if (lane == 0) y[(size_t)s * q + r] = acc;
  }
}

}  // namespace

extern "C" int ddm_dd_matvec(const float* hi, const float* lo, const double* d,
                             double* y, int n_sub, int P, int q, void* stream) {
  if (n_sub <= 0 || q <= 0) return (int)cudaSuccess;
  const dim3 grid((q + kRowsPerBlock - 1) / kRowsPerBlock, n_sub);
  const dim3 block(kWarps * 32);
  const size_t smem = (size_t)q * sizeof(double);
  // 16-byte loads need every row start 16-byte aligned
  const bool vec4 = (P % 4 == 0) && ((uintptr_t)hi % 16 == 0) &&
                    ((uintptr_t)lo % 16 == 0);
  cudaStream_t st = (cudaStream_t)stream;
  if (vec4) {
    if (smem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(
          dd_matvec_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    dd_matvec_kernel<true><<<grid, block, smem, st>>>(hi, lo, d, y, P, q);
  } else {
    if (smem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(
          dd_matvec_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    dd_matvec_kernel<false><<<grid, block, smem, st>>>(hi, lo, d, y, P, q);
  }
  return (int)cudaGetLastError();
}

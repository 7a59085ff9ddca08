// SCV SpMM for Hopper (sm_90a): out = [acc +] A_hat @ Z over the SCV tile layout.
//
// Replaces the TPU kernel built by scv_spmm_pallas
// (src/repro/kernels/scv_spmm/scv_spmm.py:197): the sparse branch of its
// vector body (_kernel_vector, :101 / _sparse, :150) and its accumulate mode
// (the `acc` operand aliased onto the output, :274-282, with the strip seed of
// _init, :121).  The one-hot scatter/gather matmuls that the TPU body uses to
// reach its matrix unit are not carried over: here each entry is a gathered
// load of one Z row and one FMA per feature column.
//
// What bounds it on an H100: bytes.  Each entry costs 12 bytes of index and
// value data and a Z row gather (4 * F bytes, mostly from L2 when a column
// block is reused), against 2 * F flops, far below the ~20 flops per byte at
// which the card's fp32 rate would take over.  So the design moves each byte
// once where it can:
//   * one thread block owns one block-row run (all tiles of one output strip
//     in the schedule, found on the host by RunIndex) and one feature block;
//     the T x Fb output strip lives in shared memory and is written to device
//     memory exactly once, as on the TPU, with no atomics and a fixed
//     summation order (the result is deterministic);
//   * each thread owns one feature column, so the Z-row gathers and the strip
//     write-back coalesce across the warp and no thread reads another's part
//     of the strip: the kernel needs no barrier at all;
//   * entries past a tile's nnz are never read, so padding slots, zero-nnz
//     coverage dummies and the composite's repeat-last-tile padding cost only
//     the tile header.
// Accumulate mode seeds the strip from `out` instead of zero, which is how a
// chain of per-capacity-bucket launches sums into one output.
//
// The dense-tile branch (_dense, :169) and the scalar body (_kernel_scalar,
// :57) are not ported here; every tile, whatever its nnz, takes this path.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 128;
constexpr int kUnroll = 4;

__global__ void __launch_bounds__(kMaxThreads)
scv_spmm_runs_kernel(const int32_t* __restrict__ tile_row,
                     const int32_t* __restrict__ tile_col,
                     const int32_t* __restrict__ nnz_in_tile,
                     const int32_t* __restrict__ rows,
                     const int32_t* __restrict__ cols,
                     const float* __restrict__ vals,
                     const int32_t* __restrict__ run_ptr,
                     const float* __restrict__ z,
                     float* __restrict__ out,
                     int cap, int n_feat, int tile, int accumulate) {
  extern __shared__ float strip[];  // [tile][blockDim.x]
  const int f = blockIdx.y * blockDim.x + threadIdx.x;
  // Threads past the feature width leave at once: no barrier follows.
  if (f >= n_feat) return;
  float* col = strip + threadIdx.x;  // this thread's column of the strip
  const int stride = blockDim.x;

  const int t_begin = run_ptr[blockIdx.x];
  const int t_end = run_ptr[blockIdx.x + 1];
  float* out_col = out + (int64_t)tile_row[t_begin] * tile * n_feat + f;

  for (int r = 0; r < tile; ++r) {
    col[r * stride] = accumulate ? out_col[(int64_t)r * n_feat] : 0.0f;
  }

  for (int t = t_begin; t < t_end; ++t) {
    const int nnz = nnz_in_tile[t];
    const float* z_col = z + (int64_t)tile_col[t] * tile * n_feat + f;
    const int32_t* r_t = rows + (int64_t)t * cap;
    const int32_t* c_t = cols + (int64_t)t * cap;
    const float* v_t = vals + (int64_t)t * cap;
    int j = 0;
    // Issue kUnroll gathers before the first FMA; the strip updates stay in
    // entry order, since two entries of a group may share a row.
    for (; j + kUnroll <= nnz; j += kUnroll) {
      int r[kUnroll];
      float v[kUnroll];
      float zv[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        r[u] = r_t[j + u];
        v[u] = v_t[j + u];
        zv[u] = z_col[(int64_t)c_t[j + u] * n_feat];
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        col[r[u] * stride] = fmaf(v[u], zv[u], col[r[u] * stride]);
      }
    }
    for (; j < nnz; ++j) {
      const int r = r_t[j];
      col[r * stride] =
          fmaf(v_t[j], z_col[(int64_t)c_t[j] * n_feat], col[r * stride]);
    }
  }

  for (int r = 0; r < tile; ++r) {
    out_col[(int64_t)r * n_feat] = col[r * stride];
  }
}

}  // namespace

// Launches one SCV SpMM over a segment whose runs are given by run_ptr
// (n_runs + 1 offsets into the tile arrays).  All pointers are device
// pointers; `stream` is a cudaStream_t.  `threads` must be a multiple of 32
// no larger than 128, and tile * threads * 4 bytes must fit the 48 KB of
// shared memory a block gets without opting in.  Allocates nothing and does
// not synchronise; returns cudaGetLastError() after the launch.
extern "C" int scv_spmm_runs(const void* tile_row, const void* tile_col,
                             const void* nnz_in_tile, const void* rows,
                             const void* cols, const void* vals,
                             const void* run_ptr, const void* z, void* out,
                             int n_runs, int cap, int n_feat, int tile,
                             int threads, int accumulate, void* stream) {
  if (n_runs <= 0 || n_feat <= 0 || tile <= 0 || threads <= 0 ||
      threads > kMaxThreads || threads % 32 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid((unsigned)n_runs, (unsigned)((n_feat + threads - 1) / threads));
  const size_t smem = sizeof(float) * (size_t)tile * (size_t)threads;
  scv_spmm_runs_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      (const int32_t*)tile_row, (const int32_t*)tile_col,
      (const int32_t*)nnz_in_tile, (const int32_t*)rows, (const int32_t*)cols,
      (const float*)vals, (const int32_t*)run_ptr, (const float*)z,
      (float*)out, cap, n_feat, tile, accumulate);
  return (int)cudaGetLastError();
}

// SCV SpMM for Hopper (sm_90a): out = [acc +] A_hat @ Z over the SCV tile layout.
//
// Replaces the TPU kernel built by scv_spmm_pallas
// (src/repro/kernels/scv_spmm/scv_spmm.py:197), all of its bodies and modes:
//   * the vector body _kernel_vector (:101): its sparse branch _sparse (:150)
//     and its dense-tile branch _dense (:169), as scv_spmm_runs;
//   * its accumulate mode (the `acc` operand aliased onto the output,
//     :274-282, with the strip seed of _init, :121), as a flag of both
//     entries;
//   * the scalar body _kernel_scalar (:57), as scv_spmm_runs_scalar.
// The one-hot scatter/gather matmuls that the TPU's vector body uses to
// reach its matrix unit are not carried over: here each sparse entry is a
// gathered load of one Z row and one FMA per feature column.
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
//     of the strip;
//   * entries past a tile's nnz are never read, so padding slots, zero-nnz
//     coverage dummies and the composite's repeat-last-tile padding cost only
//     the tile header.
// Accumulate mode seeds the strip from `out` instead of zero, which is how a
// chain of per-capacity-bucket launches sums into one output.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 128;
constexpr int kUnroll = 4;
constexpr int kDenseChunk = 32;  // Z-block rows held in registers at a time
constexpr int kStage = 256;      // entries the scalar body stages at a time
constexpr size_t kDefaultSmem = 48 * 1024;

// Dense-tile branch (replaces _dense, scv_spmm.py:169).  A tile takes it iff
// 0 <= dense_threshold < nnz, the reference's rule (:147-148); the threshold
// is still the reference's TPU value, T^2/16 (core/scv.py::
// dense_tile_threshold), which a later change re-derives for this card.
//
// What bounds it: operations.  It spends T^2 * F FMAs on a tile, against
// nnz * F for the gather path (2 * nnz * F flops), and reads the whole T x F
// Z block once instead of one Z row per entry.  It runs on the CUDA cores in
// fp32: tensor cores (TF32) would break bit-exactness with the plain version.
//
//   1. D (T x T, f32, row stride ldd) is zeroed by the whole block, then
//      densified by warp 0 alone, 32 entries at a time: lanes whose entries
//      share a (row, col) are grouped by __match_any_sync, and the group's
//      lowest lane adds their values to D in entry order.  Groups follow one
//      another in entry order, so duplicates are summed in entry order, with
//      no shared-memory atomics and nothing left to scheduling.
//   2. Each thread adds D @ Z_block to its strip column, holding
//      kDenseChunk values of its Z column in registers and reading D's rows
//      as warp-wide broadcasts (float4 where the chunk is whole).
// Every thread of the block reaches the barriers: nnz is the same for all of
// them, and threads past the feature width skip only the strip work.
__device__ void dense_tile(float* dmat, int ldd, float* col, int stride,
                           const int32_t* r_t, const int32_t* c_t,
                           const float* v_t, int nnz, const float* z_col,
                           int z_valid, int n_feat, int tile, bool active) {
  __syncthreads();  // the previous dense tile's readers are done with D
  for (int i = threadIdx.x; i < tile * ldd; i += blockDim.x) dmat[i] = 0.0f;
  __syncthreads();
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    for (int j0 = 0; j0 < nnz; j0 += 32) {
      const int j = j0 + lane;
      const bool live = j < nnz;
      // dead lanes get keys no live entry has, and no two dead lanes share
      const int key = live ? r_t[j] * ldd + c_t[j] : -1 - lane;
      const unsigned same = __match_any_sync(0xffffffffu, key);
      if (live && lane == __ffs(same) - 1) {
        float d = dmat[key];
        for (unsigned m = same; m; m &= m - 1) d += v_t[j0 + __ffs(m) - 1];
        dmat[key] = d;
      }
      __syncwarp();
    }
  }
  __syncthreads();
  if (!active) return;
  int c0 = 0;
  for (; c0 + kDenseChunk <= tile; c0 += kDenseChunk) {
    float zc[kDenseChunk];
#pragma unroll
    for (int k = 0; k < kDenseChunk; ++k) {
      zc[k] = c0 + k < z_valid ? z_col[(int64_t)(c0 + k) * n_feat] : 0.0f;
    }
    for (int r = 0; r < tile; ++r) {
      // ldd and c0 are multiples of 4: the row chunk is 16-byte aligned
      const float4* d4 = reinterpret_cast<const float4*>(dmat + r * ldd + c0);
      float acc = col[r * stride];
#pragma unroll
      for (int k = 0; k < kDenseChunk / 4; ++k) {
        const float4 d = d4[k];
        acc = fmaf(d.x, zc[4 * k], acc);
        acc = fmaf(d.y, zc[4 * k + 1], acc);
        acc = fmaf(d.z, zc[4 * k + 2], acc);
        acc = fmaf(d.w, zc[4 * k + 3], acc);
      }
      col[r * stride] = acc;
    }
  }
  for (; c0 < tile; ++c0) {  // the last tile % kDenseChunk columns
    const float zv = c0 < z_valid ? z_col[(int64_t)c0 * n_feat] : 0.0f;
    for (int r = 0; r < tile; ++r) {
      col[r * stride] = fmaf(dmat[r * ldd + c0], zv, col[r * stride]);
    }
  }
}

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
                     int cap, int n_feat, int tile, int accumulate,
                     int n_z_rows, int dense_threshold) {
  extern __shared__ float4 smem4[];
  float* strip = reinterpret_cast<float*>(smem4);  // [tile][blockDim.x]
  const int stride = blockDim.x;
  const int ldd = (tile + 3) & ~3;
  float* dmat = strip + tile * stride;  // [tile][ldd], only when dense_threshold >= 0
  const int f = blockIdx.y * blockDim.x + threadIdx.x;
  // Threads past the feature width stay for the dense branch's barriers
  // but touch no strip column, Z column or output column.
  const bool active = f < n_feat;
  float* col = strip + threadIdx.x;  // this thread's column of the strip

  const int t_begin = run_ptr[blockIdx.x];
  const int t_end = run_ptr[blockIdx.x + 1];
  float* out_col = out + (int64_t)tile_row[t_begin] * tile * n_feat + f;

  if (active) {
    for (int r = 0; r < tile; ++r) {
      col[r * stride] = accumulate ? out_col[(int64_t)r * n_feat] : 0.0f;
    }
  }

  for (int t = t_begin; t < t_end; ++t) {
    const int nnz = nnz_in_tile[t];
    const int col_base = tile_col[t] * tile;
    const float* z_col = z + (int64_t)col_base * n_feat + f;
    const int32_t* r_t = rows + (int64_t)t * cap;
    const int32_t* c_t = cols + (int64_t)t * cap;
    const float* v_t = vals + (int64_t)t * cap;
    if (dense_threshold >= 0 && nnz > dense_threshold) {
      dense_tile(dmat, ldd, col, stride, r_t, c_t, v_t, nnz, z_col,
                 n_z_rows - col_base, n_feat, tile, active);
      continue;
    }
    if (!active) continue;
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

  if (active) {
    for (int r = 0; r < tile; ++r) {
      out_col[(int64_t)r * n_feat] = col[r * stride];
    }
  }
}

// Scalar body (replaces _kernel_scalar, scv_spmm.py:57): the plain
// per-entry loop out[r, :] += v * Z[c, :], kept as the measured baseline.
// Same run ownership and strip as the vector body, but no unrolled gathers
// and no dense branch; each tile's entries are staged through shared memory
// kStage at a time (the TPU body holds them in SMEM), and every thread then
// walks them in entry order.  Its sums are taken in the same order as the
// vector body's sparse branch.  Bounded, like that branch, by one dependent
// chain of loads per entry.
__global__ void __launch_bounds__(kMaxThreads)
scv_spmm_runs_scalar_kernel(const int32_t* __restrict__ tile_row,
                            const int32_t* __restrict__ tile_col,
                            const int32_t* __restrict__ nnz_in_tile,
                            const int32_t* __restrict__ rows,
                            const int32_t* __restrict__ cols,
                            const float* __restrict__ vals,
                            const int32_t* __restrict__ run_ptr,
                            const float* __restrict__ z,
                            float* __restrict__ out,
                            int cap, int n_feat, int tile, int accumulate) {
  extern __shared__ float4 smem4[];
  float* strip = reinterpret_cast<float*>(smem4);  // [tile][blockDim.x]
  const int stride = blockDim.x;
  int32_t* s_rows = reinterpret_cast<int32_t*>(strip + tile * stride);
  int32_t* s_cols = s_rows + kStage;
  float* s_vals = reinterpret_cast<float*>(s_cols + kStage);
  const int f = blockIdx.y * blockDim.x + threadIdx.x;
  const bool active = f < n_feat;  // the rest only help stage entries
  float* col = strip + threadIdx.x;

  const int t_begin = run_ptr[blockIdx.x];
  const int t_end = run_ptr[blockIdx.x + 1];
  float* out_col = out + (int64_t)tile_row[t_begin] * tile * n_feat + f;

  if (active) {
    for (int r = 0; r < tile; ++r) {
      col[r * stride] = accumulate ? out_col[(int64_t)r * n_feat] : 0.0f;
    }
  }

  for (int t = t_begin; t < t_end; ++t) {
    const int nnz = nnz_in_tile[t];
    const float* z_col = z + (int64_t)tile_col[t] * tile * n_feat + f;
    for (int j0 = 0; j0 < nnz; j0 += kStage) {
      const int n = min(kStage, nnz - j0);
      const int64_t base = (int64_t)t * cap + j0;
      __syncthreads();  // every thread is done with the previous stage
      for (int i = threadIdx.x; i < n; i += blockDim.x) {
        s_rows[i] = rows[base + i];
        s_cols[i] = cols[base + i];
        s_vals[i] = vals[base + i];
      }
      __syncthreads();
      if (!active) continue;
      for (int i = 0; i < n; ++i) {
        const int r = s_rows[i];
        col[r * stride] = fmaf(s_vals[i], z_col[(int64_t)s_cols[i] * n_feat],
                               col[r * stride]);
      }
    }
  }

  if (active) {
    for (int r = 0; r < tile; ++r) {
      out_col[(int64_t)r * n_feat] = col[r * stride];
    }
  }
}

// Shared memory above the 48 KB a block gets by default needs the kernel's
// opt-in, once per process (one card): up to the card's per-block maximum.
template <typename Kernel>
int reserve_smem(Kernel kernel, size_t smem, bool* opted) {
  if (smem <= kDefaultSmem) return 0;
  int dev = 0, max_optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&max_optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err != cudaSuccess) return (int)err;
  if (smem > (size_t)max_optin) return (int)cudaErrorInvalidValue;
  if (!*opted) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               max_optin);
    if (err != cudaSuccess) return (int)err;
    *opted = true;
  }
  return 0;
}

bool valid_launch(int n_runs, int n_feat, int tile, int threads) {
  return n_runs > 0 && n_feat > 0 && tile > 0 && threads > 0 &&
         threads <= kMaxThreads && threads % 32 == 0;
}

}  // namespace

// Launches the vector body over one segment whose runs are given by run_ptr
// (n_runs + 1 offsets into the tile arrays).  All pointers are device
// pointers; `stream` is a cudaStream_t.  `threads` must be a multiple of 32
// no larger than 128.  `n_z_rows` is z's row count (the dense branch reads
// whole Z blocks and treats rows past it as zero).  A tile with
// nnz > dense_threshold >= 0 takes the dense branch; a negative threshold
// turns the branch off, and only then is no room kept for D.  Shared memory:
// the tile x threads f32 strip, plus a tile x ((tile + 3) & ~3) f32 D when
// the branch is on; above 48 KB the kernel opts in.  Allocates nothing and
// does not synchronise; returns cudaGetLastError() after the launch.
extern "C" int scv_spmm_runs(const void* tile_row, const void* tile_col,
                             const void* nnz_in_tile, const void* rows,
                             const void* cols, const void* vals,
                             const void* run_ptr, const void* z, void* out,
                             int n_runs, int cap, int n_feat, int tile,
                             int threads, int accumulate, int n_z_rows,
                             int dense_threshold, void* stream) {
  static bool opted = false;
  if (!valid_launch(n_runs, n_feat, tile, threads)) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t ldd = (size_t)((tile + 3) & ~3);
  const size_t smem = sizeof(float) * ((size_t)tile * (size_t)threads +
                                       (dense_threshold >= 0 ? (size_t)tile * ldd : 0));
  const int rc = reserve_smem(scv_spmm_runs_kernel, smem, &opted);
  if (rc != 0) return rc;
  const dim3 grid((unsigned)n_runs, (unsigned)((n_feat + threads - 1) / threads));
  scv_spmm_runs_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      (const int32_t*)tile_row, (const int32_t*)tile_col,
      (const int32_t*)nnz_in_tile, (const int32_t*)rows, (const int32_t*)cols,
      (const float*)vals, (const int32_t*)run_ptr, (const float*)z,
      (float*)out, cap, n_feat, tile, accumulate, n_z_rows, dense_threshold);
  return (int)cudaGetLastError();
}

// Launches the scalar body; arguments as scv_spmm_runs without the dense
// branch's.  Shared memory: the strip plus kStage staged entries (12 bytes
// each); above 48 KB the kernel opts in.
extern "C" int scv_spmm_runs_scalar(const void* tile_row, const void* tile_col,
                                    const void* nnz_in_tile, const void* rows,
                                    const void* cols, const void* vals,
                                    const void* run_ptr, const void* z, void* out,
                                    int n_runs, int cap, int n_feat, int tile,
                                    int threads, int accumulate, void* stream) {
  static bool opted = false;
  if (!valid_launch(n_runs, n_feat, tile, threads)) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = sizeof(float) * (size_t)tile * (size_t)threads +
                      (size_t)kStage * (2 * sizeof(int32_t) + sizeof(float));
  const int rc = reserve_smem(scv_spmm_runs_scalar_kernel, smem, &opted);
  if (rc != 0) return rc;
  const dim3 grid((unsigned)n_runs, (unsigned)((n_feat + threads - 1) / threads));
  scv_spmm_runs_scalar_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      (const int32_t*)tile_row, (const int32_t*)tile_col,
      (const int32_t*)nnz_in_tile, (const int32_t*)rows, (const int32_t*)cols,
      (const float*)vals, (const int32_t*)run_ptr, (const float*)z,
      (float*)out, cap, n_feat, tile, accumulate);
  return (int)cudaGetLastError();
}

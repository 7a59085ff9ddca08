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
// reach its matrix unit are not carried over: here each entry is a load of
// one Z value per feature column and one FMA.
//
// What bounds it on an H100: bytes.  Each entry costs 12 bytes of index and
// value data and a Z row gather (4 * F bytes, mostly from L2 when a column
// block is reused), against 2 * F flops, far below the ~20 flops per byte at
// which the card's fp32 rate would take over.  What keeps a kernel of this
// kind from its bound is latency, not bandwidth: a hub block-row's run of
// thousands of tiles walked by one block, and per tile a chain of dependent
// loads (header, then entries, then Z rows).  The vector body's design:
//   * work units, not runs (core/scv.py::RunIndex): a unit is a span of one
//     block-row run's tiles holding at most UNIT_WORK tiles + entries, and a
//     thread block owns one (unit, feature block).  The units are launched
//     heaviest first.  Trailing zero-nnz tiles (the serving composite's
//     tile-count padding) lie in no unit and cost nothing;
//   * the T x Fb output strip lives in shared memory.  A run of one unit
//     seeds it (zero, or `out` in accumulate mode) and writes it to device
//     memory once.  The units of a split run write partial strips to
//     scratch; the block that finishes its run's work last (a per-run
//     counter: __threadfence, then atomicAdd) adds the seed and the partials
//     in unit order, writes the strip and sets the counter back to 0.  No
//     float atomics: the sums are taken in a fixed order, so two launches on
//     the same inputs give the same bits;
//   * staging: the block copies up to kHeaders tile headers into shared
//     memory with coalesced loads, one warp sorts them into live sparse
//     tiles (with entry offsets) and dense tiles, and the block then copies
//     up to kEntries live entries at a time into shared memory, marking
//     each group of kGroup whose rows are pairwise distinct.  Entries past
//     a tile's nnz are never read;
//   * gather: each thread owns one feature column and walks the staged
//     entries (16-byte broadcast reads).  It holds only Z values in
//     registers: the next kAhead are requested before the current kAhead
//     are added, so a thread keeps up to 2 * kAhead gathers in flight.  A
//     group with distinct rows reads, updates and writes its kGroup strip
//     rows side by side; any other group goes one entry after the other.
//     Each thread updates only its own column of the strip, each row in
//     entry order, so no barrier guards it;
//   * the run's last block reads the partial strips kWide values at a time,
//     the next kWide requested before the current are added;
//   * dense tiles (0 <= dense_threshold < nnz, the reference's rule
//     :147-148; replaces _dense): each thread copies its column of the
//     tile's T x Fb Z block into shared memory once, then walks the tile's
//     staged entries reading Z from there.  The one read of the Z block is
//     the dense branch's gain; it costs nnz * F FMAs, not T^2 * F.  Within
//     a header chunk the sparse tiles' entries are summed before the dense
//     tiles', a fixed order.
// Accumulate mode seeds the strip from `out` instead of zero, which is how a
// chain of per-capacity-bucket launches sums into one output.  A unit whose
// run is -1 is padding (a launch captured in a CUDA graph has a grid sized
// from the segment's shapes, core/scv.py::RunIndex.padded): both bodies
// return from it before any other read.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 128;
constexpr int kMinBlocks = 4;  // vector-body blocks an SM should hold (caps registers at 128)
constexpr int kGroup = 8;      // staged entries whose strip updates may run side by side
constexpr int kAhead = 32;     // entries whose Z values a thread requests ahead
constexpr int kWide = 32;      // partial-strip values the run's last block reads at a time
constexpr int kHeaders = 256;  // tile headers the vector body stages at a time
constexpr int kEntries = 256;  // entries the vector body stages at a time
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr unsigned kFullMask = 0xffffffffu;

// One staged entry: its row in the strip, its Z row (global for a sparse
// tile, within the staged Z block for a dense one) and its value.  16 bytes,
// so a thread reads one with a single broadcast load.  `distinct`, on the
// first entry of each whole group of kGroup, says that the group's rows are
// pairwise distinct.
struct __align__(16) Entry {
  int row;
  int col;
  float val;
  int distinct;
};

// Staged tile headers of one chunk, and the warp-built lists over them.
struct Headers {
  int nnz[kHeaders];
  int col[kHeaders];
  int sparse[kHeaders];      // positions of the live sparse tiles, in order
  int offset[kHeaders + 1];  // their first entry in the chunk's entry list, then the total
  int dense[kHeaders];       // positions of the dense tiles, in order
  int n_sparse;
  int n_dense;
  int last;  // this block finishes its split run
};

// Warp 0: sorts headers [0, n) into the live sparse tiles, with their entry
// offsets, and the dense tiles.  Each lane takes kHeaders / 32 consecutive
// headers; warp-wide exclusive sums place them in schedule order.
__device__ void index_headers(Headers& h, int n, int dense_threshold) {
  constexpr int kPer = kHeaders / 32;
  const int lane = threadIdx.x;
  const int i0 = lane * kPer;
  int n_sp = 0, n_dn = 0, n_en = 0;
  for (int k = 0; k < kPer; ++k) {
    const int i = i0 + k;
    if (i < n) {
      const int nnz = h.nnz[i];
      const bool dense = dense_threshold >= 0 && nnz > dense_threshold;
      n_dn += dense;
      n_sp += !dense && nnz > 0;
      n_en += dense ? 0 : nnz;
    }
  }
  int sp = n_sp, dn = n_dn, en = n_en;
  for (int d = 1; d < 32; d <<= 1) {
    const int a = __shfl_up_sync(kFullMask, sp, d);
    const int b = __shfl_up_sync(kFullMask, dn, d);
    const int c = __shfl_up_sync(kFullMask, en, d);
    if (lane >= d) {
      sp += a;
      dn += b;
      en += c;
    }
  }
  sp -= n_sp;
  dn -= n_dn;
  en -= n_en;
  for (int k = 0; k < kPer; ++k) {
    const int i = i0 + k;
    if (i < n) {
      const int nnz = h.nnz[i];
      if (dense_threshold >= 0 && nnz > dense_threshold) {
        h.dense[dn++] = i;
      } else if (nnz > 0) {
        h.sparse[sp] = i;
        h.offset[sp++] = en;
        en += nnz;
      }
    }
  }
  if (lane == 31) {
    h.n_sparse = sp;
    h.n_dense = dn;
    h.offset[sp] = en;
  }
}

// Marks each whole group of kGroup staged entries [0, n) whose rows are
// pairwise distinct: its strip updates touch kGroup different rows and may
// be issued side by side.
__device__ void mark_groups(Entry* entries, int n) {
  for (int g = threadIdx.x; g < n / kGroup; g += blockDim.x) {
    Entry* e = entries + g * kGroup;
    int r[kGroup];
#pragma unroll
    for (int u = 0; u < kGroup; ++u) r[u] = e[u].row;
    bool distinct = true;
#pragma unroll
    for (int a = 0; a < kGroup; ++a) {
#pragma unroll
      for (int b = a + 1; b < kGroup; ++b) distinct &= r[a] != r[b];
    }
    e->distinct = distinct;
  }
}

// The Z value an entry names, for this thread's feature column: from device
// memory (sparse tile; zsrc = z + f, ld = n_feat) or from the staged Z block
// (dense tile; zsrc = zblk + threadIdx.x, ld = the strip stride).
template <bool kDense>
__device__ __forceinline__ float z_of(const Entry& e, const float* zsrc, int ld) {
  if (kDense) return zsrc[e.col * ld];
  return __ldg(zsrc + (int64_t)e.col * ld);
}

// Adds the group of kGroup staged entries at `e`, whose Z values are zv,
// into this thread's strip column.  Rows pairwise distinct: all reads, then
// all FMAs and writes, side by side.  Otherwise one entry after the other,
// in entry order.  The same FMAs on the same values either way.
__device__ __forceinline__ void add_group(const Entry* e, const float* zv, float* col,
                                          int stride) {
  int r[kGroup];
  float v[kGroup];
#pragma unroll
  for (int u = 0; u < kGroup; ++u) {
    const Entry x = e[u];
    r[u] = x.row;
    v[u] = x.val;
  }
  if (e[0].distinct) {
    float s[kGroup];
#pragma unroll
    for (int u = 0; u < kGroup; ++u) s[u] = col[r[u] * stride];
#pragma unroll
    for (int u = 0; u < kGroup; ++u) col[r[u] * stride] = fmaf(v[u], zv[u], s[u]);
  } else {
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      col[r[u] * stride] = fmaf(v[u], zv[u], col[r[u] * stride]);
    }
  }
}

// Adds the staged entries [0, n) into this thread's strip column, in entry
// order for each row.  Only the Z values are held in registers: those of
// the next kAhead entries are requested before the current kAhead are
// added (up to 2 * kAhead in flight); rows and values are read from shared
// memory when they are added.
template <bool kDense>
__device__ __forceinline__ void walk(const Entry* entries, int n, float* col, int stride,
                                     const float* zsrc, int ld) {
  int k = 0;
  if (n >= kAhead) {
    float zv[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) zv[u] = z_of<kDense>(entries[u], zsrc, ld);
    for (; k + 2 * kAhead <= n; k += kAhead) {
      float zn[kAhead];
#pragma unroll
      for (int u = 0; u < kAhead; ++u) zn[u] = z_of<kDense>(entries[k + kAhead + u], zsrc, ld);
#pragma unroll
      for (int g = 0; g < kAhead; g += kGroup) add_group(entries + k + g, zv + g, col, stride);
#pragma unroll
      for (int u = 0; u < kAhead; ++u) zv[u] = zn[u];
    }
#pragma unroll
    for (int g = 0; g < kAhead; g += kGroup) add_group(entries + k + g, zv + g, col, stride);
    k += kAhead;
  }
  for (; k + kGroup <= n; k += kGroup) {
    float zv[kGroup];
#pragma unroll
    for (int u = 0; u < kGroup; ++u) zv[u] = z_of<kDense>(entries[k + u], zsrc, ld);
    add_group(entries + k, zv, col, stride);
  }
  for (; k < n; ++k) {
    const Entry e = entries[k];
    col[e.row * stride] = fmaf(e.val, z_of<kDense>(e, zsrc, ld), col[e.row * stride]);
  }
}

// Seeds this thread's strip column: from `out` (accumulate mode, a run of
// one unit) or zero.  The units of a split run sum from zero; the run's
// last block adds the seed.  One branch outside the loops: with the choice
// inside the loop, the vector body ran a few percent slower on the H100.
__device__ __forceinline__ void seed_strip(float* col, int stride, const float* out_col,
                                           int n_feat, int tile, bool from_out) {
  if (from_out) {
    for (int r = 0; r < tile; ++r) col[r * stride] = out_col[(int64_t)r * n_feat];
  } else {
    for (int r = 0; r < tile; ++r) col[r * stride] = 0.0f;
  }
}

// Ends a work unit's block, every thread of it.  A run of one unit writes
// its strip.  A split run: publish this unit's partial strip, then the
// run's last block to arrive (a per-(run, feature block) counter:
// __threadfence, then atomicAdd) sums seed and partials in unit order,
// writes the strip and sets the counter back to 0.  `u` is the unit,
// `first` and `count` its run's first unit and unit count, `last` a flag
// in shared memory.
__device__ __forceinline__ void finish_unit(float* col, int stride, float* out_col,
                                            float* scratch, int32_t* counters, int* last,
                                            int4 unit, int u, int first, int count, int tile,
                                            int n_feat, int f, bool active, int accumulate) {
  if (count == 1) {
    if (active) {
      for (int r = 0; r < tile; ++r) out_col[(int64_t)r * n_feat] = col[r * stride];
    }
    return;
  }
  if (active) {
    float* part = scratch + (int64_t)unit.w * tile * n_feat + f;
    for (int r = 0; r < tile; ++r) part[(int64_t)r * n_feat] = col[r * stride];
  }
  __threadfence();
  __syncthreads();
  int32_t* counter = counters + (int64_t)unit.z * gridDim.y + blockIdx.y;
  if (threadIdx.x == 0) *last = atomicAdd(counter, 1) == count - 1;
  __syncthreads();
  if (!*last) return;
  __threadfence();
  if (active) {
    for (int r = 0; r < tile; ++r) {
      col[r * stride] = accumulate ? out_col[(int64_t)r * n_feat] : 0.0f;
    }
    // The run's units hold consecutive scratch slots, so partial k's row r
    // is element k * tile + r from the first: walking the elements in order
    // adds each row's partials in unit order.  kWide reads in flight, the
    // next kWide requested before the current are added.
    const float* p = scratch + (int64_t)(unit.w - (u - first)) * tile * n_feat + f;
    const int n = count * tile;
    int i = 0, r = 0;
    if (n >= kWide) {
      float cur[kWide];
#pragma unroll
      for (int w = 0; w < kWide; ++w) cur[w] = __ldcg(p + (int64_t)w * n_feat);
      for (; i + 2 * kWide <= n; i += kWide) {
        float nxt[kWide];
#pragma unroll
        for (int w = 0; w < kWide; ++w) nxt[w] = __ldcg(p + (int64_t)(i + kWide + w) * n_feat);
#pragma unroll
        for (int w = 0; w < kWide; ++w) {
          col[r * stride] += cur[w];
          r = r + 1 == tile ? 0 : r + 1;
          cur[w] = nxt[w];
        }
      }
#pragma unroll
      for (int w = 0; w < kWide; ++w) {
        col[r * stride] += cur[w];
        r = r + 1 == tile ? 0 : r + 1;
      }
      i += kWide;
    }
    for (; i < n; ++i) {
      col[r * stride] += __ldcg(p + (int64_t)i * n_feat);
      r = r + 1 == tile ? 0 : r + 1;
    }
    for (r = 0; r < tile; ++r) out_col[(int64_t)r * n_feat] = col[r * stride];
  }
  if (threadIdx.x == 0) *counter = 0;  // ready for the next launch
}

__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
scv_spmm_runs_kernel(const int32_t* __restrict__ tile_row,
                     const int32_t* __restrict__ tile_col,
                     const int32_t* __restrict__ nnz_in_tile,
                     const int32_t* __restrict__ rows,
                     const int32_t* __restrict__ cols,
                     const float* __restrict__ vals,
                     const int4* __restrict__ units,
                     const int32_t* __restrict__ unit_ptr,
                     const int32_t* __restrict__ order,
                     const float* __restrict__ z,
                     float* __restrict__ out,
                     float* __restrict__ scratch,
                     int32_t* __restrict__ counters,
                     int cap, int n_feat, int tile, int accumulate,
                     int n_z_rows, int dense_threshold) {
  extern __shared__ float4 smem4[];
  const int stride = blockDim.x;
  float* strip = reinterpret_cast<float*>(smem4);  // [tile][stride]
  float* zblk = strip + tile * stride;  // [tile][stride], only when dense_threshold >= 0
  Entry* entries = reinterpret_cast<Entry*>(zblk + (dense_threshold >= 0 ? tile * stride : 0));
  Headers& h = *reinterpret_cast<Headers*>(entries + kEntries);
  const int f = blockIdx.y * blockDim.x + threadIdx.x;
  // Threads past the feature width stage entries and reach every barrier,
  // but touch no strip column, Z column or output column.
  const bool active = f < n_feat;
  float* col = strip + threadIdx.x;  // this thread's column of the strip

  const int u = order[blockIdx.x];
  const int4 unit = units[u];  // first tile, end tile, run, scratch slot
  if (unit.z < 0) return;  // a padding unit of a captured launch's grid
  const int first = unit_ptr[unit.z];
  const int count = unit_ptr[unit.z + 1] - first;
  const bool split = count > 1;
  float* out_col = out + (int64_t)tile_row[unit.x] * tile * n_feat + f;

  if (active) seed_strip(col, stride, out_col, n_feat, tile, accumulate && !split);

  for (int h0 = unit.x; h0 < unit.y; h0 += kHeaders) {
    const int n_h = min(kHeaders, unit.y - h0);
    __syncthreads();  // the previous chunk's readers are done with headers and entries
    for (int i = threadIdx.x; i < n_h; i += blockDim.x) {
      h.nnz[i] = nnz_in_tile[h0 + i];
      h.col[i] = tile_col[h0 + i];
    }
    __syncthreads();
    if (threadIdx.x < 32) index_headers(h, n_h, dense_threshold);
    __syncthreads();

    // sparse tiles: their live entries, kEntries at a time
    const int n_sp = h.n_sparse;
    const int total = h.offset[n_sp];
    for (int e0 = 0; e0 < total; e0 += kEntries) {
      const int n = min(kEntries, total - e0);
      if (e0) __syncthreads();  // every thread is done with the previous entries
      for (int k = threadIdx.x; k < n; k += blockDim.x) {
        const int e = e0 + k;
        int lo = 0, hi = n_sp - 1;  // the last sparse tile whose offset is <= e
        while (lo < hi) {
          const int mid = (lo + hi + 1) >> 1;
          if (h.offset[mid] <= e) lo = mid; else hi = mid - 1;
        }
        const int i = h.sparse[lo];
        const int64_t slot = (int64_t)(h0 + i) * cap + (e - h.offset[lo]);
        entries[k] = Entry{rows[slot], h.col[i] * tile + cols[slot], vals[slot], 0};
      }
      __syncthreads();
      mark_groups(entries, n);
      __syncthreads();
      if (active) walk<false>(entries, n, col, stride, z + f, n_feat);
    }

    // dense tiles, one at a time: this thread's column of the Z block, then
    // the tile's entries, kEntries at a time
    for (int d = 0; d < h.n_dense; ++d) {
      const int i = h.dense[d];
      const int nnz = h.nnz[i];
      const int col_base = h.col[i] * tile;
      if (active) {
        const float* zc = z + (int64_t)col_base * n_feat + f;
        const int z_valid = n_z_rows - col_base;  // Z rows past z's end count as zero
#pragma unroll 8
        for (int c = 0; c < tile; ++c) {
          zblk[c * stride + threadIdx.x] = c < z_valid ? __ldg(zc + (int64_t)c * n_feat) : 0.0f;
        }
      }
      const int64_t base = (int64_t)(h0 + i) * cap;
      for (int j0 = 0; j0 < nnz; j0 += kEntries) {
        const int n = min(kEntries, nnz - j0);
        __syncthreads();  // every thread is done with the previous entries
        for (int k = threadIdx.x; k < n; k += blockDim.x) {
          const int64_t slot = base + j0 + k;
          entries[k] = Entry{rows[slot], cols[slot], vals[slot], 0};
        }
        __syncthreads();
        mark_groups(entries, n);
        __syncthreads();
        if (active) walk<true>(entries, n, col, stride, zblk + threadIdx.x, stride);
      }
    }
  }

  finish_unit(col, stride, out_col, scratch, counters, &h.last, unit, u, first, count, tile,
              n_feat, f, active, accumulate);
}

// Scalar body (replaces _kernel_scalar, scv_spmm.py:57): the plain
// per-entry loop out[r, :] += v * Z[c, :], entry after entry, kept as the
// measured baseline; no dense branch.  Bounded on this card, as the vector
// body is, by latency rather than bytes: each entry is a Z-row gather and
// a read-modify-write of one strip row that the next entry may touch, so
// a warp's strip updates form one dependent chain (a shared-memory load,
// an FMA, a store) and a launch lasts about as long as its heaviest unit's
// chain.  The design:
//   * work units, as the vector body's: one block per (unit, feature
//     block), heaviest first; a split run merged by the same finish_unit;
//   * entries staged asynchronously.  A tile's live entries lie contiguous
//     in rows/cols/vals (slot t * cap + j), so warp 0 cuts the unit's
//     tiles into chunks of at most kPieces tile slices and 4 * kQuads
//     entries (plan_chunk) and copies them with cp.async into a ring of
//     kStages stages (copy_chunk): 16-byte copies where a quad of entries
//     is whole and the three arrays share their 16-byte phase, 4-byte
//     copies at a slice's unaligned head and tail (a cap that is not a
//     multiple of 4).  The next chunk lands while the block walks this one;
//     one barrier a chunk;
//   * gathers in flight: a thread (one feature column) requests the Z
//     values of the next batch of kBatch entries (one slice's) before it
//     reads the current batch's rows and values into registers and adds
//     it, so the next batch's gathers overlap the current batch's strip
//     updates, which run one entry after another, in entry order.  Two
//     register buffers take the batches' Z values in turn, and an address
//     is one 32 x 32 -> 64-bit multiply-add from the slice's first Z row;
//   * shared-memory traffic: each warp reads every staged entry, so a
//     batch that starts on a quad reads rows, columns and values four at
//     a time (16-byte broadcasts); an unaligned slice's first 1-3 entries
//     are a batch of their own, read one by one.
// No float atomics: two launches on the same inputs give the same bits.
constexpr int kBatch = 16;   // entries a scalar-body thread holds in registers at a time
constexpr int kQuads = 128;  // 16-byte quads of each entry array a stage holds
constexpr int kStages = 2;   // stages in the scalar body's ring
constexpr int kPieces = 32;  // tile slices a chunk holds at most (one per lane of warp 0)
static_assert(kBatch % 4 == 0, "a batch on a quad is read a quad at a time");

// One chunk of a unit's live entries: up to kPieces slices of consecutive
// tiles.  Slice p is `count[p]` entries from slot `src[p]`, staged from
// element `dst[p]` of the stage's arrays, whose 16-byte phase is src's; it
// starts in quad `quad[p]`, and `quad[n_pieces]` is the quads used.
struct Chunk {
  int64_t src[kPieces];
  int dst[kPieces];
  int count[kPieces];
  int zrow[kPieces];  // the slice's tile's first Z row, tile_col * tile
  int quad[kPieces + 1];
  int n_pieces;
  int last;  // the unit's last chunk
};

struct __align__(16) Stage {
  int32_t rows[4 * kQuads];
  int32_t cols[4 * kQuads];
  float vals[4 * kQuads];
  Chunk chunk;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Warp 0: plans the chunk that starts at the cursor (tile t, entry j) of
// tiles [t, end) into ch, and moves the cursor past it.  Lane l looks at
// tile t + l: its slice needs ceil((phase + count) / 4) quads, and a
// warp-wide sum places the slices until kQuads are used; the last slice
// may be cut.  Tiles without entries give no slice.
__device__ __forceinline__ void plan_chunk(Chunk& ch, int& t, int& j, int end,
                           const int32_t* __restrict__ nnz_in_tile,
                           const int32_t* __restrict__ tile_col,
                           const int32_t* __restrict__ rows, int cap, int tile) {
  const int lane = threadIdx.x;
  const int tt = t + lane;
  const bool valid = tt < end;
  const int j0 = lane == 0 ? j : 0;
  const int count = valid ? nnz_in_tile[tt] - j0 : 0;
  const int64_t src = (int64_t)tt * cap + j0;
  const int phase = valid ? (int)((reinterpret_cast<uintptr_t>(rows + src) >> 2) & 3) : 0;
  const int quads = count > 0 ? (phase + count + 3) >> 2 : 0;
  int incl = quads;
  for (int d = 1; d < 32; d <<= 1) {
    const int x = __shfl_up_sync(kFullMask, incl, d);
    if (lane >= d) incl += x;
  }
  const int excl = incl - quads;
  const bool taken = count > 0 && excl < kQuads;
  const int n_take = !taken ? 0 : incl <= kQuads ? count : 4 * (kQuads - excl) - phase;
  const unsigned took = __ballot_sync(kFullMask, taken);
  if (taken) {
    const int p = __popc(took & ((1u << lane) - 1));
    ch.src[p] = src;
    ch.dst[p] = 4 * excl + phase;
    ch.count[p] = n_take;
    ch.zrow[p] = tile_col[tt] * tile;
    ch.quad[p] = excl;
  }
  // tiles given whole form a prefix of the lanes; the cursor moves to the
  // first tile not given whole, past what it gave
  const int whole = __popc(__ballot_sync(kFullMask, valid && incl <= kQuads));
  const int j_next = __shfl_sync(kFullMask, j0 + n_take, whole & 31);
  const int total = __shfl_sync(kFullMask, incl, 31);
  t += whole;
  j = whole < 32 && t < end ? j_next : 0;
  if (lane == 0) {
    const int n_pieces = __popc(took);
    ch.n_pieces = n_pieces;
    ch.quad[n_pieces] = min(total, kQuads);
    ch.last = t >= end;
  }
  __syncwarp();
}

// Warp 0: copies the planned chunk into its stage with cp.async, one quad
// of each array a lane at a time, and commits the copies as one group.
// `wide`: rows, cols and vals share their 16-byte phase, so a whole quad
// is one 16-byte copy of each.
__device__ __forceinline__ void copy_chunk(Stage& s, const int32_t* __restrict__ rows,
                            const int32_t* __restrict__ cols, const float* __restrict__ vals,
                            bool wide) {
  const Chunk& ch = s.chunk;
  const int n_pieces = ch.n_pieces;
  for (int q = threadIdx.x; q < ch.quad[n_pieces]; q += 32) {
    int lo = 0, hi = n_pieces - 1;  // the last slice that starts at or before quad q
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (ch.quad[mid] <= q) lo = mid; else hi = mid - 1;
    }
    const int dst = ch.dst[lo];
    const int64_t src = ch.src[lo];
    const int e0 = 4 * q - dst;  // the quad's first element, within the slice
    const int n = ch.count[lo];
    if (wide && e0 >= 0 && e0 + 4 <= n) {
      cp_async16(s.rows + 4 * q, rows + src + e0);
      cp_async16(s.cols + 4 * q, cols + src + e0);
      cp_async16(s.vals + 4 * q, vals + src + e0);
    } else {
      for (int e = max(e0, 0); e < min(e0 + 4, n); ++e) {
        cp_async4(s.rows + dst + e, rows + src + e);
        cp_async4(s.cols + dst + e, cols + src + e);
        cp_async4(s.vals + dst + e, vals + src + e);
      }
    }
  }
  cp_async_commit();
}

// A batch of the staged chunk: consecutive entries of one slice, from
// element `i`, whose Z rows start at `zrow`.  A batch starts on a quad
// (i % 4 == 0) and holds up to kBatch entries, or is a slice's unaligned
// head and holds the up to 3 entries before its first quad.
struct Batch {
  int i, n, zrow;
};

// The batch after `b` (n = 0 past the chunk's end); (p, left): the slice
// being read and the entries left in it after b.
__device__ __forceinline__ Batch next_batch(const Chunk& ch, const Batch& b, int& p, int& left) {
  Batch nb{b.i + b.n, 0, b.zrow};
  if (left == 0 && p + 1 < ch.n_pieces) {
    ++p;
    nb.i = ch.dst[p];
    nb.zrow = ch.zrow[p];
    left = ch.count[p];
  }
  nb.n = min(nb.i & 3 ? 4 - (nb.i & 3) : kBatch, left);
  left -= nb.n;
  return nb;
}

// Reads batch b's elements of staged array `a` into registers: a quad
// (one 16-byte broadcast) at a time, or one by one for an unaligned head.
template <typename T, typename T4>
__device__ __forceinline__ void read_staged(const T* a, const Batch& b, T* out) {
  if ((b.i & 3) == 0) {
#pragma unroll
    for (int q = 0; q < kBatch / 4; ++q) {
      if (4 * q < b.n) {
        const T4 x = *reinterpret_cast<const T4*>(a + b.i + 4 * q);
        out[4 * q] = x.x;
        out[4 * q + 1] = x.y;
        out[4 * q + 2] = x.z;
        out[4 * q + 3] = x.w;
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      if (k < b.n) out[k] = a[b.i + k];
    }
  }
}

// Requests the Z values of batch b for this thread's column: `zcol` is
// this thread's column of Z, `ld4` a Z row's bytes.  The slice's first Z
// row is found once; each entry's address is then one 32 x 32 -> 64-bit
// multiply-add from it.  kFull: the batch holds kBatch entries, so no
// entry needs a predicate.
template <bool kFull>
__device__ __forceinline__ void gather(const Stage& s, const Batch& b, const char* zcol, int ld4,
                                       float* zv) {
  int c[kBatch];
  read_staged<int, int4>(s.cols, b, c);
  const uint64_t zs = reinterpret_cast<uint64_t>(zcol + (int64_t)b.zrow * ld4);
#pragma unroll
  for (int k = 0; k < kBatch; ++k) {
    const uint64_t a = (uint64_t)(unsigned)c[k] * (unsigned)ld4 + zs;
    if (kFull || k < b.n) zv[k] = __ldg(reinterpret_cast<const float*>(a));
  }
}

// Adds batch b, whose Z values are zv, into this thread's strip column
// (`stride4`: a strip row's bytes), one entry after another.
template <bool kFull>
__device__ __forceinline__ void add_batch(const Stage& s, const Batch& b, const float* zv,
                                          char* col, int stride4) {
  int r[kBatch];
  float v[kBatch];
  read_staged<int, int4>(s.rows, b, r);
  read_staged<float, float4>(s.vals, b, v);
#pragma unroll
  for (int k = 0; k < kBatch; ++k) {
    if (kFull || k < b.n) {
      float* x = reinterpret_cast<float*>(col + r[k] * stride4);
      *x = fmaf(v[k], zv[k], *x);
    }
  }
}

// Adds the staged chunk into this thread's strip column, entry after
// entry.  The next batch's Z values are requested before the current
// batch's rows and values are read and the batch is added, so they load
// while its strip updates run.
__device__ __forceinline__ void walk_chunk(const Stage& s, float* col, int stride,
                                           const float* zsrc, int ld) {
  const char* zcol = reinterpret_cast<const char*>(zsrc);
  char* colb = reinterpret_cast<char*>(col);
  const int ld4 = 4 * ld, stride4 = 4 * stride;
  int p = -1, left = 0;
  // gathers the next batch into `into`, then adds `b` from `from`; returns
  // the next batch
  const auto step = [&](const Batch& b, const float* from, float* into) {
    const Batch nb = next_batch(s.chunk, b, p, left);
    if (nb.n == kBatch) gather<true>(s, nb, zcol, ld4, into);
    else gather<false>(s, nb, zcol, ld4, into);
    if (b.n == kBatch) add_batch<true>(s, b, from, colb, stride4);
    else add_batch<false>(s, b, from, colb, stride4);
    return nb;
  };
  float za[kBatch], zb[kBatch];  // two batches' Z values, in turn
  Batch b = next_batch(s.chunk, Batch{0, 0, 0}, p, left);
  if (b.n == kBatch) gather<true>(s, b, zcol, ld4, za); else gather<false>(s, b, zcol, ld4, za);
  while (b.n > 0) {
    b = step(b, za, zb);
    if (b.n == 0) break;
    b = step(b, zb, za);
  }
}

__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
scv_spmm_runs_scalar_kernel(const int32_t* __restrict__ tile_row,
                            const int32_t* __restrict__ tile_col,
                            const int32_t* __restrict__ nnz_in_tile,
                            const int32_t* __restrict__ rows,
                            const int32_t* __restrict__ cols,
                            const float* __restrict__ vals,
                            const int4* __restrict__ units,
                            const int32_t* __restrict__ unit_ptr,
                            const int32_t* __restrict__ order,
                            const float* __restrict__ z,
                            float* __restrict__ out,
                            float* __restrict__ scratch,
                            int32_t* __restrict__ counters,
                            int cap, int n_feat, int tile, int accumulate) {
  extern __shared__ float4 smem4[];
  const int stride = blockDim.x;
  float* strip = reinterpret_cast<float*>(smem4);  // [tile][stride]
  Stage* ring = reinterpret_cast<Stage*>(strip + tile * stride);
  int* last = reinterpret_cast<int*>(ring + kStages);
  const int f = blockIdx.y * blockDim.x + threadIdx.x;
  const bool active = f < n_feat;  // the rest reach every barrier, nothing more
  float* col = strip + threadIdx.x;

  const int u = order[blockIdx.x];
  const int4 unit = units[u];  // first tile, end tile, run, scratch slot
  if (unit.z < 0) return;  // a padding unit of a captured launch's grid
  const int first = unit_ptr[unit.z];
  const int count = unit_ptr[unit.z + 1] - first;
  float* out_col = out + (int64_t)tile_row[unit.x] * tile * n_feat + f;
  if (active) seed_strip(col, stride, out_col, n_feat, tile, accumulate && count == 1);

  const bool producer = threadIdx.x < 32;
  const auto align16 = [](const void* a) { return reinterpret_cast<uintptr_t>(a) & 15; };
  const bool wide = align16(rows) == align16(cols) && align16(rows) == align16(vals);
  int t = unit.x, j = 0;  // warp 0's cursor
  if (producer) {
    for (int c = 0; c < kStages - 1; ++c) {
      plan_chunk(ring[c].chunk, t, j, unit.y, nnz_in_tile, tile_col, rows, cap, tile);
      copy_chunk(ring[c], rows, cols, vals, wide);
    }
  }
  for (int c = 0;; ++c) {
    const Stage& s = ring[c % kStages];
    if (producer) cp_async_wait<kStages - 2>();
    __syncthreads();  // chunk c has landed; every thread is done with chunk c - 1
    const bool final = s.chunk.last;
    if (producer && !final) {
      Stage& next = ring[(c + kStages - 1) % kStages];  // chunk c - 1's stage
      plan_chunk(next.chunk, t, j, unit.y, nnz_in_tile, tile_col, rows, cap, tile);
      copy_chunk(next, rows, cols, vals, wide);
    }
    if (active) walk_chunk(s, col, stride, z + f, n_feat);
    if (final) break;
  }
  finish_unit(col, stride, out_col, scratch, counters, last, unit, u, first, count, tile,
              n_feat, f, active, accumulate);
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

bool valid_launch(int n_blocks, int n_feat, int tile, int threads) {
  return n_blocks > 0 && n_feat > 0 && tile > 0 && threads > 0 &&
         threads <= kMaxThreads && threads % 32 == 0;
}

}  // namespace

// Launches the vector body over one segment's n_units work units
// (RunIndex: `units` int4 (first tile, end tile, run, scratch slot),
// `unit_ptr` n_runs + 1 offsets into them, `order` the launch order).  All
// pointers are device pointers; `stream` is a cudaStream_t.  `threads` must
// be a multiple of 32 no larger than 128.  `n_z_rows` is z's row count (the
// dense branch stages whole Z blocks and treats rows past it as zero).  A
// tile with nnz > dense_threshold >= 0 takes the dense branch; a negative
// threshold turns the branch off, and only then is no room kept for the Z
// block.  `scratch` holds one tile x n_feat f32 partial strip per unit of a
// split run and `counters` one int32 per (run, feature block), all zero; both
// may be null when no run is split.  Shared memory: the tile x threads f32
// strip, the Z block of the same size when the branch is on, kEntries staged
// entries and kHeaders staged headers; above 48 KB the kernel opts in.
// Allocates nothing and does not synchronise; returns cudaGetLastError()
// after the launch.
extern "C" int scv_spmm_runs(const void* tile_row, const void* tile_col,
                             const void* nnz_in_tile, const void* rows,
                             const void* cols, const void* vals,
                             const void* units, const void* unit_ptr,
                             const void* order, const void* z, void* out,
                             void* scratch, void* counters,
                             int n_units, int cap, int n_feat, int tile,
                             int threads, int accumulate, int n_z_rows,
                             int dense_threshold, void* stream) {
  static bool opted = false;
  if (!valid_launch(n_units, n_feat, tile, threads)) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t strips = dense_threshold >= 0 ? 2 : 1;
  const size_t smem = sizeof(float) * (size_t)tile * (size_t)threads * strips +
                      sizeof(Entry) * kEntries + sizeof(Headers);
  const int rc = reserve_smem(scv_spmm_runs_kernel, smem, &opted);
  if (rc != 0) return rc;
  const dim3 grid((unsigned)n_units, (unsigned)((n_feat + threads - 1) / threads));
  scv_spmm_runs_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      (const int32_t*)tile_row, (const int32_t*)tile_col,
      (const int32_t*)nnz_in_tile, (const int32_t*)rows, (const int32_t*)cols,
      (const float*)vals, (const int4*)units, (const int32_t*)unit_ptr,
      (const int32_t*)order, (const float*)z, (float*)out, (float*)scratch,
      (int32_t*)counters, cap, n_feat, tile, accumulate, n_z_rows, dense_threshold);
  return (int)cudaGetLastError();
}

// Launches the scalar body over one segment's n_units work units; the
// arguments as scv_spmm_runs, without the dense branch's.  Shared memory:
// the tile x threads f32 strip and kStages stages of staged entries and
// their chunk plan; above 48 KB the kernel opts in.
extern "C" int scv_spmm_runs_scalar(const void* tile_row, const void* tile_col,
                                    const void* nnz_in_tile, const void* rows,
                                    const void* cols, const void* vals,
                                    const void* units, const void* unit_ptr,
                                    const void* order, const void* z, void* out,
                                    void* scratch, void* counters,
                                    int n_units, int cap, int n_feat, int tile,
                                    int threads, int accumulate, void* stream) {
  static bool opted = false;
  if (!valid_launch(n_units, n_feat, tile, threads)) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = sizeof(float) * (size_t)tile * (size_t)threads +
                      sizeof(Stage) * kStages + 16;
  const int rc = reserve_smem(scv_spmm_runs_scalar_kernel, smem, &opted);
  if (rc != 0) return rc;
  const dim3 grid((unsigned)n_units, (unsigned)((n_feat + threads - 1) / threads));
  scv_spmm_runs_scalar_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      (const int32_t*)tile_row, (const int32_t*)tile_col,
      (const int32_t*)nnz_in_tile, (const int32_t*)rows, (const int32_t*)cols,
      (const float*)vals, (const int4*)units, (const int32_t*)unit_ptr,
      (const int32_t*)order, (const float*)z, (float*)out, (float*)scratch,
      (int32_t*)counters, cap, n_feat, tile, accumulate);
  return (int)cudaGetLastError();
}

// SCV SpMM for Hopper (sm_90a): out = [acc +] A_hat @ Z over the SCV tile layout.
//
// Replaces the TPU kernel built by scv_spmm_pallas
// (src/repro/kernels/scv_spmm/scv_spmm.py:197), all of its bodies and modes:
//   * the vector body _kernel_vector (:101): its sparse branch _sparse (:150)
//     and its dense-tile branch _dense (:169), as scv_spmm_runs;
//   * its accumulate mode (the `acc` operand aliased onto the output,
//     :274-282, with the strip seed of _init, :121): the TPU chains one
//     launch per capacity segment, each later one adding into the output.
//     Here one launch of the vector body takes every segment of the chain
//     (a table of up to kMaxSegments, passed by value), and the accumulate
//     flag seeds the strips from `out` (a chain started from zeros);
//   * the scalar body _kernel_scalar (:57), as scv_spmm_runs_scalar, still
//     one launch per segment.
// The one-hot scatter/gather matmuls that the TPU's vector body uses to
// reach its matrix unit are not carried over: here each sparse entry is a
// load of one Z value per feature column and one FMA, and only dense tiles
// go to the tensor cores.
//
// What bounds it on an H100: bytes.  Each entry costs 12 bytes of index and
// value data and a Z row gather (4 * F bytes, mostly from L2 when a column
// block is reused), against 2 * F flops, far below the ~20 flops per byte at
// which the card's fp32 rate would take over.  What keeps a kernel of this
// kind from its bound is latency, not bandwidth: a hub block-row's run of
// thousands of tiles walked by one block, and per tile a chain of dependent
// loads (header, then entries, then Z rows).  The vector body's design:
//   * one launch per chain: the plan-level run index (core/scv.py::PlanRuns)
//     makes each block-row one run across all segments, its segments' tiles
//     in segment order, cut into work units of at most UNIT_WORK tiles +
//     entries; a unit is a list of pieces, each a span of one segment's
//     tiles.  A thread block owns one (unit, feature block), the units are
//     launched heaviest first over the whole chain, so a later segment's
//     hub units run beside the first segment's work instead of after it,
//     and a light block-row's tiles of every segment are one block's.
//     Trailing zero-nnz tiles (the serving composite's tile-count padding)
//     lie in no piece and cost nothing;
//   * the T x Fb output strip lives in shared memory.  A run of one unit
//     seeds it (zero, or `out` in accumulate mode) and writes it to device
//     memory once.  The units of a split run sum their strips over a fixed
//     binary tree of the run's units (finish_unit: per node a counter,
//     __threadfence, then atomicAdd; the second block to arrive adds the
//     other's strip and climbs), and the root's block adds the seed and
//     writes the strip.  No float atomics: the sums are taken in a fixed
//     order, so two launches on the same inputs give the same bits;
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
//   * a merging block reads its sibling's strip kWide values at a time;
//   * dense tiles (0 <= dense_threshold < nnz, the reference's rule
//     :147-148; replaces _dense) on the tensor cores.  The tile's T x Fb
//     Z block is prefetched into L1 while D (T x T, f32) is built in shared
//     memory from the tile's entries, duplicates summed in entry order: in
//     the (column, row) order the plans are built in, read straight from
//     device memory a warp of entries at a time, the first entry of each
//     run of one (row, col) sums the run and stores it (one block-wide vote
//     checks the order); in any other order D is built again from staged
//     entries, each warp taking those of some columns, __match_any_sync
//     finding equal keys whose lowest lane adds them in lane order.  Then
//     each warp adds D @ Z_block into its own 32 strip columns with
//     mma.sync m16n8k8 in the 3xTF32 split: x = big + small, both rounded
//     to TF32, and small*big + big*small + big*big summed in the f32
//     accumulators; its B fragments come from Z in device memory (L1), so
//     the Z block takes no shared memory and a block's shared memory stays
//     within what three blocks an SM need at T = 64 (a staged Z block cut
//     that to two, and the sparse walk of the same launch slowed by about
//     a third).  The split keeps about f32's precision (a single TF32 pass
//     keeps three digits) and is exact on integer inputs below 2^11 in
//     magnitude, whose small parts are zero.  One read of the Z block and
//     T^2 * F * 3 tensor-core MACs replace nnz * F dependent shared-memory
//     updates.  Within a header chunk the sparse tiles' entries are summed
//     before the dense tiles', a fixed order.  Strip rows are kStripPad
//     floats wider and D rows kDensePad wider than their data, so the
//     fragments' shared-memory reads hit 32 banks.
// Accumulate mode seeds the strip from `out` instead of zero.  A unit whose
// run is -1 is padding (a launch captured in a CUDA graph has a grid sized
// from the segments' shapes, core/scv.py::PlanRuns.padded): both bodies
// return from it before any other read.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 128;
constexpr int kMinBlocks = 4;  // vector-body blocks an SM should hold (caps registers at 128)
constexpr int kDenseMinBlocks = 3;  // the same with the dense branch (caps registers at 168)
constexpr int kGroup = 8;      // staged entries whose strip updates may run side by side
constexpr int kAhead = 32;     // entries whose Z values a thread requests ahead
constexpr int kWide = 32;      // partial-strip values a merging block reads at a time
constexpr int kHeaders = 256;  // tile headers the vector body stages at a time
constexpr int kEntries = 256;  // entries the vector body stages at a time
constexpr int kDenseBatch = 4;  // steps of a dense tile's entries whose reads are in flight together
constexpr int kMaxSegments = 16;  // capacity segments one vector launch takes
constexpr int kStripPad = 8;   // strip columns past the threads, dense branch on
constexpr int kDensePad = 4;   // D columns past its depth
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr unsigned kFullMask = 0xffffffffu;

// The segments of one vector launch: each one's tile and entry arrays and
// its entry capacity (device pointers; a segment without tiles is never
// read).
struct Segments {
  const int32_t* tile_col[kMaxSegments];
  const int32_t* nnz_in_tile[kMaxSegments];
  const int32_t* rows[kMaxSegments];
  const int32_t* cols[kMaxSegments];
  const float* vals[kMaxSegments];
  int cap[kMaxSegments];
};

// One staged entry: its row in the strip, its Z row (global for a sparse
// tile, its column within the tile for a dense one) and its value.  16
// bytes, so a thread reads one with a single broadcast load.  `distinct`,
// on the first entry of each whole group of kGroup, says that the group's
// rows are pairwise distinct.
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

// The Z value a sparse tile's entry names, for this thread's feature column
// (zsrc = z + f, ld = n_feat).
__device__ __forceinline__ float z_of(const Entry& e, const float* zsrc, int ld) {
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
__device__ __forceinline__ void walk(const Entry* entries, int n, float* col, int stride,
                                     const float* zsrc, int ld) {
  int k = 0;
  if (n >= kAhead) {
    float zv[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) zv[u] = z_of(entries[u], zsrc, ld);
    for (; k + 2 * kAhead <= n; k += kAhead) {
      float zn[kAhead];
#pragma unroll
      for (int u = 0; u < kAhead; ++u) zn[u] = z_of(entries[k + kAhead + u], zsrc, ld);
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
    for (int u = 0; u < kGroup; ++u) zv[u] = z_of(entries[k + u], zsrc, ld);
    add_group(entries + k, zv, col, stride);
  }
  for (; k < n; ++k) {
    const Entry e = entries[k];
    col[e.row * stride] = fmaf(e.val, z_of(e, zsrc, ld), col[e.row * stride]);
  }
}

// Asks for the dense branch's Z block, Z rows [col_base, col_base + tile)
// of the block's feature columns (from f0, 4 bytes each), to be brought
// into L1 while D is built: one prefetch a 128-byte line.
__device__ __forceinline__ void prefetch_zblock(const float* z, int col_base, int n_feat,
                                                int n_z_rows, int tile, int f0) {
  const int width = min((int)blockDim.x, n_feat - f0);
  const int lines = (width + 31) / 32;
  const int rows = min(tile, n_z_rows - col_base);
  for (int i = threadIdx.x; i < rows * lines; i += blockDim.x) {
    const float* p = z + (int64_t)(col_base + i / lines) * n_feat + f0 + 32 * (i % lines);
    asm volatile("prefetch.global.L1 [%0];\n" ::"l"(p));
  }
}

// Writes a dense tile's entries [0, n) into D (zero, row stride ld),
// straight from device memory, taking them to be in (column, row) order,
// the order plans lay them out in (core/scv.py::_tile_sort), so
// that equal (row, col) pairs are neighbours.  Warp w takes 32 consecutive
// entries at a time, one a lane (kDenseBatch such steps read together),
// and finds its neighbours' keys by shuffle (the lanes at the ends read
// one more entry each): the first entry of
// each run of one (row, col) sums the run in entry order (by shuffle
// within the warp, from device memory past it) and stores the sum; the
// runs' elements are distinct, so no two threads write one.  Returns, to
// every thread, whether the entries were in that order; if they were not,
// D holds garbage.  A barrier.
__device__ __forceinline__ bool add_ordered_entries(float* dmat, int ld,
                                                    const int32_t* __restrict__ rows,
                                                    const int32_t* __restrict__ cols,
                                                    const float* __restrict__ vals, int n,
                                                    int tile) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5, nw = blockDim.x >> 5;
  const int step = 32 * nw;  // entries the block reads at a time
  bool out_of_order = false;
  for (int k00 = 32 * w; k00 < n; k00 += kDenseBatch * step) {
    // kDenseBatch steps' entries requested together, with the neighbours
    // at each step's ends
    int key[kDenseBatch], prev[kDenseBatch], next[kDenseBatch];
    float v[kDenseBatch];
#pragma unroll
    for (int b = 0; b < kDenseBatch; ++b) {
      const int k = k00 + b * step + lane;
      key[b] = k < n ? cols[k] * tile + rows[k] : INT32_MAX;
      v[b] = k < n ? vals[k] : 0.0f;
      prev[b] = lane == 0 && k > 0 && k - 1 < n ? cols[k - 1] * tile + rows[k - 1] : -1;
      next[b] = lane == 31 && k + 1 < n ? cols[k + 1] * tile + rows[k + 1] : INT32_MAX;
    }
#pragma unroll
    for (int b = 0; b < kDenseBatch; ++b) {
      const int k0 = k00 + b * step;
      if (k0 >= n) break;  // uniform across the warp
      const int k = k0 + lane;
      const bool valid = k < n;
      const int up = __shfl_up_sync(kFullMask, key[b], 1);
      const int down = __shfl_down_sync(kFullMask, key[b], 1);
      const int pk = lane == 0 ? prev[b] : up;
      const int nk = lane == 31 ? next[b] : down;
      out_of_order |= valid && key[b] < pk;
      const int tail = __shfl_sync(kFullMask, nk, 31);  // the key after this warp's entries
      float d = v[b];
      bool on = true;  // every lane from this one to the last holds this key
      if (__any_sync(kFullMask, valid && nk == key[b])) {  // a run of equal entries
        for (int j = 1; j < 32; ++j) {
          const float vj = __shfl_down_sync(kFullMask, v[b], j);
          const int kj = __shfl_down_sync(kFullMask, key[b], j);
          if (lane + j < 32) {
            on = on && kj == key[b];
            if (on) d += vj;
          }
        }
      } else {
        on = lane == 31;
      }
      if (valid && key[b] != pk) {
        if (on && tail == key[b]) {  // the run goes on past this warp's entries
          for (int x = k0 + 32; x < n && cols[x] * tile + rows[x] == key[b]; ++x) d += vals[x];
        }
        dmat[(key[b] % tile) * ld + key[b] / tile] = d;
      }
    }
  }
  return !__syncthreads_or(out_of_order);
}

// Adds the staged entries [0, n) of a dense tile into D (row stride ld),
// duplicates in entry order, for entries in no known order.  Warp w of nw
// takes the entries whose column is w mod nw, so no two warps touch one
// element; a warp takes 32 entries at a time, and for each set of its
// lanes with one (row, col) the lowest adds the set's values in lane order.
__device__ __forceinline__ void add_dense_entries(float* dmat, int ld, const Entry* e, int n) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5, nw = blockDim.x >> 5;
  for (int g0 = 0; g0 < n; g0 += 32) {
    const int k = g0 + lane;
    int key = -1 - lane;  // a key of its own: matches no lane
    if (k < n) {
      const Entry x = e[k];
      if (x.col % nw == w) key = x.row * ld + x.col;
    }
    const unsigned same = __match_any_sync(kFullMask, key);
    if (key >= 0 && (same & ((1u << lane) - 1)) == 0) {
      float d = dmat[key];
      for (unsigned m = same; m; m &= m - 1) d += e[g0 + __ffs(m) - 1].val;
      dmat[key] = d;
    }
    __syncwarp();
  }
}

// x as big + small, each rounded to TF32 (round to nearest, ties away).
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(big) : "f"(x));
  const float rest = x - __uint_as_float(big);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(small) : "f"(rest));
}

// c += a @ b on the tensor cores: one m16n8k8 product in TF32, f32 sums.
__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Each warp: strip[:, its 32 columns] += D @ Z_block[:, those columns], in
// the 3xTF32 split.  kMT m16 tiles of rows at a time (16 * kMT rows by 32
// columns: kMT x 4 accumulator tiles in registers; 4 where the tile allows,
// so each B fragment is read once for 64 rows), D's depth tile_k in steps
// of 8.  Fragment layouts are mma.m16n8k8's (g = lane / 4, t = lane
// % 4): A (g | g + 8, t | t + 4) from D in shared memory, B (t | t + 4, g)
// read from Z in device memory (Z row col_base + k, the warp's columns;
// zero past the tile, past z's rows and past the feature width; the next
// step's requested before this step's products), C (g | g + 8, 2t, 2t + 1)
// from zero, added to the strip.  Strip rows past the tile are neither
// read nor written (D's rows there are zero).
template <int kMT>
__device__ __forceinline__ void tile_product(float* strip, int stride, const float* dmat, int ld,
                                             const float* __restrict__ z, int col_base,
                                             int n_feat, int n_z_rows, int f0, int tile,
                                             int tile_m, int tile_k) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = threadIdx.x & ~31;
  const float* zc = z + (int64_t)col_base * n_feat + f0 + n0 + g;
  const int rows = min(tile, n_z_rows - col_base);  // Z rows this tile has
  bool live[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) live[j] = f0 + n0 + 8 * j + g < n_feat;
  const auto load_b = [&](int k0, float (&b)[4][2]) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int k = k0 + t + 4 * hh;
        b[j][hh] = live[j] && k < rows ? __ldg(zc + (int64_t)k * n_feat + 8 * j) : 0.0f;
      }
    }
  };
  for (int m0 = 0; m0 < tile_m; m0 += 16 * kMT) {
    // this tile's product alone, added to the strip in f32 at the end: the
    // tensor cores' sums stay within one tile's depth, so their rounding
    // does not grow with the dense tiles a strip takes
    float acc[kMT][4][4] = {};
    float bz[4][2];
    load_b(0, bz);
    for (int k0 = 0; k0 < tile_k; k0 += 8) {
      float bn[4][2];
      if (k0 + 8 < tile_k) load_b(k0 + 8, bn);
      uint32_t ah[kMT][4], al[kMT][4], bh[4][2], bl[4][2];
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
        const float* a = dmat + (m0 + 16 * i + g) * ld + k0 + t;
        split_tf32(a[0], ah[i][0], al[i][0]);
        split_tf32(a[8 * ld], ah[i][1], al[i][1]);
        split_tf32(a[4], ah[i][2], al[i][2]);
        split_tf32(a[8 * ld + 4], ah[i][3], al[i][3]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        split_tf32(bz[j][0], bh[j][0], bl[j][0]);
        split_tf32(bz[j][1], bh[j][1], bl[j][1]);
      }
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          mma_tf32(acc[i][j], al[i], bh[j]);
          mma_tf32(acc[i][j], ah[i], bl[j]);
          mma_tf32(acc[i][j], ah[i], bh[j]);
        }
      }
      if (k0 + 8 < tile_k) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          bz[j][0] = bn[j][0];
          bz[j][1] = bn[j][1];
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kMT; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int r = m0 + 16 * i + g + 8 * hh;
          if (r < tile) {
            float2* c = reinterpret_cast<float2*>(strip + r * stride + n0 + 8 * j + 2 * t);
            const float2 v = *c;
            *c = make_float2(v.x + acc[i][j][2 * hh], v.y + acc[i][j][2 * hh + 1]);
          }
        }
      }
    }
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
// its strip.  The units of a split run sum their strips over a fixed binary
// tree of the run's units (leaf j is its j-th unit; at each level node i
// and node i ^ 1 meet in their parent): a block publishes its node's sum
// to scratch (at the slot of the node's first unit; the run's units hold
// consecutive slots), then bumps the parent's counter (__threadfence, then
// atomicAdd).  The first to arrive leaves; the second adds the other's sum
// into its strip, sets the counter back to 0 and climbs.  x + y == y + x in
// f32, so which child arrives first does not show in the bits, and two
// launches on the same inputs give the same bits.  The root's block adds
// the seed (`out` in accumulate mode, else zero) and writes the strip.
// Each tree level costs one write and one read of a strip, side by side
// across the run, where a walk of all the partials by one block cost
// count of them one after another.  A node's counter is the one of its
// right child's first unit, one per (unit, feature block).  `u` is the
// unit, `first` and `count` its run's first unit and unit count, `last` a
// flag in shared memory.
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
  const int leaf = u - first;
  float* const slots = scratch + (int64_t)(unit.w - leaf) * tile * n_feat + f;
  for (int level = 0; (1 << level) < count; ++level) {
    const int node = leaf >> level;
    if (((node ^ 1) << level) >= count) continue;  // no sibling: climb alone
    if (active) {
      float* mine = slots + (int64_t)(node << level) * tile * n_feat;
      for (int r = 0; r < tile; ++r) mine[(int64_t)r * n_feat] = col[r * stride];
    }
    __threadfence();
    __syncthreads();
    int32_t* counter = counters + (int64_t)(first + ((node | 1) << level)) * gridDim.y +
                       blockIdx.y;
    if (threadIdx.x == 0) *last = atomicAdd(counter, 1) == 1;
    __syncthreads();
    if (!*last) return;
    __threadfence();
    if (active) {
      // the sibling's sum, kWide rows at a time in flight
      const float* other = slots + (int64_t)((node ^ 1) << level) * tile * n_feat;
      for (int r0 = 0; r0 < tile; r0 += kWide) {
        float v[kWide];
#pragma unroll
        for (int w = 0; w < kWide; ++w) {
          if (r0 + w < tile) v[w] = __ldcg(other + (int64_t)(r0 + w) * n_feat);
        }
#pragma unroll
        for (int w = 0; w < kWide; ++w) {
          if (r0 + w < tile) col[(r0 + w) * stride] += v[w];
        }
      }
    }
    if (threadIdx.x == 0) *counter = 0;  // ready for the next launch
  }
  if (active) {
    for (int r = 0; r < tile; ++r) {
      const float seed = accumulate ? out_col[(int64_t)r * n_feat] : 0.0f;
      out_col[(int64_t)r * n_feat] = seed + col[r * stride];
    }
  }
}

// Built twice: without the dense branch, for launches with no dense tile
// (kMinBlocks blocks an SM, 128 registers a thread), and with it, whose
// shared memory holds kDenseMinBlocks blocks an SM at T = 64 and F = 128,
// so its threads may take the registers the products need without spilling.
template <bool kDense>
__global__ void __launch_bounds__(kMaxThreads, kDense ? kDenseMinBlocks : kMinBlocks)
scv_spmm_runs_kernel(const Segments segs,
                     const int4* __restrict__ pieces,
                     const int4* __restrict__ units,
                     const int32_t* __restrict__ unit_ptr,
                     const int32_t* __restrict__ order,
                     const int32_t* __restrict__ run_row,
                     const float* __restrict__ z,
                     float* __restrict__ out,
                     float* __restrict__ scratch,
                     int32_t* __restrict__ counters,
                     int n_feat, int tile, int accumulate, int n_z_rows, int dense_threshold) {
  extern __shared__ float4 smem4[];
  const bool dense_on = kDense;  // the host launches this build when dense_threshold >= 0
  const int stride = blockDim.x + (dense_on ? kStripPad : 0);
  const int tile_k = (tile + 7) & ~7;    // D's depth: whole k8 steps
  const int tile_m = (tile + 15) & ~15;  // D's rows: whole m16 tiles
  const int ld = tile_k + kDensePad;
  float* strip = reinterpret_cast<float*>(smem4);  // [tile][stride]
  float* dmat = strip + tile * stride;  // the dense branch's D [tile_m][ld], only when it is on
  Entry* entries = reinterpret_cast<Entry*>(dmat + (dense_on ? tile_m * ld : 0));
  Headers& h = *reinterpret_cast<Headers*>(entries + kEntries);
  const int f = blockIdx.y * blockDim.x + threadIdx.x;
  // Threads past the feature width stage entries, reach every barrier and
  // take part in the tensor-core products (on zero Z columns), but touch no
  // strip column for the sparse walk, no Z column and no output column.
  const bool active = f < n_feat;
  float* col = strip + threadIdx.x;  // this thread's column of the strip

  const int u = order[blockIdx.x];
  const int4 unit = units[u];  // first piece, end piece, run, scratch slot
  if (unit.z < 0) return;  // a padding unit of a captured launch's grid
  const int first = unit_ptr[unit.z];
  const int count = unit_ptr[unit.z + 1] - first;
  const bool split = count > 1;
  float* out_col = out + (int64_t)run_row[unit.z] * tile * n_feat + f;

  if (active) seed_strip(col, stride, out_col, n_feat, tile, accumulate && !split);

  for (int p = unit.x; p < unit.y; ++p) {
    const int4 piece = pieces[p];  // segment, first tile, end tile
    const int32_t* __restrict__ tile_col = segs.tile_col[piece.x];
    const int32_t* __restrict__ nnz_in_tile = segs.nnz_in_tile[piece.x];
    const int32_t* __restrict__ rows = segs.rows[piece.x];
    const int32_t* __restrict__ cols = segs.cols[piece.x];
    const float* __restrict__ vals = segs.vals[piece.x];
    const int cap = segs.cap[piece.x];
    for (int h0 = piece.y; h0 < piece.z; h0 += kHeaders) {
      const int n_h = min(kHeaders, piece.z - h0);
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
        if (active) walk(entries, n, col, stride, z + f, n_feat);
      }

      // dense tiles, one at a time: the Z block prefetched, D built from the
      // tile's entries, then the product
      for (int d = 0; kDense && d < h.n_dense; ++d) {
        const int i = h.dense[d];
        const int nnz = h.nnz[i];
        __syncthreads();  // the walk and the previous product are done with entries and D
        prefetch_zblock(z, h.col[i] * tile, n_feat, n_z_rows, tile, blockIdx.y * blockDim.x);
        float4* d4 = reinterpret_cast<float4*>(dmat);
        for (int x = threadIdx.x; x < tile_m * ld / 4; x += blockDim.x) {
          d4[x] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        }
        const int64_t base = (int64_t)(h0 + i) * cap;
        __syncthreads();  // D is zero
        if (!add_ordered_entries(dmat, ld, rows + base, cols + base, vals + base, nnz, tile)) {
          // not in the plans' order: D again from zero, from staged entries
          for (int x = threadIdx.x; x < tile_m * ld / 4; x += blockDim.x) {
            d4[x] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          }
          for (int j0 = 0; j0 < nnz; j0 += kEntries) {
            const int n = min(kEntries, nnz - j0);
            __syncthreads();  // D is zero; every warp is done with the previous entries
            for (int k = threadIdx.x; k < n; k += blockDim.x) {
              const int64_t slot = base + j0 + k;
              entries[k] = Entry{rows[slot], cols[slot], vals[slot], 0};
            }
            __syncthreads();
            add_dense_entries(dmat, ld, entries, n);
          }
        }
        __syncthreads();  // D is whole
        const int col_base = h.col[i] * tile, f0 = blockIdx.y * blockDim.x;
        if (tile_m % 64 == 0) {
          tile_product<4>(strip, stride, dmat, ld, z, col_base, n_feat, n_z_rows, f0, tile,
                          tile_m, tile_k);
        } else if (tile_m % 32 == 0) {
          tile_product<2>(strip, stride, dmat, ld, z, col_base, n_feat, n_z_rows, f0, tile,
                          tile_m, tile_k);
        } else {
          tile_product<1>(strip, stride, dmat, ld, z, col_base, n_feat, n_z_rows, f0, tile,
                          tile_m, tile_k);
        }
      }
    }
  }

  if (dense_on) __syncthreads();  // a product wrote strip columns of other lanes
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

// The vector body's shared memory: the tile x stride f32 strip, with the
// dense branch on D (tile_m x ld), then kEntries staged entries and
// kHeaders staged headers.
size_t vector_smem(int tile, int threads, bool dense) {
  const size_t stride = (size_t)threads + (dense ? kStripPad : 0);
  size_t floats = (size_t)tile * stride;
  if (dense) {
    const size_t tile_k = (size_t)((tile + 7) & ~7), tile_m = (size_t)((tile + 15) & ~15);
    floats += tile_m * (tile_k + kDensePad);
  }
  return sizeof(float) * floats + sizeof(Entry) * kEntries + sizeof(Headers);
}

bool vector_opted[2] = {false, false};  // the sparse and the dense build

}  // namespace

// Launches the vector body once over a chain of n_segments segments
// (at most kMaxSegments): segment k's tile_col, nnz_in_tile, rows, cols and
// vals device pointers are element k of the five pointer arrays (host
// arrays), its entry capacity caps[k].  The schedule is the chain's
// plan-level run index (core/scv.py::PlanRuns): `pieces` int4 (segment,
// first tile, end tile, 0), `units` int4 (first piece, end piece, run,
// scratch slot), `unit_ptr` n_runs + 1 offsets into the units, `order` the
// launch order of the n_units units, `run_row` each run's block-row.  All
// other pointers are device pointers; `stream` is a cudaStream_t.
// `threads` must be a multiple of 32 no larger than 128.  `n_z_rows` is z's
// row count (the dense branch reads whole Z blocks and treats rows past it
// as zero).  A tile with nnz > dense_threshold >= 0 takes the dense branch;
// a negative threshold turns the branch off, and only then is no room kept
// for D.  `scratch` holds one tile x n_feat f32 partial
// strip per unit of a split run and `counters` one int32 per (unit, feature
// block), all zero; both may be null when no run is split.  Above 48 KB of
// shared memory (vector_smem) the kernel opts in.  Allocates nothing and
// does not synchronise; returns cudaGetLastError() after the launch.
extern "C" int scv_spmm_runs(int n_segments, const void* const* tile_col,
                             const void* const* nnz_in_tile, const void* const* rows,
                             const void* const* cols, const void* const* vals,
                             const int* caps, const void* pieces, const void* units,
                             const void* unit_ptr, const void* order, const void* run_row,
                             const void* z, void* out, void* scratch, void* counters,
                             int n_units, int n_feat, int tile, int threads, int accumulate,
                             int n_z_rows, int dense_threshold, void* stream) {
  if (!valid_launch(n_units, n_feat, tile, threads) || n_segments < 1 ||
      n_segments > kMaxSegments) {
    return (int)cudaErrorInvalidValue;
  }
  Segments segs = {};
  for (int k = 0; k < n_segments; ++k) {
    segs.tile_col[k] = (const int32_t*)tile_col[k];
    segs.nnz_in_tile[k] = (const int32_t*)nnz_in_tile[k];
    segs.rows[k] = (const int32_t*)rows[k];
    segs.cols[k] = (const int32_t*)cols[k];
    segs.vals[k] = (const float*)vals[k];
    segs.cap[k] = caps[k];
  }
  const bool dense = dense_threshold >= 0;
  const auto kernel = dense ? scv_spmm_runs_kernel<true> : scv_spmm_runs_kernel<false>;
  const size_t smem = vector_smem(tile, threads, dense);
  const int rc = reserve_smem(kernel, smem, &vector_opted[dense]);
  if (rc != 0) return rc;
  const dim3 grid((unsigned)n_units, (unsigned)((n_feat + threads - 1) / threads));
  kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      segs, (const int4*)pieces, (const int4*)units, (const int32_t*)unit_ptr,
      (const int32_t*)order, (const int32_t*)run_row, (const float*)z, (float*)out,
      (float*)scratch, (int32_t*)counters, n_feat, tile, accumulate, n_z_rows, dense_threshold);
  return (int)cudaGetLastError();
}

// The vector body's blocks of `threads` threads that one SM holds at once
// for a tile of `tile` rows, with the dense branch on or off, into
// *blocks (registers and shared memory as built); returns the CUDA error.
extern "C" int scv_spmm_runs_occupancy(int tile, int threads, int dense, int* blocks) {
  const auto kernel = dense ? scv_spmm_runs_kernel<true> : scv_spmm_runs_kernel<false>;
  const size_t smem = vector_smem(tile, threads, dense != 0);
  const int rc = reserve_smem(kernel, smem, &vector_opted[dense != 0]);
  if (rc != 0) return rc;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, threads, smem);
}

// Launches the scalar body over one segment's n_units work units
// (RunIndex: `units` int4 (first tile, end tile, run, scratch slot),
// `unit_ptr` n_runs + 1 offsets into them, `order` the launch order), with
// tile_row to find each run's block-row; the other arguments as
// scv_spmm_runs, without the dense branch's.  Shared memory: the tile x
// threads f32 strip and kStages stages of staged entries and their chunk
// plan; above 48 KB the kernel opts in.
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

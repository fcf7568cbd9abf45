// Ordered row scatter-add for Hopper (sm_90a): out[index[e], :] += source[e, :]
// with every target row summed in operand order, as numpy's np.add.at and
// XLA's scatter on the CPU add.  No TPU kernel: the JAX reference leaves
// these scatters to XLA -- the backward of an embedding lookup
// (src/repro/models/layers.py, transformer.py:243-245), the MoE combine
// out.at[buf_tok].add(y) (src/repro/models/moe.py:136-138) and the
// backward of its dispatch gather (moe.py:122).  CUDA's index_add_ and
// the backward of table[tokens] add with atomics, in an order that changes
// from run to run, so a train step on the card would not repeat itself.
// ordered_scatter.cu takes at most 8 columns; these rows are 1..7,168 wide
// and their targets reach a whole vocabulary (151,936 rows).
//
// What bounds it.  Each target's adds are one chain (the order is the
// contract), so the call takes at least the longest target's rows times
// the dependent add latency; beside that, reading the source rows and the
// index once and reading and writing each touched target row once.  On the
// model paths the chains are at most 8 rows and the bytes bound the call.
//
// Design.  The host wrapper (kernels/ops.py ordered_rows_add) picks one of
// three routes from the shapes alone (ops.rows_plan); every route reads the
// index in place (int32 or int64) and drops rows outside 0..n-1 itself.
//
//   scan   one launch, no partition, for small calls (a decode step's
//          combine: 1,024 slots into 4 tokens).  A CTA owns a (target,
//          column tile); it reads the whole index in operand order,
//          kScanItems x blockDim rows a round, ballots for its target,
//          compacts the matching row numbers in order into shared memory
//          (warp counts, their prefix, the rank in the ballot) and folds
//          them.  The chain order is the operand order by construction.
//   smem   E <= kMaxRows: one CTA of kPartThreads partitions the rows
//          stably by target in shared memory, then the fold runs.  The
//          keys stay in shared memory, only the row order (16-bit) moves:
//          LSD passes over the target's key bits, at most kDigitBits a
//          pass (one pass for n <= 512, the combine's 512 tokens; two for a
//          151,936-row vocabulary).  A pass counts each warp's rows by digit
//          (shared atomics: a count has no order), scans the counts
//          digit-major, and places each row at its (digit, warp) start +
//          the rows of that digit the warp has placed + its rank among the
//          lanes of its step with the same digit (one ballot for each bit
//          in which the step's digits differ).  Warps own contiguous chunks
//          in order, steps and lanes ascend, so every pass is stable.  The
//          CTA then writes the sorted row numbers and the runs of equal
//          targets (start, target) and their count.  The fold is launched
//          with programmatic dependent launch: its CTAs wait on the card
//          (griddepcontrol.wait) while the partition finishes.
//   sort   E > kMaxRows: the wrapper partitions with torch.sort(stable)
//          and writes the same runs; then the fold.
//
// The fold (smem and sort routes) is a grid of at most kFoldCtas CTAs an SM
// that walks the (run, column tile) work items, their count read on the
// card, so no CTA exists only to find its run empty.  A thread owns V
// adjacent columns, a 16-byte vector wherever the width and both pointers
// allow it (8 bfloat16, 4 float32, 2 float64; else the largest that
// divides), and keeps kAhead rows of its chain in flight in its own slots
// of a shared ring (cp.async, one commit group a row), adding row r while
// rows r+1..r+kAhead land.  Sizes come from shapes on the host and every
// offset stays on the card: nothing synchronises, and a call records into
// a CUDA graph.
//
// Float contract: every add is __fadd_rn / __dadd_rn; a bfloat16 add is the
// float32 sum of the two bfloat16 values rounded to bfloat16 (round to
// nearest even), as ml_dtypes' np.add.at and XLA's bf16 scatter on the CPU
// add; nothing is contracted or reassociated.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kFoldThreads = 256;  // at most, a fold or scan CTA
constexpr int kFoldCtas = 6;       // fold CTAs an SM holds at once (ops.ROWS_FOLD_CTAS)
constexpr int kAhead = 4;          // rows of a chain in flight a thread
constexpr int kSlots = kAhead + 1; // a slot is refilled one row after it is read
constexpr int kScanItems = 4;      // index rows a scan thread reads a round
constexpr int kPartThreads = 1024;
constexpr int kPartWarps = kPartThreads / kWarp;
constexpr int kMaxRows = 16384;    // rows the one-CTA partition takes (ops.ROWS_SMEM_MAX)
constexpr int kDigitBits = 9;      // key bits a pass, at most
constexpr int kMaxPasses = 4;      // 31 key bits
constexpr int kPartSmemMax =
    4 * kMaxRows + 4 * kPartWarps * ((1 << kDigitBits) + 1) + 4 * kMaxRows;

enum Route { kScan = 0, kSmem = 1, kSort = 2 };

__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ __nv_bfloat16 add_rn(__nv_bfloat16 a, __nv_bfloat16 b) {
  return __float2bfloat16_rn(__fadd_rn(__bfloat162float(a), __bfloat162float(b)));
}

template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

template <typename T, int V>
__device__ __forceinline__ void add_into(Vec<T, V>& acc, const Vec<T, V>& x) {
#pragma unroll
  for (int i = 0; i < V; ++i) acc.v[i] = add_rn(acc.v[i], x.v[i]);
}

// one row's vector into this thread's slot: cp.async where the vector is
// 4, 8 or 16 bytes, a plain copy for a lone bfloat16
template <typename Row>
__device__ __forceinline__ void stage(Row* slot, const Row* src) {
  if constexpr (sizeof(Row) >= 4) {
    const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(slot));
    if constexpr (sizeof(Row) == 16)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
    else
      asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(dst), "l"(src),
                   "n"(static_cast<int>(sizeof(Row))) : "memory");
  } else {
    *slot = *src;
  }
}

__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

__device__ __forceinline__ void wait_ahead() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kAhead - 1) : "memory");
}

// Add `rows` rows of the chain, row_of(0) .. row_of(rows - 1) of source, at
// this thread's columns col .. col + V - 1, to acc in order.  Slot s of the
// thread is ring[s * kFoldThreads + threadIdx.x]; the row number of the row
// kAhead + 1 ahead is loaded one row early, so its latency hides behind the
// wait.
template <typename T, int V, typename RowOf>
__device__ __forceinline__ void fold_chain(const T* __restrict__ source, int64_t width, int64_t col,
                                           int rows, RowOf row_of, Vec<T, V>* ring,
                                           Vec<T, V>& acc) {
  using Row = Vec<T, V>;
  Row* mine = ring + threadIdx.x;
  auto src = [&](int row) {
    return reinterpret_cast<const Row*>(source + static_cast<int64_t>(row) * width + col);
  };
  int ahead[kAhead];
#pragma unroll
  for (int k = 0; k < kAhead; ++k) ahead[k] = k < rows ? row_of(k) : 0;
#pragma unroll
  for (int k = 0; k < kAhead; ++k) {
    if (k < rows) stage(mine + k * kFoldThreads, src(ahead[k]));
    commit();
  }
  int next = kAhead < rows ? row_of(kAhead) : 0;
  int slot = 0, fill = kAhead;  // the slots of row r and of row r + kAhead
  for (int r = 0; r < rows; ++r) {
    wait_ahead();  // this thread's copy of row r has landed
    add_into(acc, mine[slot * kFoldThreads]);
    if (r + kAhead < rows) {
      stage(mine + fill * kFoldThreads, src(next));  // the slot row r - 1 was read from
      next = r + kAhead + 1 < rows ? row_of(r + kAhead + 1) : 0;
    }
    commit();
    slot = slot + 1 == kSlots ? 0 : slot + 1;
    fill = fill + 1 == kSlots ? 0 : fill + 1;
  }
}

__device__ __forceinline__ void grid_dependency_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// scan route: a CTA a (target, column tile), one launch
// ---------------------------------------------------------------------------

template <typename T, int V, typename I>
__global__ void __launch_bounds__(kFoldThreads, kFoldCtas)
scan_kernel(const I* __restrict__ index, const T* __restrict__ source, T* __restrict__ out,
            int64_t E, int64_t width, int tiles) {
  using Row = Vec<T, V>;
  __shared__ Row ring[kSlots * kFoldThreads];
  __shared__ int list[kScanItems * kFoldThreads];     // a round's matching rows, in order
  __shared__ int counts[kScanItems][kFoldThreads / kWarp];
  const int t = blockIdx.x / tiles;
  const int warps = blockDim.x / kWarp, warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const unsigned below = (1u << lane) - 1;
  const int64_t col = (static_cast<int64_t>(blockIdx.x % tiles) * blockDim.x + threadIdx.x) * V;
  const bool active = col < width;  // threads past the row's end still scan
  Row* dst = reinterpret_cast<Row*>(out + static_cast<int64_t>(t) * width + col);
  Row acc;
  if (active) acc = *dst;
  const int64_t round = static_cast<int64_t>(kScanItems) * blockDim.x;
  for (int64_t base = 0; base < E; base += round) {
    bool hit[kScanItems];
#pragma unroll
    for (int i = 0; i < kScanItems; ++i) {
      const int64_t r = base + i * blockDim.x + threadIdx.x;
      hit[i] = r < E && index[r] == static_cast<I>(t);
    }
    unsigned m[kScanItems];
#pragma unroll
    for (int i = 0; i < kScanItems; ++i) {
      m[i] = __ballot_sync(kFull, hit[i]);
      if (lane == 0) counts[i][warp] = __popc(m[i]);
    }
    __syncthreads();
    // the round's rows in operand order are (item, warp, lane)-major
    int at[kScanItems], found = 0;
#pragma unroll
    for (int i = 0; i < kScanItems; ++i)
      for (int w = 0; w < warps; ++w) {
        if (w == warp) at[i] = found;
        found += counts[i][w];
      }
#pragma unroll
    for (int i = 0; i < kScanItems; ++i)
      if (hit[i])
        list[at[i] + __popc(m[i] & below)] = static_cast<int>(base + i * blockDim.x + threadIdx.x);
    __syncthreads();
    if (active && found > 0)
      fold_chain<T, V>(source, width, col, found, [&](int k) { return list[k]; }, ring, acc);
    __syncthreads();  // list and counts are rewritten next round
  }
  if (active) *dst = acc;
}

// ---------------------------------------------------------------------------
// smem route: the one-CTA stable partition
// ---------------------------------------------------------------------------

// the kept lanes whose digit equals this lane's (0 for a dropped lane): one
// ballot for each bit in which the kept lanes' digits differ
__device__ __forceinline__ unsigned peers_of(unsigned d, bool in, unsigned kept) {
  if (kept == 0) return 0;  // warp-uniform
  unsigned varying =
      __reduce_or_sync(kFull, in ? d : 0u) ^ __reduce_and_sync(kFull, in ? d : ~0u);
  unsigned p = in ? kept : 0u;
  while (varying) {  // warp-uniform
    const int b = __ffs(varying) - 1;
    varying &= varying - 1;
    const bool bit = (d >> b) & 1u;
    const unsigned ones = __ballot_sync(kFull, bit);
    p &= bit ? ones : ~ones;
  }
  return p;
}

// exclusive scan of value(0) .. value(L - 1) over the CTA, each thread a
// run of ceil(L / blockDim) items in a row: emit(k, prefix) in order for
// each of its items (value(k) is read before emit(k, .)); returns the total
template <typename Value, typename Emit>
__device__ __forceinline__ int block_scan(int L, Value value, Emit emit, int* sums) {
  const int warps = blockDim.x / kWarp, warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int per = (L + blockDim.x - 1) / blockDim.x;
  const int lo = min(static_cast<int>(threadIdx.x) * per, L), hi = min(lo + per, L);
  int sum = 0;
  for (int k = lo; k < hi; ++k) sum += value(k);
  int incl = sum;
#pragma unroll
  for (int o = 1; o < kWarp; o <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == kWarp - 1) sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int w = lane < warps ? sums[lane] : 0;
    int wi = w;
#pragma unroll
    for (int o = 1; o < kWarp; o <<= 1) {
      const int y = __shfl_up_sync(kFull, wi, o);
      if (lane >= o) wi += y;
    }
    sums[lane] = wi - w;
    if (lane == kWarp - 1) sums[kWarp] = wi;
  }
  __syncthreads();
  int run = sums[warp] + incl - sum;
  const int total = sums[kWarp];
  for (int k = lo; k < hi; ++k) {
    const int v = value(k);
    emit(k, run);
    run += v;
  }
  __syncthreads();  // sums is rewritten by the next scan
  return total;
}

// Stable partition of rows 0..E-1 by target (rows out of range dropped):
// perm[0 .. kept) the kept rows in (target, operand) order; run j of equal
// targets is perm[seg_start[j] .. seg_start[j + 1]) of target
// seg_target[j], j < *seg_count.  Shared memory: keys[E] (the target of
// each row, -1 if dropped), counters[kPartWarps][2^bits + 1] (a pad word
// against bank conflicts), and two 16-bit row orders of E_pad.
template <typename I>
__global__ void __launch_bounds__(kPartThreads, 1)
partition_kernel(const I* __restrict__ index, int E, int n, int bits, int passes,
                 int* __restrict__ perm, int* __restrict__ seg_start,
                 int* __restrict__ seg_target, int* __restrict__ seg_count) {
  extern __shared__ __align__(16) int part_smem[];
  __shared__ int sums[kWarp + 1];
  launch_dependents();  // the fold's CTAs may take their SMs and wait there
  const int stride = (1 << bits) + 1;
  const int pad = E + (E & 1);
  int* keys = part_smem;
  int* counters = keys + E;
  unsigned short* order0 = reinterpret_cast<unsigned short*>(counters + kPartWarps * stride);
  unsigned short* order1 = order0 + pad;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const unsigned below = (1u << lane) - 1;
  const unsigned mask = (1u << bits) - 1;
  // 1. the keys: the index read in place
#pragma unroll 4
  for (int r = threadIdx.x; r < E; r += kPartThreads) {
    const I x = index[r];
    keys[r] = (x >= 0 && x < n) ? static_cast<int>(x) : -1;
  }
  __syncthreads();
  int L = E;  // rows in the current order (pass 0: all, in operand order)
  for (int p = 0; p < passes; ++p) {
    const unsigned short* in = (p & 1) ? order0 : order1;  // pass 0 reads 0 .. E-1
    unsigned short* to = (p & 1) ? order1 : order0;
    const int shift = p * bits;
    for (int i = threadIdx.x; i < kPartWarps * stride; i += kPartThreads) counters[i] = 0;
    __syncthreads();
    const int sub = (L + kPartThreads - 1) / kPartThreads * kWarp;  // whole steps a warp
    const int lo = min(warp * sub, L), hi = min(lo + sub, L);
    int* mine = counters + warp * stride;
    // 2. count each warp's rows by digit
    auto key_at = [&](int i, int* row) {
      *row = i < hi ? (p == 0 ? i : static_cast<int>(in[i])) : 0;
      return i < hi ? keys[*row] : -1;
    };
    for (int base = lo; base < hi; base += kWarp) {
      int row;
      const int k = key_at(base + lane, &row);
      if (k >= 0) atomicAdd(&mine[(static_cast<unsigned>(k) >> shift) & mask], 1);
    }
    __syncthreads();
    // 3. the (digit, warp) starts, digit-major
    const int total = block_scan(
        kPartWarps << bits,
        [&](int q) { return counters[(q % kPartWarps) * stride + q / kPartWarps]; },
        [&](int q, int s) { counters[(q % kPartWarps) * stride + q / kPartWarps] = s; }, sums);
    // 4. place each row
    for (int base = lo; base < hi; base += kWarp) {
      int row;
      const int k = key_at(base + lane, &row);
      const bool kept_row = k >= 0;
      const unsigned d = kept_row ? (static_cast<unsigned>(k) >> shift) & mask : 0u;
      const unsigned kept = __ballot_sync(kFull, kept_row);
      const unsigned peers = peers_of(d, kept_row, kept);
      if (kept_row) to[mine[d] + __popc(peers & below)] = static_cast<unsigned short>(row);
      __syncwarp();
      if (kept_row && (peers & below) == 0) mine[d] += __popc(peers);
      __syncwarp();
    }
    __syncthreads();
    L = total;
  }
  // 5. the sorted rows and the runs
  const unsigned short* fin = ((passes - 1) & 1) ? order1 : order0;
  for (int i = threadIdx.x; i < L; i += kPartThreads) perm[i] = fin[i];
  const int runs = block_scan(
      L, [&](int i) { return (i == 0 || keys[fin[i]] != keys[fin[i - 1]]) ? 1 : 0; },
      [&](int i, int j) {
        if (i == 0 || keys[fin[i]] != keys[fin[i - 1]]) {
          seg_start[j] = i;
          seg_target[j] = keys[fin[i]];
        }
      },
      sums);
  if (threadIdx.x == 0) {
    seg_start[runs] = L;
    *seg_count = runs;
  }
}

// ---------------------------------------------------------------------------
// the fold of the smem and sort routes: (run, column tile) work items
// ---------------------------------------------------------------------------

template <typename T, int V>
__global__ void __launch_bounds__(kFoldThreads, kFoldCtas)
fold_kernel(const int* __restrict__ perm, const int* __restrict__ seg_start,
            const int* __restrict__ seg_target, const int* __restrict__ seg_count,
            const T* __restrict__ source, T* __restrict__ out, int64_t width, int tiles) {
  using Row = Vec<T, V>;
  __shared__ Row ring[kSlots * kFoldThreads];
  grid_dependency_wait();  // the partition's writes are visible past this
  const int64_t work = static_cast<int64_t>(*seg_count) * tiles;
  for (int64_t w = blockIdx.x; w < work; w += gridDim.x) {
    const int j = static_cast<int>(w / tiles);
    const int64_t col = ((w % tiles) * blockDim.x + threadIdx.x) * V;
    if (col >= width) continue;  // no barrier in this loop
    const int start = seg_start[j], rows = seg_start[j + 1] - start;
    Row* dst = reinterpret_cast<Row*>(out + static_cast<int64_t>(seg_target[j]) * width + col);
    Row acc = *dst;
    fold_chain<T, V>(source, width, col, rows, [&](int k) { return perm[start + k]; }, ring, acc);
    *dst = acc;
  }
}

struct Call {
  const void* index;
  int index64;
  const void* source;
  void* out;
  int64_t E;
  int n;
  int64_t width;
  int route, threads, tiles, grid, passes, bits;
  int* scratch;
  cudaStream_t stream;
  int64_t cap() const { return E < n ? E : n; }
  int* perm() const { return scratch; }
  int* seg_start() const { return scratch + E; }
  int* seg_target() const { return seg_start() + cap() + 1; }
  int* seg_count() const { return seg_target() + cap() + 1; }
  size_t part_smem() const {
    return 4 * static_cast<size_t>(E) + 4 * kPartWarps * ((size_t(1) << bits) + 1) +
           4 * static_cast<size_t>(E + (E & 1));
  }
};

template <typename I>
void launch_partition(const Call& c) {
  static bool opted_in = false;  // past the 48 KB a launch gets unasked
  if (!opted_in) {
    cudaFuncSetAttribute(partition_kernel<I>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         kPartSmemMax);
    opted_in = true;
  }
  partition_kernel<I><<<1, kPartThreads, c.part_smem(), c.stream>>>(
      static_cast<const I*>(c.index), static_cast<int>(c.E), c.n, c.bits, c.passes, c.perm(),
      c.seg_start(), c.seg_target(), c.seg_count());
}

template <typename T, int V>
void launch_fold(const Call& c, bool dependent) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(c.grid));
  cfg.blockDim = dim3(static_cast<unsigned>(c.threads));
  cfg.stream = c.stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = dependent ? 1 : 0;
  cudaLaunchKernelEx(&cfg, fold_kernel<T, V>, static_cast<const int*>(c.perm()),
                     static_cast<const int*>(c.seg_start()),
                     static_cast<const int*>(c.seg_target()),
                     static_cast<const int*>(c.seg_count()), static_cast<const T*>(c.source),
                     static_cast<T*>(c.out), c.width, c.tiles);
}

template <typename T, int V>
void launch_scan(const Call& c) {
  if (c.index64)
    scan_kernel<T, V, int64_t><<<c.grid, c.threads, 0, c.stream>>>(
        static_cast<const int64_t*>(c.index), static_cast<const T*>(c.source),
        static_cast<T*>(c.out), c.E, c.width, c.tiles);
  else
    scan_kernel<T, V, int32_t><<<c.grid, c.threads, 0, c.stream>>>(
        static_cast<const int32_t*>(c.index), static_cast<const T*>(c.source),
        static_cast<T*>(c.out), c.E, c.width, c.tiles);
}

enum Part { kWhole = 0, kPartition = 1, kFold = 2 };

// what `part` of the call launches: the scan route is one kernel (its
// "fold"; it has no partition), the sort route's partition is the wrapper's
template <typename T, int V>
int run(const Call& c, int part) {
  if (c.route == kScan) {
    if (part != kPartition) launch_scan<T, V>(c);
  } else {
    if (c.route == kSmem && part != kFold)
      c.index64 ? launch_partition<int64_t>(c) : launch_partition<int32_t>(c);
    if (part != kPartition) launch_fold<T, V>(c, c.route == kSmem && part == kWhole);
  }
  return static_cast<int>(cudaGetLastError());
}

bool valid(const Call& c, int dtype, int vec) {
  const int size = dtype == 1 ? 8 : dtype == 0 ? 4 : 2;
  const uintptr_t align = static_cast<uintptr_t>(size) * vec;
  if (c.E < 1 || c.n < 1 || c.width < 1 || c.E >= (int64_t(1) << 31) || vec < 1 ||
      c.width % vec || reinterpret_cast<uintptr_t>(c.out) % align ||
      reinterpret_cast<uintptr_t>(c.source) % align || c.threads < kWarp ||
      c.threads > kFoldThreads || c.threads % kWarp || c.tiles < 1 ||
      static_cast<int64_t>(c.tiles) * c.threads * vec < c.width || c.grid < 1)
    return false;
  if (c.route == kScan)
    return static_cast<int64_t>(c.n) * c.tiles == c.grid;
  if (c.scratch == nullptr || (c.route != kSmem && c.route != kSort)) return false;
  if (c.route == kSort) return true;
  int key_bits = 0;
  while (key_bits < 31 && ((c.n - 1) >> key_bits) != 0) ++key_bits;
  return c.E <= kMaxRows && c.passes >= 1 && c.passes <= kMaxPasses && c.bits >= 0 &&
         c.bits <= kDigitBits && c.passes * c.bits >= key_bits;
}

int dispatch(const Call& c, int dtype, int vec, int part) {
  if (!valid(c, dtype, vec)) return static_cast<int>(cudaErrorInvalidValue);
  switch (dtype * 16 + vec) {
    case 0 * 16 + 1: return run<float, 1>(c, part);
    case 0 * 16 + 2: return run<float, 2>(c, part);
    case 0 * 16 + 4: return run<float, 4>(c, part);
    case 1 * 16 + 1: return run<double, 1>(c, part);
    case 1 * 16 + 2: return run<double, 2>(c, part);
    case 2 * 16 + 1: return run<__nv_bfloat16, 1>(c, part);
    case 2 * 16 + 2: return run<__nv_bfloat16, 2>(c, part);
    case 2 * 16 + 4: return run<__nv_bfloat16, 4>(c, part);
    case 2 * 16 + 8: return run<__nv_bfloat16, 8>(c, part);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// index: (E,) int32 or int64 (index64), read in place, rows outside 0..n-1
// dropped; source: (E, width) and out: (n, width) of dtype 0 float32, 1
// float64, 2 bfloat16, contiguous, out updated in place; vec: the columns a
// thread takes (a power of two, at most 16 bytes, dividing width, both
// pointers aligned to it); route 0 scan, 1 smem, 2 sort; threads, tiles,
// grid: a CTA's threads, the column tiles of a row, the CTAs (scan: n ·
// tiles; else the fold's); passes, bits: the smem partition's digit passes
// and bits a pass; scratch: E + 2 · (min(n, E) + 1) + 1 int32 (smem and
// sort; the sort route's wrapper fills it: perm, run starts, run targets,
// the run count).  The plan is ops.rows_plan.  Returns cudaGetLastError(),
// or cudaErrorInvalidValue for arguments outside these limits.
int ordered_rows_add(const void* index, int index64, const void* source, void* out, int dtype,
                     long long E, int n, long long width, int vec, int route, int threads,
                     int tiles, int grid, int passes, int bits, int* scratch, void* stream) {
  const Call c{index, index64, source, out, E, n, width, route, threads, tiles, grid, passes,
               bits, scratch, static_cast<cudaStream_t>(stream)};
  return dispatch(c, dtype, vec, kWhole);
}

// The two halves of ordered_rows_add, with its arguments, so that each can
// be timed alone: the smem route's partition (nothing for the others), and
// the fold of a partition left in scratch (the scan route: its one kernel).
int ordered_rows_partition(const void* index, int index64, const void* source, void* out,
                           int dtype, long long E, int n, long long width, int vec, int route,
                           int threads, int tiles, int grid, int passes, int bits, int* scratch,
                           void* stream) {
  const Call c{index, index64, source, out, E, n, width, route, threads, tiles, grid, passes,
               bits, scratch, static_cast<cudaStream_t>(stream)};
  return dispatch(c, dtype, vec, kPartition);
}

int ordered_rows_fold(const void* index, int index64, const void* source, void* out, int dtype,
                      long long E, int n, long long width, int vec, int route, int threads,
                      int tiles, int grid, int passes, int bits, int* scratch, void* stream) {
  const Call c{index, index64, source, out, E, n, width, route, threads, tiles, grid, passes,
               bits, scratch, static_cast<cudaStream_t>(stream)};
  return dispatch(c, dtype, vec, kFold);
}

}  // extern "C"

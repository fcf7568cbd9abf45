// One clock-auction round over the K-padded sparse bid book, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/sparse_bid_eval.py
// (sparse_bid_eval -> _sparse_bid_eval_kernel).  Each user u offers B
// alternative bundles of K (pool, quantity) pairs; at prices p a bundle
// costs sum_k val_k * p[idx_k].  Scalar pi: the user takes its first cheapest
// valid bundle and stays in while cost <= pi.  Vector pi: it takes the first
// bundle of highest surplus pi_b - cost and stays in while surplus >= 0.
// The round returns chosen (U,) int32 (-1 = out) and the excess demand of the
// chosen bundles, in one of two forms:
//
//   z mode         z (R,): one thread per user scatters its chosen bundle into
//                  a shared-memory copy of z with shared atomics, then each CTA
//                  adds its tile to z with one global atomicAdd per pool.  The
//                  order of those float additions changes from run to run, so
//                  z is float-close only, never bit-reproducible.
//   partials mode  (num_blocks, R): the deterministic settlement form, the
//                  block sums of the users' demand rows reduced exactly as
//                  XLA's CPU backend reduces them for the JAX reference
//                  (windows of 32 rows folded left to right, level by level,
//                  or one 8-lane vectorized fold for 16..32 fused rows; see
//                  repro_torch/kernels/ref.py).  No float atomics: the result
//                  is bit-identical to the plain PyTorch version, run after
//                  run.
//
// Float contract: compiled with --fmad=false so no a*b+c is contracted
// implicitly.  Where XLA contracts (the K-term cost fold, and pi - v*p when
// K = 1) the kernel calls __fmaf_rn explicitly; every other add is __fadd_rn.
//
// What bounds it: memory.  For the 100k-agent economy book (U = 64,691,
// B = 8, K = 3, R = 24, vector pi) one round reads idx+val 12.4 MB, pi
// 2.1 MB and mask 0.5 MB and writes chosen 0.26 MB -- about 15.3 MB, or
// ~4.6 us at 3.35 TB/s, so an 842-round cold clock is bounded below by
// ~3.9 ms.
//
// Partials design: one launch reads the book once and keeps the chosen rows
// on the SM; a second, small one folds the later levels.  A level-1 CTA owns
// up to 8 consecutive level-1 windows of one user block (32 rows each, after
// XLA's front padding lo), so its users are one contiguous span of the book:
//   1. it stages the span's idx, val, pi and mask into shared memory with
//      cp.async, all copies in flight at once and coalesced across the CTA,
//      each user's idx/val/pi row at an odd word stride so that the
//      selection's per-user reads hit distinct banks;
//   2. one thread per row selects from shared memory (the same choose()
//      arithmetic as z mode), writes chosen, and keeps its chosen terms in
//      shared memory, merged so that the first term of each pool carries the
//      k-order fold from +0 of all its terms: that is the row value x(i)[r];
//   3. a warp is a window: it walks the window's 32 rows in order, and for
//      each row its lanes add the row's live terms into a shared (R,)
//      accumulator at once (a row's live terms have distinct pools).  Rows
//      that do not touch r would add +0.0, which leaves a sum that started at
//      +0 unchanged (in round-to-nearest a running sum from +0 is never
//      -0.0), so skipping them keeps the left fold bit-identical while the
//      work is 32*K a window, not 32*K*R, and 32 steps deep whatever R is;
//   4. the second launch gives each (block, 32 pools) a CTA that folds the
//      later levels, left folds of <= 32 values in fixed order.
// Blocks of m <= 32 rows take one CTA each and one launch: the same staged
// selection, then one thread per pool folds the block whole (vectorized or
// left fold).  No float atomics and no inter-CTA counters.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWindow = 32;               // XLA's tree-reduction window
constexpr int kSmemFloats = 12 * 1024;    // z mode: 48 KB of dynamic shared memory
constexpr int kMaxWindowsPerCta = 8;
constexpr int kRegK = 4;                  // partials: terms a bundle merged in registers
constexpr int kRegPools = 4 * 32;         // partials: pools a lane can sum in registers
constexpr int kOneHotMaxR = 128;          // ref.ONEHOT_ROWS_MAX_R
constexpr size_t kSmemBudget = 110 * 1024;  // partials: two CTAs an SM
constexpr size_t kSmemMax = 200 * 1024;

__host__ __device__ inline int odd(int n) { return n | 1; }

__device__ __forceinline__ float bundle_cost(const int* ib, const float* vb, const float* p,
                                             int K) {
  float acc = __fmul_rn(vb[0], p[ib[0]]);
#pragma unroll 4
  for (int k = 1; k < K; ++k) acc = __fmaf_rn(vb[k], p[ib[k]], acc);
  return acc;
}

// First extremum over the valid bundles of one user; all-invalid users end
// up out.  ib/vb: the user's B*K pairs, mb: its B mask bytes, pib: its pi
// (one value, or B with vector pi).
__device__ __forceinline__ void choose(const int* ib, const float* vb, const uint8_t* mb,
                                       const float* pib, int pi_vector, const float* p, int B,
                                       int K, int& bhat, bool& active) {
  bhat = 0;
  if (!pi_vector) {
    float best = 0.f;
#pragma unroll 4
    for (int b = 0; b < B; ++b) {
      const float c = mb[b] ? bundle_cost(ib + b * K, vb + b * K, p, K)
                            : __int_as_float(0x7f800000);
      if (b == 0 || c < best) { best = c; bhat = b; }
    }
    active = best <= pib[0];
  } else {
    float best = 0.f;
#pragma unroll 4
    for (int b = 0; b < B; ++b) {
      const int off = b * K;
      float s = -__int_as_float(0x7f800000);
      if (mb[b]) {
        s = K == 1 ? __fmaf_rn(-vb[off], p[ib[off]], pib[b])
                   : __fsub_rn(pib[b], bundle_cost(ib + off, vb + off, p, K));
      }
      if (b == 0 || s > best) { best = s; bhat = b; }
    }
    active = best >= 0.f;
  }
}

// ---------------------------------------------------------------------------
// z mode
// ---------------------------------------------------------------------------

// One thread per user: writes chosen and scatters the chosen bundle into z.
__global__ void select_z_kernel(const int* __restrict__ idx, const float* __restrict__ val,
                                const uint8_t* __restrict__ mask, const float* __restrict__ pi,
                                int pi_vector, const float* __restrict__ prices, int U, int B,
                                int K, int R, int stage, int* __restrict__ chosen,
                                float* __restrict__ z) {
  extern __shared__ float smem[];
  float* s_prices = smem;
  float* s_z = smem + (stage ? R : 0);
  if (stage)
    for (int r = threadIdx.x; r < R; r += blockDim.x) { s_prices[r] = prices[r]; s_z[r] = 0.f; }
  __syncthreads();
  const float* p = stage ? s_prices : prices;

  const int u = blockIdx.x * blockDim.x + threadIdx.x;
  if (u < U) {
    const size_t row = static_cast<size_t>(u) * B;
    int bhat;
    bool active;
    choose(idx + row * K, val + row * K, mask + row, pi_vector ? pi + row : pi + u, pi_vector,
           p, B, K, bhat, active);
    chosen[u] = active ? bhat : -1;
    if (active) {
      const size_t off = (row + bhat) * K;
      for (int k = 0; k < K; ++k) atomicAdd(stage ? &s_z[idx[off + k]] : &z[idx[off + k]],
                                            val[off + k]);
    }
  }
  if (stage) {
    __syncthreads();
    for (int r = threadIdx.x; r < R; r += blockDim.x)
      if (s_z[r] != 0.f) atomicAdd(&z[r], s_z[r]);
  }
}

// ---------------------------------------------------------------------------
// partials mode
// ---------------------------------------------------------------------------

// Shared-memory carve-up of one level-1 CTA, in 4-byte words.  With
// stage_book = 0 the book is read from global memory (a pathological B*K);
// with acc_smem = 0 the window sums accumulate in the level buffer itself (a
// pathological R).
struct Layout {
  int stage_book, stage_prices, acc_smem;
  int ik, pv, kp;  // row strides: idx/val words, pi words, chosen terms
  int idx, val, pi, mask, prices, sel_r, sel_x, acc, words;
};

Layout make_layout(int rows, int windows, int B, int K, int R, int pi_vector, int stage_book,
                   int acc_smem) {
  Layout L{};
  L.stage_book = stage_book;
  L.stage_prices = R <= 4096;
  L.acc_smem = acc_smem;
  L.ik = odd(B * K);
  L.pv = pi_vector ? odd(B) : 1;
  L.kp = odd(K);
  int at = 0;
  auto take = [&at](int words) { const int here = at; at += (words + 3) / 4 * 4; return here; };
  const int s = stage_book ? rows : 0;
  L.idx = take(s * L.ik);
  L.val = take(s * L.ik);
  L.pi = take(s * L.pv);
  L.mask = take(stage_book ? (rows * B + 3) / 4 + 1 : 0);  // the span's bytes as whole words
  L.prices = take(L.stage_prices ? R : 0);
  L.sel_r = take(rows * L.kp);
  L.sel_x = take(rows * L.kp);
  L.acc = take(acc_smem && R > kRegPools ? windows * R : 0);
  L.words = at;
  return L;
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(gmem) : "memory");
}

// Starts copying rows x len consecutive 4-byte elements of g into s, row q
// at s + q*stride (an odd stride: consecutive rows start on different
// banks).  Consecutive threads copy consecutive elements, every copy in
// flight at once; cp.async.wait_all completes them.
template <typename T>
__device__ void stage(const T* __restrict__ g, int rows, int len, int stride, T* s) {
  const int n = rows * len, nt = blockDim.x;
  const int drow = nt / len, dcol = nt % len;
  int row = threadIdx.x / len, col = threadIdx.x % len;
  for (int e = threadIdx.x; e < n; e += nt) {
    cp_async4(s + row * stride + col, g + e);
    row += drow;
    col += dcol;
    if (col >= len) { col -= len; ++row; }
  }
}

// x(i): the value of block row i at pool r, from its merged chosen terms
// (0.f where the row does not touch r)
struct MergedRow {
  const int* sel_r;
  const float* sel_x;
  int kp, K, r;
  __device__ float operator()(int i) const {
    for (int k = 0; k < K; ++k)
      if (sel_r[i * kp + k] == r) return sel_x[i * kp + k];
    return 0.f;
  }
};

// x(i): entry i of one (block, pool) column of a level buffer
struct BufValue {
  const float* col;
  int R;
  __device__ float operator()(int i) const { return __ldcg(col + static_cast<size_t>(i) * R); }
};

template <class X>
__device__ float fold_window(const X& x, int n, int w, int lo) {
  float acc = 0.f;
#pragma unroll
  for (int j = 0; j < kWindow; ++j) {
    const int i = w * kWindow + j - lo;
    acc = __fadd_rn(acc, (i >= 0 && i < n) ? x(i) : 0.f);
  }
  return acc;
}

template <class X>
__device__ float fold_whole(const X& x, int n, bool vectorized) {
  if (!vectorized || n < 16) {
    float acc = 0.f;
    for (int i = 0; i < n; ++i) acc = __fadd_rn(acc, x(i));
    return acc;
  }
  float a[8], b[8], v[8];
#pragma unroll
  for (int l = 0; l < 8; ++l) { a[l] = x(l); b[l] = x(8 + l); }
  const int nmain = n / 16 * 16;
  for (int s = 16; s < nmain; s += 16) {
#pragma unroll
    for (int l = 0; l < 8; ++l) {
      a[l] = __fadd_rn(a[l], x(s + l));
      b[l] = __fadd_rn(b[l], x(s + 8 + l));
    }
  }
#pragma unroll
  for (int l = 0; l < 8; ++l) v[l] = __fadd_rn(a[l], b[l]);
  int pos = nmain;
  if (n - nmain >= 8) {
#pragma unroll
    for (int l = 0; l < 8; ++l) v[l] = __fadd_rn(v[l], x(nmain + l));
    pos += 8;
  }
  float h[4];
#pragma unroll
  for (int l = 0; l < 4; ++l) h[l] = __fadd_rn(v[l], v[l + 4]);
  float acc = __fadd_rn(__fadd_rn(h[0], h[2]), __fadd_rn(h[1], h[3]));
  for (int i = pos; i < n; ++i) acc = __fadd_rn(acc, x(i));
  return acc;
}

// Level 1.  grid (ceil(n1 / windows), num_blocks), 32 * windows threads.
// Block j holds rows [j*m, (j+1)*m) of the zero-padded users; its level 1
// has n1 windows with lo rows of front padding, written to buf (nb, n1, R).
// whole: m <= 32, one CTA a block folds it whole into partials.  KT > 0
// compiles the kernel for K = KT (the loops over a bundle's terms unroll).
template <int KT>
__global__ void __launch_bounds__(kThreads)
partials_kernel(const int* __restrict__ idx, const float* __restrict__ val,
                const uint8_t* __restrict__ mask, const float* __restrict__ pi, int pi_vector,
                const float* __restrict__ prices, int U, int B, int K_, int R, int m, int n1,
                int lo, int windows, int whole, int vectorized, Layout L,
                int* __restrict__ chosen, float* __restrict__ buf, float* __restrict__ partials) {
  extern __shared__ __align__(16) float smem[];
  const int K = KT > 0 ? KT : K_;
  int* s_idx = reinterpret_cast<int*>(smem) + L.idx;
  float* s_val = smem + L.val;
  float* s_pi = smem + L.pi;
  float* s_prices = smem + L.prices;
  int* s_sel_r = reinterpret_cast<int*>(smem) + L.sel_r;
  float* s_sel_x = smem + L.sel_x;
  float* s_acc = smem + L.acc;

  const int j = blockIdx.y;
  const int w0 = blockIdx.x * windows;
  const int nw = min(windows, n1 - w0);
  const int row0 = max(0, w0 * kWindow - lo);
  const int row1 = min(m, (w0 + nw) * kWindow - lo);
  const int u0 = j * m + row0;
  const int nu = max(0, min(j * m + row1, U) - u0);  // rows past U are zero padding
  const int BK = B * K, pi_len = pi_vector ? B : 1;

  // 1. stage the CTA's span of the book: idx, val and pi at odd row strides,
  //    the mask bytes as the whole words that hold them
  const uint8_t* mask0 = mask + static_cast<size_t>(u0) * B;
  const int mshift = static_cast<int>(reinterpret_cast<uintptr_t>(mask0) & 3);
  const uint8_t* s_mask = reinterpret_cast<const uint8_t*>(smem + L.mask) + mshift;
  if (L.stage_book) {
    stage(idx + static_cast<size_t>(u0) * BK, nu, BK, L.ik, s_idx);
    stage(val + static_cast<size_t>(u0) * BK, nu, BK, L.ik, s_val);
    stage(pi + static_cast<size_t>(u0) * pi_len, nu, pi_len, L.pv, s_pi);
    const int words = nu > 0 ? (mshift + nu * B + 3) / 4 : 0;
    stage(reinterpret_cast<const int*>(mask0 - mshift), 1, words, words,
          reinterpret_cast<int*>(smem + L.mask));
  }
  if (L.stage_prices)
    for (int r = threadIdx.x; r < R; r += blockDim.x) s_prices[r] = prices[r];
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  const float* p = L.stage_prices ? s_prices : prices;

  // 2. one thread per row: select, write chosen, keep the merged chosen terms
  const int t = threadIdx.x, wl = t / kWindow, lane = t % kWindow;
  const int i = (w0 + wl) * kWindow + lane - lo;  // row of block j
  const int u = j * m + i;
  int* sr = s_sel_r + t * L.kp;
  float* sx = s_sel_x + t * L.kp;
  if (wl < nw && i >= 0 && i < m && u < U) {
    const int q = u - u0;
    const int* ib = L.stage_book ? s_idx + q * L.ik : idx + static_cast<size_t>(u) * BK;
    const float* vb = L.stage_book ? s_val + q * L.ik : val + static_cast<size_t>(u) * BK;
    const uint8_t* mb = L.stage_book ? s_mask + q * B : mask + static_cast<size_t>(u) * B;
    const float* pib = L.stage_book ? s_pi + q * L.pv : pi + static_cast<size_t>(u) * pi_len;
    int bhat;
    bool active;
    choose(ib, vb, mb, pib, pi_vector, p, B, K, bhat, active);
    chosen[u] = active ? bhat : -1;
    const float on = active ? 1.f : 0.f;
    // the first term of each pool takes the k-order fold from +0 of the
    // pool's terms; the later ones are marked dead (-1)
    if (K <= kRegK) {
      int tr[kRegK];
      float tx[kRegK];
#pragma unroll
      for (int k = 0; k < kRegK; ++k)
        if (k < K) { tr[k] = ib[bhat * K + k]; tx[k] = __fmul_rn(vb[bhat * K + k], on); }
#pragma unroll
      for (int k = 0; k < kRegK; ++k) {
        if (k >= K) break;
        bool first = true;
#pragma unroll
        for (int k0 = 0; k0 < k; ++k0) first = first && tr[k0] != tr[k];
        float x = __fadd_rn(0.f, tx[k]);
#pragma unroll
        for (int k2 = k + 1; k2 < kRegK; ++k2)
          if (k2 < K && tr[k2] == tr[k]) x = __fadd_rn(x, tx[k2]);
        sr[k] = first ? tr[k] : -1;
        sx[k] = x;
      }
    } else {
      for (int k = 0; k < K; ++k) {
        sr[k] = ib[bhat * K + k];
        sx[k] = __fmul_rn(vb[bhat * K + k], on);
      }
      for (int k = 0; k < K; ++k) {
        if (sr[k] < 0) continue;
        float x = __fadd_rn(0.f, sx[k]);
        for (int k2 = k + 1; k2 < K; ++k2)
          if (sr[k2] == sr[k]) { x = __fadd_rn(x, sx[k2]); sr[k2] = -1; }
        sx[k] = x;
      }
    }
    // one row a block over one-hot rows: XLA's reduce is the row itself,
    // whose one-hot sum drops its leading 0 +, so a row whose terms are all
    // -0.0 on one pool keeps -0.0 there (ref.block_partials)
    if (m == 1 && R <= kOneHotMaxR) {
      bool negzero = true;
      for (int k = 0; k < K; ++k)
        negzero = negzero && ib[bhat * K + k] == ib[bhat * K] &&
                  __float_as_uint(__fmul_rn(vb[bhat * K + k], on)) == 0x80000000u;
      if (negzero) sx[0] = -0.f;
    }
  } else {
    for (int k = 0; k < K; ++k) sr[k] = -1;  // padding and zero rows
  }

  if (whole) {  // m <= 32: one thread per pool folds the block whole
    __syncthreads();
    for (int r = t; r < R; r += blockDim.x) {
      const MergedRow x{s_sel_r, s_sel_x, L.kp, K, r};
      partials[static_cast<size_t>(j) * R + r] = m == 1 ? x(0) : fold_whole(x, m, vectorized != 0);
    }
    return;
  }

  // 3. level 1: warp wl folds window w0 + wl, its rows in order
  if (wl >= nw) return;
  float* out = buf + (static_cast<size_t>(j) * n1 + w0 + wl) * R;
  const int* wr = s_sel_r + wl * kWindow * L.kp;
  const float* wx = s_sel_x + wl * kWindow * L.kp;
  __syncwarp();
  if (R <= kRegPools) {  // lane l sums pools l, l+32, l+64, l+96 in registers
    float a[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int row = 0; row < kWindow; ++row)
      for (int k = 0; k < K; ++k) {
        const int r = wr[row * L.kp + k] - lane;
        const float x = wx[row * L.kp + k];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (r == kWindow * q) a[q] = __fadd_rn(a[q], x);
      }
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (lane + kWindow * q < R) out[lane + kWindow * q] = a[q];
    return;
  }
  // more pools: a shared (R,) accumulator; a row's live terms have
  // distinct pools, so its lanes add them at once
  float* acc = L.acc_smem ? s_acc + wl * R : out;
  for (int r = lane; r < R; r += kWindow) acc[r] = 0.f;
  __syncwarp();
  for (int row = 0; row < kWindow; ++row) {
    for (int k = lane; k < K; k += kWindow) {
      const int r = wr[row * L.kp + k];
      if (r >= 0) acc[r] = __fadd_rn(acc[r], wx[row * L.kp + k]);
    }
    __syncwarp();
  }
  if (L.acc_smem)
    for (int r = lane; r < R; r += kWindow) out[r] = acc[r];
}

// The later levels: grid (num_blocks, ceil(R / 32)), 256 threads; a CTA
// folds 32 pools of one block, left folds of <= 32 values in fixed order,
// level by level after buf's level 1, into partials.
__global__ void __launch_bounds__(kThreads)
fold_levels_kernel(float* __restrict__ buf, int R, int n1, float* __restrict__ partials) {
  const int j = blockIdx.x, nb = gridDim.x;
  const int r = blockIdx.y * kWindow + threadIdx.x % kWindow;
  const int g = threadIdx.x / kWindow, groups = blockDim.x / kWindow;
  const float* in = buf + static_cast<size_t>(j) * n1 * R;
  float* level = buf + static_cast<size_t>(nb) * n1 * R;
  int n = n1;
  while (n > kWindow) {
    const int n_out = (n + kWindow - 1) / kWindow;
    const int lo = (n_out * kWindow - n) / 2;
    float* out = level + static_cast<size_t>(j) * n_out * R;
    if (r < R)
      for (int w = g; w < n_out; w += groups)
        out[static_cast<size_t>(w) * R + r] = fold_window(BufValue{in + r, R}, n, w, lo);
    __syncthreads();
    in = out;
    level += static_cast<size_t>(nb) * n_out * R;
    n = n_out;
  }
  if (g == 0 && r < R)
    partials[static_cast<size_t>(j) * R + r] = fold_whole(BufValue{in + r, R}, n, false);
}

}  // namespace

extern "C" {

// z mode.  z must hold R zeros on entry.  Returns cudaGetLastError().
int sparse_bid_eval_z(const int* idx, const float* val, const uint8_t* mask, const float* pi,
                      int pi_vector, const float* prices, int U, int B, int K, int R,
                      int* chosen, float* z, void* stream) {
  const int stage = R <= kSmemFloats / 2;
  const int blocks = U > 0 ? (U + kThreads - 1) / kThreads : 1;
  select_z_kernel<<<blocks, kThreads, stage ? 2 * sizeof(float) * R : 0,
                    static_cast<cudaStream_t>(stream)>>>(idx, val, mask, pi, pi_vector, prices,
                                                         U, B, K, R, stage, chosen, z);
  return static_cast<int>(cudaGetLastError());
}

// Partials mode: one launch for m <= 32 rows a block, else two (level 1,
// then the later levels).  scratch holds the window levels of the fold (the
// sum over levels of num_blocks * ceil(n / 32) * R floats, n > 32 being each
// level's input length, for m = ceil(U / num_blocks)); partials receives
// (num_blocks, R).  Returns cudaGetLastError(), or cudaErrorInvalidValue for
// num_blocks outside 1..65535 or a K whose 32 rows of chosen terms do not
// fit in shared memory (K > ~800).
int sparse_bid_eval_partials(const int* idx, const float* val, const uint8_t* mask,
                             const float* pi, int pi_vector, const float* prices, int U, int B,
                             int K, int R, int num_blocks, int vectorized, int* chosen,
                             float* scratch, float* partials, void* stream_ptr) {
  using Kernel = decltype(&partials_kernel<0>);
  static const Kernel kernels[kRegK + 1] = {partials_kernel<0>, partials_kernel<1>,
                                            partials_kernel<2>, partials_kernel<3>,
                                            partials_kernel<4>};
  static size_t allowed[kRegK + 1] = {48 * 1024, 48 * 1024, 48 * 1024, 48 * 1024, 48 * 1024};
  if (num_blocks < 1 || num_blocks > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int m = (U + num_blocks - 1) / num_blocks;
  const int whole = m <= kWindow;
  const int n1 = whole ? 1 : (m + kWindow - 1) / kWindow;
  const int lo = whole ? 0 : (n1 * kWindow - m) / 2;
  // the most windows (8, 4, 2, 1) whose layout fits: the book staged
  // within two CTAs an SM, else read from device memory within one
  Layout L{};
  int windows = 0;
  for (int staged = 1; staged >= 0 && windows == 0; --staged)
    for (int w = whole ? 1 : kMaxWindowsPerCta; w >= 1 && windows == 0; w /= 2) {
      L = make_layout(kWindow * w, w, B, K, R, pi_vector, staged, staged);
      if (sizeof(float) * L.words <= (staged ? kSmemBudget : kSmemMax)) windows = w;
    }
  if (windows == 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * L.words;
  const int kt = K <= kRegK ? K : 0;
  if (smem > allowed[kt]) {  // raised once per size, before any capture into a CUDA graph
    const cudaError_t err = cudaFuncSetAttribute(
        kernels[kt], cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed[kt] = smem;
  }
  kernels[kt]<<<dim3((n1 + windows - 1) / windows, num_blocks), kWindow * windows, smem,
                    stream>>>(idx, val, mask, pi, pi_vector, prices, U, B, K, R, m, n1, lo,
                              windows, whole, vectorized, L, chosen, scratch, partials);
  if (whole) return static_cast<int>(cudaGetLastError());
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  fold_levels_kernel<<<dim3(num_blocks, (R + kWindow - 1) / kWindow), kThreads, 0, stream>>>(
      scratch, R, n1, partials);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

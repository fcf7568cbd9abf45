// One dense clock-auction round (scalar pi) for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/clock_bid_eval.py
// (bid_eval -> _bid_eval_kernel).  Each user u offers B alternative bundles,
// dense rows of R pool quantities; at prices p a bundle costs
// sum_r bundles[u, b, r] * p[r].  A masked bundle costs +inf; the user takes
// its first cheapest bundle and stays in while cost <= pi[u].  The round
// returns chosen (U,) int32 (-1 = out) and z (R,), the chosen rows summed
// over users.
//
// Two launches' worth of work, as in the plain version (ref.bid_eval):
//
//   selection  one warp per user.  R >= 60: lane t folds r = t, t+32, ...
//              with one FMA each, reading each row coalesced, and the warp
//              halves the 32 lane sums (xor 16, 8, 4, 2, 1).  R < 60: the
//              reference's left FMA fold, one lane per bundle; the warp
//              then takes the first minimum.  Either way the cost is bit for
//              bit ref.dense_costs, so chosen is exact.
//   z fold     one thread per (window of 32 users, pool): it reads the
//              chosen rows (0 for a user that is out) and folds them as
//              ref.dense_fold does -- windows of 32 padded by pad//2 users
//              in front, folded left to right, level by level (one launch
//              a level), or for U <= 32 the reference's small-count tree.
//              No float atomics: z is bit-identical to the plain version,
//              run after run.  (The TPU kernel also sums z in a fixed order,
//              across its sequential grid.)
//
// Float contract: compiled with --fmad=false; the cost fold's FMAs are
// explicit __fmaf_rn, every other add is __fadd_rn.
//
// What bounds it: memory.  One round reads the U*B*R float32 bundles once
// (1.21 GB for the 101,000 x 3 x 1,000 planet book, 0.36 ms at 3.35 TB/s).
// This first design reads the valid rows once in the selection pass and then
// the chosen rows (a third of the book at B = 3) again in the z fold.  Left for
// later: fold the chosen row into z in the selection pass (one pass over the
// book), and TMA staging of the rows.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 256;
constexpr int kWindow = 32;              // XLA's tree-reduction window
constexpr int kLaneFoldMinR = 60;        // ref.DENSE_LANE_FOLD_MIN_R
constexpr int kMaxStagedPrices = 12 * 1024;  // 48 KB of dynamic shared memory
constexpr unsigned kFull = 0xffffffffu;

// The reference's left FMA fold of one row (R < 60).
__device__ __forceinline__ float cost_left(const float* __restrict__ row, const float* p, int R) {
  float acc = 0.f;
  for (int r = 0; r < R; ++r) acc = __fmaf_rn(row[r], p[r], acc);
  return acc;
}

// The 32-lane fold of one row (R >= 60); every lane of the warp calls it
// and every lane returns the same sum.
__device__ __forceinline__ float cost_lanes(const float* __restrict__ row, const float* p, int R,
                                            int lane) {
  float acc = 0.f;
  int r = lane;
  for (; r + 3 * kWarp < R; r += 4 * kWarp) {  // four loads in flight per lane
    const float b0 = row[r], b1 = row[r + kWarp], b2 = row[r + 2 * kWarp], b3 = row[r + 3 * kWarp];
    acc = __fmaf_rn(b0, p[r], acc);
    acc = __fmaf_rn(b1, p[r + kWarp], acc);
    acc = __fmaf_rn(b2, p[r + 2 * kWarp], acc);
    acc = __fmaf_rn(b3, p[r + 3 * kWarp], acc);
  }
  for (; r < R; r += kWarp) acc = __fmaf_rn(row[r], p[r], acc);
  for (int off = kWarp / 2; off > 0; off >>= 1)
    acc = __fadd_rn(acc, __shfl_xor_sync(kFull, acc, off));
  return acc;
}

__global__ void select_kernel(const float* __restrict__ bundles, const uint8_t* __restrict__ mask,
                              const float* __restrict__ pi, const float* __restrict__ prices,
                              int U, int B, int R, int stage_prices, int* __restrict__ chosen) {
  extern __shared__ float s_prices[];
  if (stage_prices) {
    for (int r = threadIdx.x; r < R; r += blockDim.x) s_prices[r] = prices[r];
    __syncthreads();
  }
  const float* p = stage_prices ? s_prices : prices;
  const int lane = threadIdx.x % kWarp;
  const int u = blockIdx.x * (blockDim.x / kWarp) + threadIdx.x / kWarp;
  if (u >= U) return;
  const size_t row0 = static_cast<size_t>(u) * B;
  const float inf = __int_as_float(0x7f800000);
  float best = inf;
  int bhat = 0;
  if (R >= kLaneFoldMinR) {
    for (int b = 0; b < B; ++b) {
      // the mask is uniform across the warp, so a masked row is skipped whole
      const float c = mask[row0 + b] ? cost_lanes(bundles + (row0 + b) * R, p, R, lane) : inf;
      if (b == 0 || c < best) { best = c; bhat = b; }
    }
  } else {
    bhat = INT_MAX;  // lanes without a bundle lose every comparison
    for (int b = lane; b < B; b += kWarp) {
      const float c = mask[row0 + b] ? cost_left(bundles + (row0 + b) * R, p, R) : inf;
      if (bhat == INT_MAX || c < best) { best = c; bhat = b; }
    }
    for (int off = kWarp / 2; off > 0; off >>= 1) {  // first minimum across lanes
      const float ob = __shfl_xor_sync(kFull, best, off);
      const int oi = __shfl_xor_sync(kFull, bhat, off);
      if (ob < best || (ob == best && oi < bhat)) { best = ob; bhat = oi; }
    }
  }
  if (lane == 0) chosen[u] = best <= pi[u] ? bhat : -1;
}

// x(i): pool r of user i's chosen row, 0 for a user that is out
struct RowValue {
  const float* bundles;
  const int* chosen;
  int B, R, r;
  __device__ float operator()(int i) const {
    const int c = chosen[i];
    return c >= 0 ? bundles[(static_cast<size_t>(i) * B + c) * R + r] : 0.f;
  }
};

// x(i): entry i of one pool's column of an (n, R) level buffer
struct BufValue {
  const float* col;
  int R;
  __device__ float operator()(int i) const { return col[static_cast<size_t>(i) * R]; }
};

template <class X>
__device__ float fold_left(const X& x, int from, int n, float acc) {
  for (int i = from; i < n; ++i) acc = __fadd_rn(acc, x(i));
  return acc;
}

template <class X>
__device__ float fold_window(const X& x, int n, int w, int lo) {
  float acc = 0.f;
  for (int j = 0; j < kWindow; ++j) {
    const int i = w * kWindow + j - lo;
    acc = __fadd_rn(acc, (i >= 0 && i < n) ? x(i) : 0.f);
  }
  return acc;
}

__device__ __forceinline__ float halve8(const float v[8]) {
  float h[4];
#pragma unroll
  for (int l = 0; l < 4; ++l) h[l] = __fadd_rn(v[l], v[l + 4]);
  return __fadd_rn(__fadd_rn(h[0], h[2]), __fadd_rn(h[1], h[3]));
}

// XLA's fused reduce of n <= 32 gathered rows (ref._dense_vector_fold and
// the left fold below 16).
template <class X>
__device__ float fold_small(const X& x, int n) {
  if (n < 16) return fold_left(x, 0, n, 0.f);
  float v[8];
#pragma unroll
  for (int l = 0; l < 8; ++l) v[l] = __fadd_rn(x(l), x(8 + l));
  if (n == 32) {
#pragma unroll
    for (int l = 0; l < 8; ++l) v[l] = __fadd_rn(__fadd_rn(v[l], x(16 + l)), x(24 + l));
    return halve8(v);
  }
  if (n >= 20 && n < 24) {
    const float s = __fadd_rn(halve8(v), x(16));
    const float acc = __fadd_rn(__fadd_rn(s, x(18)), __fadd_rn(x(17), x(19)));
    return fold_left(x, 20, n, acc);
  }
  int pos = 16;
  if (n >= 24) {
#pragma unroll
    for (int l = 0; l < 8; ++l) v[l] = __fadd_rn(v[l], x(16 + l));
    pos = 24;
  }
  return fold_left(x, pos, n, halve8(v));
}

// Level 1: out[w][r] folds users [w*32 - lo, (w+1)*32 - lo) of pool r, or
// with whole all n users.
__global__ void fold_rows_kernel(const float* __restrict__ bundles, const int* __restrict__ chosen,
                                 int B, int R, int n, int lo, int n_out, int whole,
                                 float* __restrict__ out) {
  const size_t t = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= static_cast<size_t>(n_out) * R) return;
  const int r = static_cast<int>(t % R);
  const int w = static_cast<int>(t / R);
  const RowValue x{bundles, chosen, B, R, r};
  out[t] = whole ? fold_small(x, n) : fold_window(x, n, w, lo);
}

// Later levels: out[w][r] folds in[:][r] (n entries) left to right.
__global__ void fold_buf_kernel(const float* __restrict__ in, int R, int n, int lo, int n_out,
                                int whole, float* __restrict__ out) {
  const size_t t = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= static_cast<size_t>(n_out) * R) return;
  const int r = static_cast<int>(t % R);
  const int w = static_cast<int>(t / R);
  const BufValue x{in + r, R};
  out[t] = whole ? fold_left(x, 0, n, 0.f) : fold_window(x, n, w, lo);
}

inline int blocks_for(size_t n) { return static_cast<int>((n + kThreads - 1) / kThreads); }

}  // namespace

extern "C" {

// chosen receives U int32, z R floats; scratch holds the window levels of
// the z fold (the sum over levels of ceil(n / 32) * R floats, n > 32 being
// each level's input length).  Returns cudaGetLastError().
int bid_eval(const float* bundles, const uint8_t* mask, const float* pi, const float* prices,
             int U, int B, int R, int* chosen, float* scratch, float* z, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (R == 0) return 0;
  if (U == 0) return static_cast<int>(cudaMemsetAsync(z, 0, sizeof(float) * R, stream));
  const int stage = R <= kMaxStagedPrices;
  const int users_per_block = kThreads / kWarp;
  select_kernel<<<(U + users_per_block - 1) / users_per_block, kThreads,
                  stage ? sizeof(float) * R : 0, stream>>>(bundles, mask, pi, prices, U, B, R,
                                                           stage, chosen);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  const float* in = nullptr;  // nullptr: this level reads the chosen rows
  int n = U;
  while (n > kWindow) {
    const int n_out = (n + kWindow - 1) / kWindow;
    const int lo = (n_out * kWindow - n) / 2;
    const size_t total = static_cast<size_t>(n_out) * R;
    if (in == nullptr)
      fold_rows_kernel<<<blocks_for(total), kThreads, 0, stream>>>(bundles, chosen, B, R, n, lo,
                                                                   n_out, 0, scratch);
    else
      fold_buf_kernel<<<blocks_for(total), kThreads, 0, stream>>>(in, R, n, lo, n_out, 0, scratch);
    err = static_cast<int>(cudaGetLastError());
    if (err) return err;
    in = scratch;
    scratch += total;
    n = n_out;
  }
  if (in == nullptr)
    fold_rows_kernel<<<blocks_for(R), kThreads, 0, stream>>>(bundles, chosen, B, R, n, 0, 1, 1, z);
  else
    fold_buf_kernel<<<blocks_for(R), kThreads, 0, stream>>>(in, R, n, 0, 1, 1, z);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

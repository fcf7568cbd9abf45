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
//   partials mode  (num_blocks, R): the deterministic settlement form.  The
//                  selection pass writes each user's chosen (idx, val) row;
//                  fold kernels then reduce the user rows of each contiguous
//                  block exactly as XLA's CPU backend reduces them for the
//                  JAX reference (windows of 32 folded left to right, level
//                  by level, or one 8-lane vectorized fold for 16..32 fused
//                  rows; see repro_torch/kernels/ref.py).  One thread owns one
//                  (block, window, pool) sum.  No float atomics: the result is
//                  bit-identical to the plain PyTorch version, run after run.
//
// Float contract: compiled with --fmad=false so no a*b+c is contracted
// implicitly.  Where XLA contracts (the K-term cost fold, and pi - v*p when
// K = 1) the kernel calls __fmaf_rn explicitly; every other add is __fadd_rn.
//
// What bounds it: memory.  For the 100k-agent economy book (U = 64,691,
// B = 8, K = 3, R = 24, vector pi) one round reads idx+val 12.4 MB, pi
// 2.1 MB and mask 0.5 MB and writes chosen 0.26 MB -- about 15.3 MB, or
// ~4.6 us at 3.35 TB/s, so an 842-round cold clock is bounded below by
// ~3.9 ms.  This first version does nothing to reach that bound: each thread
// reads its user's B*K pairs with plain loads (uncoalesced across the warp),
// and the block fold runs one thread per (block, pool) column at the last
// level, serial over up to 32 values.  Left for later: cp.async/TMA staging
// of the idx/val tiles into shared memory, and a parallel deterministic fold.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWindow = 32;               // XLA's tree-reduction window
constexpr int kSmemFloats = 12 * 1024;    // 48 KB of dynamic shared memory

__device__ __forceinline__ float bundle_cost(const int* __restrict__ ib,
                                             const float* __restrict__ vb,
                                             const float* p, int K) {
  float acc = __fmul_rn(vb[0], p[ib[0]]);
  for (int k = 1; k < K; ++k) acc = __fmaf_rn(vb[k], p[ib[k]], acc);
  return acc;
}

// First extremum over the valid bundles; all-invalid users end up out.
__device__ __forceinline__ void choose(const int* __restrict__ idx,
                                       const float* __restrict__ val,
                                       const uint8_t* __restrict__ mask,
                                       const float* __restrict__ pi, int pi_vector,
                                       const float* p, int u, int B, int K,
                                       int& bhat, bool& active) {
  const size_t row = static_cast<size_t>(u) * B;
  bhat = 0;
  if (!pi_vector) {
    float best = 0.f;
    for (int b = 0; b < B; ++b) {
      const size_t off = (row + b) * K;
      const float c = mask[row + b] ? bundle_cost(idx + off, val + off, p, K)
                                    : __int_as_float(0x7f800000);
      if (b == 0 || c < best) { best = c; bhat = b; }
    }
    active = best <= pi[u];
  } else {
    float best = 0.f;
    for (int b = 0; b < B; ++b) {
      const size_t off = (row + b) * K;
      float s = -__int_as_float(0x7f800000);
      if (mask[row + b]) {
        s = K == 1 ? __fmaf_rn(-val[off], p[idx[off]], pi[row + b])
                   : __fsub_rn(pi[row + b], bundle_cost(idx + off, val + off, p, K));
      }
      if (b == 0 || s > best) { best = s; bhat = b; }
    }
    active = best >= 0.f;
  }
}

// One thread per user.  Writes chosen; with sel_idx the chosen (idx, val)
// row of every user u < U_pad (zeros on padding rows); with z the chosen
// bundles scattered into z.
__global__ void select_kernel(const int* __restrict__ idx, const float* __restrict__ val,
                              const uint8_t* __restrict__ mask, const float* __restrict__ pi,
                              int pi_vector, const float* __restrict__ prices, int U, int U_pad,
                              int B, int K, int R, int stage_prices, int stage_z,
                              int* __restrict__ chosen, int* __restrict__ sel_idx,
                              float* __restrict__ sel_val, float* __restrict__ z) {
  extern __shared__ float smem[];
  float* s_prices = smem;
  float* s_z = smem + (stage_prices ? R : 0);
  if (stage_prices)
    for (int r = threadIdx.x; r < R; r += blockDim.x) s_prices[r] = prices[r];
  if (z != nullptr && stage_z)
    for (int r = threadIdx.x; r < R; r += blockDim.x) s_z[r] = 0.f;
  __syncthreads();
  const float* p = stage_prices ? s_prices : prices;

  const int u = blockIdx.x * blockDim.x + threadIdx.x;
  if (u < U) {
    int bhat;
    bool active;
    choose(idx, val, mask, pi, pi_vector, p, u, B, K, bhat, active);
    chosen[u] = active ? bhat : -1;
    const size_t off = (static_cast<size_t>(u) * B + bhat) * K;
    const float on = active ? 1.f : 0.f;
    for (int k = 0; k < K; ++k) {
      const int i = idx[off + k];
      const float v = __fmul_rn(val[off + k], on);
      if (sel_idx != nullptr) {
        sel_idx[static_cast<size_t>(u) * K + k] = i;
        sel_val[static_cast<size_t>(u) * K + k] = v;
      }
      if (z != nullptr && active) atomicAdd(stage_z ? &s_z[i] : &z[i], v);
    }
  } else if (u < U_pad && sel_idx != nullptr) {
    for (int k = 0; k < K; ++k) {
      sel_idx[static_cast<size_t>(u) * K + k] = 0;
      sel_val[static_cast<size_t>(u) * K + k] = 0.f;
    }
  }
  if (z != nullptr && stage_z) {
    __syncthreads();
    for (int r = threadIdx.x; r < R; r += blockDim.x)
      if (s_z[r] != 0.f) atomicAdd(&z[r], s_z[r]);
  }
}

// x(i): user row base+i of the selected bundles at pool r, terms added in k order
struct RowValue {
  const int* sel_idx;
  const float* sel_val;
  int K, r;
  size_t base;
  __device__ float operator()(int i) const {
    const size_t off = (base + i) * K;
    float acc = 0.f;
    for (int k = 0; k < K; ++k)
      acc = __fadd_rn(acc, sel_idx[off + k] == r ? sel_val[off + k] : 0.f);
    return acc;
  }
};

// x(i): entry i of one (block, pool) column of a (nb, n, R) level buffer
struct BufValue {
  const float* col;
  int R;
  __device__ float operator()(int i) const { return col[static_cast<size_t>(i) * R]; }
};

template <class X>
__device__ float fold_window(const X& x, int n, int w, int lo) {
  float acc = 0.f;
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

// Level 1: out[b][w][r] folds rows [b*n, (b+1)*n) of the selected bundles.
__global__ void fold_rows_kernel(const int* __restrict__ sel_idx, const float* __restrict__ sel_val,
                                 int K, int R, int nb, int n, int lo, int n_out, int whole,
                                 int vectorized, float* __restrict__ out) {
  const size_t t = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= static_cast<size_t>(nb) * n_out * R) return;
  const int r = static_cast<int>(t % R);
  const int w = static_cast<int>((t / R) % n_out);
  const int b = static_cast<int>(t / (static_cast<size_t>(R) * n_out));
  const RowValue x{sel_idx, sel_val, K, r, static_cast<size_t>(b) * n};
  out[t] = whole ? fold_whole(x, n, vectorized != 0) : fold_window(x, n, w, lo);
}

// Later levels: out[b][w][r] folds in[b][:][r] (n entries), left to right.
__global__ void fold_buf_kernel(const float* __restrict__ in, int R, int nb, int n, int lo,
                                int n_out, int whole, float* __restrict__ out) {
  const size_t t = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= static_cast<size_t>(nb) * n_out * R) return;
  const int r = static_cast<int>(t % R);
  const int w = static_cast<int>((t / R) % n_out);
  const int b = static_cast<int>(t / (static_cast<size_t>(R) * n_out));
  const BufValue x{in + static_cast<size_t>(b) * n * R + r, R};
  out[t] = whole ? fold_whole(x, n, false) : fold_window(x, n, w, lo);
}

inline int blocks_for(size_t n) { return static_cast<int>((n + kThreads - 1) / kThreads); }

int launch_select(const int* idx, const float* val, const uint8_t* mask, const float* pi,
                  int pi_vector, const float* prices, int U, int U_pad, int B, int K, int R,
                  int* chosen, int* sel_idx, float* sel_val, float* z, cudaStream_t stream) {
  const int stage_prices = R <= kSmemFloats / 2;
  const int stage_z = z != nullptr && stage_prices;
  const size_t smem = sizeof(float) * R * (stage_prices + stage_z);
  select_kernel<<<blocks_for(U_pad > 0 ? U_pad : 1), kThreads, smem, stream>>>(
      idx, val, mask, pi, pi_vector, prices, U, U_pad, B, K, R, stage_prices, stage_z,
      chosen, sel_idx, sel_val, z);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// z mode.  z must hold R zeros on entry.  Returns cudaGetLastError().
int sparse_bid_eval_z(const int* idx, const float* val, const uint8_t* mask, const float* pi,
                      int pi_vector, const float* prices, int U, int B, int K, int R,
                      int* chosen, float* z, void* stream) {
  return launch_select(idx, val, mask, pi, pi_vector, prices, U, U, B, K, R, chosen, nullptr,
                       nullptr, z, static_cast<cudaStream_t>(stream));
}

// Partials mode.  U_pad = num_blocks * m.  sel_idx/sel_val hold U_pad * K
// entries; scratch holds the window levels of the fold (the sum over levels
// of num_blocks * ceil(n / 32) * R floats, n > 32 being each level's input
// length); partials receives (num_blocks, R).  Returns cudaGetLastError().
int sparse_bid_eval_partials(const int* idx, const float* val, const uint8_t* mask,
                             const float* pi, int pi_vector, const float* prices, int U, int B,
                             int K, int R, int num_blocks, int vectorized, int* chosen,
                             int* sel_idx, float* sel_val, float* scratch, float* partials,
                             void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int m = (U + num_blocks - 1) / num_blocks;
  const int U_pad = m * num_blocks;
  int err = launch_select(idx, val, mask, pi, pi_vector, prices, U, U_pad, B, K, R, chosen,
                          sel_idx, sel_val, nullptr, stream);
  if (err) return err;
  const float* in = nullptr;  // nullptr: level 1 reads the selected rows
  int n = m;
  while (n > kWindow) {
    const int n_out = (n + kWindow - 1) / kWindow;
    const int lo = (n_out * kWindow - n) / 2;
    const size_t total = static_cast<size_t>(num_blocks) * n_out * R;
    if (in == nullptr)
      fold_rows_kernel<<<blocks_for(total), kThreads, 0, stream>>>(
          sel_idx, sel_val, K, R, num_blocks, n, lo, n_out, 0, 0, scratch);
    else
      fold_buf_kernel<<<blocks_for(total), kThreads, 0, stream>>>(in, R, num_blocks, n, lo,
                                                                  n_out, 0, scratch);
    err = static_cast<int>(cudaGetLastError());
    if (err) return err;
    in = scratch;
    scratch += total;
    n = n_out;
  }
  const size_t total = static_cast<size_t>(num_blocks) * R;
  if (in == nullptr)
    fold_rows_kernel<<<blocks_for(total), kThreads, 0, stream>>>(
        sel_idx, sel_val, K, R, num_blocks, n, 0, 1, 1, vectorized, partials);
  else
    fold_buf_kernel<<<blocks_for(total), kThreads, 0, stream>>>(in, R, num_blocks, n, 0, 1, 1,
                                                                partials);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

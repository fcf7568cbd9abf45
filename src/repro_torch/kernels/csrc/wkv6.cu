// Chunked RWKV-6 (WKV) recurrence for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/wkv6.py (wkv6 -> _wkv6_kernel).
// Per (batch, head), over tokens t with decays w_t in (0, 1]:
//
//   S_t = diag(w_t) S_{t-1} + k_tᵀ v_t          (K x V state)
//   o_t = r_t (S_{t-1} + diag(u) k_tᵀ v_t)
//
// computed a chunk of L tokens at a time in log space (cs = inclusive
// cumsum of log w down the chunk, cs_ex = cs - log w):
//
//   o_t    = (r_t ⊙ e^{cs_ex[t]}) · S
//            + Σ_{s<t} [Σ_k r_t[k] k_s[k] e^{cs_ex[t,k] - cs[s,k]}] v_s
//            + (r_t ⊙ u · k_t) v_t
//   S_next = diag(e^{cs[L-1]}) S + (k ⊙ e^{cs[L-1] - cs})ᵀ v
//
// Every exponent is <= 0, so nothing overflows for strong decay (splitting
// e^{cs_ex - cs} into e^{cs_ex}·e^{-cs} would).  Same algebra as the plain
// version, ref.wkv6_chunked; no bitwise contract, float tolerance only.
//
// Design.  The TPU grid (H, T/L) runs its chunk axis in order and carries S
// in VMEM scratch; Hopper blocks run in no order.  Here one CTA owns one
// (batch, head) and a block of up to 64 columns of V, and walks the chunks
// in a loop, S staying in shared memory.  Columns of V are independent in
// the recurrence, so the grid is (B·H, ceil(V / 64)); at the served shape
// (B = 4, H = 64, V = 64) that is 256 CTAs of 256 threads on 132 SMs, all
// resident at once.  Inputs are read in place from their (B, T, H, ·)
// layout; the ragged last chunk is padded in shared memory (w = 1, so
// log w = 0; r = k = v = 0) and no o row past T is written.  r, k, v come in
// as float32 or bfloat16, w, u and the state as float32; all arithmetic is
// float32 on CUDA cores (logf/expf, no fast math, no tensor cores).  A chunk
// is six steps between barriers: load (and log w), the cumsum of log w per k
// column (a fixed sequential fold), the strictly lower-triangular decayed
// scores one (t, s) pair a thread plus the diagonal bonus, the decayed r and
// k in place, the outputs, the state update.
//
// What bounds it: at the served prefill (B = 4, T = 500, H = 64, K = V = 64,
// L = 32) the exponentials, B·H·ceil(T/L)·(L(L-1)/2·K + 2·L·K + K), the
// bytes (r, k, v read, w read in float32, o written in float32) and, a
// little behind, the float32 FMAs set the bound about equally; chip_smoke.py
// computes it from each run's shapes.  This first version computes only the
// strict lower triangle of the L x L x K decays (the Pallas kernel computes
// all of them and masks half), and keeps everything of a chunk in shared
// memory.  It does not reach the bound: every FMA reads two shared-memory
// operands, and the V-column blocks would recompute the decays if V > 64.
// Register tiling of the output and state products, and wgmma for them, are
// later work.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVBlock = 64;  // columns of V per CTA

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) { return __bfloat162float(*p); }

// Shared floats a CTA needs: r, k, cs, cs_ex at (L, K+1); v at (L, kVBlock);
// the scores at (L, L+1); the state at (K, kVBlock); u, cs[L-1], e^{cs[L-1]}.
size_t smem_floats(int K, int L) {
  return 4 * static_cast<size_t>(L) * (K + 1) + static_cast<size_t>(L) * kVBlock +
         static_cast<size_t>(L) * (L + 1) + static_cast<size_t>(K) * kVBlock + 3 * K;
}

template <typename In>
__global__ void __launch_bounds__(kThreads)
wkv6_kernel(const In* __restrict__ r, const In* __restrict__ k, const In* __restrict__ v,
            const float* __restrict__ w, const float* __restrict__ u,
            const float* __restrict__ s0, int T, int H, int K, int V, int L,
            float* __restrict__ o, float* __restrict__ s_out) {
  extern __shared__ float smem[];
  const int kp = K + 1;  // padded rows: lanes reading different rows hit different banks
  float* r_s = smem;                   // (L, kp): r, then r ⊙ e^{cs_ex}
  float* k_s = r_s + L * kp;           // (L, kp): k, then k ⊙ e^{cs[L-1] - cs}
  float* cs_s = k_s + L * kp;          // (L, kp): log w, then cs
  float* ce_s = cs_s + L * kp;         // (L, kp): cs_ex
  float* v_s = ce_s + L * kp;          // (L, kVBlock)
  float* a_s = v_s + L * kVBlock;      // (L, L+1): scores, s <= t only
  float* st_s = a_s + L * (L + 1);     // (K, kVBlock): the running state
  float* u_s = st_s + K * kVBlock;     // (K)
  float* tot_s = u_s + K;              // (K): cs[L-1]
  float* etot_s = tot_s + K;           // (K): e^{cs[L-1]}

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int v0 = blockIdx.y * kVBlock;
  const int vb = min(kVBlock, V - v0);
  const int tid = threadIdx.x;

  for (int i = tid; i < K * kVBlock; i += kThreads) {
    const int kk = i / kVBlock, vv = i % kVBlock;
    st_s[i] = (s0 != nullptr && vv < vb)
                  ? s0[(static_cast<size_t>(bh) * K + kk) * V + v0 + vv] : 0.f;
  }
  for (int i = tid; i < K; i += kThreads) u_s[i] = u[h * K + i];

  const int n_chunks = (T + L - 1) / L;
  const int n_pairs = L * (L - 1) / 2;
  for (int c = 0; c < n_chunks; ++c) {
    const int t0 = c * L;
    const int rows = min(L, T - t0);
    __syncthreads();  // the previous chunk is done with every buffer

    // 1. load the chunk; padded rows get r = k = v = 0 and log w = 0
    for (int i = tid; i < L * K; i += kThreads) {
      const int t = i / K, kk = i % K;
      float rv = 0.f, kv = 0.f, lw = 0.f;
      if (t < rows) {
        const size_t g = ((static_cast<size_t>(b) * T + t0 + t) * H + h) * K + kk;
        rv = load_f(r + g);
        kv = load_f(k + g);
        lw = logf(fmaxf(w[g], 1e-38f));
      }
      r_s[t * kp + kk] = rv;
      k_s[t * kp + kk] = kv;
      cs_s[t * kp + kk] = lw;
    }
    for (int i = tid; i < L * kVBlock; i += kThreads) {
      const int t = i / kVBlock, vv = i % kVBlock;
      v_s[i] = (t < rows && vv < vb)
                   ? load_f(v + ((static_cast<size_t>(b) * T + t0 + t) * H + h) * V + v0 + vv)
                   : 0.f;
    }
    __syncthreads();

    // 2. cumsum of log w down each k column, a sequential fold
    for (int kk = tid; kk < K; kk += kThreads) {
      float run = 0.f;
      for (int t = 0; t < L; ++t) {
        const float lw = cs_s[t * kp + kk];
        run = run + lw;
        cs_s[t * kp + kk] = run;
        ce_s[t * kp + kk] = run - lw;
      }
      tot_s[kk] = run;
      etot_s[kk] = expf(run);
    }
    __syncthreads();

    // 3. scores: strictly lower triangle, pair p = t(t-1)/2 + s with s < t,
    //    then the diagonal bonus r_t ⊙ u · k_t
    for (int p = tid; p < n_pairs; p += kThreads) {
      int t = static_cast<int>((1.f + sqrtf(1.f + 8.f * static_cast<float>(p))) * 0.5f);
      while (t * (t - 1) / 2 > p) --t;
      while (t * (t + 1) / 2 <= p) ++t;
      const int s = p - t * (t - 1) / 2;
      const float* rt = r_s + t * kp;
      const float* ks = k_s + s * kp;
      const float* cet = ce_s + t * kp;
      const float* css = cs_s + s * kp;
      float acc = 0.f;
      for (int kk = 0; kk < K; ++kk) acc += rt[kk] * ks[kk] * expf(fminf(cet[kk] - css[kk], 0.f));
      a_s[t * (L + 1) + s] = acc;
    }
    for (int t = tid; t < L; t += kThreads) {
      float acc = 0.f;
      for (int kk = 0; kk < K; ++kk) acc += r_s[t * kp + kk] * u_s[kk] * k_s[t * kp + kk];
      a_s[t * (L + 1) + t] = acc;
    }
    __syncthreads();

    // 4. decayed r and k, in place
    for (int i = tid; i < L * K; i += kThreads) {
      const int t = i / K, kk = i % K;
      r_s[t * kp + kk] *= expf(ce_s[t * kp + kk]);
      k_s[t * kp + kk] *= expf(tot_s[kk] - cs_s[t * kp + kk]);
    }
    __syncthreads();

    // 5. outputs of the chunk's real rows: a warp shares t, its lanes take
    //    consecutive columns
    for (int i = tid; i < L * kVBlock; i += kThreads) {
      const int t = i / kVBlock, vv = i % kVBlock;
      if (t >= rows || vv >= vb) continue;
      float acc = 0.f;
      for (int kk = 0; kk < K; ++kk) acc += r_s[t * kp + kk] * st_s[kk * kVBlock + vv];
      for (int s = 0; s <= t; ++s) acc += a_s[t * (L + 1) + s] * v_s[s * kVBlock + vv];
      o[((static_cast<size_t>(b) * T + t0 + t) * H + h) * V + v0 + vv] = acc;
    }
    __syncthreads();

    // 6. the state for the next chunk
    for (int i = tid; i < K * kVBlock; i += kThreads) {
      const int kk = i / kVBlock, vv = i % kVBlock;
      float acc = etot_s[kk] * st_s[i];
      for (int t = 0; t < L; ++t) acc += k_s[t * kp + kk] * v_s[t * kVBlock + vv];
      st_s[i] = acc;
    }
  }
  __syncthreads();
  for (int i = tid; i < K * kVBlock; i += kThreads) {
    const int kk = i / kVBlock, vv = i % kVBlock;
    if (vv < vb) s_out[(static_cast<size_t>(bh) * K + kk) * V + v0 + vv] = st_s[i];
  }
}

template <typename In>
int launch(const void* r, const void* k, const void* v, const float* w, const float* u,
           const float* s0, int B, int T, int H, int K, int V, int L, float* o, float* s_out,
           cudaStream_t stream) {
  // Above 48 KB a block's dynamic shared memory must be allowed first.  The
  // limit is raised once per size, before any capture into a CUDA graph
  // (the first call of a shape runs outside one).
  static size_t allowed = 48 * 1024;
  const size_t smem = sizeof(float) * smem_floats(K, L);
  if (smem > allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        wkv6_kernel<In>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed = smem;
  }
  const dim3 grid(B * H, (V + kVBlock - 1) / kVBlock);
  wkv6_kernel<In><<<grid, kThreads, smem, stream>>>(
      static_cast<const In*>(r), static_cast<const In*>(k), static_cast<const In*>(v), w, u, s0,
      T, H, K, V, L, o, s_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// r, k, w (B, T, H, K) and v (B, T, H, V), contiguous; r, k, v float32
// (bf16 = 0) or bfloat16 (bf16 = 1); w float32; u (H, K) float32; s0
// (B, H, K, V) float32 or null for zeros; chunk length L, 1 <= L <= T.
// Writes o (B, T, H, V) and s_out (B, H, K, V), float32.  Returns
// cudaGetLastError() after the launch, or the error of raising the block's
// dynamic shared-memory limit (a chunk and K too large for one SM).
int wkv6(const void* r, const void* k, const void* v, const float* w, const float* u,
         const float* s0, int B, int T, int H, int K, int V, int L, int bf16, float* o,
         float* s_out, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (bf16)
    return launch<__nv_bfloat16>(r, k, v, w, u, s0, B, T, H, K, V, L, o, s_out, stream);
  return launch<float>(r, k, v, w, u, s0, B, T, H, K, V, L, o, s_out, stream);
}

}  // extern "C"

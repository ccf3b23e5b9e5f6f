// Block coordinate descent for the row-sparse group lasso over an alpha
// grid, for Hopper: K3, `group_cd_grid_kernel`.
//
// K3 replaces work the JAX package leaves to XLA, not a TPU kernel:
// channel_pruning_tpu/ops/lasso.py `group_cd_solve`, vmapped over the alphas
// by `group_cd_solve_grid`. For each alpha it minimises
//   1/(2N) ||Y - X B||_F^2 + alpha * sum_j ||B_j||_2
// from G = XᵀX (c x c, symmetric) and C = XᵀY (c x n), alphas_n = alpha * N:
//   R_j   = (C_j - Q_j) + G_jj * B_j              Q = G @ B, maintained
//   B_j'  = max(0, 1 - alpha_n / ||R_j||) R_j / G_jj   (0 where G_jj <= 0)
//   Q    += G[:, j] ⊗ (B_j' - B_j)                (G symmetric: row == column)
// with ||R_j|| = sqrt(sum R_j² + 1e-30). Each alpha stops on its own, when
// max|delta| <= tol * max(max|B|, 1e-12) after a sweep (at least one sweep
// runs), or after n_sweeps sweeps.
//
// A row update whose delta is 0 everywhere is skipped: Q + G·0 == Q for
// every finite Q (Q never holds -0: it starts at +0 and x + (-0) == x), so
// the result is the one of the update that JAX runs. Every float operation
// uses the round-to-nearest intrinsics in the plain PyTorch version's order
// (kernels/group_cd.group_cd_solve_grid_plain), built with -fmad=false, and
// the plain version sums a row's squares in this kernel's order (per
// thread, then the warps' butterflies), so the two agree bit for bit. (The
// JAX package sums them in XLA's order: the results agree to rounding.)
//
// Bound. The rows of one alpha are serial (row j reads Q_j, which every
// earlier moving row changed), and a moving row updates all of Q: c·n
// multiply-adds, with Q read and written once, 8·c·n bytes. At
// (c, n) = (2048, 512) Q is 4 MB an alpha, so a grid of 16 alphas keeps
// 64 MB of Q against a 50 MB L2, and a sweep of dense alphas moves ~16 GB of
// Q an alpha: the kernel is bound by Q's traffic, far above the bound of the
// work it must do (G and C read once, B written once).
//
// Design (simple first): one block of 1024 threads per alpha, B and Q in
// device memory, the row's R_j and then its delta in shared memory, one
// block reduction per row for ||R_j||, and a block barrier between rows.
// Spreading an alpha over a cluster, keeping a residual instead of Q, or
// wgmma on blocks of rows are for a later redesign.
//
// `stats`, when not null, receives for each alpha the sweeps run and the
// number of row updates with a nonzero delta (int32 pairs), from which the
// work these inputs need is counted.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxN = 32768;  // the row lives in 128 KB of shared memory

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

// Every thread gets the block's sum (max) of v. Two barriers: the partials
// are written after the first, the result read after the second, so calls
// may follow each other.
template <bool kMax>
__device__ __forceinline__ float block_reduce(float v, float* red,
                                              float* out) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  v = kMax ? warp_max(v) : warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = red[lane];  // kWarps == 32: every lane holds one warp's partial
    v = kMax ? warp_max(v) : warp_sum(v);
    if (lane == 0) *out = v;
  }
  __syncthreads();
  return *out;
}

__global__ void __launch_bounds__(kThreads)
group_cd_grid_kernel(const float* __restrict__ G, const float* __restrict__ C,
                     const float* __restrict__ alphas_n,
                     float* __restrict__ B_all, float* __restrict__ Q_all,
                     int* __restrict__ stats, int c, int n, int n_sweeps,
                     float tol) {
  extern __shared__ float s_row[];  // R_j, then its delta
  __shared__ float s_red[kWarps];
  __shared__ float s_out;
  const size_t cn = (size_t)c * n;
  float* B = B_all + blockIdx.x * cn;
  float* Q = Q_all + blockIdx.x * cn;
  const float alpha_n = alphas_n[blockIdx.x];
  for (size_t i = threadIdx.x; i < cn; i += kThreads) B[i] = Q[i] = 0.0f;
  __syncthreads();
  // Q's update walks (i, k) over c x n with a stride of kThreads elements:
  // the row and column steps, so no division runs in the loop
  const int step_i = kThreads / n, step_k = kThreads % n;

  int it = 0, moves = 0;
  while (true) {
    float tmax_delta = 0.0f;
    for (int j = 0; j < c; ++j) {
      const float dj = G[(size_t)j * c + j];
      const float sdj = dj > 0.0f ? dj : 1.0f;
      float* Bj = B + (size_t)j * n;
      const float* Cj = C + (size_t)j * n;
      const float* Qj = Q + (size_t)j * n;
      float ss = 0.0f;
      for (int k = threadIdx.x; k < n; k += kThreads) {
        const float r =
            __fadd_rn(__fsub_rn(Cj[k], Qj[k]), __fmul_rn(dj, Bj[k]));
        s_row[k] = r;  // this thread's own k: read back below by it alone
        ss = __fadd_rn(ss, __fmul_rn(r, r));
      }
      ss = block_reduce<false>(ss, s_red, &s_out);
      const float norm = __fsqrt_rn(__fadd_rn(ss, 1e-30f));
      const float scale = __fdiv_rn(
          fmaxf(0.0f, __fsub_rn(1.0f, __fdiv_rn(alpha_n, norm))), sdj);
      int moved = 0;
      for (int k = threadIdx.x; k < n; k += kThreads) {
        const float b_new = dj > 0.0f ? __fmul_rn(scale, s_row[k]) : 0.0f;
        const float d = __fsub_rn(b_new, Bj[k]);
        Bj[k] = b_new;
        s_row[k] = d;
        tmax_delta = fmaxf(tmax_delta, fabsf(d));
        moved |= d != 0.0f;
      }
      // a barrier too: every delta is in shared memory before Q reads it
      if (__syncthreads_or(moved)) {
        ++moves;
        const float* Gj = G + (size_t)j * c;  // == column j
        int i = threadIdx.x / n, k = threadIdx.x % n;
        for (size_t e = threadIdx.x; e < cn; e += kThreads) {
          Q[e] = __fadd_rn(Q[e], __fmul_rn(Gj[i], s_row[k]));
          i += step_i;
          k += step_k;
          if (k >= n) {
            k -= n;
            ++i;
          }
        }
        __syncthreads();  // Q is current before the next row reads it
      }
    }
    ++it;
    float tmax_b = 0.0f;
    for (size_t e = threadIdx.x; e < cn; e += kThreads)
      tmax_b = fmaxf(tmax_b, fabsf(B[e]));
    const float max_delta = block_reduce<true>(tmax_delta, s_red, &s_out);
    const float max_b = block_reduce<true>(tmax_b, s_red, &s_out);
    const float scale = fmaxf(max_b, 1e-12f);
    if (!(it < n_sweeps && max_delta > __fmul_rn(tol, scale))) break;
  }
  if (stats != nullptr && threadIdx.x == 0) {
    stats[2 * blockIdx.x] = it;
    stats[2 * blockIdx.x + 1] = moves;
  }
}

}  // namespace

extern "C" {

// K3: one block of 1024 threads per alpha on `stream`, for c >= 1 and
// 1 <= n <= kMaxN. B (the result) and Q (scratch) hold n_alpha·c·n floats
// each; the kernel zeroes both. `stats` is null or holds 2·n_alpha ints.
// Returns the launch's error code (0 on success); the caller checks it.
int cp_group_cd_grid(const float* G, const float* C, const float* alphas_n,
                     float* B, float* Q, int* stats, int c, int n,
                     int n_alpha, int n_sweeps, float tol, void* stream) {
  if (c < 1 || n < 1 || n > kMaxN || n_alpha < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * (size_t)n;
  cudaError_t err = cudaFuncSetAttribute(
      group_cd_grid_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  group_cd_grid_kernel<<<n_alpha, kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      G, C, alphas_n, B, Q, stats, c, n, n_sweeps, tol);
  return static_cast<int>(cudaGetLastError());
}

const char* cp_group_cd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

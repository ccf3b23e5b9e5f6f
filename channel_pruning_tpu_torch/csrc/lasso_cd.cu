// Gram-form cyclic coordinate-descent LASSO over an alpha grid, for Hopper:
// two kernels with one contract, K1 (`lasso_cd_grid_kernel`, c <= 1024) and
// K2 (`lasso_cd_stream_kernel`, larger c; see its own note further down).
//
// K1 replaces the TPU kernel channel_pruning_tpu/kernels/lasso_cd.py
// `cd_solve_grid_pallas` (body `_cd_kernel`). For each alpha it minimises
//   1/(2N) ||y - Z beta||^2 + alpha ||beta||_1
// from G = ZᵀZ (c x c, symmetric) and b = Zᵀy, with alphas_n = alpha * N:
//   c_j   = (b_j - q_j) + G_jj * beta_j          q = G @ beta, maintained
//   beta' = sign(c_j) * max(|c_j| - alpha_n, 0) / G_jj
//   q    += G[j, :] * (beta' - beta_j)           (G symmetric: row == column)
// Coordinates with a zero diagonal stay at 0 (padding is inert). A sweep
// loop stops when max|delta| <= tol * max(max|beta|, 1e-12), or after
// n_sweeps sweeps.
//
// Design. One block per alpha, so each alpha stops on its own (the
// per-alpha rule of the reference's XLA path, ops/lasso.cd_solve; the TPU
// kernel stopped blocks of 8 alphas together). beta, q, b and diag(G) live
// in shared memory (16·c bytes, 16 KB at c = 1024); G stays in global
// memory, where all A blocks read it and it stays resident in the 50 MB L2
// (1 MB at c = 512). Thread t owns columns t, t+256, ... so the row read
// G[j, t::256] is coalesced. Per coordinate: thread 0 computes the new
// beta_j and delta, a barrier publishes delta, and if delta != 0 every
// thread updates its slice of q and a second barrier orders that update
// before the next coordinate reads q. delta is double-buffered by the
// parity of j, so the second barrier can be skipped when delta == 0.
//
// Arithmetic. Every float operation uses the round-to-nearest intrinsics in
// the plain PyTorch version's order (kernels/lasso_cd.cd_solve_grid_plain),
// so no multiply-add is contracted and the kernel matches it bit for bit.
//
// Bound. Latency of the serial coordinate chain: about c * sweeps steps per
// block, each with one or two barriers, one shared-memory round trip through
// thread 0 and one L2 row read; the card's arithmetic and bandwidth are
// nearly idle (~0.3 us a step measured on an H100 80GB HBM3 at 700 W, with
// most alphas running to the 200-sweep cap). Later work: several alphas per block sharing each G row,
// prefetching row j+1 while thread 0 computes, a warp-level delta broadcast
// in place of the block barrier, and a CUDA graph over the whole alpha
// search.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float soft_threshold(float cj, float alpha_n,
                                                float dj) {
  // sign(c) * max(|c| - alpha_n, 0) / d, in that order
  float sgn = (cj > 0.0f) ? 1.0f : ((cj < 0.0f) ? -1.0f : 0.0f);
  float mag = fmaxf(__fsub_rn(fabsf(cj), alpha_n), 0.0f);
  return __fdiv_rn(__fmul_rn(sgn, mag), dj);
}

__global__ void __launch_bounds__(kThreads)
lasso_cd_grid_kernel(const float* __restrict__ G, const float* __restrict__ b,
                     const float* __restrict__ alphas_n,
                     float* __restrict__ out, int c, int n_sweeps, float tol) {
  extern __shared__ float smem[];
  float* s_beta = smem;
  float* s_q = smem + c;
  float* s_b = smem + 2 * c;
  float* s_diag = smem + 3 * c;
  __shared__ float s_delta[2];
  __shared__ float s_warp_max[kThreads / 32];
  __shared__ int s_continue;

  const int tid = threadIdx.x;
  const float alpha_n = alphas_n[blockIdx.x];
  for (int k = tid; k < c; k += kThreads) {
    s_beta[k] = 0.0f;
    s_q[k] = 0.0f;
    s_b[k] = b[k];
    s_diag[k] = G[(size_t)k * c + k];
  }
  __syncthreads();

  float max_delta = 0.0f;  // meaningful in thread 0 only
  int it = 0;
  do {
    max_delta = 0.0f;
    for (int j = 0; j < c; ++j) {
      if (tid == 0) {
        const float dj = s_diag[j];
        const float bj_old = s_beta[j];
        float bj = 0.0f;
        if (dj > 0.0f) {
          const float cj = __fadd_rn(__fsub_rn(s_b[j], s_q[j]),
                                     __fmul_rn(dj, bj_old));
          bj = soft_threshold(cj, alpha_n, dj);
        }
        const float delta = __fsub_rn(bj, bj_old);
        s_beta[j] = bj;
        s_delta[j & 1] = delta;
        max_delta = fmaxf(max_delta, fabsf(delta));
      }
      __syncthreads();
      const float delta = s_delta[j & 1];
      if (delta != 0.0f) {
        const float* row = G + (size_t)j * c;
        for (int k = tid; k < c; k += kThreads) {
          s_q[k] = __fadd_rn(s_q[k], __fmul_rn(row[k], delta));
        }
        __syncthreads();
      }
    }
    ++it;
    // block-wide max|beta| decides whether another sweep runs
    float m = 0.0f;
    for (int k = tid; k < c; k += kThreads) m = fmaxf(m, fabsf(s_beta[k]));
    for (int off = 16; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    if ((tid & 31) == 0) s_warp_max[tid >> 5] = m;
    __syncthreads();
    if (tid == 0) {
      float scale = 0.0f;
      for (int w = 0; w < kThreads / 32; ++w) scale = fmaxf(scale, s_warp_max[w]);
      scale = fmaxf(scale, 1e-12f);
      s_continue = (it < n_sweeps) && (max_delta > __fmul_rn(tol, scale));
    }
    __syncthreads();
  } while (s_continue);

  float* dst = out + (size_t)blockIdx.x * c;
  for (int k = tid; k < c; k += kThreads) dst[k] = s_beta[k];
}

// K2: the same contract for large c, with G's rows streamed into shared
// memory ahead of use.
//
// Replaces the TPU kernel channel_pruning_tpu/kernels/lasso_cd.py
// `cd_solve_grid_pallas_hbm` (body `_cd_kernel_hbm`), which kept G in HBM
// and DMA'd 8-row blocks into a double-buffered (2, 8, c) VMEM scratch under
// DMA semaphores, 8 alphas to a program. Here, as in K1, one block per alpha
// (each alpha stops on its own). beta, q, b and diag(G) live in dynamic
// shared memory (16·c bytes) beside two row buffers (8·c bytes): 24·c bytes,
// 48 KB at c = 2048 and 192 KB at kMaxCStream = 8192, under the 227 KB a
// block may have. Row j is copied into buffer (step & 1) with cp.async at
// the start of coordinate j-1, so the copy overlaps thread 0's update, the
// barrier and the q update of the coordinate before it. Thread t copies and
// later reads only its own columns t, t+256, ... (the same columns of q it
// owns), so its cp.async.wait_group alone orders the copy before its reads;
// and every coordinate has a barrier between a buffer's last read and the
// copy that next overwrites it.
//
// Arithmetic: K1's, operation for operation, so K2 equals K1 and the plain
// version bit for bit.
//
// Bound: as K1, the latency of the serial coordinate chain. Each coordinate
// also moves one row (8 KB at c = 2048) from L2, or from HBM once G (c²·4
// bytes, 64 MB at c = 4096) outgrows the 50 MB L2; a grid of 32 alphas needs
// ~1 TB/s of it at 0.5 us a step, well under either bound.

constexpr int kMaxCStream = 8192;

__device__ __forceinline__ void cp_async_f32(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__global__ void __launch_bounds__(kThreads)
lasso_cd_stream_kernel(const float* __restrict__ G,
                       const float* __restrict__ b,
                       const float* __restrict__ alphas_n,
                       float* __restrict__ out, int c, int n_sweeps,
                       float tol) {
  extern __shared__ float smem[];
  float* s_beta = smem;
  float* s_q = smem + c;
  float* s_b = smem + 2 * c;
  float* s_diag = smem + 3 * c;
  float* s_row = smem + 4 * c;  // two row buffers, c floats each
  __shared__ float s_delta[2];
  __shared__ float s_warp_max[kThreads / 32];
  __shared__ int s_continue;

  const int tid = threadIdx.x;
  const float alpha_n = alphas_n[blockIdx.x];
  for (int k = tid; k < c; k += kThreads) {
    s_beta[k] = 0.0f;
    s_q[k] = 0.0f;
    s_b[k] = b[k];
    s_diag[k] = G[(size_t)k * c + k];
    cp_async_f32(s_row + k, G + k);  // row 0 into buffer 0
  }
  cp_async_commit();
  __syncthreads();

  int slot = 0;            // buffer holding the current coordinate's row
  float max_delta = 0.0f;  // meaningful in thread 0 only
  int it = 0;
  do {
    max_delta = 0.0f;
    for (int j = 0; j < c; ++j) {
      // row j has landed (this thread's columns); start the next row, the
      // first row of the next sweep after the last one
      cp_async_wait_all();
      const float* next = G + (size_t)(j + 1 < c ? j + 1 : 0) * c;
      float* nbuf = s_row + (slot ^ 1) * c;
      for (int k = tid; k < c; k += kThreads) cp_async_f32(nbuf + k, next + k);
      cp_async_commit();
      if (tid == 0) {
        const float dj = s_diag[j];
        const float bj_old = s_beta[j];
        float bj = 0.0f;
        if (dj > 0.0f) {
          const float cj = __fadd_rn(__fsub_rn(s_b[j], s_q[j]),
                                     __fmul_rn(dj, bj_old));
          bj = soft_threshold(cj, alpha_n, dj);
        }
        const float delta = __fsub_rn(bj, bj_old);
        s_beta[j] = bj;
        s_delta[j & 1] = delta;
        max_delta = fmaxf(max_delta, fabsf(delta));
      }
      __syncthreads();
      const float delta = s_delta[j & 1];
      if (delta != 0.0f) {
        const float* row = s_row + slot * c;
        for (int k = tid; k < c; k += kThreads) {
          s_q[k] = __fadd_rn(s_q[k], __fmul_rn(row[k], delta));
        }
        __syncthreads();
      }
      slot ^= 1;
    }
    ++it;
    float m = 0.0f;
    for (int k = tid; k < c; k += kThreads) m = fmaxf(m, fabsf(s_beta[k]));
    for (int off = 16; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    if ((tid & 31) == 0) s_warp_max[tid >> 5] = m;
    __syncthreads();
    if (tid == 0) {
      float scale = 0.0f;
      for (int w = 0; w < kThreads / 32; ++w) scale = fmaxf(scale, s_warp_max[w]);
      scale = fmaxf(scale, 1e-12f);
      s_continue = (it < n_sweeps) && (max_delta > __fmul_rn(tol, scale));
    }
    __syncthreads();
  } while (s_continue);
  cp_async_wait_all();  // drain the prefetch for the sweep that did not run

  float* dst = out + (size_t)blockIdx.x * c;
  for (int k = tid; k < c; k += kThreads) dst[k] = s_beta[k];
}

}  // namespace

extern "C" {

// Launches one block per alpha on `stream`. Returns cudaGetLastError() of the
// launch (0 on success); the caller checks it.
int cp_lasso_cd_grid(const float* G, const float* b, const float* alphas_n,
                     float* out, int c, int n_alpha, int n_sweeps, float tol,
                     void* stream) {
  const size_t smem = (size_t)4 * c * sizeof(float);
  lasso_cd_grid_kernel<<<n_alpha, kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      G, b, alphas_n, out, c, n_sweeps, tol);
  return static_cast<int>(cudaGetLastError());
}

// K2: as cp_lasso_cd_grid, for 1 <= c <= kMaxCStream. The kernel's
// dynamic shared-memory limit is raised first: the default 48 KB holds the
// static and dynamic parts together, and at c = 2048 the dynamic part alone
// is 48 KB.
int cp_lasso_cd_grid_stream(const float* G, const float* b,
                            const float* alphas_n, float* out, int c,
                            int n_alpha, int n_sweeps, float tol,
                            void* stream) {
  if (c < 1 || c > kMaxCStream) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = (size_t)6 * c * sizeof(float);
  const cudaError_t err = cudaFuncSetAttribute(
      lasso_cd_stream_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  lasso_cd_stream_kernel<<<n_alpha, kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      G, b, alphas_n, out, c, n_sweeps, tol);
  return static_cast<int>(cudaGetLastError());
}

const char* cp_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

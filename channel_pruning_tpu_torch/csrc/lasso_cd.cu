// Gram-form cyclic coordinate-descent LASSO over an alpha grid, for Hopper:
// two kernels with one contract, K1 (c <= 1024) and K2 (1024 < c <= 8192),
// both instances of the template `lasso_cd_grid_kernel`.
//
// K1 replaces the TPU kernel channel_pruning_tpu/kernels/lasso_cd.py
// `cd_solve_grid_pallas` (body `_cd_kernel`), K2 its HBM-streaming sibling
// `cd_solve_grid_pallas_hbm` (body `_cd_kernel_hbm`). For each alpha they
// minimise
//   1/(2N) ||y - Z beta||^2 + alpha ||beta||_1
// from G = ZᵀZ (c x c, symmetric) and b = Zᵀy, with alphas_n = alpha * N:
//   c_j   = (b_j - q_j) + G_jj * beta_j          q = G @ beta, maintained
//   beta' = sign(c_j) * max(|c_j| - alpha_n, 0) / G_jj
//   q    += G[j, :] * (beta' - beta_j)           (G symmetric: row == column)
// Coordinates with a zero diagonal stay at 0 (padding is inert). Each alpha
// stops on its own, when max|delta| <= tol * max(max|beta|, 1e-12) after a
// sweep, or after n_sweeps sweeps. An alpha of +inf thresholds every
// coordinate to 0, so it stops after one sweep of c/32 window steps with
// no move: the fused search's rounds after it is done cost that much.
//
// Arithmetic. Every float operation uses the round-to-nearest intrinsics in
// the plain PyTorch version's order (kernels/lasso_cd.cd_solve_grid_plain),
// and the build passes -fmad=false, so the kernels match it bit for bit.
//
// Bound. The coordinate chain of one alpha is serial: a step reads q_j,
// which the step before may have changed. The card's arithmetic and
// bandwidth are nearly idle (a 32-alpha grid at c = 512 needs ~0.5 GFLOP and
// ~1 MB): a grid costs the serial steps of its slowest alpha (the smallest,
// whose solution is densest) times the latency of one. The first kernels
// of this port ran one block of 256 threads per alpha with thread 0
// computing every coordinate, so every step paid a block barrier and a
// shared-memory round trip, although most steps have delta = 0 and change
// nothing.
//
// Design: the coordinate chain of one alpha runs in one warp, with no block
// barrier in the coordinate loop. Column k belongs to lane k mod 32. The
// sweep walks 32-column chunks. In a chunk, every lane computes its
// coordinate's candidate beta from the current q with the plain version's
// operations; __ballot_sync(delta != 0) and __ffs find the first lane f at
// or after the window start s that moves. Lanes s..f-1 commit their
// candidate (their delta is 0: q has not changed since s, so the serial
// loop computes the same values), lane f commits its beta, delta reaches
// every lane by __shfl_sync, q takes row 32i+f times delta, and the window
// restarts at f+1; a window in which no lane moves commits all its lanes and
// ends the chunk. A sweep takes c/32 + (nonzero deltas) serial iterations
// instead of c.
//
// The row update is split to keep the row read off the chain: the window
// chunk's 32 q values take it at once from the chunk's diagonal block of G,
// staged in shared memory by TMA one chunk ahead; the other chunks' q take
// it from the row, loaded into registers at the move and applied at the
// next move or at the chunk's end, so the load overlaps the next chain
// step. No chunk's q is read before its chunk starts, so every q_k receives
// the same products in the same order as in the serial loop, and the result
// is bit-identical. q lives in registers, indexed only by compile-time
// offsets, and W = ceil(c/256) warps (rounded up to a power of two, at most
// 32) serve one alpha: each runs the same chain on the same values, so they
// decide alike without talking, and each holds and updates 8 chunks of q,
// which divides the update work of a moving coordinate by W (see
// `lasso_cd_grid_kernel`).
//
// Measured on an H100 80GB HBM3 at 700 W (tools/cd_latency_probe.py): a
// window step takes ~410 cycles of latency (the candidate ~320 of them, its
// division ~60), an L2 load ~390, a TMA row copy ~410-470 from issue to
// arrival (109 to issue), and a column of a row update ~6 cycles with q in
// registers against ~41-46 with q in shared memory (one warp). The
// smallest alphas of a grid have dense solutions (nearly every coordinate
// moves in every sweep), so a grid's time is that chain's latency times its
// moving coordinates, plus their updates; the skip-ahead pays off on the
// sparse alphas.
//
// `stats`, when not null, receives for each alpha the sweeps run and the
// number of nonzero-delta steps (int32 pairs), from which the work these
// inputs need is counted.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxC = 1024;        // K1
constexpr int kMaxCStream = 8192;  // K2: up to 32 warps of 8 chunks

__device__ __forceinline__ float soft_threshold(float cj, float alpha_n,
                                                float dj) {
  // sign(c) * max(|c| - alpha_n, 0) / d, in that order
  float sgn = (cj > 0.0f) ? 1.0f : ((cj < 0.0f) ? -1.0f : 0.0f);
  float mag = fmaxf(__fsub_rn(fabsf(cj), alpha_n), 0.0f);
  return __fdiv_rn(__fmul_rn(sgn, mag), dj);
}

// One coordinate's new beta from the current q, in the plain version's order
// and branch-free as it is: divide by the diagonal where it is positive
// (safe_dk = dk there, 1 elsewhere), then 0 where it is not.
__device__ __forceinline__ float cd_candidate(float bk, float qk, float dk,
                                              float safe_dk, float beta_old,
                                              float alpha_n) {
  const float cj = __fadd_rn(__fsub_rn(bk, qk), __fmul_rn(dk, beta_old));
  const float bj = soft_threshold(cj, alpha_n, safe_dk);
  return dk > 0.0f ? bj : 0.0f;
}

__device__ __forceinline__ float warp_max(float m) {
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(kFull, m, off));
  return m;
}

__device__ __forceinline__ void write_stats(int* stats, int it, int moves) {
  if (stats != nullptr && threadIdx.x == 0) {
    stats[2 * blockIdx.x] = it;
    stats[2 * blockIdx.x + 1] = moves;
  }
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// mbarriers and bulk copies (TMA): a lane issues a copy of a whole row
// segment, and the copies' completion flips the barrier's phase.
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// If `issue`: expect `expect` more bytes on the barrier (0: none), then
// copy `bytes` from src to dst, completing on it. Predicated, so the lanes
// that issue nothing do not branch.
__device__ __forceinline__ void tma_load(bool issue, unsigned expect,
                                         void* dst, const void* src,
                                         unsigned bytes, uint64_t* bar) {
  asm volatile(
      "{\n.reg .pred p, e;\n"
      "setp.ne.b32 p, %0, 0;\n"
      "setp.ne.and.b32 e, %1, 0, p;\n"
      "@e mbarrier.arrive.expect_tx.shared::cta.b64 _, [%5], %1;\n"
      "@p cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%2], [%3], %4, [%5];\n}\n" ::"r"(static_cast<int>(issue)),
      "r"(expect), "r"(smem_addr(dst)), "l"(src), "r"(bytes),
      "r"(smem_addr(bar))
      : "memory");
}

// Thread 0 sets up the block's barriers; a block barrier must follow
// before any copy.
__device__ __forceinline__ void init_barriers(uint64_t* bars, int n) {
  if (threadIdx.x == 0) {
    for (int k = 0; k < n; ++k) mbar_init(bars + k);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
}

// Chunk i's diagonal block (rows 32i + a, a < n, their columns 32i..) into
// blk[a * 32 ...] and b's chunk into bch, on one barrier. c % 4 == 0 keeps
// every segment a multiple of 16 bytes; lanes read nothing past n.
__device__ __forceinline__ void stage_chunk(float* blk, float* bch,
                                            uint64_t* bar, const float* G,
                                            const float* b, int c, int i,
                                            int lane) {
  const int n = min(32, c - 32 * i);
  const unsigned w = 4u * n;
  __syncwarp();  // every lane is done reading the buffer
  tma_load(lane == 0, w * (n + 1), bch, b + 32 * i, w, bar);
  __syncwarp();  // the expected bytes are set before any other copy lands
  tma_load(lane < n, 0u, blk + lane * 32,
           G + (size_t)(32 * i + min(lane, n - 1)) * c + 32 * i, w, bar);
}

// Waits for barrier k's pending phase; `parity` holds one bit a barrier.
__device__ __forceinline__ void wait_flip(uint64_t* bars, unsigned& parity,
                                          int k) {
  mbar_wait(bars + k, (parity >> k) & 1u);
  parity ^= 1u << k;
}

// This warp's segment of a row into registers: columns 32t + lane of it,
// 0 past its n columns (n <= 0: none).
template <int M>
__device__ __forceinline__ void load_row(float (&row)[M], const float* src,
                                         int n, int lane) {
#pragma unroll
  for (int t = 0; t < M; ++t)
    row[t] = 32 * t + lane < n ? src[32 * t + lane] : 0.0f;
}

// A row update to this warp's chunks, from registers (d = 0: nothing
// pending, and q + 0·row = q). It updates the window's chunk too: that
// register is stale while the window's scalar is live and is overwritten
// when the chunk ends.
template <int M>
__device__ __forceinline__ void apply_row(float (&q)[M], const float (&row)[M],
                                          float d) {
#pragma unroll
  for (int t = 0; t < M; ++t) q[t] = __fadd_rn(q[t], __fmul_rn(row[t], d));
}

// Shared-memory floats of the register kernel with W warps of M chunks: the
// two staged chunks (block and b), beta, and the window's q handed over.
__host__ __device__ constexpr size_t grid_smem_floats(int M, int W) {
  return (size_t)2 * 1024 + 2 * 32 + 32 * M * W + 2 * 32;
}

// K1 and K2: q in registers. W warps serve one alpha, and warp w holds q of
// the M chunks w·M .. w·M + M - 1 (M·W = ceil(c/32) rounded up to a power
// of two). Every warp runs the same coordinate chain on the same values, so
// all of them take the same decisions with no exchange; each applies the
// row updates to its own chunks only, which divides the per-coordinate
// update work by W. A moving coordinate's row segment is loaded into
// registers at once and applied at the next move (or at the chunk's end),
// so the load's latency overlaps the next chain step. The window chunk's q
// passes from the warp holding it to all warps through shared memory at the
// chunk's start: one block barrier a chunk, none a coordinate. The chunk
// loop is not unrolled (the code stays small): the window's q and beta live
// in two scalars, and every access to q[] has a compile-time index.
template <int M, int W>
__global__ void __launch_bounds__(32 * W)
lasso_cd_grid_kernel(const float* __restrict__ G, const float* __restrict__ b,
                     const float* __restrict__ alphas_n,
                     float* __restrict__ out, int* __restrict__ stats, int c,
                     int n_sweeps, float tol) {
  extern __shared__ __align__(128) float grid_smem[];
  __shared__ uint64_t chunk_bar[2];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* s_blk = grid_smem;              // diagonal blocks: this, next
  float* s_bch = s_blk + 2 * 1024;       // b's chunks: this, next
  float* s_beta = s_bch + 2 * 32;        // beta
  float* s_qwin = s_beta + 32 * M * W;   // the window's q, handed over
  const float alpha_n = alphas_n[blockIdx.x];
  const int nch = (c + 31) / 32;
  const int col0 = 32 * M * warp;        // this warp's first column
  float q[M], row[M];                    // row: the last move's segment
  float row_d = 0.0f;                    // and its delta, 0: none pending
#pragma unroll
  for (int t = 0; t < M; ++t) q[t] = row[t] = 0.0f;
  for (int k = threadIdx.x; k < 32 * M * W; k += 32 * W) s_beta[k] = 0.0f;
  init_barriers(chunk_bar, 2);
  __syncthreads();
  if (warp == 0) stage_chunk(s_blk, s_bch, chunk_bar, G, b, c, 0, lane);

  int it = 0, moves = 0;
  int pb = 0;                // which staged buffer is this chunk's
  unsigned chunk_par = 0;    // the chunk barriers' pending phases
  while (true) {
    float max_delta = 0.0f, max_beta = 0.0f;
    for (int i = 0; i < nch; ++i) {
      // chunk i is q[ti] on the warp holding it: compile-time selects (an
      // index whose range the compiler could prove would become a dynamic
      // one, and q would move to local memory)
      const bool holder = i / M == warp;
      const int ti = i - warp * M;
      if (holder) {
        float v = 0.0f;
#pragma unroll
        for (int t = 0; t < M; ++t)
          if (t == ti) v = q[t];
        s_qwin[(i & 1) * 32 + lane] = v;
      }
      __syncthreads();  // the last chunk is done everywhere; its q is handed
      if (warp == 0)
        stage_chunk(s_blk + (pb ^ 1) * 1024, s_bch + (pb ^ 1) * 32,
                    chunk_bar + (pb ^ 1), G, b, c, i + 1 < nch ? i + 1 : 0,
                    lane);
      wait_flip(chunk_bar, chunk_par, pb);
      const bool in = 32 * i + lane < c;
      const float* blk = s_blk + pb * 1024;
      const float bk = in ? s_bch[pb * 32 + lane] : 0.0f;
      const float dk = in ? blk[lane * 32 + lane] : 0.0f;  // 0 past c: inert
      const float sdk = dk > 0.0f ? dk : 1.0f;
      float qw = s_qwin[(i & 1) * 32 + lane];
      float bw = s_beta[32 * i + lane];
      int s = 0;  // the window: lanes s..31 of chunk i
      while (true) {
        const float bj = cd_candidate(bk, qw, dk, sdk, bw, alpha_n);
        const float delta = __fsub_rn(bj, bw);
        const unsigned moved =
            __ballot_sync(kFull, delta != 0.0f) & (kFull << s);
        if (moved == 0u) {
          if (lane >= s) bw = bj;
          break;
        }
        const int f = __ffs(moved) - 1;
        if (lane >= s && lane <= f) bw = bj;
        const float d = __shfl_sync(kFull, delta, f);
        max_delta = fmaxf(max_delta, fabsf(d));
        ++moves;
        // the window's q at once, from the staged block (G symmetric); this
        // warp's chunks: the last move's segment now, this one's next time
        qw = __fadd_rn(qw, __fmul_rn(blk[f * 32 + lane], d));
        apply_row(q, row, row_d);
        load_row(row, G + (size_t)(32 * i + f) * c + col0, c - col0, lane);
        row_d = d;
        s = f + 1;
        if (s == 32) break;
      }
      // the next chunk reads q: the pending update lands first
      apply_row(q, row, row_d);
      row_d = 0.0f;
      if (holder) {
#pragma unroll
        for (int t = 0; t < M; ++t)
          if (t == ti) q[t] = qw;
      }
      if (warp == 0) s_beta[32 * i + lane] = bw;
      max_beta = fmaxf(max_beta, warp_max(fabsf(bw)));  // final for the sweep
      pb ^= 1;
    }
    ++it;
    const float scale = fmaxf(max_beta, 1e-12f);
    if (!(it < n_sweeps && max_delta > __fmul_rn(tol, scale))) break;
  }
  wait_flip(chunk_bar, chunk_par, pb);  // the chunk staged but not run
  __syncthreads();

  float* dst = out + (size_t)blockIdx.x * c;
  for (int k = threadIdx.x; k < c; k += 32 * W) dst[k] = s_beta[k];
  write_stats(stats, it, moves);
}

template <int M, int W>
cudaError_t launch_grid(const float* G, const float* b, const float* alphas_n,
                        float* out, int* stats, int c, int n_alpha,
                        int n_sweeps, float tol, cudaStream_t stream) {
  const size_t smem = sizeof(float) * grid_smem_floats(M, W);
  cudaError_t err = cudaFuncSetAttribute(
      lasso_cd_grid_kernel<M, W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  lasso_cd_grid_kernel<M, W><<<n_alpha, 32 * W, smem, stream>>>(
      G, b, alphas_n, out, stats, c, n_sweeps, tol);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// K1: one block per alpha (1 to 4 warps) on `stream`, for 1 <= c <= kMaxC.
// `stats` is null or holds 2·n_alpha ints. Returns the launch's error code
// (0 on success); the caller checks it.
int cp_lasso_cd_grid(const float* G, const float* b, const float* alphas_n,
                     float* out, int* stats, int c, int n_alpha, int n_sweeps,
                     float tol, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int chunks = (c + 31) / 32;
  cudaError_t err = cudaErrorInvalidValue;
  if (c < 1 || c > kMaxC) return static_cast<int>(err);
  if (chunks <= 4)
    err = launch_grid<4, 1>(G, b, alphas_n, out, stats, c, n_alpha,
                            n_sweeps, tol, st);
  else if (chunks <= 8)
    err = launch_grid<8, 1>(G, b, alphas_n, out, stats, c, n_alpha,
                            n_sweeps, tol, st);
  else if (chunks <= 16)
    err = launch_grid<8, 2>(G, b, alphas_n, out, stats, c, n_alpha,
                            n_sweeps, tol, st);
  else
    err = launch_grid<8, 4>(G, b, alphas_n, out, stats, c, n_alpha,
                            n_sweeps, tol, st);
  return static_cast<int>(err);
}

// K2: as cp_lasso_cd_grid, for 1 <= c <= kMaxCStream (8 to 32 warps, the
// 1024 threads a block may have bounding c).
int cp_lasso_cd_grid_stream(const float* G, const float* b,
                            const float* alphas_n, float* out, int* stats,
                            int c, int n_alpha, int n_sweeps, float tol,
                            void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (c < 1 || c > kMaxCStream) return static_cast<int>(err);
  if (c <= 2048)
    err = launch_grid<8, 8>(G, b, alphas_n, out, stats, c, n_alpha,
                            n_sweeps, tol, st);
  else if (c <= 4096)
    err = launch_grid<8, 16>(G, b, alphas_n, out, stats, c, n_alpha,
                             n_sweeps, tol, st);
  else
    err = launch_grid<8, 32>(G, b, alphas_n, out, stats, c, n_alpha,
                             n_sweeps, tol, st);
  return static_cast<int>(err);
}

const char* cp_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

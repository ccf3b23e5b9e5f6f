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
// The one division is computed exactly another way (`cd_candidate`).
//
// Bound. The coordinate chain of one alpha is serial: a step reads q_j,
// which the step before may have changed. The card's arithmetic and
// bandwidth are nearly idle (a 32-alpha grid at c = 512 needs ~0.5 GFLOP and
// ~1 MB): a grid costs the serial steps of its slowest alpha (the smallest,
// whose solution is densest: all but a few percent of its coordinates move
// in every sweep) times the latency of one, plus a chunk's fixed cost.
//
// Design: the coordinate chain of one alpha runs in one warp, with no block
// barrier in the coordinate loop. Column k belongs to lane k mod 32. The
// sweep walks 32-column chunks. In a chunk, every lane computes its
// coordinate's candidate beta from the current q; __ballot_sync(delta != 0)
// and __ffs find the first lane f at or after the window start s that
// moves. Lanes s..f-1 commit their candidate (their delta is 0: q has not
// changed since s, so the serial loop computes the same values), lane f
// commits its beta, delta reaches every lane by __shfl_sync, q takes row
// 32i+f times delta, and the window restarts at f+1; a window in which no
// lane moves commits all its lanes and ends the chunk. A sweep takes
// c/32 + (nonzero deltas) serial steps instead of c.
//
// The row update is split to keep the row read off the chain: the window
// chunk's 32 q values take it at once from the chunk's diagonal block of G,
// staged in shared memory (cp.async) one chunk ahead; the other chunks' q
// take it from the row, loaded into a ring of registers and applied a few
// moves later or at the chunk's end. No chunk's q is read before its chunk
// starts, so every q_k receives the same products in the same order as in
// the serial loop, and the result is bit-identical. q lives in registers,
// indexed only by compile-time offsets, and W warps serve one alpha: each
// runs the same chain on the same values, so they decide alike without
// talking, and each holds and updates M chunks of q, which divides the
// update work of a moving coordinate by W (see `lasso_cd_grid_kernel`).
//
// Measured on an H100 80GB HBM3 at 700 W (tools/cd_latency_probe.py): the
// window step with the first kernels' candidate took 413 cycles, the
// candidate 318 of them: the sign was an integer converted to float
// (I2FP) and __fdiv_rn a reciprocal, three FMAs and an FCHK range test
// inside a BSSY/BSYNC region around a call to its slow path. The candidate
// below takes 81 cycles (its f64 product 52) and the window step 175; an
// L2 load takes ~380, ballot + ffs + shuffle 26. The chain of a move is
// the delta's shuffle, the staged block's entry (a shared load), a product
// and a sum for the next coordinate's q, and the candidate. In the kernel a
// move costs 254-327 cycles on the benchmark cells' grids
// (tools/cd_cell_grids.py): the row update's loads and products still go
// between the shuffle and the next candidate.
//
// `stats`, when not null, receives for each alpha the sweeps run and the
// number of nonzero-delta steps (int32 pairs), from which the work these
// inputs need is counted.

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxC = 1024;        // K1: up to 16 warps of 2 chunks
constexpr int kMaxCStream = 8192;  // K2: up to 8 warps of 32 chunks

// One coordinate's new beta from the current q, equal to the plain
// version's sign(c) * max(|c| - alpha_n, 0) / d, and 0 where d <= 0:
//   c = (b - q) + d·beta_old    (d·beta_old, `dkb`, taken once a chunk)
// sign(c)·mag is a select (c = ±0 gives +0, as 0·mag does), and the
// division a product in f64 with rinv = 1/d rounded to f64 (1 where
// d <= 0, whose numerator is 0): a quotient of two floats lies farther
// than 2^-49 (relative) from any midpoint of two floats, the f64 product
// errs by less than 2^-52, so rounding it to f32 gives the correctly
// rounded quotient, as __fdiv_rn does (tests/test_torch_lasso_cd.py holds
// the two equal on millions of pairs and the edge cases). No slow path,
// no branch.
__device__ __forceinline__ float cd_candidate(float bk, float qk, float dkb,
                                              bool live, double rinv,
                                              float alpha_n) {
  const float cj = __fadd_rn(__fsub_rn(bk, qk), dkb);
  const float mag = fmaxf(__fsub_rn(fabsf(cj), alpha_n), 0.0f);
  const float num = (live && cj < 0.0f) ? -mag
                                        : ((live && cj > 0.0f) ? mag : 0.0f);
  return __double2float_rn(__dmul_rn(static_cast<double>(num), rinv));
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

// Asynchronous 16-byte copies from global to shared memory (cp.async),
// each thread's in one group a chunk; `ok` false copies nothing.
__device__ __forceinline__ void copy16(float* dst, const float* src, bool ok) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %2, 0;\n"
      "@p cp.async.cg.shared.global [%0], [%1], 16;\n}\n" ::"r"(
          smem_addr(dst)),
      "l"(src), "r"(static_cast<int>(ok))
      : "memory");
}

__device__ __forceinline__ void copies_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// This thread's copies have landed (a block barrier then shows them to
// every thread).
__device__ __forceinline__ void copies_wait() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Chunk i's diagonal block (rows 32i + a, a < n, their columns 32i..) into
// blk[a * 32 ...] and b's chunk into bch, in 16-byte pieces spread over
// the block's threads (c % 4 == 0: a row segment is whole pieces); nothing
// past n rows or columns is read.
__device__ __forceinline__ void stage_chunk(float* blk, float* bch,
                                            const float* G, const float* b,
                                            int c, int i) {
  const int n = min(32, c - 32 * i);
  for (int k = threadIdx.x; k < 33 * 8; k += blockDim.x) {
    const int a = k >> 3, p = 4 * (k & 7);
    const bool ok = p < n && (a < n || a == 32);
    const float* src = a < 32 ? G + (size_t)(32 * i + a) * c + 32 * i + p
                              : b + 32 * i + p;
    copy16(a < 32 ? blk + a * 32 + p : bch + p, ok ? src : b, ok);
  }
  copies_commit();
}

// This warp's segment of a row into registers: columns 32t + lane of it.
// FULL: the warp's M·32 columns all lie inside the row; else 0 past its
// n columns (n <= 0: none), so no lane reads past the matrix.
template <bool FULL, int M>
__device__ __forceinline__ void load_row(float (&row)[M], const float* src,
                                         int n, int lane) {
#pragma unroll
  for (int t = 0; t < M; ++t)
    row[t] = FULL || 32 * t + lane < n ? src[32 * t + lane] : 0.0f;
}

// A row update to this warp's chunks, from registers (d = 0: nothing
// pending, and q + 0·row = q). It updates the window's chunk too: that
// register is overwritten when the chunk ends.
template <int M>
__device__ __forceinline__ void apply_row(float (&q)[M], const float (&row)[M],
                                          float d) {
#pragma unroll
  for (int t = 0; t < M; ++t) q[t] = __fadd_rn(q[t], __fmul_rn(row[t], d));
}

// The chunk's end with slot K next in the ring of R: the last move's row
// (not yet loaded) into slot K - 1, then the pending rows in the order of
// their moves, the oldest (slot K) first; the ring is then empty.
template <int K, bool FULL, int M, int R>
__device__ __forceinline__ void drain_ring(float (&q)[M], float (&ring)[R][M],
                                           float (&ring_d)[R],
                                           const float* last, int n,
                                           int lane) {
  load_row<FULL>(ring[(K + R - 1) % R], last, n, lane);
#pragma unroll
  for (int k = 0; k < R; ++k) {
    apply_row(q, ring[(K + k) % R], ring_d[(K + k) % R]);
    ring_d[(K + k) % R] = 0.0f;
  }
}

// Shared-memory floats of the kernel with W warps of M chunks: the two
// staged chunks (block and b), beta, the window's q handed over, and
// (as doubles, two floats each) the diagonal's reciprocals.
__host__ __device__ constexpr size_t grid_smem_floats(int M, int W) {
  return (size_t)2 * 1024 + 2 * 32 + 32 * M * W + 2 * 32 + 2 * 32 * M * W;
}

// K1 and K2: q in registers. W warps serve one alpha, and warp w holds q of
// the M chunks w·M .. w·M + M - 1 (M·W = ceil(c/32) rounded up to a power
// of two). Every warp runs the same coordinate chain on the same values, so
// all of them take the same decisions with no exchange; each applies the
// row updates to its own chunks only, which divides the per-coordinate
// update work by W.
//
// Between two moves the dependent path is the mover's delta (a shuffle),
// the next coordinate's q (the staged block's entry, a product and a sum)
// and the candidate. Everything else runs in its shadow: a moving
// coordinate's row segment is loaded into a ring of R register rows one
// move later (its address is then known, so the load does not queue in
// front of the chain) and applied R moves after the move (at the chunk's
// end, oldest first), so an L2 load has R - 1 chain steps to land; the
// move loop is unrolled R times so that every ring slot has a compile-time
// index. FULL (no warp's columns past c) drops the loads' bounds tests.
// max|beta| is reduced across the warp once a sweep. The window chunk's q
// passes from the warp holding it to all warps through shared memory at
// the chunk's start: one block barrier a chunk, none a coordinate. The
// chunk loop is not unrolled (the code stays small): the window's q and
// beta live in two scalars, and every access to q[] has a compile-time
// index.
template <int M, int W, int R, bool FULL>
__global__ void __launch_bounds__(32 * W, 1)
lasso_cd_grid_kernel(const float* __restrict__ G, const float* __restrict__ b,
                     const float* __restrict__ alphas_n,
                     float* __restrict__ out, int* __restrict__ stats, int c,
                     int n_sweeps, float tol) {
  static_assert(R == 2 || R == 4, "one drain case a ring slot");
  extern __shared__ __align__(128) float grid_smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* s_blk = grid_smem;              // diagonal blocks: this, next
  float* s_bch = s_blk + 2 * 1024;       // b's chunks: this, next
  float* s_beta = s_bch + 2 * 32;        // beta
  float* s_qwin = s_beta + 32 * M * W;   // the window's q, handed over
  double* s_rinv = reinterpret_cast<double*>(s_qwin + 2 * 32);  // 1/G_kk
  const float alpha_n = alphas_n[blockIdx.x];
  const int nch = (c + 31) / 32;
  const int col0 = 32 * M * warp;        // this warp's first column
  const int ncol = c - col0;             // its columns inside the row
  float q[M], ring[R][M], ring_d[R];
#pragma unroll
  for (int t = 0; t < M; ++t) q[t] = 0.0f;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    ring_d[r] = 0.0f;
#pragma unroll
    for (int t = 0; t < M; ++t) ring[r][t] = 0.0f;
  }
  for (int k = threadIdx.x; k < 32 * M * W; k += 32 * W) {
    s_beta[k] = 0.0f;
    const float d = k < c ? G[(size_t)k * c + k] : 0.0f;
    s_rinv[k] = d > 0.0f ? __ddiv_rn(1.0, static_cast<double>(d)) : 1.0;
  }
  stage_chunk(s_blk, s_bch, G, b, c, 0);

  int it = 0, moves = 0;
  int pb = 0;                // which staged buffer is this chunk's
  while (true) {
    float max_delta = 0.0f, lane_max_beta = 0.0f;
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
      copies_wait();    // this chunk's block, staged a chunk ago
      __syncthreads();  // the last chunk is done everywhere; its q is handed
      stage_chunk(s_blk + (pb ^ 1) * 1024, s_bch + (pb ^ 1) * 32, G, b, c,
                  i + 1 < nch ? i + 1 : 0);
      const bool in = 32 * i + lane < c;
      const float* blk = s_blk + pb * 1024;
      const float bk = in ? s_bch[pb * 32 + lane] : 0.0f;
      const float dk = in ? blk[lane * 32 + lane] : 0.0f;  // 0 past c: inert
      const bool live = dk > 0.0f;
      const double rinv = s_rinv[32 * i + lane];
      float qw = s_qwin[(i & 1) * 32 + lane];
      float bw = s_beta[32 * i + lane];
      // a lane's beta changes only when the window passes it, so d·beta of
      // every lane still in the window is the chunk's first
      const float dkb = __fmul_rn(dk, bw);
      const float* rows = G + (size_t)(32 * i) * c + col0;
      const float* last = rows;  // the last move's row, loaded one move on
      int s = 0;      // the window: lanes s..31 of chunk i
      int next = 0;   // the ring slot the next move takes
      bool open = true;
      while (open) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float bj = cd_candidate(bk, qw, dkb, live, rinv, alpha_n);
          const float delta = __fsub_rn(bj, bw);
          const unsigned moved =
              __ballot_sync(kFull, delta != 0.0f) & (kFull << s);
          if (moved == 0u) {
            if (lane >= s) bw = bj;
            next = r;
            open = false;
            break;
          }
          const int f = __ffs(moved) - 1;
          // the window's q at once, from the staged block (G symmetric)
          const float g = blk[f * 32 + lane];
          const float d = __shfl_sync(kFull, delta, f);
          qw = __fadd_rn(qw, __fmul_rn(g, d));
          if (lane >= s && lane <= f) bw = bj;
          max_delta = fmaxf(max_delta, fabsf(d));
          ++moves;
          // this warp's chunks: the move R back now; the last move's row
          // into its slot (slot r - 1, d = 0 at the chunk's first move)
          apply_row(q, ring[r], ring_d[r]);
          load_row<FULL>(ring[(r + R - 1) % R], last, ncol, lane);
          last = rows + (size_t)f * c;
          ring_d[r] = d;
          s = f + 1;
          if (s == 32) {
            next = (r + 1) % R;
            open = false;
            break;
          }
        }
      }
      // the next chunk reads q: the pending updates land first, in order
      switch (next) {
        case 0: drain_ring<0, FULL>(q, ring, ring_d, last, ncol, lane); break;
        case 1: drain_ring<1, FULL>(q, ring, ring_d, last, ncol, lane); break;
        case 2:
          drain_ring<2 % R, FULL>(q, ring, ring_d, last, ncol, lane);
          break;
        default:
          drain_ring<3 % R, FULL>(q, ring, ring_d, last, ncol, lane);
          break;
      }
      if (holder) {
#pragma unroll
        for (int t = 0; t < M; ++t)
          if (t == ti) q[t] = qw;
      }
      if (warp == 0) s_beta[32 * i + lane] = bw;
      lane_max_beta = fmaxf(lane_max_beta, fabsf(bw));  // final this sweep
      pb ^= 1;
    }
    ++it;
    const float scale = fmaxf(warp_max(lane_max_beta), 1e-12f);
    if (!(it < n_sweeps && max_delta > __fmul_rn(tol, scale))) break;
  }
  copies_wait();  // the chunk staged but not run
  __syncthreads();

  float* dst = out + (size_t)blockIdx.x * c;
  for (int k = threadIdx.x; k < c; k += 32 * W) dst[k] = s_beta[k];
  write_stats(stats, it, moves);
}

template <int M, int W, int R, bool FULL>
cudaError_t launch_grid(const float* G, const float* b, const float* alphas_n,
                        float* out, int* stats, int c, int n_alpha,
                        int n_sweeps, float tol, cudaStream_t stream) {
  const size_t smem = sizeof(float) * grid_smem_floats(M, W);
  cudaError_t err = cudaFuncSetAttribute(
      lasso_cd_grid_kernel<M, W, R, FULL>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  lasso_cd_grid_kernel<M, W, R, FULL><<<n_alpha, 32 * W, smem, stream>>>(
      G, b, alphas_n, out, stats, c, n_sweeps, tol);
  return cudaGetLastError();
}

// The instance for c: W warps of M chunks, a ring of R; FULL where every
// warp's columns lie inside the matrix (c = 32·M·W): the loads without
// bounds tests made K1/K2 14% faster on the resnet50.cp2x cell's grids
// (tools/cd_cell_grids.py, H100 80GB HBM3).
template <int M, int W, int R>
cudaError_t launch_for(const float* G, const float* b, const float* alphas_n,
                       float* out, int* stats, int c, int n_alpha,
                       int n_sweeps, float tol, cudaStream_t stream) {
  if (c == 32 * M * W)
    return launch_grid<M, W, R, true>(G, b, alphas_n, out, stats, c, n_alpha,
                                      n_sweeps, tol, stream);
  return launch_grid<M, W, R, false>(G, b, alphas_n, out, stats, c, n_alpha,
                                     n_sweeps, tol, stream);
}

}  // namespace

extern "C" {

// K1: one block per alpha (1 to 16 warps) on `stream`, for 1 <= c <= kMaxC.
// `stats` is null or holds 2·n_alpha ints. Returns the launch's error code
// (0 on success); the caller checks it. More warps of fewer chunks spread
// a chunk's staging and a move's row update: on the benchmark cells' grids
// warps of 1-2 chunks ran fastest in K1 (K2 at c = 2048: 8 warps of 8,
// not 16 of 4).
int cp_lasso_cd_grid(const float* G, const float* b, const float* alphas_n,
                     float* out, int* stats, int c, int n_alpha, int n_sweeps,
                     float tol, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int chunks = (c + 31) / 32;
  cudaError_t err = cudaErrorInvalidValue;
  if (c < 1 || c > kMaxC) return static_cast<int>(err);
  if (chunks <= 1)
    err = launch_for<1, 1, 4>(G, b, alphas_n, out, stats, c, n_alpha,
                              n_sweeps, tol, st);
  else if (chunks <= 2)
    err = launch_for<1, 2, 4>(G, b, alphas_n, out, stats, c, n_alpha,
                              n_sweeps, tol, st);
  else if (chunks <= 4)
    err = launch_for<1, 4, 4>(G, b, alphas_n, out, stats, c, n_alpha,
                              n_sweeps, tol, st);
  else if (chunks <= 8)
    err = launch_for<2, 4, 4>(G, b, alphas_n, out, stats, c, n_alpha,
                              n_sweeps, tol, st);
  else if (chunks <= 16)
    err = launch_for<2, 8, 4>(G, b, alphas_n, out, stats, c, n_alpha,
                              n_sweeps, tol, st);
  else
    err = launch_for<2, 16, 4>(G, b, alphas_n, out, stats, c, n_alpha,
                              n_sweeps, tol, st);
  return static_cast<int>(err);
}

// K2: as cp_lasso_cd_grid, for 1 <= c <= kMaxCStream: 8 or 16 warps of 8
// chunks up to c = 4096, above it 8 warps of 32 chunks with a ring of 2
// and bounds-tested loads (16 warps of 16 would need more than the 128
// registers a thread of a 512-thread block may have).
int cp_lasso_cd_grid_stream(const float* G, const float* b,
                            const float* alphas_n, float* out, int* stats,
                            int c, int n_alpha, int n_sweeps, float tol,
                            void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (c < 1 || c > kMaxCStream) return static_cast<int>(err);
  if (c <= 2048)
    err = launch_for<8, 8, 4>(G, b, alphas_n, out, stats, c, n_alpha,
                              n_sweeps, tol, st);
  else if (c <= 4096)
    err = launch_for<8, 16, 4>(G, b, alphas_n, out, stats, c, n_alpha,
                               n_sweeps, tol, st);
  else
    err = launch_grid<32, 8, 2, false>(G, b, alphas_n, out, stats, c,
                                       n_alpha, n_sweeps, tol, st);
  return static_cast<int>(err);
}

const char* cp_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

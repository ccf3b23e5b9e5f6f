// Gram-form cyclic coordinate-descent LASSO over an alpha grid, for Hopper:
// two kernels with one contract, K1 (c <= 1024) and K2 (1024 < c <= 8192),
// each an instance of `lasso_cd_split_kernel`.
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
// The row update is kept off the chain: the window chunk's 32 q values take
// it at once from the chunk's diagonal block of G, staged in shared memory;
// every other chunk's q takes it later, in the moves' order. No chunk's q
// is read before its chunk starts, so every q_k receives the same products
// in the same order as in the serial loop, and the result is
// bit-identical. The kernel gives the chain a warp of its own and the row
// updates to other warps, fed through a queue in shared memory
// (`lasso_cd_split_kernel`).
//
// Measured on an H100 80GB HBM3 at 700 W (tools/cd_latency_probe.py): the
// candidate below takes 81 cycles (its f64 product 52) and the window step
// 175; an L2 load ~380, ballot + ffs + shuffle 26; the window step with the
// move published into the queue (lane 0's one 64-bit store) 188. The chain
// of a move is the delta's shuffle, the staged block's entry (a shared
// load), a product and a sum for the next coordinate's q, and the
// candidate; in the chain warp a move costs ~200 cycles (clock-stamped
// copies on the benchmark cells' grids), against 254-327 where every warp
// ran the chain and put its row updates' loads and products between the
// shuffle and the next candidate.
//
// `stats`, when not null, receives for each alpha the sweeps run and the
// number of nonzero-delta steps (int32 pairs), from which the work these
// inputs need is counted.

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxC = 1024;        // K1: up to 32 chunks
constexpr int kMaxCStream = 8192;  // K2: up to 256 chunks

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

// The split kernels' move queue: kQueue 64-bit entries in shared memory,
// each (delta bits << 32) | (tag << 14) | row, the tag the entry's index
// mod 2^18, so an entry shows by itself that it has landed (a slot holds
// its entry or the one kQueue before). A row field of kEnd or kStop marks
// a chunk's end or the alpha's.
constexpr int kQueue = 128;
constexpr unsigned kTagMask = (1u << 18) - 1;
constexpr unsigned kEnd = 8192, kStop = 8193;  // rows are < kMaxCStream

__device__ __forceinline__ unsigned long long entry(int h, unsigned row,
                                                   float d) {
  return (static_cast<unsigned long long>(__float_as_uint(d)) << 32) |
         ((static_cast<unsigned>(h) & kTagMask) << 14) | row;
}
__device__ __forceinline__ unsigned entry_tag(unsigned long long e) {
  return static_cast<unsigned>(e) >> 14;
}
__device__ __forceinline__ unsigned entry_row(unsigned long long e) {
  return static_cast<unsigned>(e) & 0x3fffu;
}
__device__ __forceinline__ float entry_delta(unsigned long long e) {
  return __uint_as_float(static_cast<unsigned>(e >> 32));
}
__device__ __forceinline__ void put_relaxed(unsigned long long* p,
                                            unsigned long long v) {
  asm volatile("st.relaxed.cta.shared.b64 [%0], %1;\n" ::"r"(smem_addr(p)),
               "l"(v) : "memory");
}
// a marker: every earlier load and store of this thread before it
__device__ __forceinline__ void put_release(unsigned long long* p,
                                            unsigned long long v) {
  asm volatile("st.release.cta.shared.b64 [%0], %1;\n" ::"r"(smem_addr(p)),
               "l"(v) : "memory");
}
__device__ __forceinline__ unsigned long long get_relaxed(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.cta.shared.b64 %0, [%1];\n"
               : "=l"(v) : "r"(smem_addr(p)) : "memory");
  return v;
}
__device__ __forceinline__ int get_int(const int* p) {
  int v;
  asm volatile("ld.relaxed.cta.shared.b32 %0, [%1];\n"
               : "=r"(v) : "r"(smem_addr(p)) : "memory");
  return v;
}
__device__ __forceinline__ int get_int_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.cta.shared.b32 %0, [%1];\n"
               : "=r"(v) : "r"(smem_addr(p)) : "memory");
  return v;
}
__device__ __forceinline__ void put_int(int* p, int v) {
  asm volatile("st.relaxed.cta.shared.b32 [%0], %1;\n" ::"r"(smem_addr(p)),
               "r"(v) : "memory");
}
__device__ __forceinline__ void put_int_release(int* p, int v) {
  asm volatile("st.release.cta.shared.b32 [%0], %1;\n" ::"r"(smem_addr(p)),
               "r"(v) : "memory");
}

// A wait of the split kernels that outlasts 2^28 polls (seconds; a chunk's
// longest wait is microseconds) traps, so a broken hand-over fails the
// launch instead of hanging the card.
__device__ __forceinline__ void poll_guard(unsigned& polls) {
  if (++polls == (1u << 28)) __trap();
}

// The update warps of the split kernel with NW warps (a multiple of 4):
// warp 0, the chain's, is alone on its scheduler (warp w issues on
// sub-partition w mod 4, and warps 4, 8, ... stay idle).
__host__ __device__ constexpr int split_updaters(int NW) {
  return NW - NW / 4;
}

// Shared-memory bytes of the split kernel with S staged steps and widest
// c cm: each step's staged blocks (the diagonal block, the next chunk's
// columns), two steps' q handed over, b, the diagonal, beta and its
// reciprocals, the queue, a barrier for each staged step, each update
// warp's entries taken, the step in each hand-over slot and each buffer.
__host__ __device__ constexpr size_t split_smem_bytes(int S, int cm) {
  return sizeof(float) * (2 * S * 1024 + 2 * 32 + 3 * cm) +
         sizeof(double) * cm + sizeof(unsigned long long) * (kQueue + S) +
         sizeof(int) * (32 + 2 + S);
}

// A step's staged blocks, chunk i with the next chunk i1: its diagonal
// block (rows 32i + a, a < n, columns 32i..) into blk and the rows'
// segments at the next chunk's columns (32·i1..) into nxt, in 16-byte
// pieces over threads t of nt, nothing past the matrix read.
__device__ __forceinline__ void stage_step(float* blk, float* nxt,
                                           const float* G, int c, int i,
                                           int i1, int t, int nt) {
  const int n = min(32, c - 32 * i), n1 = min(32, c - 32 * i1);
  for (int k = t; k < 64 * 8; k += nt) {
    const int a = (k >> 3) & 31, p = 4 * (k & 7);
    const bool diag = k < 32 * 8;
    const bool ok = a < n && p < (diag ? n : n1);
    const float* src = G + (size_t)(32 * i + a) * c + 32 * (diag ? i : i1) + p;
    copy16((diag ? blk : nxt) + a * 32 + p, ok ? src : G, ok);
  }
}

// This lane's copies so far arrive on `bar` as they land.
__device__ __forceinline__ void copies_arrive(unsigned long long* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// Wait until `bar` completes the phase of parity `par`.
__device__ __forceinline__ void bar_wait(unsigned long long* bar,
                                         unsigned par) {
  unsigned done = 0;
  for (unsigned polls = 0; !done; poll_guard(polls))
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(par) : "memory");
}

// Wait until *p == v (acquire).
__device__ __forceinline__ void wait_for(const int* p, int v) {
  for (unsigned polls = 0; get_int_acquire(p) != v;) poll_guard(polls);
}

// This update warp's segment of a row into registers, four columns a lane:
// columns 128t + 4·lane .. + 3 of it, 0 past its n columns (n % 4 == 0).
template <int V>
__device__ __forceinline__ void load_row4(float4 (&row)[V], const float* src,
                                          int n, int lane) {
#pragma unroll
  for (int t = 0; t < V; ++t)
    row[t] = 128 * t + 4 * lane < n
                 ? *reinterpret_cast<const float4*>(src + 128 * t + 4 * lane)
                 : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

template <int V>
__device__ __forceinline__ void apply_row4(float4 (&q)[V],
                                           const float4 (&row)[V], float d) {
#pragma unroll
  for (int t = 0; t < V; ++t) {
    q[t].x = __fadd_rn(q[t].x, __fmul_rn(row[t].x, d));
    q[t].y = __fadd_rn(q[t].y, __fmul_rn(row[t].y, d));
    q[t].z = __fadd_rn(q[t].z, __fmul_rn(row[t].z, d));
    q[t].w = __fadd_rn(q[t].w, __fmul_rn(row[t].w, d));
  }
}

// q[t] for a t known only at run time, by bit masks: a select chain over a
// register array is turned back into an indexed load from local memory.
template <int V>
__device__ __forceinline__ float4 pick4(const float4 (&q)[V], int t) {
  unsigned x = 0, y = 0, z = 0, w = 0;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const unsigned m = k == t ? ~0u : 0u;
    x |= __float_as_uint(q[k].x) & m;
    y |= __float_as_uint(q[k].y) & m;
    z |= __float_as_uint(q[k].z) & m;
    w |= __float_as_uint(q[k].w) & m;
  }
  return make_float4(__uint_as_float(x), __uint_as_float(y),
                     __uint_as_float(z), __uint_as_float(w));
}

// K1 and K2: one chain warp and update warps, joined by the move queue.
// The chain warp (warp 0) runs each alpha's coordinate chain: candidate,
// ballot and __ffs, the delta's shuffle, the window chunk's q from the
// staged diagonal block, the commits of beta; its one other work a move is lane 0's store of (row, delta) into
// the queue, and a lane's note of the move. Update warp u holds q of the M
// chunks u·M .. u·M + M - 1 in registers, four columns a lane (row
// segments load 16 bytes a lane). It reads the queue in order, a batch of
// up to R landed entries at a time: it takes them (so the chain may reuse
// their slots), issues every row segment's load at once, with the bounds
// tests, then applies them in the entries' order, so q_k receives the same
// products in the same order as in the serial loop, at any lag.
//
// A chunk's end does not wait for the last move's row: at the end of step
// g - 2 the holder of step g's chunk hands over a copy of its q (then
// through step g - 2); at the end of step g - 1 the chain warp applies that
// step's moves to the copy, in order, from the staged block of step g's
// columns, and starts step g on it. b, the diagonal and its reciprocals
// are read once, into shared memory, so a step without a move needs no
// staged block. With at most S chunks every step's blocks are staged once;
// else S buffers roll: at the end of step g - 1 the update warp (g - 1 + S)
// mod (update warps) stages step g - 1 + S (cp.async, completion on the
// buffer's barrier, which the chain waits on at the step's start). So the
// chain waits on the update warps only when a hand-over or a block is late
// or the queue lacks room for a step (it reads their progress only when
// its last reading no longer promises room, and counts a step that has to
// wait in `stalls`). Nothing in the move loop waits. A slot's or buffer's
// step number, not a count, tells the chain that it is ready, as update
// warps run at their own lags. max|beta| and the stopping rule stay in the
// chain warp; a stop marker ends the update warps' loop. With PIPE an
// update warp keeps two batches in flight: the next one's loads issue
// before this one's rows are applied. One instance serves any c up to
// 32·M·U (M a multiple of 4, S a power of two).
template <int M, int NW, int R, int S, bool PIPE>
__global__ void __launch_bounds__(32 * NW, 1)
lasso_cd_split_kernel(const float* __restrict__ G, const float* __restrict__ b,
                      const float* __restrict__ alphas_n,
                      float* __restrict__ out, int* __restrict__ stats,
                      unsigned long long* __restrict__ stalls, int c,
                      int n_sweeps, float tol) {
  constexpr int U = split_updaters(NW);
  constexpr int V = M / 4;               // float4 of q a lane
  constexpr int CM = 32 * M * U;
  static_assert(NW % 4 == 0 && U <= 32 && M % 4 == 0 && S >= 4 &&
                    (S & (S - 1)) == 0,
                "layout");
  extern __shared__ __align__(128) float grid_smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* s_blk = grid_smem;                  // diagonal blocks
  float* s_nxt = s_blk + S * 1024;           // the next chunk's columns
  float* s_qhand = s_nxt + S * 1024;         // q handed over: two slots
  float* s_b = s_qhand + 2 * 32;             // b, 0 past c
  float* s_diag = s_b + CM;                  // G_kk, 0 past c
  float* s_beta = s_diag + CM;               // beta
  double* s_rinv = reinterpret_cast<double*>(s_beta + CM);  // 1/G_kk
  unsigned long long* s_queue =
      reinterpret_cast<unsigned long long*>(s_rinv + CM);
  unsigned long long* s_bar = s_queue + kQueue;  // a buffer's copies
  int* s_taken = reinterpret_cast<int*>(s_bar + S);  // a warp's entries
  int* s_hand = s_taken + 32;                // the step in each q slot
  int* s_staged = s_hand + 2;                // the step in each buffer
  const int nch = (c + 31) / 32;
  const int nupd = (nch + M - 1) / M;        // update warps holding chunks
  const bool resident = nch <= S;            // every block staged once
  for (int k = threadIdx.x; k < CM; k += 32 * NW) {
    const bool in = k < c;
    const float d = in ? G[(size_t)k * c + k] : 0.0f;
    s_b[k] = in ? b[k] : 0.0f;
    s_diag[k] = d;
    s_beta[k] = 0.0f;
    s_rinv[k] = d > 0.0f ? __ddiv_rn(1.0, static_cast<double>(d)) : 1.0;
  }
  for (int k = threadIdx.x; k < kQueue; k += 32 * NW) s_queue[k] = ~0ull;
  if (threadIdx.x < 32) {
    s_taken[threadIdx.x] = 0;
    s_qhand[32 + threadIdx.x] = 0.0f;        // step 1's copy: q before step 0
  }
  if (threadIdx.x < S) s_staged[threadIdx.x] = -1;
  if (threadIdx.x == 0) {
    s_hand[0] = -1;
    s_hand[1] = 1;
    for (int k = 0; k < S; ++k)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 32;\n" ::"r"(
                       smem_addr(s_bar + k))
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (resident) {                            // chunk i's blocks in buffer i
    for (int i = 0; i < nch; ++i)
      stage_step(s_blk + i * 1024, s_nxt + i * 1024, G, c, i, (i + 1) % nch,
                 threadIdx.x, blockDim.x);
    copies_commit();
    copies_wait();
  }
  __syncthreads();

  if (warp == 0) {
    const float alpha_n = alphas_n[blockIdx.x];
    int it = 0, moves = 0, h = 0, g = 0;
    int room = kQueue;                   // publish freely while h < room
    unsigned long long n_stall = 0;
    float qn = 0.0f;                     // the next step's q: step 0's
    while (true) {
      float max_delta = 0.0f, lane_max_beta = 0.0f;
      bool stop = false;
      for (int i = 0; i < nch; ++i, ++g) {
        // room in the queue for the step's entries (32 moves and a marker):
        // every update warp has taken h + 33 - kQueue
        if (h + 33 > room) {
          int v = lane < nupd ? get_int(s_taken + lane) : 0x7fffffff;
          v = __reduce_min_sync(kFull, v);
          if (h + 33 > v + kQueue) {
            ++n_stall;
            unsigned polls = 0;
            do {
              poll_guard(polls);
              v = lane < nupd ? get_int(s_taken + lane) : 0x7fffffff;
              v = __reduce_min_sync(kFull, v);
            } while (h + 33 > v + kQueue);
          }
          room = v + kQueue;
        }
        const int sb = resident ? i : g & (S - 1);
        if (!resident) {                 // the step's blocks, staged
          wait_for(s_staged + sb, g);
          bar_wait(s_bar + sb, (g / S) & 1);
        }
        const float* blk = s_blk + sb * 1024;
        const int k = 32 * i + lane;
        const float bk = s_b[k], dk = s_diag[k];  // 0 past c: inert
        const bool live = dk > 0.0f;
        const double rinv = s_rinv[k];
        float qw = qn;
        float bw = s_beta[k];
        const float dkb = __fmul_rn(dk, bw);
        const int h0 = h;                // the step's first entry
        int s = 0;
        while (true) {
          const float bj = cd_candidate(bk, qw, dkb, live, rinv, alpha_n);
          const float delta = __fsub_rn(bj, bw);
          const unsigned moved =
              __ballot_sync(kFull, delta != 0.0f) & (kFull << s);
          if (moved == 0u) {
            if (lane >= s) bw = bj;
            break;
          }
          const int f = __ffs(moved) - 1;
          const float gv = blk[f * 32 + lane];
          const float d = __shfl_sync(kFull, delta, f);
          qw = __fadd_rn(qw, __fmul_rn(gv, d));
          if (lane >= s && lane <= f) bw = bj;
          max_delta = fmaxf(max_delta, fabsf(d));
          if (lane == 0)
            put_relaxed(s_queue + (h & (kQueue - 1)), entry(h, 32 * i + f, d));
          ++h;
          s = f + 1;
          if (s == 32) break;
        }
        moves += h - h0;
        s_beta[k] = bw;
        lane_max_beta = fmaxf(lane_max_beta, fabsf(bw));
        if (i + 1 == nch) {
          ++it;
          const float scale = fmaxf(warp_max(lane_max_beta), 1e-12f);
          stop = !(it < n_sweeps && max_delta > __fmul_rn(tol, scale));
        }
        __syncwarp();                    // the step's entries, to every lane
        if (!stop) {
          // the next step's q: its holder's copy through step g - 1, then
          // this step's moves in order (read back from the queue) from the
          // staged next columns
          wait_for(s_hand + ((g + 1) & 1), g + 1);
          qn = s_qhand[((g + 1) & 1) * 32 + lane];
          const float* nxt = s_nxt + sb * 1024;
          for (int m0 = h0; m0 < h; m0 += 8) {  // loads first, then the sums
            float gm[8], dm[8];
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              const unsigned long long e = s_queue[(m0 + j) & (kQueue - 1)];
              gm[j] = nxt[(entry_row(e) & 31) * 32 + lane];
              dm[j] = entry_delta(e);
            }
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              const float sum = __fadd_rn(qn, __fmul_rn(gm[j], dm[j]));
              qn = m0 + j < h ? sum : qn;
            }
          }
        }
        __syncwarp();  // the marker: after every lane's reads of the step
        if (lane == 0)
          put_release(s_queue + (h & (kQueue - 1)),
                      entry(h, stop ? kStop : kEnd, 0.0f));
        ++h;
        if (stop) break;
      }
      if (stop) break;
    }
    write_stats(stats, it, moves);
    if (stalls != nullptr && lane == 0) atomicAdd(stalls, n_stall);
  } else if ((warp & 3) != 0) {
    const int u = warp - 1 - warp / 4;
    if (u < nupd) {
      const int col0 = 32 * M * u;       // this warp's first column
      const int ncol = c - col0;         // its columns inside the row
      float4 q[V];
#pragma unroll
      for (int t = 0; t < V; ++t) q[t] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      // step x into its buffer, once the buffer's last step is staged and
      // its copies have landed (a lane's arrival must not count toward the
      // phase before); its step number then tells the chain
      auto stage = [&](int x) {
        const int sb = x & (S - 1);
        __threadfence_block();           // after the chain's reads of it
        if (x >= S) {
          wait_for(s_staged + sb, x - S);
          bar_wait(s_bar + sb, (x / S - 1) & 1);
        }
        stage_step(s_blk + sb * 1024, s_nxt + sb * 1024, G, c, x % nch,
                   (x + 1) % nch, lane, 32);
        copies_arrive(s_bar + sb);
        __syncwarp();
        if (lane == 0) put_int_release(s_staged + sb, x);
      };
      if (!resident)                     // steps 0 .. S - 1, round robin
        for (int x = u; x < S; x += nupd) stage(x);
      int p = 0, g = 0;                  // entries taken, steps ended
      // the entries landed from p on, in order, up to the first marker (with
      // `wait`, at least one): taken (the chain may reuse their slots), and
      // their rows' loads issued
      auto take = [&](unsigned long long (&e)[R], float4 (&rows)[R][V],
                      int& n, unsigned& last, bool wait) {
        for (unsigned polls = 0;; poll_guard(polls)) {
          e[0] = get_relaxed(s_queue + (p & (kQueue - 1)));
          if (!wait || entry_tag(e[0]) == (p & kTagMask)) break;
        }
#pragma unroll
        for (int k = 1; k < R; ++k)
          e[k] = get_relaxed(s_queue + ((p + k) & (kQueue - 1)));
        n = 0;
        last = 0;
#pragma unroll
        for (int k = 0; k < R; ++k) {
          if (n == k && last < kEnd &&
              entry_tag(e[k]) == ((p + k) & kTagMask)) {
            n = k + 1;
            last = entry_row(e[k]);
          }
        }
        if (n == 0) return;
        if (lane == 0) put_int(s_taken + u, p + n);
        p += n;
#pragma unroll
        for (int k = 0; k < R; ++k)
          if (k < n && entry_row(e[k]) < kEnd)
            load_row4(rows[k], G + (size_t)entry_row(e[k]) * c + col0, ncol,
                      lane);
      };
      // a batch's rows into q in order, then its marker: false at the stop
      auto apply = [&](const unsigned long long (&e)[R],
                       const float4 (&rows)[R][V], int n, unsigned last) {
#pragma unroll
        for (int k = 0; k < R; ++k)
          if (k < n && entry_row(e[k]) < kEnd)
            apply_row4(q, rows[k], entry_delta(e[k]));
        if (last < kEnd) return true;
        if (last == kStop) return false;
        ++g;                             // the chain runs step g
        const int i = (g + 1) % nch;     // step g + 1's chunk
        if (i / M == u) {                // a copy of its q, through g - 1
          const int lc = i - u * M;
          if ((lane >> 3) == (lc & 3))
            *reinterpret_cast<float4*>(s_qhand + ((g + 1) & 1) * 32 +
                                       4 * (lane & 7)) = pick4(q, lc >> 2);
          __syncwarp();
          if (lane == 0) put_int_release(s_hand + ((g + 1) & 1), g + 1);
        }
        // step g - 1 freed its buffer: step g - 1 + S into it
        if (!resident && (g - 1 + S) % nupd == u) stage(g - 1 + S);
        return true;
      };
      // with PIPE, two batches in flight: the next one's loads issue before
      // this one's rows are applied (none taken past a marker, which is
      // handled first: the chain may wait on it)
      unsigned long long ea[R], eb[R];
      float4 ra[R][V], rb[R][V];
      int na = 0, nb = 0;
      unsigned la = 0, lb = 0;
      while (true) {
        if (na == 0) take(ea, ra, na, la, true);
        nb = 0;
        if (PIPE && la < kEnd) take(eb, rb, nb, lb, false);
        if (!apply(ea, ra, na, la)) break;
        if (nb == 0) {
          na = 0;
          continue;
        }
        na = 0;
        if (lb < kEnd) take(ea, ra, na, la, false);
        if (!apply(eb, rb, nb, lb)) break;
      }
      copies_commit();                   // no copy lands after the block
      copies_wait();
    }
  }
  __syncthreads();
  float* dst = out + (size_t)blockIdx.x * c;
  for (int k = threadIdx.x; k < c; k += 32 * NW) dst[k] = s_beta[k];
}

// The split instance: NW warps, update warps of M chunks and batches of
// R, S staged steps, PIPE.
template <int M, int NW, int R, int S, bool PIPE>
cudaError_t launch_split(const float* G, const float* b,
                         const float* alphas_n, float* out, int* stats,
                         unsigned long long* stalls, int c, int n_alpha,
                         int n_sweeps, float tol, cudaStream_t stream) {
  constexpr int cm = 32 * M * split_updaters(NW);
  if (c > cm) return cudaErrorInvalidValue;
  const size_t smem = split_smem_bytes(S, cm);
  cudaError_t err = cudaFuncSetAttribute(
      lasso_cd_split_kernel<M, NW, R, S, PIPE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  lasso_cd_split_kernel<M, NW, R, S, PIPE>
      <<<n_alpha, 32 * NW, smem, stream>>>(G, b, alphas_n, out, stats, stalls,
                                            c, n_sweeps, tol);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// K1: one block per alpha on `stream`, for 1 <= c <= kMaxC, by the number
// of 32-column chunks. `stats` is null or holds 2·n_alpha ints; `stalls`
// is null or one counter, to which each block adds the steps at whose
// start its chain warp waited for room in the queue. Returns the
// launch's error code (0 on success); the caller checks it.
int cp_lasso_cd_grid(const float* G, const float* b, const float* alphas_n,
                     float* out, int* stats, int c, int n_alpha, int n_sweeps,
                     float tol, void* stream, unsigned long long* stalls) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int chunks = (c + 31) / 32;
  cudaError_t err = cudaErrorInvalidValue;
  if (c < 1 || c > kMaxC) return static_cast<int>(err);
  if (chunks <= 8)
    err = launch_split<4, 4, 4, 8, true>(G, b, alphas_n, out, stats, stalls,
                                          c, n_alpha, n_sweeps, tol, st);
  else if (chunks <= 16)
    err = launch_split<4, 8, 4, 16, true>(G, b, alphas_n, out, stats, stalls,
                                          c, n_alpha, n_sweeps, tol, st);
  else
    err = launch_split<4, 12, 8, 8, true>(G, b, alphas_n, out, stats, stalls,
                                          c, n_alpha, n_sweeps, tol, st);
  return static_cast<int>(err);
}

// K2: as cp_lasso_cd_grid, for 1 <= c <= kMaxCStream.
int cp_lasso_cd_grid_stream(const float* G, const float* b,
                            const float* alphas_n, float* out, int* stats,
                            int c, int n_alpha, int n_sweeps, float tol,
                            void* stream, unsigned long long* stalls) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int chunks = (c + 31) / 32;
  cudaError_t err = cudaErrorInvalidValue;
  if (c < 1 || c > kMaxCStream) return static_cast<int>(err);
  if (chunks <= 64)
    err = launch_split<12, 8, 8, 8, false>(G, b, alphas_n, out, stats,
                                           stalls, c, n_alpha, n_sweeps, tol,
                                           st);
  else if (chunks <= 128)
    err = launch_split<16, 12, 4, 8, false>(G, b, alphas_n, out, stats,
                                            stalls, c, n_alpha, n_sweeps, tol,
                                            st);
  else
    err = launch_split<24, 16, 2, 4, false>(G, b, alphas_n, out, stats,
                                            stalls, c, n_alpha, n_sweeps, tol,
                                            st);
  return static_cast<int>(err);
}

const char* cp_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

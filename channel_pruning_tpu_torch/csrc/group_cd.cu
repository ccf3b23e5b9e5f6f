// Block coordinate descent for the row-sparse group lasso over an alpha
// grid, for Hopper: K3, `group_cd_grid_kernel<kSmem>`.
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
// Q's update skips a column whose delta is 0: Q + G·0 == Q for every finite
// G and Q (Q never holds -0: it starts at +0 and x + (-0) == x), so the
// result is the one of the update that JAX runs. Every float operation
// uses the round-to-nearest intrinsics in the plain PyTorch version's order
// (kernels/group_cd.group_cd_solve_grid_plain), built with -fmad=false, and
// the plain version sums a row's squares in this kernel's order (per
// thread of 1024, then the warps' butterflies, then one warp over the 32
// warps' sums), so the two agree bit for bit. (The JAX package sums them in
// XLA's order: the results agree to rounding.)
//
// Bound. The rows of one alpha are serial (row j reads Q_j, which every
// earlier moving row changed), and a moving row updates all of Q: c·n
// multiply-adds, with Q read and written once, 8·c·n bytes. At
// (c, n) = (2048, 512) Q is 4 MB an alpha, so a grid of 16 alphas keeps
// 64 MB of Q against a 50 MB L2, and a sweep of dense alphas moves ~16 GB of
// Q an alpha: the kernel is bound by Q's traffic and by the latency of the
// serial row steps, far above the bound of the work it must do (G and C
// read once, B written once).
//
// Design. One thread-block cluster of K blocks (1024 threads each) per
// alpha (the launch plan of kernels/group_cd.py chooses K). Block r owns
// the rows r, r + K, r + 2K, ... of B, C and Q: the owner of a row is not
// the owner of the next, so the next owner's solve runs while the others
// update their rows. Rows are numbered R = sweep * c + j; row R uses slot
// R & 1 of every block's shared memory. For each row j:
//   1. the owner of j has computed R_j, its norm (one block reduction),
//      B_j' and delta_j, exactly as one block did before, and pushed
//      delta_j into slot R & 1 of every block of the cluster with st.async,
//      which counts the bytes on that block's mbarrier for the slot;
//   2. every block waits on its own mbarrier until delta_j is whole, reads
//      it, and arrives at a relaxed cluster barrier: it is done with the
//      slot;
//   3. the owner of row j + 1 updates that row (Q_{j+1} += G_{j,j+1}
//      delta_j), solves it and pushes delta_{j+1}; then every block updates
//      its other rows, Q[i, k] += G[j, i] * delta_j[k], and waits at the
//      cluster barrier. Every element of Q gets the same updates in the
//      same j order as in the plain version.
// The owner of row R + 1 writes slot (R + 1) & 1 only after the cluster
// barrier of row R - 1, which every block passes after it has read delta
// R - 1 from that slot. The stop rule's maxima are reduced over the cluster
// (each block over its rows, then every block over the K partials in the
// same way), so every block takes the same decision; maxima do not depend
// on the order. Two variants of one template:
//   kSmem = true: the block's slices of G's columns (c x rows), C and B
//     (rows x n) sit in shared memory and Q's rows in registers, at most
//     kRegRows a thread (n <= 1024); B is copied out at the end.
//   kSmem = false: G, C and B stay in device memory, and Q too but for
//     its first q_rows rows a block, which fill the rest of the shared
//     memory; the K blocks update their parts of Q in parallel (the res5
//     shapes, whose Q outgrows any cluster's registers and shared memory).
// Keeping a residual E = X·B instead of Q (fewer rows than channels) or
// wgmma on blocks of rows are for a later redesign: both change rounding.
//
// `stats`, when not null, receives for each alpha the sweeps run and the
// number of row updates with a nonzero delta (int32 pairs), from which the
// work these inputs need is counted.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxK = 16;            // 8 is portable; 16 is not
constexpr int kMaxN = 19328;         // three rows in shared memory
constexpr int kRegRows = 12;         // kSmem: Q's rows a thread holds
constexpr int kStaticBudget = 512;   // bytes of static shared memory at most

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

// The cluster barrier, relaxed: it orders nothing in memory and only says
// that every thread of the cluster has passed its arrive
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// A real instruction that reads x: a later instruction issues only once x
// has arrived (its load has been performed)
__device__ __forceinline__ void consume(float x) {
  asm volatile("{\n.reg .b32 sink;\nmov.b32 sink, %0;\n}\n" :: "f"(x));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The address of this block's shared location `local` in block `rank`
__device__ __forceinline__ uint32_t remote(uint32_t local, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out) : "r"(local), "r"(rank));
  return out;
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

// One arrival on `bar` that also expects `bytes` of stores to complete
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" :: "r"(bar), "r"(parity) : "memory");
}

// Stores v at the shared address `dst` of a block of the cluster and counts
// its 4 bytes on that block's mbarrier `bar`
__device__ __forceinline__ void push(uint32_t dst, float v, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];\n"
      :: "r"(dst), "r"(__float_as_uint(v)), "r"(bar) : "memory");
}

template <bool kSmem>
__global__ void __launch_bounds__(kThreads, 1)
group_cd_grid_kernel(const float* __restrict__ G, const float* __restrict__ C,
                     const float* __restrict__ alphas_n,
                     float* __restrict__ B_all, float* __restrict__ Q_all,
                     int* __restrict__ stats, int c, int n, int n_sweeps,
                     float tol, int q_rows) {
  // dynamic: the delta slots (2n, written by the rows' owners), the row
  // being solved (n), then kSmem's slices of G (c x rows), C and B, or
  // Q's first q_rows rows
  extern __shared__ float smem[];
  __shared__ alignas(8) uint64_t s_full[2];  // slot s holds a whole delta
  __shared__ float s_red[kWarps];
  __shared__ float s_out;
  __shared__ float s_sweep[2];          // this block's max|delta|, max|B|
  __shared__ int s_moves;

  cg::cluster_group cluster = cg::this_cluster();
  const int K = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int alpha = blockIdx.x / K;
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  if (t == 0) {
    mbar_init(smem_u32(&s_full[0]), 1);
    mbar_init(smem_u32(&s_full[1]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    // the one arrival of each slot's first phase (rows 0 and 1)
    mbar_expect(smem_u32(&s_full[0]), 4u * n);
    mbar_expect(smem_u32(&s_full[1]), 4u * n);
  }
  __syncthreads();
  const int rows = (c - rank + K - 1) / K;  // global row rank + K il
  const size_t cn = (size_t)c * n, rn = (size_t)rows * n;
  const float alpha_n = alphas_n[alpha];
  float* slots = smem;
  float* row = smem + 2 * n;

  // Q's update: thread t takes columns k0 = t % n, k0 + 1024, ... of the
  // rows rb .. rb + E - 1 (rb = (t / n) E); 1024 / n threads share a
  // column when n < 1024 (the rest idle). A thread keeps the delta of its
  // first two columns in registers, so for n <= 2048 it reads its slot
  // once and arrives at the row's cluster barrier before it updates Q
  // ("early"); for wider rows it arrives after.
  const int rows_step = n < kThreads ? kThreads / n : 1;
  const bool updates = t < rows_step * n;
  const int k0 = t % n;
  const int E = (rows + rows_step - 1) / rows_step;
  const int rb = (t / n) * E;
  const int my_lo = rb, my_hi = min(rb + E, rows);
  const bool early = n <= 2 * kThreads;

  // the block's rows il: G's columns (g[j * g_stride + il * g_step] =
  // G[j, rank + K il]), C and B (row il at il * r_stride); Q in registers
  // (kSmem) or in device memory but for its first q_rows rows, which sit in
  // shared memory after `row`
  const float* g;
  const float* Cb;
  float* Bb;
  const size_t out_stride = (size_t)K * n;
  float* Qg = Q_all + alpha * cn + (size_t)rank * n;  // row il at il * K n
  float* Qs = row + n;                                // row il < q_rows
  q_rows = kSmem ? 0 : min(q_rows, rows);
  // Q's row il, k in shared or device memory (not kSmem)
  auto qat = [&](int il, int k) -> float* {
    return il < q_rows ? Qs + (size_t)il * n + k : Qg + il * out_stride + k;
  };
  size_t g_stride, g_step, r_stride;
  float* B_out = B_all + alpha * cn + (size_t)rank * n;
  float q[kSmem ? kRegRows : 1];  // kSmem: Q[rb + m, k0]
#pragma unroll
  for (int m = 0; m < (kSmem ? kRegRows : 1); ++m) q[m] = 0.0f;
  if constexpr (kSmem) {
    float* Gs = row + n;
    float* Cs = Gs + (size_t)c * rows;
    float* Bs = Cs + rn;
    for (size_t e = t; e < (size_t)c * rows; e += kThreads) {
      const size_t j = e / rows, il = e - j * rows;
      Gs[e] = G[j * c + rank + K * il];
    }
    for (size_t e = t; e < rn; e += kThreads) {
      const size_t il = e / n, k = e - il * n;
      Cs[e] = C[(rank + K * il) * n + k];
      Bs[e] = 0.0f;
    }
    g = Gs, g_stride = rows, g_step = 1, Cb = Cs, Bb = Bs, r_stride = n;
  } else {
    Bb = B_out;
    for (size_t e = t; e < rn; e += kThreads) {
      const size_t il = e / n, k = e - il * n;
      Bb[il * out_stride + k] = *qat(il, k) = 0.0f;
    }
    g = G + rank, g_stride = c, g_step = K, r_stride = out_stride;
    Cb = C + (size_t)rank * n;
  }

  // Q[il, k] += G[j, rank + K il] * d over the thread's rows il in
  // [lo, hi) but `skip` (kSmem: all of its rows but `skip`)
  const int my_rows = my_hi - my_lo;
  auto update = [&](const float* gj, int k, float d, int lo, int hi,
                    int skip) {
    if constexpr (kSmem) {
      const int ms = skip - rb;  // outside [0, my_rows) when not the thread's
#pragma unroll
      for (int m = 0; m < kRegRows; ++m)
        if (m < my_rows && m != ms)
          q[m] = __fadd_rn(q[m], __fmul_rn(gj[rb + m], d));  // g_step 1
    } else {
      // rows below q_rows from shared memory, the rest from device memory,
      // each in a loop of its own (no generic addresses)
      auto rows_of = [&](float* base, size_t stride, int from, int to) {
        constexpr int kU = 4;  // loads in flight a thread
        for (int il = from; il < to; il += kU) {
          float v[kU], gv[kU];
#pragma unroll
          for (int u = 0; u < kU; ++u) {
            const int i = il + u;
            if (i < to && i != skip) {
              v[u] = base[i * stride + k];
              gv[u] = gj[i * g_step];
            }
          }
#pragma unroll
          for (int u = 0; u < kU; ++u) {
            const int i = il + u;
            if (i < to && i != skip)
              base[i * stride + k] = __fadd_rn(v[u], __fmul_rn(gv[u], d));
          }
        }
      };
      rows_of(Qs, n, lo, min(hi, q_rows));
      rows_of(Qg, out_stride, max(lo, q_rows), hi);
    }
  };

  // Row j of the block's own rows, row number R: R_j, its norm, B_j' and
  // delta_j, pushed into slot R & 1 of every block of the cluster. A row's
  // squares are summed as block_reduce sums them (each warp then reduces
  // the 32 partials itself: one barrier fewer).
  float tmax_delta = 0.0f;
  int moves = 0;
  auto solve_row = [&](int j, int R) {
    const int jl = j / K;
    const uint32_t dst = smem_u32(slots + (R & 1) * n);
    const uint32_t bar = smem_u32(&s_full[R & 1]);
    const float dj = g[(size_t)j * g_stride + jl * g_step];
    const float sdj = dj > 0.0f ? dj : 1.0f;
    float* Bj = Bb + jl * r_stride;
    const float* Cj = Cb + jl * r_stride;
    const float* Qj = kSmem ? row : qat(jl, 0);
    float ss = 0.0f;
    for (int k = t; k < n; k += kThreads) {
      const float r = __fadd_rn(__fsub_rn(Cj[k], Qj[k]), __fmul_rn(dj, Bj[k]));
      row[k] = r;  // this thread's own k: read back below by it alone
      ss = __fadd_rn(ss, __fmul_rn(r, r));
    }
    ss = warp_sum(ss);
    if (lane == 0) s_red[warp] = ss;
    __syncthreads();
    ss = warp_sum(s_red[lane]);  // warp 0's sum in block_reduce, bit for bit
    const float norm = __fsqrt_rn(__fadd_rn(ss, 1e-30f));
    const float scale = __fdiv_rn(
        fmaxf(0.0f, __fsub_rn(1.0f, __fdiv_rn(alpha_n, norm))), sdj);
    int moved = 0;
    for (int k = t; k < n; k += kThreads) {
      const float b_new = dj > 0.0f ? __fmul_rn(scale, row[k]) : 0.0f;
      const float d = __fsub_rn(b_new, Bj[k]);
      Bj[k] = b_new;
      for (int r = 0; r < K; ++r)
        push(remote(dst + 4u * k, r), d, remote(bar, r));
      tmax_delta = fmaxf(tmax_delta, fabsf(d));
      moved |= d != 0.0f;
    }
    // off the critical path: the pushes are on their way
    moves += __syncthreads_or(moved) != 0 && t == 0;
  };
  auto owns = [&](int j) { return j % K == rank; };
  // kSmem: the owner's row jl of Q, from its holders' registers into `row`
  // for solve_row (after a block barrier), first updated with delta d of
  // row j (G[j, rank + K jl] = gj[jl]) where gj is not null
  auto stage = [&](int jl, const float* gj, float d) {
    if constexpr (kSmem) {
      if (updates && jl >= my_lo && jl < my_hi) {
#pragma unroll
        for (int m = 0; m < kRegRows; ++m)
          if (rb + m == jl) {
            if (gj != nullptr && d != 0.0f)
              q[m] = __fadd_rn(q[m], __fmul_rn(gj[jl], d));
            row[k0] = q[m];
          }
      }
    }
  };

  // every block has started (distributed shared memory and the mbarriers
  // are valid) and its slices are written
  cluster.sync();

  int it = 0;
  while (true) {
    tmax_delta = 0.0f;
    const int R0 = it * c;
    // slot R0 & 1 was last read at row R0 - 2, before the last barrier
    if (rank == 0) {
      stage(0, nullptr, 0.0f);
      __syncthreads();
      solve_row(0, R0);
    }
    for (int j = 0; j < c; ++j) {
      const int R = R0 + j, s = R & 1;
      // delta_j has arrived whole in this block's slot s
      mbar_wait(smem_u32(&s_full[s]), (R >> 1) & 1);
      if (t == 0) mbar_expect(smem_u32(&s_full[s]), 4u * n);  // row R + 2
      const float* dl = slots + s * n;
      const float* gj = g + (size_t)j * g_stride;  // G[j, rank + K il]
      float dv0 = 0.0f, dv1 = 0.0f;
      if (updates && early) {
        dv0 = dl[k0];
        if (k0 + kThreads < n) dv1 = dl[k0 + kThreads];
        consume(dv0);
        consume(dv1);
      }
      // this block is done with slot s (n <= 2048): the owner of row R + 2
      // writes it only once every block has arrived
      if (early) cluster_arrive_relaxed();
      auto update_all = [&](int lo, int hi, int skip) {
        if (!updates) return;
        for (int k = k0, m = 0; k < n; k += kThreads, ++m) {
          const float d = m == 0 && early ? dv0 : m == 1 && early ? dv1 : dl[k];
          if (d != 0.0f)  // Q + G·0 == Q: a column that did not move
            update(gj, k, d, lo, hi, skip);
        }
      };
      // the next row's owner first brings that row up to date, solves it
      // and pushes its delta, then updates its other rows
      const int next = j + 1;
      int skip = -1;
      if (next < c && owns(next)) {
        skip = next / K;
        if constexpr (kSmem)
          stage(skip, gj, dv0);
        else
          update_all(max(my_lo, skip), min(my_hi, skip + 1), -1);
        __syncthreads();
        solve_row(next, R + 1);
      }
      update_all(my_lo, my_hi, skip);
      if (!early) cluster_arrive_relaxed();
      // every block is done with slot s's row R before the owner of row
      // R + 2 pushes into it
      cluster_wait();
    }
    ++it;
    __syncthreads();  // B's rows, written by their owners' threads
    float tmax_b = 0.0f;
    for (size_t e = t; e < rn; e += kThreads) {
      const size_t il = e / n, k = e - il * n;
      tmax_b = fmaxf(tmax_b, fabsf(Bb[il * r_stride + k]));
    }
    const float md = block_reduce<true>(tmax_delta, s_red, &s_out);
    const float mb = block_reduce<true>(tmax_b, s_red, &s_out);
    if (t == 0) s_sweep[0] = md, s_sweep[1] = mb;
    // s_sweep is written again only after the next sweep's row barriers,
    // which every block reaches after it has read it here
    cluster.sync();
    float max_delta = 0.0f, max_b = 0.0f;
    for (int r = 0; r < K; ++r) {
      const float* v = cluster.map_shared_rank(s_sweep, r);
      max_delta = fmaxf(max_delta, v[0]);
      max_b = fmaxf(max_b, v[1]);
    }
    const float scale = fmaxf(max_b, 1e-12f);
    if (!(it < n_sweeps && max_delta > __fmul_rn(tol, scale))) break;
  }
  if constexpr (kSmem) {
    for (size_t e = t; e < rn; e += kThreads) {
      const size_t il = e / n, k = e - il * n;
      B_out[il * out_stride + k] = Bb[e];
    }
  }
  if (t == 0) s_moves = moves;
  cluster.sync();
  if (rank == 0 && t == 0 && stats != nullptr) {
    int total = 0;
    for (int r = 0; r < K; ++r) total += *cluster.map_shared_rank(&s_moves, r);
    stats[2 * alpha] = it;
    stats[2 * alpha + 1] = total;
  }
  // no block leaves while rank 0 reads its shared memory
  cluster.sync();
}

// The launch configuration of one variant: K blocks a cluster, n_clusters
// clusters, `smem` bytes of dynamic shared memory a block.
struct Launch {
  cudaLaunchConfig_t config;
  cudaLaunchAttribute attr;
};

template <bool kSmem>
cudaError_t prepare(int k, int n_clusters, int smem, cudaStream_t stream,
                    Launch* out) {
  auto kernel = group_cd_grid_kernel<kSmem>;
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, kernel);
  if (err != cudaSuccess) return err;
  if (fa.sharedSizeBytes > static_cast<size_t>(kStaticBudget))
    return cudaErrorInvalidConfiguration;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  if (k > 8) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  out->attr.id = cudaLaunchAttributeClusterDimension;
  out->attr.val.clusterDim.x = k;
  out->attr.val.clusterDim.y = 1;
  out->attr.val.clusterDim.z = 1;
  out->config = cudaLaunchConfig_t{};
  out->config.gridDim = dim3(k * n_clusters);
  out->config.blockDim = dim3(kThreads);
  out->config.dynamicSmemBytes = smem;
  out->config.stream = stream;
  out->config.attrs = &out->attr;
  out->config.numAttrs = 1;
  return cudaSuccess;
}

// The dynamic shared memory a variant needs for blocks of `rows` rows, or
// 0 where the variant cannot take them (kSmem = false: without Q's rows).
size_t smem_needed(bool in_smem, int c, int n, int rows) {
  size_t floats = 3 * (size_t)n;
  if (in_smem) {
    const int rows_step = n < kThreads ? kThreads / n : 1;
    if (n > kThreads || (rows + rows_step - 1) / rows_step > kRegRows)
      return 0;
    floats += (size_t)rows * ((size_t)c + 2 * (size_t)n);
  }
  return sizeof(float) * floats;
}

}  // namespace

extern "C" {

// K3: a cluster of k blocks of 1024 threads per alpha on `stream`, for
// c >= 1, 1 <= n <= kMaxN and k <= c; block r owns rows r, r + k, ...
// `variant`
// 1 keeps the blocks' slices in shared memory and Q in registers, 0 all in
// device memory; `smem` is the dynamic shared memory a block gets (the
// plan's; variant 0 keeps as many of a block's rows of Q there as it
// holds). B (the result) holds n_alpha·c·n floats; Q (scratch, variant 0
// only, else may be null) as many; the kernel zeroes both. `stats` is null
// or holds 2·n_alpha ints. Returns the launch's error code (0 on success);
// the caller checks it.
int cp_group_cd_grid(const float* G, const float* C, const float* alphas_n,
                     float* B, float* Q, int* stats, int c, int n,
                     int n_alpha, int n_sweeps, float tol, int variant,
                     int k, int smem, void* stream) {
  if (c < 1 || n < 1 || n > kMaxN || n_alpha < 1 || k < 1 || k > kMaxK ||
      k > c || (variant != 0 && variant != 1) || (variant == 0 && !Q))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t need = smem_needed(variant, c, n, (c + k - 1) / k);
  if (need == 0 || smem < 0 || static_cast<size_t>(smem) < need)
    return static_cast<int>(cudaErrorInvalidValue);
  const int q_rows =
      variant ? 0 : static_cast<int>((smem / sizeof(float) - 3 * (size_t)n) / n);
  Launch l;
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err = variant ? prepare<true>(k, n_alpha, smem, s, &l)
                            : prepare<false>(k, n_alpha, smem, s, &l);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = variant ? cudaLaunchKernelEx(&l.config, group_cd_grid_kernel<true>, G,
                                     C, alphas_n, B, Q, stats, c, n, n_sweeps,
                                     tol, q_rows)
                : cudaLaunchKernelEx(&l.config, group_cd_grid_kernel<false>,
                                     G, C, alphas_n, B, Q, stats, c, n,
                                     n_sweeps, tol, q_rows);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// How many clusters of k blocks of a variant, with `smem` bytes of dynamic
// shared memory each, the current device holds at once
// (cudaOccupancyMaxActiveClusters), into *out. Returns an error code.
int cp_group_cd_max_active_clusters(int variant, int k, int smem, int* out) {
  if (k < 1 || k > kMaxK || (variant != 0 && variant != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  Launch l;
  cudaError_t err = variant ? prepare<true>(k, 1, smem, nullptr, &l)
                            : prepare<false>(k, 1, smem, nullptr, &l);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = variant ? cudaOccupancyMaxActiveClusters(
                      out, group_cd_grid_kernel<true>, &l.config)
                : cudaOccupancyMaxActiveClusters(
                      out, group_cd_grid_kernel<false>, &l.config);
  return static_cast<int>(err);
}

const char* cp_group_cd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

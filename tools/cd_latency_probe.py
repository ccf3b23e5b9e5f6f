#!/usr/bin/env python3
"""Latency probe of the steps the LASSO CD kernels (channel_pruning_tpu_torch/
csrc/lasso_cd.cu) chain per coordinate, on one NVIDIA card:

    python3 tools/cd_latency_probe.py [--sass DIR]

One warp times, with clock64, dependent chains of: the candidate step
(the first kernels' operations, their division included), the division alone,
ballot + ffs + shuffle, a shared-memory load, a global (L2) load, a full
window step (candidate, ballot, shuffle, the staged-block update), a TMA row
copy from issue to arrival, the issue of one TMA copy, and a row update of q
held in registers against one held in shared memory (read-modify-write);
then the candidate step as K1/K2 now compute it (the division an f64
product with the diagonal's reciprocal), that product alone, the first
candidate with every numerator 0, and the window step with the new
candidate, its first mover found by ballot + ffs or by redux.min; last the
split kernels' chain step: that window step with the move published into
the shared-memory queue (one tagged 64-bit store, the queue's fill read
every 32 moves), alone and with a named barrier's or an mbarrier's arrive.
Prints cycles per step at c = 512 and c = 2048, and the card's clock;
`--sass DIR` also writes the probe's SASS there (cuobjdump).
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

SOURCE = r'''
#include <cuda_runtime.h>
#include <cstdint>

__device__ __forceinline__ float candidate(float bk, float qk, float dk,
                                           float sdk, float beta, float a) {
  const float cj = __fadd_rn(__fsub_rn(bk, qk), __fmul_rn(dk, beta));
  const float sgn = (cj > 0.0f) ? 1.0f : ((cj < 0.0f) ? -1.0f : 0.0f);
  const float mag = fmaxf(__fsub_rn(fabsf(cj), a), 0.0f);
  const float bj = __fdiv_rn(__fmul_rn(sgn, mag), sdk);
  return dk > 0.0f ? bj : 0.0f;
}
// the candidate as K1/K2 compute it since the division became an f64
// product with the diagonal's reciprocal (rinv = 1/d in f64, 1 where d <= 0)
__device__ __forceinline__ float candidate_rcp(float bk, float qk, float dk,
                                               double rinv, float beta,
                                               float a) {
  const float cj = __fadd_rn(__fsub_rn(bk, qk), __fmul_rn(dk, beta));
  const float mag = fmaxf(__fsub_rn(fabsf(cj), a), 0.0f);
  const bool live = dk > 0.0f;
  const float num = (live && cj < 0.0f) ? -mag
                                        : ((live && cj > 0.0f) ? mag : 0.0f);
  return __double2float_rn(__dmul_rn(static_cast<double>(num), rinv));
}
__device__ __forceinline__ unsigned saddr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void tma(bool issue, void* dst, const void* src,
                                    unsigned bytes, uint64_t* bar) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %0, 0;\n"
      "@p mbarrier.arrive.expect_tx.shared::cta.b64 _, [%4], %3;\n"
      "@p cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%1], [%2], %3, [%4];\n}\n"
      :: "r"((int)issue), "r"(saddr(dst)), "l"(src), "r"(bytes),
         "r"(saddr(bar)) : "memory");
}
__device__ __forceinline__ void mwait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  do {
    asm volatile("{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(saddr(bar)), "r"(parity) : "memory");
  } while (!done);
}

// out: cycles per step of each chain; G holds 512 rows of c floats
__global__ void probe(const float* __restrict__ G, float* sink,
                      long long* out, int n, int c) {
  extern __shared__ __align__(128) float sm[];
  __shared__ uint64_t bar[8];
  float* blk = sm;                // 1024
  float* qs = sm + 1024;          // c
  float* ring = qs + c;           // 8 rows of c
  const int lane = threadIdx.x;
  for (int k = lane; k < 1024 + 9 * c; k += 32) sm[k] = 0.0f;
  for (int k = lane; k < 1024; k += 32) blk[k] = G[k];
  if (lane == 0) {
    for (int k = 0; k < 8; ++k)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                   :: "r"(saddr(bar + k)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncwarp();
  float q = G[lane], beta = 0.5f * G[lane + 32], bk = G[lane + 64];
  const float dk = 1.0f + fabsf(G[lane + 96]);
  long long t0, t1;
  t0 = clock64();
  for (int it = 0; it < n; ++it)
    q = __fadd_rn(q, __fmul_rn(candidate(bk, q, dk, dk, beta, 0.1f), 1e-30f));
  t1 = clock64(); out[0] = (t1 - t0) / n;
  float x = q + 1.0f;
  t0 = clock64();
  for (int it = 0; it < n; ++it) x = __fdiv_rn(x, dk) + 1.0f;
  t1 = clock64(); out[1] = (t1 - t0) / n;
  float v = q;
  t0 = clock64();
  for (int it = 0; it < n; ++it) {
    const unsigned m = __ballot_sync(0xffffffffu, v != 0.0f) | 1u;
    v = __shfl_sync(0xffffffffu, v, __ffs(m) - 1) + 1.0f;
  }
  t1 = clock64(); out[2] = (t1 - t0) / n;
  int idx = lane;
  t0 = clock64();
  for (int it = 0; it < n; ++it) idx = (int)blk[idx] & 1023;
  t1 = clock64(); out[3] = (t1 - t0) / n;
  int j = lane;
  t0 = clock64();
  for (int it = 0; it < n; ++it)
    j = ((int)G[(size_t)(j & 511) * c + lane] & 1) + (j + 97) % 512;
  t1 = clock64(); out[4] = (t1 - t0) / n;
  t0 = clock64();
  for (int it = 0; it < n; ++it) {
    const float bj = candidate(bk, q, dk, dk, beta, 0.1f);
    const float delta = __fsub_rn(bj, beta);
    const unsigned m = __ballot_sync(0xffffffffu, delta != 0.0f) | 1u;
    const int f = __ffs(m) - 1;
    const float d = __shfl_sync(0xffffffffu, delta, f);
    q = __fadd_rn(q, __fmul_rn(blk[f * 32 + lane], __fmul_rn(d, 1e-30f)));
  }
  t1 = clock64(); out[5] = (t1 - t0) / n;
  unsigned par = 0;
  t0 = clock64();
  for (int it = 0; it < n; ++it) {
    __syncwarp();
    tma(lane == 0, ring, G + (size_t)(it % 512) * c, 4u * c, bar);
    mwait(bar, par);
    par ^= 1;
  }
  t1 = clock64(); out[6] = (t1 - t0) / n;
  long long issue = 0;
  for (int it = 0; it < n / 8; ++it) {
    t0 = clock64();
    for (int s = 0; s < 8; ++s) {
      __syncwarp();
      tma(lane == 0, ring + s * c, G + (size_t)((8 * it + s) % 512) * c,
          4u * c, bar + s);
    }
    issue += clock64() - t0;
    for (int s = 0; s < 8; ++s) mwait(bar + s, par);
    par ^= 1;
  }
  out[7] = issue / (8 * (n / 8));
  float qr[16];
  for (int t = 0; t < 16; ++t) qr[t] = 0.0f;
  const float d = q * 1e-30f;
  t0 = clock64();
  for (int it = 0; it < n; ++it) {
    const float* row = ring + (it & 7) * c;
#pragma unroll
    for (int t = 0; t < 16; ++t)
      qr[t] = __fadd_rn(qr[t], __fmul_rn(row[32 * t + lane], d));
  }
  t1 = clock64(); out[8] = (t1 - t0) / (16 * n);
  t0 = clock64();
  for (int it = 0; it < n; ++it) {
    const float* row = ring + (it & 7) * c;
#pragma unroll 8
    for (int k = lane; k < c; k += 32)
      qs[k] = __fadd_rn(qs[k], __fmul_rn(row[k], d));
  }
  t1 = clock64(); out[9] = (t1 - t0) / (n * (c / 32));
  const double rinv = 1.0 / static_cast<double>(dk);
  float qn = q;
  t0 = clock64();
  for (int it = 0; it < n; ++it)
    qn = __fadd_rn(qn, __fmul_rn(candidate_rcp(bk, qn, dk, rinv, beta, 0.1f),
                                 1e-30f));
  t1 = clock64(); out[10] = (t1 - t0) / n;
  float y = q + 1.0f;
  t0 = clock64();
  for (int it = 0; it < n; ++it)
    y = __double2float_rn(__dmul_rn(static_cast<double>(y), rinv)) + 1.0f;
  t1 = clock64(); out[11] = (t1 - t0) / n;
  float qz = q;
  t0 = clock64();
  for (int it = 0; it < n; ++it)  // every numerator 0 (|c| below alpha)
    qz = __fadd_rn(qz, __fmul_rn(candidate(bk, qz, dk, dk, beta, 1e30f),
                                 1e-30f));
  t1 = clock64(); out[12] = (t1 - t0) / n;
  float qw = q;
  t0 = clock64();
  for (int it = 0; it < n; ++it) {
    const float bj = candidate_rcp(bk, qw, dk, rinv, beta, 0.1f);
    const float delta = __fsub_rn(bj, beta);
    const unsigned m = __ballot_sync(0xffffffffu, delta != 0.0f) | 1u;
    const int f = __ffs(m) - 1;
    const float d = __shfl_sync(0xffffffffu, delta, f);
    qw = __fadd_rn(qw, __fmul_rn(blk[f * 32 + lane], __fmul_rn(d, 1e-30f)));
  }
  t1 = clock64(); out[13] = (t1 - t0) / n;
  float qr2 = q;
  t0 = clock64();
  for (int it = 0; it < n; ++it) {
    const float bj = candidate_rcp(bk, qr2, dk, rinv, beta, 0.1f);
    const float delta = __fsub_rn(bj, beta);
    const int f = min(__reduce_min_sync(0xffffffffu,
                                        delta != 0.0f ? lane : 32), 31);
    const float d = __shfl_sync(0xffffffffu, delta, f);
    qr2 = __fadd_rn(qr2, __fmul_rn(blk[f * 32 + lane], __fmul_rn(d, 1e-30f)));
  }
  t1 = clock64(); out[14] = (t1 - t0) / n;
  // the split kernels' chain warp: the window step, then the move published
  // into the shared-memory queue (lane 0's one tagged 64-bit store), the
  // queue's fill read back every 32 moves; alone, then with a named
  // barrier's arrive or an mbarrier's arrive after the store
  unsigned long long* slots = reinterpret_cast<unsigned long long*>(ring);
  volatile int* done = reinterpret_cast<volatile int*>(ring + 256);
  done[lane] = 0x3fffffff;
  __syncwarp();
  float qp[3] = {q, q, q};
#pragma unroll
  for (int var = 0; var < 3; ++var) {
    int lim = 0;
    t0 = clock64();
    for (int it = 0; it < n; ++it) {
      const float bj = candidate_rcp(bk, qp[var], dk, rinv, beta, 0.1f);
      const float delta = __fsub_rn(bj, beta);
      const unsigned m = __ballot_sync(0xffffffffu, delta != 0.0f) | 1u;
      const int f = __ffs(m) - 1;
      const float d = __shfl_sync(0xffffffffu, delta, f);
      qp[var] = __fadd_rn(qp[var],
                          __fmul_rn(blk[f * 32 + lane], __fmul_rn(d, 1e-30f)));
      if (it >= lim)
        lim = min(__reduce_min_sync(0xffffffffu, done[lane]), it) + 32;
      const unsigned long long e =
          (static_cast<unsigned long long>(__float_as_uint(d)) << 32) |
          (static_cast<unsigned>(it & 0x3ffff) << 14) | static_cast<unsigned>(f);
      if (lane == 0)
        asm volatile("st.volatile.shared.u64 [%0], %1;\n" ::"r"(
                         saddr(slots + (it & 63))), "l"(e) : "memory");
      if (var == 1) asm volatile("bar.arrive 1, 32;\n" ::: "memory");
      if (var == 2 && lane == 0)
        asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
                     :: "r"(saddr(bar + 7)) : "memory");
    }
    t1 = clock64(); out[15 + var] = (t1 - t0) / n;
  }
  float acc = 0.0f;
  for (int t = 0; t < 16; ++t) acc += qr[t];
  sink[lane] = q + x + v + idx + j + acc + qs[lane] + qn + y + qz + qw + qr2 +
               qp[0] + qp[1] + qp[2];
}

extern "C" int run(const float* G, float* sink, long long* out, int n,
                   int c) {
  const int smem = (int)sizeof(float) * (1024 + 9 * c);
  cudaFuncSetAttribute(probe, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem);
  probe<<<1, 32, smem>>>(G, sink, out, n, c);
  return (int)cudaGetLastError();
}
'''

NAMES = ["candidate step", "division", "ballot+ffs+shfl", "shared load",
         "global (L2) load", "window step", "TMA row copy, issue to arrival",
         "TMA issue", "row update, q in registers (a column)",
         "row update, q in shared memory (a column)",
         "candidate step, f64 reciprocal", "f64 reciprocal product alone",
         "candidate step, numerator 0", "window step, f64 reciprocal",
         "window step, f64 reciprocal, redux.min first mover",
         "chain step + queue publish (tagged 64-bit store)",
         "chain step + queue publish + bar.arrive",
         "chain step + queue publish + mbarrier.arrive"]


def dump_sass(so: Path, dst: Path) -> None:
    """cuobjdump's SASS of a built library into `dst`."""
    r = subprocess.run(["/usr/local/cuda/bin/cuobjdump", "-sass", str(so)],
                       capture_output=True, text=True)
    dst.write_text(r.stdout + r.stderr)
    print(f"[sass] {so.name} -> {dst} ({len(r.stdout.splitlines())} lines)")


def main() -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sass", type=Path, default=None,
                    help="write the SASS of the probe and of K1/K2 here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("cd_latency_probe: needs an NVIDIA card", file=sys.stderr)
        return 2
    build = Path(__file__).resolve().parents[1] / "channel_pruning_tpu_torch" / "_build"
    build.mkdir(parents=True, exist_ok=True)
    src, so = build / "cd_latency_probe.cu", build / "cd_latency_probe.so"
    src.write_text(SOURCE)
    subprocess.run(["/usr/local/cuda/bin/nvcc", "-gencode",
                    "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                    "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-o",
                    str(so), str(src)], check=True)
    if args.sass is not None:
        sys.path.insert(0, str(build.parents[1]))
        from channel_pruning_tpu_torch.kernels import lasso_cd

        args.sass.mkdir(parents=True, exist_ok=True)
        lasso_cd.build()
        dump_sass(so, args.sass / "cd_latency_probe.sass")
        dump_sass(lasso_cd._so_path(), args.sass / "lasso_cd.sass")
        (args.sass / "lasso_cd.ptxas.txt").write_text(lasso_cd.ptxas_report())
    lib = ctypes.CDLL(str(so))
    lib.run.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    for c in (512, 2048):
        G = torch.randn(512 * c, device="cuda")
        sink = torch.zeros(32, device="cuda")
        out = torch.zeros(len(NAMES), dtype=torch.int64, device="cuda")
        rc = lib.run(G.data_ptr(), sink.data_ptr(), out.data_ptr(), 4000, c)
        torch.cuda.synchronize()
        if rc != 0:
            raise RuntimeError(f"launch failed ({rc})")
        for name, cyc in zip(NAMES, out.cpu().tolist()):
            print(f"[latency] c={c} {name}: {cyc} cycles")
    return 0


if __name__ == "__main__":
    sys.exit(main())

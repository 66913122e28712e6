"""Where a round of the ``auction_fused`` kernels goes, on one GPU.

    python3 tools/fused_round_profile.py

Copies ``src/repro_torch/csrc``, puts ``clock64`` reads into the cluster
kernel and the one-block kernel of the copy (text substitutions, as
``kernel_variants.py`` makes its variants), builds it under ``build/``, and
prints, for lane 0:

- the cluster kernel at 8 and 16 CTAs, on the permutations bucket's first
  matcher call at (4, 512) (permutations + M-bonus, P = 16), CTA 0: the mean
  cycles a round spends from its start until the CTA's last warp has posted
  its bids (the bid path), in the cluster barrier (which waits for the
  slowest CTA's bids too), in the inbox scan and in the resolve, with the
  cycles of one bid (the warp's top two and its stores to every CTA);
- the one-block kernel at (4, 512) and on bench/matching's weights at
  (1, 256), (1, 512) and (1, 1024): thread 0's cycles a round up to the
  first barrier's exit and from there to the second's, and a bid's cycles
  from its list entry to the bid, in the bid, and in its atomicMax (sums
  kept in registers and written once, so the probes add no memory traffic
  to a round; the atomicMax is waited for here, not in the kernel).

It checks the copy still equals the plain version bit for bit. It needs a
CUDA device and ``nvcc``.
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from repro_torch.kernels import backend  # noqa: E402

# (anchor in the cluster kernel, text put in its place)
PROBES = [
    ("namespace cg = cooperative_groups;\n",
     "namespace cg = cooperative_groups;\n__device__ unsigned long long g_prof[8];\n"),
    ("  const float* Wrows = W + (b * n + lo) * n;",
     "  __shared__ unsigned long long s_bid;\n  const float* Wrows = W + (b * n + lo) * n;"),
    ("    while (it < max_iters && *unassigned > 0) {\n      uint2* box = inbox + parity * n;",
     "    while (it < max_iters && *unassigned > 0) {\n      const long long ta = clock64();\n"
     "      if (tid == 0) s_bid = 0;\n      __syncthreads();\n      uint2* box = inbox + parity * n;"),
    ("        const float* line = Ws + static_cast<long long>(i) * n;\n",
     "        const float* line = Ws + static_cast<long long>(i) * n;\n        const long long tq = clock64();\n"),
    ("        if (lane == 0) ++my_bids;\n      }\n      cluster_barrier();",
     "        if (lane == 0) ++my_bids;\n"
     "        if (lane == 0 && rank == 0 && b == 0) {\n"
     "          atomicAdd(&g_prof[6], static_cast<unsigned long long>(clock64() - tq));\n"
     "          atomicAdd(&g_prof[7], 1ull);\n        }\n      }\n"
     "      if (lane == 0) atomicMax(&s_bid, static_cast<unsigned long long>(clock64() - ta));\n"
     "      __syncthreads();\n      const long long tb = clock64();\n      cluster_barrier();\n"
     "      const long long tc = clock64();"),
    ("        atomicMax(&key[m.y - 1u], pack(__uint_as_float(m.x), i));\n      }\n      __syncthreads();",
     "        atomicMax(&key[m.y - 1u], pack(__uint_as_float(m.x), i));\n      }\n      __syncthreads();\n"
     "      const long long td = clock64();"),
    ("      __syncthreads();\n      parity ^= 1;",
     "      __syncthreads();\n      const long long te = clock64();\n"
     "      if (rank == 0 && tid == 0 && b == 0) {\n        g_prof[0] += s_bid;\n        g_prof[1] += tc - tb;\n"
     "        g_prof[2] += td - tc;\n        g_prof[3] += te - td;\n        g_prof[4] += te - ta;\n"
     "        g_prof[5] += 1;\n      }\n      parity ^= 1;"),
]
# The same for the one-block kernel, into g_block, with each thread's sums
# kept in registers and written once at the end (so the probes add no memory
# traffic to a round): thread 0's cycles from a round's start to the exit of
# its first barrier (the bids) and from there to the exit of the second (the
# resolve), its rounds; and, summed over the bidding warps' lane 0, the
# cycles from a bidder's list entry to its row's bid (with its next-list
# slot taken), the bid itself (loads, top twos, the warp's reduction), the
# atomicMax (waited for here, not in the kernel), and the bids.
BLOCK_PROBES = [
    ("namespace cg = cooperative_groups;\n",
     "namespace cg = cooperative_groups;\n__device__ unsigned long long g_block[8];\n"),
    ("  int total_rounds = 0;\n  unsigned long long my_bids = 0;\n\n  for (int p = 0; p < P; ++p) {\n"
     "    const float e = eps[b * P + p];\n    for (int j = tid; j < n; j += nth) {\n      r2c[j] = -1;\n"
     "      c2r[j] = -1;\n      lists[j] = j;",
     "  int total_rounds = 0;\n  unsigned long long my_bids = 0;\n"
     "  long long q_bids = 0, q_resolve = 0, q_rounds = 0, q_pre = 0, q_bid = 0, q_atom = 0, q_n = 0;\n\n"
     "  for (int p = 0; p < P; ++p) {\n"
     "    const float e = eps[b * P + p];\n    for (int j = tid; j < n; j += nth) {\n      r2c[j] = -1;\n"
     "      c2r[j] = -1;\n      lists[j] = j;"),
    ("      const int cur = it & 1, nxt = cur ^ 1;\n",
     "      const long long ta = clock64();\n      const int cur = it & 1, nxt = cur ^ 1;\n"),
    ("        const int i = list[t];\n        if (r2c[i] >= 0) continue;  // same value across the warp\n",
     "        const long long t0 = clock64();\n"
     "        const int i = list[t];\n        if (r2c[i] >= 0) continue;  // same value across the warp\n"),
    ("        int j1;\n"
     "        const float d = warp_bid<kVec, true>(Wb + static_cast<long long>(i) * n, prices, n, lane, e, j1);\n"
     "        if (lane == 0) {\n          atomicMax(&key[j1], pack(d, i));\n          next[at] = i;\n"
     "          ++my_bids;\n        }\n",
     "        int j1;\n        const long long t1 = clock64();\n"
     "        const float d = warp_bid<kVec, true>(Wb + static_cast<long long>(i) * n, prices, n, lane, e, j1);\n"
     "        const unsigned long long packed = pack(d, i);\n        asm volatile(\"\" ::\"l\"(packed) : \"memory\");\n"
     "        const long long t2 = clock64();\n"
     "        if (lane == 0) {\n          const unsigned long long was = atomicMax(&key[j1], packed);\n"
     "          asm volatile(\"\" ::\"l\"(was) : \"memory\");\n          next[at] = i;\n          ++my_bids;\n        }\n"
     "        __syncwarp();\n        const long long t3 = clock64();\n"
     "        q_pre += t1 - t0;\n        q_bid += t2 - t1;\n        q_atom += t3 - t2;\n        ++q_n;\n"),
    ("      }\n      __syncthreads();\n      // 2-3. Each column takes its best bid. A kicked",
     "      }\n      __syncthreads();\n      const long long tb = clock64();\n"
     "      // 2-3. Each column takes its best bid. A kicked"),
    ("        prices[j] = prices[j] + best;\n      }\n      __syncthreads();\n      ++it;",
     "        prices[j] = prices[j] + best;\n      }\n      __syncthreads();\n"
     "      q_bids += tb - ta;\n      q_resolve += clock64() - tb;\n      ++q_rounds;\n      ++it;"),
    ("  if (my_bids) atomicAdd(bid_total, my_bids);\n  for (int j = tid; j < n; j += nth) {\n    r2c_out[b * n + j] = r2c[j];",
     "  if (b == 0 && tid == 0) {\n    g_block[0] = q_bids;\n    g_block[1] = q_resolve;\n    g_block[2] = q_rounds;\n  }\n"
     "  if (b == 0 && lane == 0 && q_n) {\n    atomicAdd(&g_block[3], static_cast<unsigned long long>(q_pre));\n"
     "    atomicAdd(&g_block[4], static_cast<unsigned long long>(q_bid));\n"
     "    atomicAdd(&g_block[5], static_cast<unsigned long long>(q_atom));\n"
     "    atomicAdd(&g_block[6], static_cast<unsigned long long>(q_n));\n  }\n"
     "  if (my_bids) atomicAdd(bid_total, my_bids);\n  for (int j = tid; j < n; j += nth) {\n    r2c_out[b * n + j] = r2c[j];"),
]
READER = """
extern "C" int prof_read(void* host, int block) {
  return static_cast<int>(block ? cudaMemcpyFromSymbol(host, g_block, sizeof(g_block))
                                : cudaMemcpyFromSymbol(host, g_prof, sizeof(g_prof)));
}
extern "C" int prof_reset() {
  unsigned long long zero[8] = {0};
  cudaMemcpyToSymbol(g_block, zero, sizeof(zero));
  return static_cast<int>(cudaMemcpyToSymbol(g_prof, zero, sizeof(zero)));
}
"""


def build() -> ctypes.CDLL:
    dst = ROOT / "build" / "round_profile" / "csrc"
    shutil.rmtree(dst.parent, ignore_errors=True)
    shutil.copytree(backend.CSRC_DIR, dst)
    src = dst / "auction_fused.cu"
    text = src.read_text()
    for anchor, probe in PROBES + BLOCK_PROBES:
        if text.count(anchor) != 1:
            raise SystemExit(f"probe anchor not found once: {anchor!r}")
        text = text.replace(anchor, probe)
    src.write_text(text + READER)
    backend.CSRC_DIR, backend.BUILD_DIR = dst, dst.parent / "lib"
    return backend.load_library()


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0])
    lib = build()
    from chip_smoke import bonus_weights
    from repro_torch.core.torchopt.matching import _eps_schedule, default_max_iters, default_num_phases
    from repro_torch.kernels.auction_fused import fused_auction, fused_auction_ref
    from repro_torch.traffic import permutations_workload

    B, n = 4, 512
    D = np.stack([permutations_workload(n=n, k=16, rng=np.random.default_rng(b)) for b in range(B)])
    W = bonus_weights(torch.from_numpy(D.astype(np.float32)).cuda())
    eps = _eps_schedule(W, default_num_phases(n)).contiguous()
    p0 = torch.zeros((B, n), device="cuda")
    mi = default_max_iters(n)
    want = fused_auction_ref(W, p0, eps, max_iters=mi)
    lib.prof_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    for cluster in (8, 16):
        buf = (ctypes.c_ulonglong * 8)()
        lib.prof_reset()
        got = fused_auction(W, p0, eps, max_iters=mi, kernel="cluster", cluster=cluster)
        torch.cuda.synchronize()
        lib.prof_read(buf, 0)
        exact = all(torch.equal(g, w) for g, w in zip(got, want))
        r = buf[5]
        print(f"cluster {cluster}: {r} rounds (lane 0), cycles a round: bid path {buf[0] / r:.0f}, cluster barrier "
              f"{buf[1] / r:.0f}, inbox scan {buf[2] / r:.0f}, resolve {buf[3] / r:.0f}, whole round {buf[4] / r:.0f}; "
              f"CTA 0 made {buf[7]} bids at {buf[6] / max(buf[7], 1):.0f} cycles a bid; exact {exact}")

    from repro_torch.bench.matching import bench_weights

    cases = [("permutations (4, 512)", W)]
    cases += [(f"bench (1, {m})", torch.from_numpy(bench_weights(m)).cuda()[None]) for m in (256, 512, 1024)]
    for name, Wc in cases:
        Bc, m, _ = Wc.shape
        eps_c = _eps_schedule(Wc, default_num_phases(m)).contiguous()
        p0_c = torch.zeros((Bc, m), device="cuda")
        want_c = fused_auction_ref(Wc, p0_c, eps_c, max_iters=default_max_iters(m))
        buf = (ctypes.c_ulonglong * 8)()
        lib.prof_reset()
        got = fused_auction(Wc, p0_c, eps_c, max_iters=default_max_iters(m), kernel="block")
        torch.cuda.synchronize()
        lib.prof_read(buf, 1)
        exact = all(torch.equal(g, w) for g, w in zip(got, want_c))
        r, k = buf[2], max(buf[6], 1)
        print(f"one block, {name}: {r} rounds (lane 0), thread 0's cycles a round: start to the first barrier's "
              f"exit {buf[0] / r:.0f}, then to the second's {buf[1] / r:.0f}; {buf[6]} bids, cycles a bid: list "
              f"entry to the bid {buf[3] / k:.0f}, the bid {buf[4] / k:.0f}, the atomicMax {buf[5] / k:.0f}; "
              f"exact {exact}")


if __name__ == "__main__":
    main()

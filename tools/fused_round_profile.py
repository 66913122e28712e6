"""Where a round of the cluster ``auction_fused`` kernel goes, on one GPU.

    python3 tools/fused_round_profile.py

Copies ``src/repro_torch/csrc``, puts ``clock64`` reads into the cluster
kernel of the copy (text substitutions, as ``kernel_variants.py`` makes its
variants), builds it under ``build/``, runs the permutations bucket's first
matcher call at (4, 512) (permutations + M-bonus, P = 16) at 8 and 16 CTAs,
and prints, for lane 0's CTA 0, the mean cycles a round spends: from the
round's start until the CTA's last warp has posted its bids (the bid path),
in the cluster barrier (which waits for the slowest CTA's bids too), in the
inbox scan and in the resolve, with the cycles of one bid (the warp's top
two and its stores to every CTA). It checks the copy still equals the plain
version bit for bit. It needs a CUDA device and ``nvcc``.
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
    ("  const int nwarps = nth >> 5;\n\n  const float* Wrows",
     "  const int nwarps = nth >> 5;\n  __shared__ unsigned long long s_bid;\n\n  const float* Wrows"),
    ("    while (it < max_iters && *unassigned > 0) {\n      uint2* box = inbox + parity * n;",
     "    while (it < max_iters && *unassigned > 0) {\n      const long long ta = clock64();\n"
     "      if (tid == 0) s_bid = 0;\n      __syncthreads();\n      uint2* box = inbox + parity * n;"),
    ("        const float d = warp_bid(Ws",
     "        const long long tq = clock64();\n        const float d = warp_bid(Ws"),
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
READER = """
extern "C" int prof_read(void* host) { return static_cast<int>(cudaMemcpyFromSymbol(host, g_prof, sizeof(g_prof))); }
extern "C" int prof_reset() {
  unsigned long long zero[8] = {0};
  return static_cast<int>(cudaMemcpyToSymbol(g_prof, zero, sizeof(zero)));
}
"""


def build() -> ctypes.CDLL:
    dst = ROOT / "build" / "round_profile" / "csrc"
    shutil.rmtree(dst.parent, ignore_errors=True)
    shutil.copytree(backend.CSRC_DIR, dst)
    src = dst / "auction_fused.cu"
    text = src.read_text()
    for anchor, probe in PROBES:
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
    for cluster in (8, 16):
        buf = (ctypes.c_ulonglong * 8)()
        lib.prof_reset()
        got = fused_auction(W, p0, eps, max_iters=mi, kernel="cluster", cluster=cluster)
        torch.cuda.synchronize()
        lib.prof_read(buf)
        exact = all(torch.equal(g, w) for g, w in zip(got, want))
        r = buf[5]
        print(f"cluster {cluster}: {r} rounds (lane 0), cycles a round: bid path {buf[0] / r:.0f}, cluster barrier "
              f"{buf[1] / r:.0f}, inbox scan {buf[2] / r:.0f}, resolve {buf[3] / r:.0f}, whole round {buf[4] / r:.0f}; "
              f"CTA 0 made {buf[7]} bids at {buf[6] / max(buf[7], 1):.0f} cycles a bid; exact {exact}")


if __name__ == "__main__":
    main()

"""PyTorch/CUDA port of the SPECTRA parallel-OCS scheduler.

The batched device solver (DECOMPOSE → LPT → EQUALIZE → §IV bound) in
PyTorch, with the auction's two hot kernels written by hand in CUDA for the
H100 (``csrc/``). It imports ``torch``, ``numpy`` and the standard library
only; the JAX package ``repro`` is its reference and is never imported.

Entry points run on CUDA unless the caller passes ``device="cpu"``; without
a GPU they raise. See ``repro_torch.api`` for ``solve`` / ``solve_many``.
"""

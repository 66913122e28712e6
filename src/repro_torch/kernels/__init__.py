"""Hand-written CUDA kernels of the port, each beside its plain PyTorch version.

    auction_bid     per-row top-2 of W − prices (csrc/auction_bid.cu)
    auction_fused   the whole ε-scaling auction (csrc/auction_fused.cu)
"""

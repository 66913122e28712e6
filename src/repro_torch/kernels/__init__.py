"""Hand-written CUDA kernels of the port, each beside its plain PyTorch version.

    auction_bid      per-row top-2 of W − prices (csrc/auction_bid.cu)
    auction_fused    the whole ε-scaling auction (csrc/auction_fused.cu)
    flash_attention  GQA online-softmax attention (csrc/flash_attention.cu)
    ssd_scan         the Mamba-2 SSD intra-chunk pass (csrc/ssd_chunk.cu)
    demand_accum     traffic events into a demand matrix (csrc/demand_accum.cu)
"""

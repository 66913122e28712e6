from .ops import fused_auction, polish_2swap
from .ref import fused_auction_ref, polish_2swap_ref

__all__ = ["fused_auction", "fused_auction_ref", "polish_2swap", "polish_2swap_ref"]

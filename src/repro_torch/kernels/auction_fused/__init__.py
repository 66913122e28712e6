from .ops import fused_auction
from .ref import fused_auction_ref

__all__ = ["fused_auction", "fused_auction_ref"]

from .ops import auction_rounds, masked_row_top2
from .ref import NEG, auction_rounds_ref, masked_row_top2_ref

__all__ = ["NEG", "auction_rounds", "auction_rounds_ref", "masked_row_top2", "masked_row_top2_ref"]

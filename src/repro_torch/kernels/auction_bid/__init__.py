from .ops import ROUNDS_MAX_N, auction_round_loop, auction_rounds, decompose_rounds, masked_row_top2
from .ref import NEG, auction_rounds_ref, decompose_round_loop, decompose_rounds_ref, masked_row_top2_ref

__all__ = ["NEG", "ROUNDS_MAX_N", "auction_round_loop", "auction_rounds", "auction_rounds_ref", "decompose_round_loop",
           "decompose_rounds", "decompose_rounds_ref", "masked_row_top2", "masked_row_top2_ref"]

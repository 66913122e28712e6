from .ops import masked_row_top2
from .ref import NEG, masked_row_top2_ref

__all__ = ["NEG", "masked_row_top2", "masked_row_top2_ref"]

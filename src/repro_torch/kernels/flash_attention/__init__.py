from .ops import flash_attention, mha
from .ref import NEG, mha_ref

__all__ = ["NEG", "flash_attention", "mha", "mha_ref"]

from .ops import ssd_chunk, ssd_chunked, ssd_decode_step, ssd_scan
from .ref import ssd_chunk_ref, ssd_decode_step_ref, ssd_ref

__all__ = ["ssd_chunk", "ssd_chunk_ref", "ssd_chunked", "ssd_decode_step", "ssd_decode_step_ref", "ssd_ref", "ssd_scan"]

from .pipeline import DataConfig, TokenStream, make_stream

__all__ = ["DataConfig", "TokenStream", "make_stream"]

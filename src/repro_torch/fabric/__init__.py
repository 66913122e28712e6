from .ocs import OCSFabric

__all__ = ["OCSFabric"]

from .ocs import OCSFabric
from .simulator import SimReport, simulate
from .timeline import CircuitWindow, Timeline, build_timeline

__all__ = ["CircuitWindow", "OCSFabric", "SimReport", "Timeline", "build_timeline", "simulate"]

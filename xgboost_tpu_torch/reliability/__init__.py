"""Reliability for the port: deterministic fault injection at named seams
(``faults.py``)."""
from . import faults
from .faults import FaultInjected, FaultPlan, FaultSpec

__all__ = ["faults", "FaultInjected", "FaultPlan", "FaultSpec"]

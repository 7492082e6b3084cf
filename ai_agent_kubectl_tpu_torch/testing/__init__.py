"""Fault-injection and chaos-testing utilities (importable in production:
``FAULT_POINTS`` wires them through the config for game-day drills)."""

from .faults import ChaosEngine, FaultInjector, InjectedFault

__all__ = ["ChaosEngine", "FaultInjector", "InjectedFault"]

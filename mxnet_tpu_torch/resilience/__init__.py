"""Fault injection and its counters (counterpart of the part of
``mxnet_tpu/resilience`` the serving stack needs: ``faults`` and
``counters``). Checkpointing, elastic training, guardrails and the
circuit breaker are not ported yet (ROADMAP A.3)."""
from __future__ import annotations

from . import counters, faults
from .faults import clear_plan, fault_point, get_plan, install_plan

__all__ = ["counters", "faults", "install_plan", "clear_plan", "get_plan",
           "fault_point"]

"""Fault injection, retries and failure containment (counterpart of the
part of ``mxnet_tpu/resilience`` the serving stack and the trainers need):
``faults`` (deterministic fault plans), ``counters`` (the ``resilience.*``
counters), ``retry`` (transient-or-fatal classification, backoff, the
execution watchdog and the circuit breaker), ``elastic`` (the
per-replica ``StragglerMonitor``) and ``guardrails`` (the overflow check
and global-norm clipping of ``gluon.Trainer``)."""
from __future__ import annotations

from . import counters, elastic, faults, guardrails, retry
from .faults import clear_plan, fault_point, get_plan, install_plan

__all__ = ["counters", "elastic", "faults", "guardrails", "retry",
           "install_plan", "clear_plan", "get_plan", "fault_point"]

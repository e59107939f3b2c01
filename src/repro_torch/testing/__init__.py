"""``repro_torch.testing`` — deterministic test instrumentation.

:mod:`repro_torch.testing.faults` is the fault-injection registry whose
named points the serving code hits (the continuous engine's ``serve.*``
points).  It imports only the standard library at import time and is a
no-op unless a fault plan is activated, so production modules import it
unconditionally.  (Not imported eagerly here: ``python -m
repro_torch.testing.faults`` would otherwise run the module twice under
runpy and split the plan's state across two module objects.)
"""
__all__ = ["faults"]

"""Fault injection and durable tenant state for the serving stack."""
from .fault import (BOUNDARIES, FaultInjector, FaultPlan, InjectedFault,
                    RetryPolicy, StepMonitor, with_retry)
from .durable import CheckpointWriter, DurableStore, restore_tenant

__all__ = ["BOUNDARIES", "FaultInjector", "FaultPlan", "InjectedFault",
           "RetryPolicy", "StepMonitor", "with_retry",
           "CheckpointWriter", "DurableStore", "restore_tenant"]

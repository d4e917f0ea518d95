"""Fault injection, durable tenant state and compressed reductions."""
from .fault import (BOUNDARIES, FaultInjector, FaultPlan, InjectedFault,
                    RetryPolicy, StepMonitor, with_retry)
from .durable import CheckpointWriter, DurableStore, restore_tenant
from .compression import (compressed_psum, dequantize_tree, exact_int8_psum,
                          quantize_tree)

__all__ = ["BOUNDARIES", "FaultInjector", "FaultPlan", "InjectedFault",
           "RetryPolicy", "StepMonitor", "with_retry",
           "CheckpointWriter", "DurableStore", "restore_tenant",
           "compressed_psum", "exact_int8_psum", "quantize_tree",
           "dequantize_tree"]

"""AdamW with configurable moment dtypes and ZeRO-1 specs."""
from .adam import (AdamState, AdamWConfig, apply, global_norm, init,
                   schedule, state_pspecs, zero_pspecs)

__all__ = ["AdamWConfig", "AdamState", "init", "apply", "schedule",
           "global_norm", "zero_pspecs", "state_pspecs"]

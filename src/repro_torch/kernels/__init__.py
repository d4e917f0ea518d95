"""Hand-written CUDA kernels for Hopper (sources in ../csrc), their plain
PyTorch versions (ref.py), the engine-facing ops and batch-size-aware
dispatch (ops.py) and the plan cache (autotune.py).

JAX's ``resolve_interpret``, ``resolve_skip`` and ``resolve_ta_prng`` read
environment variables; the port takes that configuration as engine
arguments (``kernel_path=``, ``skip=``, ``ta_prng=``) and has no such
names."""
# the engine first: ref.py imports core.booleanize, whose package imports
# the engine, which imports ops.py and through it every wrapper module
import repro_torch.core  # noqa: F401
from .ops import (PATH_FUSED, PATH_MXU, PATH_PACKED, PATH_PACKED_MXU,
                  PATH_REF, TA_COMPACT, TA_DENSE, TA_PRNG_INKERNEL,
                  TA_PRNG_STREAM, clause_eval_op, class_sum_op,
                  fused_step_op, packed_clause_eval_op, packed_clause_mxu_op,
                  packed_step_op, round_select_op, select_path,
                  select_ta_path, step_epilogue_op, step_prologue_op,
                  ta_update_compact_op, ta_update_op, tm_infer_op,
                  unfused_step_op)
from . import autotune, ref

__all__ = ["clause_eval_op", "class_sum_op", "fused_step_op", "tm_infer_op",
           "packed_clause_eval_op", "packed_clause_mxu_op", "packed_step_op",
           "ta_update_op", "ta_update_compact_op", "unfused_step_op",
           "round_select_op", "select_path", "select_ta_path",
           "step_prologue_op", "step_epilogue_op",
           "PATH_MXU", "PATH_PACKED", "PATH_PACKED_MXU", "PATH_FUSED",
           "PATH_REF", "TA_DENSE", "TA_COMPACT", "TA_PRNG_INKERNEL",
           "TA_PRNG_STREAM", "autotune", "ref"]

"""Engine core: configuration, booleanization, the DTM engine, the legacy
training core (clause, feedback, distributed) and the legacy TM variants
on it (conv_tm, regression_tm, TMHead)."""
from .types import (COALESCED, TMConfig, TMState, TileConfig, VANILLA,
                    init_state, ta_actions)
from .booleanize import (Booleanizer, fit_threshold, fit_thermometer,
                         pack_literals, to_literals, unpack_literals)
# the engine before the PRNG: it imports the kernels package, whose
# wrappers import the PRNG module whole
from .dtm import DTMEngine, DTMProgram, TMSession, resolve_device
from .clause import (clause_outputs_logical, clause_outputs_matmul,
                     class_sums, predict, vanilla_polarity)
from .prng import PRNG, LFSRState, cluster_next, lfsr_step, make_cluster
from .feedback import FeedbackStats, train_step
from .evaluate import (accuracy, batched_predict, epoch_record,
                       feedback_fit, fit_loop)
from .tm_head import TMHead, pool_backbone_features
from . import conv_tm, regression_tm

__all__ = [
    "TMConfig", "TileConfig", "TMState", "init_state", "ta_actions",
    "VANILLA", "COALESCED", "Booleanizer", "fit_threshold", "fit_thermometer",
    "to_literals", "pack_literals", "unpack_literals",
    "clause_outputs_logical", "clause_outputs_matmul", "class_sums",
    "predict", "vanilla_polarity", "PRNG", "LFSRState", "make_cluster",
    "lfsr_step", "cluster_next", "train_step", "FeedbackStats", "DTMEngine",
    "TMSession", "conv_tm", "regression_tm", "accuracy", "batched_predict",
    "epoch_record", "feedback_fit", "fit_loop", "DTMProgram", "TMHead",
    "pool_backbone_features", "resolve_device",
]

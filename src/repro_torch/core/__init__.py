"""Engine core: configuration, booleanization, the DTM engine, and the
legacy training core (clause, feedback, distributed)."""
from .types import (COALESCED, TMConfig, TMState, TileConfig, VANILLA,
                    init_state, ta_actions)
from .booleanize import (Booleanizer, fit_thermometer, pack_literals,
                         to_literals, unpack_literals)
from .dtm import DTMEngine, DTMProgram, resolve_device
from .evaluate import accuracy, batched_predict

__all__ = ["COALESCED", "TMConfig", "TMState", "TileConfig", "VANILLA",
           "init_state", "ta_actions", "Booleanizer", "fit_thermometer",
           "pack_literals", "to_literals", "unpack_literals", "DTMEngine",
           "DTMProgram", "resolve_device", "accuracy", "batched_predict"]

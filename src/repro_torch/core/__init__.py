"""Engine core: configuration, booleanization, the DTM engine."""
from .types import COALESCED, TMConfig, TileConfig, VANILLA
from .booleanize import (Booleanizer, fit_thermometer, pack_literals,
                         unpack_literals)
from .dtm import DTMEngine, DTMProgram, resolve_device
from .evaluate import accuracy, batched_predict

__all__ = ["COALESCED", "TMConfig", "TileConfig", "VANILLA", "Booleanizer",
           "fit_thermometer", "pack_literals", "unpack_literals",
           "DTMEngine", "DTMProgram", "resolve_device", "accuracy",
           "batched_predict"]

"""Activation-sparsity predictor subsystem: predict which FFN units fire
before reading their weights, so the serving engine's predictor mode
gathers only the predicted tiles of the up- AND down-projections.
predictors.py holds the sign / low-rank predictors, calibration.py the
fitting harness and the checkpoint format."""
from repro_torch.predictor.calibration import (calibrate, calibrate_from_config,
                                               collect_ffn_inputs, load_predictor,
                                               save_predictor)
from repro_torch.predictor.predictors import (LayerReport, Predictor,
                                              pack_tile_indices, sign_predictor)

__all__ = [
    "LayerReport",
    "Predictor",
    "calibrate",
    "calibrate_from_config",
    "collect_ffn_inputs",
    "load_predictor",
    "pack_tile_indices",
    "save_predictor",
    "sign_predictor",
]

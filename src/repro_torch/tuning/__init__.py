"""Serve-time precision autotuning: the port of ``repro.tuning``.

``calibrate``  -- calibration prompt sets: synthetic held-out batches or a
                  live-traffic reservoir tap fed by the serving engine.
``search``     -- :class:`ServeTuner`: phase-1 / phase-2 / verify
                  coordinate descent over per-layer, per-role native
                  format bindings under a logit-KL budget.
``artifact``   -- the shared ``--policy`` resolver (registry name or tuned
                  artifact path) and artifact writer.

``python -m repro_torch.tuning`` runs the search and writes an artifact.
"""
from .artifact import is_artifact_spec, load_policy, save_artifact
from .calibrate import (CalibrationSet, CalibrationTap, digest_of,
                        synthetic_calibration)
from .search import (LADDER, ServeTuneResult, ServeTuner, kv_layer_groups,
                     tune_serving)

__all__ = [
    "CalibrationSet", "CalibrationTap", "digest_of",
    "synthetic_calibration",
    "LADDER", "ServeTuneResult", "ServeTuner", "kv_layer_groups",
    "tune_serving",
    "is_artifact_spec", "load_policy", "save_artifact",
]

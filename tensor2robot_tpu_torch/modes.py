"""Canonical mode names, shared by data, preprocessors, models, and train.

The analogue of tf.estimator.ModeKeys in the reference's
mode-parameterized APIs (get_feature_specification(mode), preprocess_fn
mode-awareness — SURVEY.md §2).
"""

TRAIN = "train"
EVAL = "eval"
PREDICT = "predict"

ALL_MODES = (TRAIN, EVAL, PREDICT)


def validate_mode(mode: str) -> str:
  if mode not in ALL_MODES:
    raise ValueError(f"Unknown mode {mode!r}; expected one of {ALL_MODES}")
  return mode

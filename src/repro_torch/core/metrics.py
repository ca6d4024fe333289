"""Quality metrics of the paper's LIN/LOG evaluation (§4.1), numpy only.

- training error rate (%) for LIN/LOG (thresholded prediction errors)
- accuracy (LOG's estimator score)
"""
from __future__ import annotations

import numpy as np


def training_error_rate(pred: np.ndarray, y: np.ndarray,
                        threshold: float = 0.5) -> float:
    """% of thresholded prediction errors (paper's LIN/LOG quality metric)."""
    cls = (np.asarray(pred) > threshold).astype(np.int32)
    return float(np.mean(cls != (np.asarray(y) > threshold))) * 100.0


def accuracy(pred_labels: np.ndarray, y: np.ndarray) -> float:
    return float(np.mean(np.asarray(pred_labels) == np.asarray(y)))

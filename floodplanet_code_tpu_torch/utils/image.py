"""Image utilities: the port's copy of the confusion-matrix visualization of
``floodplanet_code_tpu/utils/image.py`` (reference tools.py:118-135).

Plain numpy: OpenCV and PIL, which the JAX module imports for its resize
and GIF helpers, are not needed here and may be absent on a card machine.
"""

from __future__ import annotations

import numpy as np


def create_conf_matrix_pred_image(
    pred: np.ndarray, target: np.ndarray
) -> np.ndarray:
    """HW3 uint8 visualization: TP white, FP teal, FN red (tools.py:118)."""
    out = np.zeros([pred.shape[0], pred.shape[1], 3], dtype="uint8")
    out[(pred == 1) & (target == 1)] = (255, 255, 255)
    out[(pred == 1) & (target == 0)] = (0, 255, 255)
    out[(pred == 0) & (target == 1)] = (255, 0, 0)
    return out

"""Image utilities: the port's copy of ``floodplanet_code_tpu/utils/image.py``
(resize, confusion-matrix visualization, GIFs).

Reference equivalents: resize_image (utils_image.py:11-54),
create_conf_matrix_pred_image (tools.py:118-135, TP white / FP teal /
FN red), create_gif (tools.py:6-109, without its except:breakpoint error
path). OpenCV and PIL are imported inside the functions that need them, so
importing this module needs neither.
"""

from __future__ import annotations

import numpy as np


def resize_image(
    image: np.ndarray,
    desired_height: int,
    desired_width: int,
    resize_mode: int | None = None,
) -> np.ndarray:
    """Resize [H,W] or [C,H,W] imagery (``resize_mode`` None = Lanczos,
    the reference's default)."""
    import cv2

    if resize_mode is None:
        resize_mode = cv2.INTER_LANCZOS4
    if image.ndim == 2:
        return cv2.resize(image, dsize=(desired_width, desired_height), interpolation=resize_mode)
    if image.ndim == 3:
        hwc = np.transpose(image, (1, 2, 0))
        out = cv2.resize(hwc, dsize=(desired_width, desired_height), interpolation=resize_mode)
        if out.ndim == 2:
            out = out[:, :, None]
        return np.ascontiguousarray(np.transpose(out, (2, 0, 1)))
    raise NotImplementedError(f'Cannot resize image with "{image.ndim}" dimensions.')


def create_conf_matrix_pred_image(
    pred: np.ndarray, target: np.ndarray
) -> np.ndarray:
    """HW3 uint8 visualization: TP white, FP teal, FN red (tools.py:118)."""
    out = np.zeros([pred.shape[0], pred.shape[1], 3], dtype="uint8")
    out[(pred == 1) & (target == 1)] = (255, 255, 255)
    out[(pred == 1) & (target == 0)] = (0, 255, 255)
    out[(pred == 0) & (target == 1)] = (255, 0, 0)
    return out


def create_gif(
    image_list: list,
    save_path: str,
    fps: float = 1,
    image_text: list | None = None,
) -> str | None:
    """Save a list of uint8 HW3 arrays as an animated GIF; None (nothing
    written) for fewer than two frames."""
    if not isinstance(image_list, list) or len(image_list) < 2:
        return None
    from PIL import Image

    frames = [Image.fromarray(np.asarray(img)) for img in image_list]
    if image_text is not None and len(image_text) == len(frames):
        from PIL import ImageDraw

        for frame, text in zip(frames, image_text):
            ImageDraw.Draw(frame).text((0, 0), str(text), (255, 0, 0))
    frames = [f.quantize(dither=Image.NONE) for f in frames]
    frames[0].save(
        fp=save_path,
        format="GIF",
        append_images=frames[1:],
        save_all=True,
        duration=int(1000 / fps),
        loop=0,
    )
    return save_path

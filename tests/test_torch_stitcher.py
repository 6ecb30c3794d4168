"""The port's DeviceStitcher (on CPU tensors) against the JAX package's
stitch_batch/finalize_canvas and its host ImageStitcher oracle.

Random tiles with ragged edge tiles, a padded final batch (valid=False
rows) and the host-canvas path for scenes over the size cap; tolerance
1e-6 (the same f32 adds in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from floodplanet_code_tpu.data import crop_params_for_scene
from floodplanet_code_tpu.data import generate_image_slice_object
from floodplanet_code_tpu.inference import stitcher as jax_stitcher
from floodplanet_code_tpu_torch.inference.stitcher import (
    DeviceStitcher,
    finalize_canvas,
    make_tile_valid_mask,
)

TOL = 1e-6


def _scene_tiles(rng, h, w, c, tile=32, stride=16, batch=8):
    """Batches of (tiles, offsets, heights, widths, batch_valid), the final
    one padded by repeating its last tile with valid=False."""
    crops = crop_params_for_scene(h, w, generate_image_slice_object(tile, stride=stride))
    batches = []
    for start in range(0, len(crops), batch):
        chunk = crops[start : start + batch]
        flags = [1] * len(chunk) + [0] * (batch - len(chunk))
        chunk = chunk + [chunk[-1]] * (batch - len(chunk))
        tiles = rng.random((batch, tile, tile, c)).astype(np.float32)
        for t, cp in zip(tiles, chunk):
            t[cp.height :] = 0
            t[:, cp.width :] = 0
        batches.append((
            tiles,
            np.array([[cp.h0, cp.w0] for cp in chunk]),
            [cp.height for cp in chunk],
            [cp.width for cp in chunk],
            np.array(flags),
        ))
    return crops, batches


@pytest.mark.parametrize("max_canvas_bytes", [1 << 30, 1024])
def test_matches_jax_stitch_and_host_oracle(rng, tmp_path, max_canvas_bytes):
    h, w, c, tile = 50, 70, 3, 32
    crops, batches = _scene_tiles(rng, h, w, c, tile)
    port = DeviceStitcher(c, device="cpu", max_canvas_bytes=max_canvas_bytes)
    canvas = jnp.zeros((h + tile, w + tile, c))
    weights = jnp.zeros((h + tile, w + tile))
    host = jax_stitcher.ImageStitcher(str(tmp_path))
    for tiles, offsets, heights, widths, flags in batches:
        valid = make_tile_valid_mask(heights, widths, tile, tile, batch_valid=flags)
        want_valid = jax_stitcher.make_tile_valid_mask(
            heights, widths, tile, tile, batch_valid=flags
        )
        assert np.array_equal(valid, want_valid)
        port.add_batch("s", h, w, torch.from_numpy(tiles), offsets, valid)
        canvas, weights = jax_stitcher.stitch_batch(
            canvas, weights, jnp.asarray(tiles), jnp.asarray(offsets, jnp.int32),
            jnp.asarray(valid),
        )
        for t, o, hh, ww, f in zip(tiles, offsets, heights, widths, flags):
            if f:
                cp = next(cp for cp in crops if [cp.h0, cp.w0] == list(o))
                host.add_image(t[:hh, :ww], "s", cp, h, w)
    assert ("s" in port._host) == (max_canvas_bytes == 1024)
    got = port.pop_combined("s")
    want = np.asarray(jax_stitcher.finalize_canvas(canvas, weights))[:h, :w]
    assert got.shape == (h, w, c)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    np.testing.assert_allclose(got, host.get_combined_images()["s"], atol=TOL, rtol=0)
    assert port.scene_names() == []


def test_finalize_scrubs_nan():
    out = finalize_canvas(torch.zeros(4, 4, 1), torch.zeros(4, 4))
    assert torch.isfinite(out).all() and (out == 0).all()
    out = finalize_canvas(torch.full((2, 2, 1), float("nan")), torch.ones(2, 2))
    assert (out == 0).all()

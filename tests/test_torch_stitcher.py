"""The port's DeviceStitcher (on CPU tensors) against the JAX package's
stitch_batch/finalize_canvas and its host ImageStitcher oracle, and the
port's host ImageStitcher against the JAX one.

Random tiles with ragged edge tiles, a padded final batch (valid=False
rows) and the host-canvas path for scenes over the size cap; tolerance
1e-6 (the same f32 adds in another order). The two host ImageStitchers
add the same tiles in the same order: their canvases equal bit for bit,
and so do the TIFFs and PNGs they write, read back.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from floodplanet_code_tpu.data import crop_params_for_scene
from floodplanet_code_tpu.data import generate_image_slice_object
from floodplanet_code_tpu.geo import tiff as jax_tiff
from floodplanet_code_tpu.inference import stitcher as jax_stitcher
from floodplanet_code_tpu_torch.inference import ImageStitcher
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


@pytest.mark.parametrize("channels", [0, 3])
@pytest.mark.parametrize("backend,ext", [("tifffile", ".tif"), ("PIL", ".png")])
def test_image_stitcher_matches_jax(rng, tmp_path, channels, backend, ext):
    """Two scenes of overlapping tiles, [h, w] (channels 0) or [h, w, 3]
    probabilities in [0, 1), one scene with the geo tags of a source
    GeoTIFF: the same canvases, paths, names and sizes as the JAX class,
    and the same images read back, probabilities and thresholded classes."""
    from PIL import Image

    geo = str(tmp_path / "source.tif")
    Image.fromarray(np.zeros((4, 4), np.uint8)).save(
        geo, tiffinfo={33922: (0.0, 0.0, 0.0, 10.0, 20.0, 0.0), 33550: (0.5, 0.5, 0.0)})
    scenes = {"a": (50, 70), "b": (40, 33)}
    shape = (32, 32) + ((channels,) if channels else ())
    tiles = []
    for name, (h, w) in scenes.items():
        for cp in crop_params_for_scene(h, w, generate_image_slice_object(32, stride=16)):
            tiles.append((rng.random(shape).astype(np.float32)[:cp.height, :cp.width], name,
                          cp, h, w))
    for save_class in (False, True):
        out = {}
        for side, cls in (("port", ImageStitcher), ("jax", jax_stitcher.ImageStitcher)):
            stitcher = cls(str(tmp_path / f"{side}_{save_class}"), "pred", backend, ext)
            for tile, name, cp, h, w in tiles:
                stitcher.add_image(tile, name, cp, h, w, geo_from=geo if name == "a" else None)
            canvases = {k: v.copy() for k, v in stitcher.get_combined_images().items()}
            paths, names, sizes = stitcher.save_images(save_class=save_class)
            read = [Image.open(p) if backend == "PIL" else jax_tiff.imread(p) for p in paths]
            out[side] = (canvases, [os.path.relpath(p, stitcher.save_dir) for p in paths],
                         names, sizes, [np.asarray(r) for r in read])
        port, want = out["port"], out["jax"]
        assert sorted(port[0]) == sorted(want[0]) == ["a", "b"]
        for name in want[0]:
            assert port[0][name].dtype == want[0][name].dtype
            np.testing.assert_array_equal(port[0][name], want[0][name])
        assert port[1:4] == want[1:4]
        for got, ref in zip(port[4], want[4]):
            assert got.dtype == ref.dtype
            np.testing.assert_array_equal(got, ref)
    if backend == "tifffile":  # the geo tags followed the scene
        tags = []
        for side in ("port", "jax"):
            with jax_tiff.TiffFile(os.path.join(tmp_path, f"{side}_True", "a", "pred.tif")) as f:
                tags.append(f.geo_tags())
        assert tags[0] == tags[1] and tags[0]

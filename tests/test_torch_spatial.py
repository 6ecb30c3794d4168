"""Spatial partitioning in the port (``tpu.spatial_shards``:
floodplanet_code_tpu_torch/parallel/{mesh,halo}.py, the row exchanges of
models/unet.py) against the unsharded computation on the CPU.

One spawn of 4 gloo ranks on a 2 x 2 data x space mesh
(``tests/_torch_rank_fns.py::spatial_case``) runs every check; each rank
holds its batch shard's rows and its block of image rows. The same ranks
then run blocks of unequal height (``parallel/rows.py``): H = 50 on the
2 x 2 mesh (levels 50, 25, 12, 6, 3 in blocks 25/25, 13/12, 7/5, 4/2,
2/1) and H = 100 on a 1 x 4 mesh of the same ranks (25 x 4, 13/12/13/12,
7/6/6/6, 4/3/3/2, 2/2/1/1): the pool of every level, the upsample with
pad-to-match of every level in both conventions, the DoubleConv at an
uneven level, and the train and eval steps, by the bounds below. The JAX
side runs the unsharded functions in this process, which
tests/test_spatial.py shows GSPMD's dp x sp step equals. Tolerances:
- the row exchange: the joined rows equal the image's rows, and the
  gradient the whole image's, exactly;
- the sharded upsample (align_corners false and true) and DoubleConv
  (conv_impl xla and pallas_fused, whose plain version runs here;
  fused_bn false), against the same modules on the whole batch: forward
  and the gradients of <out, g> (the input's, and the parameters' summed
  over the ranks) within 1e-5 of each tensor's largest element; the bf16
  upsample within half a bf16 spacing of the f32 one on the same inputs;
- one spatial train step of the early-fusion UNet (base 8, f32, 32^2,
  batch 4) against the JAX package's unsharded ``make_train_step`` from the
  same weights, with the fused pair and align_corners, and with flax's
  BatchNorm (fused_bn false): loss 1e-5 relative, the confusion equal, the
  all-reduced gradients 1e-5 relative + 1e-6 (the bound of the data-parallel
  tests' loss gradients, tests/test_torch_parallel.py), the same on every
  rank; the step is SGD at lr 1, so the parameters after it are the start
  less the gradient (JAX's gradient is read that way), held to JAX's at
  the same bound; the running statistics 1e-5 relative + 1e-6;
- the spatial eval step with a padded row against JAX's
  ``make_eval_step``: loss 1e-5 relative, confusion equal;
- the sharded max pool: equal to the whole image's, forward and gradient;
- ``replicate_state``: every rank's state equals rank 0's bit for bit.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

import _torch_rank_fns as fns
from floodplanet_code_tpu.data.augment import TransformParams as JParams
from floodplanet_code_tpu.models import build_model as jax_build_model
from floodplanet_code_tpu.parallel import mesh as jmesh
from floodplanet_code_tpu.train.fit import make_eval_step as jax_eval_step
from floodplanet_code_tpu.train.fit import make_train_step as jax_train_step
from floodplanet_code_tpu.train.state import create_train_state as jax_state
from floodplanet_code_tpu_torch.config import compose
from floodplanet_code_tpu_torch.models.unet import DoubleConv, _pad_to_match, _upsample2x
from floodplanet_code_tpu_torch.parallel import launch
from floodplanet_code_tpu_torch.parallel.mesh import Mesh, local_height, local_rows
from floodplanet_code_tpu_torch.parallel.rows import row_layout
from floodplanet_code_tpu_torch.tools.import_jax_params import (
    seeded_flax_variables,
    state_dict_from_flax,
)
from floodplanet_code_tpu_torch.train import fit as port_fit
from floodplanet_code_tpu_torch.train.state import init_weights

DEADLINE = 240  # seconds for a spawn of 4 CPU ranks, imports included
STEPS = {  # port model kwargs, JAX model kwargs; from the same seeded weights
    "fused_ac": ({"conv_impl": "pallas_fused", "align_corners": True}, {"align_corners": True}),
    "flax_bn": ({"fused_bn": False}, {"fused_bn": False}),
}
DOUBLE_CONVS = [("xla", True), ("pallas_fused", True), ("xla", False)]
# Blocks of unequal height: the mesh (dp, sp), the height, the width, the
# batch and the DoubleConv's level.
UNEVEN = {"h50": ((2, 2), 50, 24, 4, 2), "h100": ((1, 4), 100, 16, 2, 4)}


def _np_tree(tree):
    return jax.tree.map(lambda v: np.array(v, np.float32), tree)


def _close(got, want, scale=1e-5):
    """Within ``scale`` of the reference's largest element."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= scale * np.abs(want).max()


def _whole(results, key, field, axis=2, mesh=(2, 2)):
    """Rank blocks reassembled: data rows stacked, space blocks joined.
    ``key`` is a key of each rank's results or a path of keys."""
    dp, sp = mesh
    path = key if isinstance(key, tuple) else (key,)

    def get(r):
        for k in path:
            r = r[k]
        return r[field]

    return np.concatenate([np.concatenate([get(results[sp * d + s]) for s in range(sp)], axis)
                           for d in range(dp)])


def _jax_reference(data: dict, flax_start) -> dict:
    """JAX's unsharded eval step and train step (SGD at lr 1) for each
    configuration from ``flax_start`` on ``data``'s batch: the eval loss and
    confusion, the step's loss and confusion, its gradient (the start less
    the parameters after) and the state after."""
    variables = flax_start
    batch = {"image": jnp.asarray(data["image"]), "target": jnp.asarray(data["target"])}
    out = {}
    for name, (_, kwargs) in STEPS.items():
        jmodel = jax_build_model("ef_model", {"ms_image": 4}, 3, dtype=jnp.float32,
                                 base_feat_channels=8, **kwargs)
        if not out:  # neither option changes the parameter tree: one state
            jstate = jax_state(jmodel, {"image": data["image"]}, lr=1.0,
                               optimizer_name="sgd", seed=0)
            jstate = jstate.replace(params=jax.tree.map(jnp.asarray, variables["params"]),
                                    batch_stats=jax.tree.map(jnp.asarray,
                                                             variables["batch_stats"]))
        logs = jax_eval_step(jmodel, 2)(jstate, dict(batch, valid=jnp.asarray(data["valid"])))
        evaluated = (float(logs["loss"]), np.asarray(logs["confusion"]))
        state, logs = jax_train_step(jmodel, 2, JParams(False, 0, False, 0, False, 0))(
            jax.tree.map(jnp.copy, jstate), batch, jax.random.key(0))
        after = {k: v.numpy() for k, v in state_dict_from_flax(
            _np_tree({"params": state.params, "batch_stats": state.batch_stats})).items()}
        out[name] = {"eval": evaluated, "loss": float(logs["loss"]),
                     "confusion": np.asarray(logs["confusion"]), "after": after}
    return out


def _uneven_case(rng, mesh, height, width, batch, conv_level, start) -> dict:
    """Inputs at every level of ``row_layout(height, sp)`` for the sharded
    modules, and a batch for the steps with its last row padded."""
    heights = row_layout(height, mesh[1]).heights
    widths = [width >> level for level in range(len(heights))]

    def draw(channels, level):
        return rng.standard_normal((batch, channels, heights[level], widths[level])).astype(
            np.float32)

    return {
        "mesh": mesh, "height": height, "conv_level": conv_level, "start": start,
        "x": [draw(3, level) for level in range(len(heights))],
        "pool_g": [draw(3, level + 1) for level in range(len(heights) - 1)],
        "up_g": [draw(3, level) for level in range(len(heights) - 1)],
        "conv_g": draw(5, conv_level),
        "image": rng.standard_normal((batch, height, width, 4)).astype(np.float32),
        "target": rng.choice([0, 1, 2], (batch, height, width), p=[0.3, 0.4, 0.3]).astype(
            np.int32),
        "valid": np.arange(batch) < batch - 1,
    }


@pytest.fixture(scope="module")
def case():
    """The inputs, the 4-rank run and the JAX reference, which runs here
    while the ranks run."""
    rng = np.random.default_rng(9)
    flax_start = seeded_flax_variables(4, 3, 8, seed=9)
    data = {
        "exchange_x": rng.standard_normal((4, 3, 8, 5)).astype(np.float32),
        "exchange_w": rng.standard_normal((4, 2, 3, 8, 5)).astype(np.float32),
        "module_x": rng.standard_normal((4, 3, 32, 8)).astype(np.float32),
        "module_g": rng.standard_normal((4, 5, 32, 8)).astype(np.float32),
        "upsample_g": rng.standard_normal((4, 3, 64, 16)).astype(np.float32),
        "double_convs": DOUBLE_CONVS,
        "image": rng.standard_normal((4, 32, 32, 4)).astype(np.float32),
        "target": rng.choice([0, 1, 2], (4, 32, 32), p=[0.3, 0.4, 0.3]).astype(np.int32),
        "valid": np.asarray([True, True, True, False]),
        "steps": {name: port for name, (port, _) in STEPS.items()},
        "start": {k: v.numpy() for k, v in state_dict_from_flax(flax_start).items()},
    }
    data["uneven"] = {key: _uneven_case(rng, *spec, data["start"])
                      for key, spec in UNEVEN.items()}
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(launch.spawn, fns.spatial_case, (data,), devices=["cpu"] * 4,
                            timeout_s=120, join_timeout_s=DEADLINE)
        reference = _jax_reference(data, flax_start)
        for key, uneven in data["uneven"].items():
            reference[key] = _jax_reference(uneven, flax_start)
        results = ranks.result()
    return data, results, reference


def test_layout(case):
    """The ranks lie row-major over (data, space); each space group holds
    one data row's ranks in row order."""
    _, results, _ = case
    for rank, r in enumerate(results):
        assert r["coords"] == {"data": rank // 2, "space": rank % 2}
        assert r["space_ranks"] == [2 * (rank // 2), 2 * (rank // 2) + 1]


_FLAT = ("data", "space")
_HYBRID = ("pod", "data", "space")


@pytest.mark.parametrize("axes,sizes,height", [
    pytest.param(_FLAT, (4, 2), 64, id="flat"),
    pytest.param(_HYBRID, (2, 2, 2), 64, id="hybrid"),
    pytest.param(_FLAT, (4, 2), 300, id="flat-300-sp2"),
    pytest.param(_FLAT, (2, 4), 300, id="flat-300-sp4"),
    pytest.param(_HYBRID, (2, 2, 2), 300, id="hybrid-300-sp2"),
    pytest.param(_FLAT, (4, 2), 50, id="flat-50-sp2"),
])
def test_local_block_matches_jax_sharding(axes, sizes, height):
    """Each rank's rows of a global batch and block of image rows are the
    ones the JAX batch sharding gives the device at the same place of the
    mesh (image [16, height, 8, 3], height sharded over 'space'), at the
    heights whose lower levels split unevenly too."""
    jax_mesh = JMesh(np.array(jax.devices()).reshape(sizes), axes)
    index_map = jmesh.batch_shardings_for(jax_mesh)["image"].devices_indices_map(
        (16, height, 8, 3))
    for rank, position in enumerate(np.ndindex(jax_mesh.devices.shape)):
        want = index_map[jax_mesh.devices[position]]
        mesh = Mesh(axes, sizes, rank)
        got = (local_rows(mesh, 16), local_height(mesh, height))
        assert [(g.start, g.stop) for g in got] == [(w.start, w.stop) for w in want[:2]]


def test_height_that_sp_does_not_divide_raises_in_both_packages():
    """300 rows over 8 blocks: the JAX batch placement refuses the
    sharding, and the port's layout raises before anything runs."""
    jax_mesh = JMesh(np.array(jax.devices()).reshape(1, 8), _FLAT)
    with pytest.raises(ValueError, match="divisible by 8"):
        jax.device_put(np.zeros((8, 300, 2, 1), np.float32),
                       jmesh.batch_shardings_for(jax_mesh)["image"])
    with pytest.raises(ValueError, match="does not split into 8 equal blocks"):
        local_height(Mesh(_FLAT, (1, 8), 3), 300)


def test_height_must_split_into_even_blocks_at_every_level():
    """Every height that sp divides runs unless a block would be empty at
    some UNet level: 80 at sp = 2 (refused before blocks could be of
    unequal height) runs; 81 (odd) and an empty block (40 at sp = 2: level
    4 has 2 rows, block 1 none; 48 at sp = 8: level 3 has 6 rows for 8
    blocks) raise, naming the level and the block."""
    mesh = Mesh(_FLAT, (1, 2), 1)
    assert local_height(mesh, 96) == slice(48, 96)
    assert local_height(mesh, 80) == slice(40, 80)
    with pytest.raises(ValueError, match="81 rows does not split into 2 equal blocks"):
        local_height(mesh, 81)
    with pytest.raises(ValueError, match="block 1 without a row at UNet level 4"):
        local_height(mesh, 40)
    with pytest.raises(ValueError, match="block 3 without a row at UNet level 3"):
        local_height(Mesh(_FLAT, (1, 8), 0), 48)


@pytest.mark.parametrize("height,sp,blocks", [
    (300, 2, [[150] * 2, [75] * 2, [38, 37], [19, 18], [10, 8]]),
    (300, 4, [[75] * 4, [38, 37, 38, 37], [19, 19, 19, 18], [10, 9, 10, 8], [5, 5, 5, 3]]),
    (50, 2, [[25, 25], [13, 12], [7, 5], [4, 2], [2, 1]]),
    (100, 4, [[25] * 4, [13, 12, 13, 12], [7, 6, 6, 6], [4, 3, 3, 2], [2, 2, 1, 1]]),
])
def test_row_layout_levels(height, sp, blocks):
    """Each block's rows at every level: contiguous, in order, summing to
    the level's height (floor halving), each block starting at the first
    pool window it owns; a window split between two blocks where a block
    ends on an odd row."""
    layout = row_layout(height, sp)
    assert list(layout.heights) == [height >> level for level in range(5)]
    assert [[b - a for a, b in level] for level in layout.blocks] == blocks
    for level, row in enumerate(layout.blocks):
        assert row[0][0] == 0 and row[-1][1] == layout.heights[level]
        assert all(row[s][1] == row[s + 1][0] for s in range(sp - 1))
        if level:
            below = layout.blocks[level - 1]
            assert all(a == -(-below[s][0] // 2) for s, (a, _) in enumerate(row))
    assert [any(layout.borrows_below(level, s) for s in range(sp)) for level in range(4)] == [
        any(b % 2 for _, b in layout.blocks[level][:-1]) for level in range(4)]


def test_fit_accepts_the_default_crop_and_keeps_jax_rows():
    """``_check_supported`` takes the reference's default 300^2 crop at
    tpu.spatial_shards=2 (and refuses 40, an empty block), and the fit's
    ``_local_block`` keeps the rows of the JAX device at each place of a
    1 x 2 mesh."""
    port_fit._check_supported(compose(overrides=["tpu.spatial_shards=2"]))
    with pytest.raises(ValueError, match="without a row at UNet level 4"):
        port_fit._check_supported(compose(overrides=["tpu.spatial_shards=2", "crop_height=40",
                                                     "crop_width=40"]))
    image = np.arange(2 * 300 * 3 * 1, dtype=np.float32).reshape(2, 300, 3, 1)
    jax_mesh = JMesh(np.array(jax.devices()[:2]).reshape(1, 2), _FLAT)
    index_map = jmesh.batch_shardings_for(jax_mesh)["image"].devices_indices_map(image.shape)
    batch = {"image": torch.from_numpy(image), "valid": torch.ones(2, dtype=torch.bool)}
    for rank in range(2):
        rows = local_height(Mesh(_FLAT, (1, 2), rank), 300)
        got = port_fit._local_block(batch, rows)
        np.testing.assert_array_equal(got["image"].numpy(),
                                      image[index_map[jax_mesh.devices[0, rank]]])
        assert got["valid"].shape == (2,)


@pytest.mark.parametrize("k", [1, 2])
def test_exchange_rows_matches_slicing(case, k):
    """The joined rows are the whole image's rows around the block (none
    past the image's edges), and the gradient of the ranks' summed
    <join_rows(x), w> is the whole image's."""
    data, results, _ = case
    x, w = data["exchange_x"], data["exchange_w"]
    per = x.shape[2] // 2
    want_dx = np.zeros_like(x)
    for rank, r in enumerate(results):
        d, s = divmod(rank, 2)
        got = r[f"exchange{k}"]
        lo, hi = max(s * per - k, 0), min((s + 1) * per + k, x.shape[2])
        np.testing.assert_array_equal(got["ext"], x[2 * d:2 * d + 2, :, lo:hi])
        assert got["joined"] == k  # one neighbour each: the block above or below
        want_dx[2 * d:2 * d + 2, :, lo:hi] += w[rank][..., :hi - lo, :]
    np.testing.assert_array_equal(_whole(results, f"exchange{k}", "dx"), want_dx)


@pytest.mark.parametrize("align_corners", [False, True])
def test_sharded_upsample_matches_whole_image(case, align_corners):
    data, results, _ = case
    x = torch.from_numpy(data["module_x"]).requires_grad_()
    up = _upsample2x(x, align_corners)
    (up * torch.from_numpy(data["upsample_g"])).sum().backward()
    _close(_whole(results, f"upsample_{align_corners}", "out"), up.detach().numpy())
    _close(_whole(results, f"upsample_{align_corners}", "dx"), x.grad.numpy())


@pytest.mark.parametrize("align_corners", [False, True])
def test_sharded_bf16_upsample_rounds_once(case, align_corners):
    """In bf16 the sharded upsample interpolates in f32 and rounds once, as
    the whole image's ``F.interpolate`` does: each element within half a
    bf16 spacing (2^-8 of itself) of the whole image's f32 upsample of the
    same bf16 inputs, plus 1e-6 of the largest for the f32 sums' order."""
    data, results, _ = case
    x = torch.from_numpy(data["module_x"]).to(torch.bfloat16)
    exact = _upsample2x(x.float(), align_corners).numpy()
    bound = 2.0**-8 * np.abs(exact) + 1e-6 * np.abs(exact).max()
    for got in (_whole(results, f"upsample_bf16_{align_corners}", "out"),
                _upsample2x(x, align_corners).float().numpy()):
        assert got.shape == exact.shape
        assert np.all(np.abs(got - exact) <= bound)


@pytest.mark.parametrize("impl,fused_bn", DOUBLE_CONVS)
def test_sharded_double_conv_matches_whole_batch(case, impl, fused_bn):
    """Train mode: BatchNorm over all four ranks; the fused pair (its plain
    version here) on the halo-extended y."""
    data, results, _ = case
    torch.manual_seed(0)
    module = DoubleConv(3, 5, conv_impl=impl, fused_bn=fused_bn).to(
        memory_format=torch.channels_last).train()
    x = torch.from_numpy(data["module_x"]).contiguous(
        memory_format=torch.channels_last).requires_grad_()
    y = module(x)
    (y * torch.from_numpy(data["module_g"])).sum().backward()
    key = f"double_conv_{impl}_{fused_bn}"
    _close(_whole(results, key, "out"), y.detach().numpy())
    _close(_whole(results, key, "dx"), x.grad.numpy())
    for name, p in module.named_parameters():
        _close(sum(r[key]["grads"][name] for r in results), p.grad.numpy())


def _check_step(got: list, want: dict, start: dict) -> None:
    after = want["after"]
    for r in got:
        np.testing.assert_allclose(r["loss"], want["loss"], rtol=1e-5)
        np.testing.assert_array_equal(r["confusion"], want["confusion"])
    for n, g in got[0]["grads"].items():
        w = start[n] - after[n]  # SGD at lr 1: the first update is the gradient
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6, err_msg=n)
        np.testing.assert_allclose(got[0]["params"][n], after[n], rtol=1e-5, atol=1e-6,
                                   err_msg=n)
        for r in got[1:]:  # one update on every rank
            np.testing.assert_array_equal(r["grads"][n], g)
            np.testing.assert_array_equal(r["params"][n], got[0]["params"][n])
    for n, b in got[0]["buffers"].items():
        np.testing.assert_allclose(b, after[n], rtol=1e-5, atol=1e-6)
        for r in got[1:]:
            np.testing.assert_array_equal(r["buffers"][n], b)


@pytest.mark.parametrize("name", list(STEPS))
def test_spatial_train_step_matches_jax_unsharded(case, name):
    data, results, reference = case
    _check_step([r[f"step_{name}"] for r in results], reference[name], data["start"])


@pytest.mark.parametrize("name", list(STEPS))
def test_spatial_eval_step_matches_jax_unsharded(case, name):
    """From the common start, with the batch's last row padded (valid
    False)."""
    _, results, reference = case
    loss, confusion = reference[name]["eval"]
    for r in results:
        np.testing.assert_allclose(r[f"step_{name}"]["eval_loss"], loss, rtol=1e-5)
        np.testing.assert_array_equal(r[f"step_{name}"]["eval_confusion"], confusion)


def test_replicate_state_gives_every_rank_rank_zeros_state(case):
    """Each rank built its model from its own seed; after replicate_state
    every rank (data and space alike) holds rank 0's, EMA included."""
    _, results, _ = case
    from floodplanet_code_tpu_torch.models import build_model

    model = init_weights(build_model("ef_model", {"ms_image": 4}, 3, base_feat_channels=8,
                                     device="cpu"), seed=0)
    want = np.concatenate([t.numpy().ravel() for t in model.state_dict().values()]
                          + [p.detach().numpy().ravel() for p in model.parameters()])
    for r in results:
        np.testing.assert_array_equal(r["replicated"], want)


# -- blocks of unequal height -----------------------------------------------------


def _uneven_whole(results, key, name, field):
    return _whole(results, (f"uneven_{key}", name), field, mesh=UNEVEN[key][0])


@pytest.mark.parametrize("key", list(UNEVEN))
def test_uneven_sharded_pool_matches_whole_image(case, key):
    """Every level's pool, windows split between two blocks included:
    equal to the whole image's, and so is the gradient (the borrowed row's
    returns to its owner)."""
    data, results, _ = case
    uneven = data["uneven"][key]
    for level in range(4):
        x = torch.from_numpy(uneven["x"][level]).requires_grad_()
        y = torch.nn.functional.max_pool2d(x, 2)
        (y * torch.from_numpy(uneven["pool_g"][level])).sum().backward()
        np.testing.assert_array_equal(_uneven_whole(results, key, f"pool{level}", "out"),
                                      y.detach().numpy())
        np.testing.assert_array_equal(_uneven_whole(results, key, f"pool{level}", "dx"),
                                      x.grad.numpy())


@pytest.mark.parametrize("key", list(UNEVEN))
@pytest.mark.parametrize("align_corners", [False, True])
def test_uneven_sharded_upsample_matches_whole_image(case, key, align_corners):
    """Every level's upsample and pad-to-match (the last block pads the
    odd level's row, the width pads locally) against the whole image's."""
    data, results, _ = case
    uneven = data["uneven"][key]
    for level in range(4):
        x = torch.from_numpy(uneven["x"][level + 1]).requires_grad_()
        g = torch.from_numpy(uneven["up_g"][level])
        up = _pad_to_match(_upsample2x(x, align_corners), g)
        (up * g).sum().backward()
        name = f"up{level}_{align_corners}"
        _close(_uneven_whole(results, key, name, "out"), up.detach().numpy())
        _close(_uneven_whole(results, key, name, "dx"), x.grad.numpy())


@pytest.mark.parametrize("key", list(UNEVEN))
@pytest.mark.parametrize("impl,fused_bn", DOUBLE_CONVS)
def test_uneven_sharded_double_conv_matches_whole_batch(case, key, impl, fused_bn):
    """At an uneven level (7/5 rows; 2/2/1/1, one-row blocks between two
    neighbours): BatchNorm weighting each rank's pixels, the convs on
    halo-extended blocks of unequal height."""
    data, results, _ = case
    uneven = data["uneven"][key]
    level = uneven["conv_level"]
    torch.manual_seed(0)
    module = DoubleConv(3, 5, conv_impl=impl, fused_bn=fused_bn).to(
        memory_format=torch.channels_last).train()
    x = torch.from_numpy(uneven["x"][level]).contiguous(
        memory_format=torch.channels_last).requires_grad_()
    y = module(x)
    (y * torch.from_numpy(uneven["conv_g"])).sum().backward()
    name = f"double_conv_{impl}_{fused_bn}"
    _close(_uneven_whole(results, key, name, "out"), y.detach().numpy())
    _close(_uneven_whole(results, key, name, "dx"), x.grad.numpy())
    for n, p in module.named_parameters():
        _close(sum(r[f"uneven_{key}"][name]["grads"][n] for r in results), p.grad.numpy())


@pytest.mark.parametrize("key", list(UNEVEN))
@pytest.mark.parametrize("name", list(STEPS))
def test_uneven_spatial_train_step_matches_jax_unsharded(case, key, name):
    """H = 50 on 2 x 2 and H = 100 on 1 x 4: split pool windows, padded
    levels and SyncBN at unequal counts, held to JAX's unsharded step."""
    data, results, reference = case
    _check_step([r[f"uneven_{key}"]["steps"][name] for r in results], reference[key][name],
                data["start"])


@pytest.mark.parametrize("key", list(UNEVEN))
@pytest.mark.parametrize("name", list(STEPS))
def test_uneven_spatial_eval_step_matches_jax_unsharded(case, key, name):
    _, results, reference = case
    loss, confusion = reference[key][name]["eval"]
    for r in results:
        got = r[f"uneven_{key}"]["steps"][name]
        np.testing.assert_allclose(got["eval_loss"], loss, rtol=1e-5)
        np.testing.assert_array_equal(got["eval_confusion"], confusion)

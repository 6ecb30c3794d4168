"""Spatial partitioning in the port (``tpu.spatial_shards``:
floodplanet_code_tpu_torch/parallel/{mesh,halo}.py, the row exchanges of
models/unet.py) against the unsharded computation on the CPU.

One spawn of 4 gloo ranks on a 2 x 2 data x space mesh
(``tests/_torch_rank_fns.py::spatial_case``) runs every check; each rank
holds its batch shard's rows and its block of image rows. The JAX side
runs the unsharded functions in this process, which tests/test_spatial.py
shows GSPMD's dp x sp step equals. Tolerances:
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
from floodplanet_code_tpu_torch.models.unet import DoubleConv, _upsample2x
from floodplanet_code_tpu_torch.parallel import launch
from floodplanet_code_tpu_torch.parallel.mesh import Mesh, local_height, local_rows
from floodplanet_code_tpu_torch.tools.import_jax_params import (
    seeded_flax_variables,
    state_dict_from_flax,
)
from floodplanet_code_tpu_torch.train.state import init_weights

DEADLINE = 240  # seconds for a spawn of 4 CPU ranks, imports included
STEPS = {  # port model kwargs, JAX model kwargs; from the same seeded weights
    "fused_ac": ({"conv_impl": "pallas_fused", "align_corners": True}, {"align_corners": True}),
    "flax_bn": ({"fused_bn": False}, {"fused_bn": False}),
}
DOUBLE_CONVS = [("xla", True), ("pallas_fused", True), ("xla", False)]


def _np_tree(tree):
    return jax.tree.map(lambda v: np.array(v, np.float32), tree)


def _close(got, want, scale=1e-5):
    """Within ``scale`` of the reference's largest element."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= scale * np.abs(want).max()


def _whole(results, key, field, axis=2):
    """Rank blocks reassembled: data rows stacked, space blocks joined."""
    return np.concatenate([np.concatenate([results[2 * d + s][key][field] for s in range(2)],
                                          axis) for d in range(2)])


def _jax_reference(data: dict) -> dict:
    """JAX's unsharded eval step and train step (SGD at lr 1) for each
    configuration from ``data``'s start: the eval loss and confusion, the
    step's loss and confusion, its gradient (the start less the parameters
    after) and the state after."""
    variables = data["flax_start"]
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
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(launch.spawn, fns.spatial_case, (data,), devices=["cpu"] * 4,
                            timeout_s=120, join_timeout_s=DEADLINE)
        reference = _jax_reference(dict(data, flax_start=flax_start))
        results = ranks.result()
    return data, results, reference


def test_layout(case):
    """The ranks lie row-major over (data, space); each space group holds
    one data row's ranks in row order."""
    _, results, _ = case
    for rank, r in enumerate(results):
        assert r["coords"] == {"data": rank // 2, "space": rank % 2}
        assert r["space_ranks"] == [2 * (rank // 2), 2 * (rank // 2) + 1]


@pytest.mark.parametrize("layout", ["flat", "hybrid"])
def test_local_block_matches_jax_sharding(layout):
    """Each rank's rows of a global batch and block of image rows are the
    ones the JAX batch sharding gives the device at the same place of the
    mesh (image [16, 64, 8, 3], height sharded over 'space')."""
    if layout == "flat":
        axes, sizes = ("data", "space"), (4, 2)
    else:
        axes, sizes = ("pod", "data", "space"), (2, 2, 2)
    jax_mesh = JMesh(np.array(jax.devices()).reshape(sizes), axes)
    index_map = jmesh.batch_shardings_for(jax_mesh)["image"].devices_indices_map((16, 64, 8, 3))
    for rank, position in enumerate(np.ndindex(jax_mesh.devices.shape)):
        want = index_map[jax_mesh.devices[position]]
        mesh = Mesh(axes, sizes, rank)
        got = (local_rows(mesh, 16), local_height(mesh, 64))
        assert [(g.start, g.stop) for g in got] == [(w.start, w.stop) for w in want[:2]]


def test_height_must_split_into_even_blocks_at_every_level():
    mesh = Mesh(("data", "space"), (1, 2), 1)
    assert local_height(mesh, 96) == slice(48, 96)
    with pytest.raises(ValueError, match=r"height % \(16 \* spatial_shards\) == 0; got 80"):
        local_height(mesh, 80)


@pytest.mark.parametrize("k", [1, 2])
def test_exchange_rows_matches_slicing(case, k):
    """The joined rows are the whole image's rows around the block (none
    past the image's edges), and the gradient of the ranks' summed
    <cat(top, x, bottom), w> is the whole image's."""
    data, results, _ = case
    x, w = data["exchange_x"], data["exchange_w"]
    per = x.shape[2] // 2
    want_dx = np.zeros_like(x)
    for rank, r in enumerate(results):
        d, s = divmod(rank, 2)
        got = r[f"exchange{k}"]
        lo, hi = max(s * per - k, 0), min((s + 1) * per + k, x.shape[2])
        np.testing.assert_array_equal(got["ext"], x[2 * d:2 * d + 2, :, lo:hi])
        assert got["top"] == (s > 0)
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


@pytest.mark.parametrize("name", list(STEPS))
def test_spatial_train_step_matches_jax_unsharded(case, name):
    data, results, reference = case
    want = reference[name]
    start, after = data["start"], want["after"]
    got = [r[f"step_{name}"] for r in results]
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

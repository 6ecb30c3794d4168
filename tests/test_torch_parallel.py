"""The port's data-parallel layer (floodplanet_code_tpu_torch/parallel/,
SyncBN, the global losses and confusion) against the JAX package's on the
CPU.

Each multi-rank case spawns 2 gloo ranks (``parallel/launch.py``, a
FileStore in a fresh temporary directory, a join deadline) that run
``tests/_torch_rank_fns.py``; the JAX side runs ``shard_map`` on 2 of the
8 virtual CPU devices, or the unsharded function where the sharded one
must equal it. Tolerances:
- SyncBN (f32, [4, 6, 6, 5]) against the JAX ``bn_relu_train`` with
  ``axis_name``: 1e-5 relative + 1e-6 absolute (the sums run in other
  orders); the port's dscale and dbias are each rank's sums, so their sum
  over the ranks is held to JAX's global ones.
- the three losses and the confusion on 2 ranks with unequal ignored
  pixels per rank against the unsharded JAX losses: values 1e-6 relative,
  gradients 1e-6 absolute + 1e-5 relative, the confusion equal.
- unequal pixel counts per rank (spatial partitioning's blocks of unequal
  height: every example on both ranks, rank 0 its first rows, rank 1 the
  rest): SyncBN, the differentiable statistics, the three losses and the
  confusion against the JAX functions of the whole batch, by the bounds
  above.
- three chained shard train steps (ef_model, base 8, f32, Adam at 1e-3,
  2 rows per rank) against the JAX shard_map step: the first step's
  all-reduced gradients against the JAX gradient of the whole batch within
  2e-4 + 2e-3*|g| (PERF.md §2; a doubled or halved gradient fails it, where
  Adam's normalization would hide it in the parameters); the first step's
  loss 1e-5 relative and confusion equal; the later steps' losses 1e-3
  relative and confusions within 0.5% of the pixels. Adam moves every
  element whose gradient is rounding noise by up to lr per step, so the
  steps drift apart: on these batches JAX's own GSPMD and shard_map steps
  differ by 1.6e-4 in the third step's loss, and by the third step 4 of
  2260 pixels (0.18%) had flipped between the port and JAX; the parameters after three
  steps every element within 2*lr*steps and each tensor within half the
  distance JAX moved it (measured 0.22; JAX's own GSPMD and shard_map
  steps end 0.22 apart on these batches), the same on both ranks bit for
  bit; the running statistics after the first step 1e-5 relative, after
  the third (batch averages of activations of the drifted parameters)
  each within 2e-2 of its tensor's largest value (measured 1.1e-2); the shard eval step with padded rows: from the
  common start loss 1e-5 relative and confusion equal, after the three
  steps loss 1e-4 and confusion within 0.5%.
"""

import json
import multiprocessing
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh as JMesh
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

import _torch_rank_fns as fns
from floodplanet_code_tpu.models import build_model as jax_build_model
from floodplanet_code_tpu.ops import losses as jl
from floodplanet_code_tpu.ops import metrics as jm
from floodplanet_code_tpu.ops.batchnorm import _stats as jax_stats
from floodplanet_code_tpu.ops.batchnorm import bn_relu_train as jax_bn
from floodplanet_code_tpu.parallel import mesh as jmesh
from floodplanet_code_tpu.parallel.shard_step import (
    make_shard_eval_step as jax_shard_eval,
    make_shard_train_step as jax_shard_train,
)
from floodplanet_code_tpu.train.state import create_train_state as jax_state
from floodplanet_code_tpu_torch.parallel import launch
from floodplanet_code_tpu_torch.parallel.mesh import (
    Mesh,
    local_rows,
    make_mesh,
    make_mesh_2d,
)
from floodplanet_code_tpu_torch.parallel.shard_step import make_shard_train_step
from floodplanet_code_tpu_torch.tools.import_jax_params import state_dict_from_flax

LR = 1e-3
DEADLINE = 240  # seconds for a spawn of 2 CPU ranks, imports included


def _np_tree(tree):
    return jax.tree.map(lambda v: np.array(v, np.float32), tree)


def _nhwc(a):
    return np.asarray(a).transpose(0, 2, 3, 1)


@pytest.fixture(scope="module")
def case():
    """The inputs, one 2-rank run of ``ops_case`` on them, and the JAX
    model the steps start from."""
    rng = np.random.default_rng(8)
    data = {
        "bn_x": rng.standard_normal((4, 6, 6, 5)).astype(np.float32) * 2 + 0.5,
        "bn_scale": rng.uniform(0.5, 1.5, 5).astype(np.float32),
        "bn_bias": rng.standard_normal(5).astype(np.float32) * 0.3,
        "bn_dz": rng.standard_normal((4, 6, 6, 5)).astype(np.float32),
        "logits": (rng.standard_normal((4, 8, 8, 3)) * 2).astype(np.float32),
        "target": rng.choice([0, 1, 2], (4, 8, 8)).astype(np.int32),
        "class_weights": np.asarray([0.2, 1.0, 3.0], np.float32),
        "unequal_split": {"bn": 2, "logits": 3},  # rank 0's rows of 6 and of 8
        "lr": LR,
    }
    # Rank 0's rows nearly all ignored (class 2), rank 1's untouched.
    data["target"][:2, :, :7] = 2
    batches = []
    for k in range(3):
        r = np.random.default_rng(100 + k)
        image = r.standard_normal((4, 32, 32, 4)).astype(np.float32)
        target = r.choice([0, 1, 2], (4, 32, 32), p=[0.2, 0.4, 0.4]).astype(np.int32)
        target[:2, :20] = 0  # unequal ignored pixels per rank (ignore_index 0)
        batches.append((image, target))
    data["batches"] = batches
    valid = np.asarray([True, True, True, False])
    data["eval"] = (batches[0][0], batches[0][1], valid)
    jmodel = jax_build_model("ef_model", {"ms_image": 4}, 3, base_feat_channels=8,
                             bn_axis_name="data")
    # JAX's initial weights, replicated on the 2-device mesh as the
    # shard_map step's state enters it (one compiled step).
    jstate = jax.device_put(jax_state(jmodel, {"image": batches[0][0]}, lr=LR, seed=0),
                            NamedSharding(_jmesh2(), P()))
    data["start"] = {k: v.numpy() for k, v in state_dict_from_flax(
        _np_tree({"params": jstate.params, "batch_stats": jstate.batch_stats})).items()}
    results = launch.spawn(fns.ops_case, (data,), devices=["cpu", "cpu"],
                           timeout_s=120, join_timeout_s=DEADLINE)
    return data, results, jmodel, jstate


def _jmesh2():
    return JMesh(np.array(jax.devices()[:2]), ("data",))


def _close(got, want, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


# -- (a) the layout -------------------------------------------------------------


@pytest.mark.parametrize("layout", ["flat", "hybrid"])
def test_local_rows_match_jax_sharding(layout):
    """Each rank's rows of a global batch of 16 are the rows the JAX
    batch sharding gives the device at the same place of the 8-device
    mesh."""
    if layout == "flat":
        jax_mesh, axes, sizes = jmesh.make_mesh(8), ("data",), (8,)
    else:
        jax_mesh, axes, sizes = jmesh.make_hybrid_mesh(2, 4), ("pod", "data"), (2, 4)
    index_map = jmesh.batch_sharding(jax_mesh).devices_indices_map((16, 3))
    for rank, position in enumerate(np.ndindex(jax_mesh.devices.shape)):
        want = index_map[jax_mesh.devices[position]][0]
        got = local_rows(Mesh(axes, sizes, rank), 16)
        assert (got.start, got.stop) == (want.start, want.stop), (rank, position)
    mesh = Mesh(axes, sizes, 5)
    assert mesh.shape == dict(jax_mesh.shape)
    assert list(mesh.coords.values()) == list(np.unravel_index(5, sizes))


def test_make_mesh_refuses_more_devices_than_ranks():
    assert make_mesh().shape == {"data": 1}
    assert make_mesh(1).groups == {"data": None, "batch": None, "all": None}
    with pytest.raises(ValueError, match="needs 2 devices"):
        make_mesh(2)
    with pytest.raises(ValueError, match="needs 4 devices"):
        make_mesh_2d(2, 2)


def test_spatial_mesh_rejected():
    """The JAX test_spatial_mesh_rejected: the data-parallel step refuses a
    mesh with a space axis (spatial partitioning runs the GSPMD step)."""
    for sizes in ((4, 2), (1, 2)):
        with pytest.raises(ValueError, match="spatial partitioning stays GSPMD-only"):
            make_shard_train_step(None, Mesh(("data", "space"), sizes), 0)


def test_backend_follows_the_devices():
    assert launch.backend_for(["cpu", "cpu"]) == "gloo"
    assert launch.backend_for(["cuda:0", "cuda:0"]) == "gloo"
    assert launch.backend_for(["cuda:0", "cuda:1"]) == "nccl"
    assert launch.backend_for(["cuda:0"]) == "nccl"


def test_a_failing_rank_fails_the_launch_without_hanging():
    """Rank 1 raises while rank 0 waits in a barrier it will never leave:
    the call raises naming rank 1, well inside the deadline."""
    with pytest.raises(RuntimeError, match="rank 1 of 2 failed(.|\n)*on purpose"):
        launch.spawn(fns.fail_on_rank_one, devices=["cpu", "cpu"], timeout_s=120,
                     join_timeout_s=DEADLINE)


# -- (b) SyncBN ------------------------------------------------------------------


def test_sync_bn_matches_jax_axis_name(case):
    data, results, _, _ = case

    def f(x, scale, bias):
        return jax_bn(x, scale, bias, 1e-5, "data")

    sharded = jax.shard_map(f, mesh=_jmesh2(), in_specs=(P("data"), P(), P()),
                            out_specs=(P("data"), P(), P()))
    args = [jnp.asarray(data[k]) for k in ("bn_x", "bn_scale", "bn_bias")]
    (z, mean, var), vjp = jax.vjp(sharded, *args)
    dx, dscale, dbias = vjp((jnp.asarray(data["bn_dz"]), jnp.zeros_like(mean),
                             jnp.zeros_like(var)))
    got = [r["bn"] for r in results]
    _close(np.concatenate([_nhwc(g["z"]) for g in got]), z)
    _close(np.concatenate([_nhwc(g["dx"]) for g in got]), dx)
    for g in got:  # the statistics: the whole batch's on every rank
        _close(g["mean"], mean)
        _close(g["var"], var)
    # dscale / dbias: each rank's sums; the step's all-reduce adds them.
    _close(sum(g["dscale"] for g in got), dscale, atol=1e-5)
    _close(sum(g["dbias"] for g in got), dbias, atol=1e-5)
    assert not np.allclose(got[0]["dscale"], dscale)


def test_synced_statistics_match_the_whole_batch(case):
    """The differentiable statistics (the fused pair's BN_0, flax's
    BatchNorm): values and gradient as the whole batch's."""
    data, results, _, _ = case
    w = jnp.asarray(data["bn_dz"])

    def f(x):
        m1, m2 = jax_stats(x, None)
        return jnp.sum(w * (x - m1) * jax.lax.rsqrt(m2 - m1 * m1 + 1e-5)), (m1, m2)

    (_, (m1, m2)), dx = jax.value_and_grad(f, has_aux=True)(jnp.asarray(data["bn_x"]))
    for r in results:
        _close(r["stats"]["mean"], m1)
        _close(r["stats"]["m2"], m2)
    _close(np.concatenate([_nhwc(r["stats"]["dx"]) for r in results]), dx, atol=1e-5)


def _rows(results, key, field):
    """The ranks' blocks of image rows joined (NHWC)."""
    return np.concatenate([_nhwc(r[key][field]) for r in results], axis=1)


def test_sync_bn_weights_unequal_pixel_counts(case):
    """Rank 0 holds 2 of each example's 6 rows, rank 1 the other 4: the
    statistics, z and dx are the whole batch's, the ranks' dscale and
    dbias sum to its."""
    data, results, _, _ = case
    args = [jnp.asarray(data[k]) for k in ("bn_x", "bn_scale", "bn_bias")]
    (z, mean, var), vjp = jax.vjp(lambda x, s, b: jax_bn(x, s, b, 1e-5, None), *args)
    dx, dscale, dbias = vjp((jnp.asarray(data["bn_dz"]), jnp.zeros_like(mean),
                             jnp.zeros_like(var)))
    _close(_rows(results, "bn_unequal", "z"), z)
    _close(_rows(results, "bn_unequal", "dx"), dx)
    for r in results:
        _close(r["bn_unequal"]["mean"], mean)
        _close(r["bn_unequal"]["var"], var)
    _close(sum(r["bn_unequal"]["dscale"] for r in results), dscale, atol=1e-5)
    _close(sum(r["bn_unequal"]["dbias"] for r in results), dbias, atol=1e-5)


def test_synced_statistics_weight_unequal_pixel_counts(case):
    """The differentiable statistics on the 2 / 4 row split: values and
    gradient as the whole batch's (an unweighted mean of the ranks' means
    would be off by far more than the bound)."""
    data, results, _, _ = case
    w = jnp.asarray(data["bn_dz"])

    def f(x):
        m1, m2 = jax_stats(x, None)
        return jnp.sum(w * (x - m1) * jax.lax.rsqrt(m2 - m1 * m1 + 1e-5)), (m1, m2)

    (_, (m1, m2)), dx = jax.value_and_grad(f, has_aux=True)(jnp.asarray(data["bn_x"]))
    for r in results:
        _close(r["stats_unequal"]["mean"], m1)
        _close(r["stats_unequal"]["m2"], m2)
    _close(_rows(results, "stats_unequal", "dx"), dx, atol=1e-5)
    halves = [data["bn_x"][:, :2].mean((0, 1, 2)), data["bn_x"][:, 2:].mean((0, 1, 2))]
    assert np.abs((halves[0] + halves[1]) / 2 - np.asarray(m1)).max() > 1e-3


# -- (c) the global losses and confusion -------------------------------------------


@pytest.mark.parametrize("name", ["ce", "weighted_ce", "dice"])
def test_losses_are_global_with_unequal_ignored_pixels(case, name):
    data, results, _, _ = case
    logits, target = jnp.asarray(data["logits"]), jnp.asarray(data["target"])
    weights = jnp.asarray(data["class_weights"])
    fn = {"ce": lambda lg: jl.cross_entropy_ignore(lg, target, 2),
          "weighted_ce": lambda lg: jl.weighted_cross_entropy(lg, target, weights, 2),
          "dice": lambda lg: jl.dice_loss(lg, target, 2)}[name]
    value, grad = jax.value_and_grad(fn)(logits)
    for r in results:
        np.testing.assert_allclose(r[name]["loss"], float(value), rtol=1e-6)
    got = np.concatenate([_nhwc(r[name]["grad"]) for r in results])
    _close(got, grad, rtol=1e-5, atol=1e-6)
    # A mean of the two ranks' own losses would differ: the shards' valid
    # pixel counts are far apart.
    valid = (data["target"] != 2).reshape(2, -1).sum(1)
    assert valid[0] * 4 < valid[1]


@pytest.mark.parametrize("name", ["ce", "weighted_ce", "dice"])
def test_losses_are_global_at_unequal_row_blocks(case, name):
    """Rank 0 holds 3 of each example's 8 rows, rank 1 the other 5."""
    data, results, _, _ = case
    logits, target = jnp.asarray(data["logits"]), jnp.asarray(data["target"])
    weights = jnp.asarray(data["class_weights"])
    fn = {"ce": lambda lg: jl.cross_entropy_ignore(lg, target, 2),
          "weighted_ce": lambda lg: jl.weighted_cross_entropy(lg, target, weights, 2),
          "dice": lambda lg: jl.dice_loss(lg, target, 2)}[name]
    value, grad = jax.value_and_grad(fn)(logits)
    for r in results:
        np.testing.assert_allclose(r[f"{name}_unequal"]["loss"], float(value), rtol=1e-6)
    _close(_rows(results, f"{name}_unequal", "grad"), grad, rtol=1e-5, atol=1e-6)
    want = jm.confusion_from_logits(logits, target, 2)
    for r in results:
        np.testing.assert_array_equal(r["confusion_unequal"], np.asarray(want))


def test_confusion_is_the_global_tally(case):
    data, results, _, _ = case
    want = jm.confusion_from_logits(jnp.asarray(data["logits"]), jnp.asarray(data["target"]), 2)
    for r in results:
        np.testing.assert_array_equal(r["confusion"], np.asarray(want))


# -- (d) the shard train and eval steps ---------------------------------------------


@pytest.fixture(scope="module")
def jax_steps(case):
    """The JAX shard_map steps on the case's batches (from a copy of the
    start: the step donates its state), the JAX gradient of the first
    batch as a whole, and the eval step after the three steps."""
    data, _, jmodel, jstate = case
    step = jax_shard_train(jmodel, _jmesh2(), 0)
    state = jax.tree.map(jnp.copy, jstate)
    steps = []
    for image, target in data["batches"]:
        state, logs = step(state, {"image": jnp.asarray(image), "target": jnp.asarray(target)},
                           jax.random.key(0))
        steps.append((float(logs["loss"]), np.asarray(logs["confusion"])))
        if len(steps) == 1:
            stats1 = state_dict_from_flax(_np_tree({"params": state.params,
                                                    "batch_stats": state.batch_stats}))
    # The first step's gradient: the JAX gradient of the whole batch, BN
    # statistics over all of it (what SyncBN computes).
    unsynced = jax_build_model("ef_model", {"ms_image": 4}, 3, base_feat_channels=8)
    image, target = data["batches"][0]

    def loss_fn(params):
        logits, _ = unsynced.apply({"params": params, "batch_stats": jstate.batch_stats},
                                   {"image": jnp.asarray(image)}, train=True,
                                   mutable=["batch_stats"])
        return jl.cross_entropy_ignore(logits, jnp.asarray(target), 0)

    grads = state_dict_from_flax(_np_tree(
        {"params": jax.jit(jax.grad(loss_fn))(jstate.params),
         "batch_stats": jstate.batch_stats}))
    final = state_dict_from_flax(_np_tree({"params": state.params,
                                           "batch_stats": state.batch_stats}))
    image, target, valid = data["eval"]
    logs = jax_shard_eval(jmodel, _jmesh2(), 0)(state, {
        "image": jnp.asarray(image), "target": jnp.asarray(target), "valid": jnp.asarray(valid)})
    return steps, grads, stats1, final, (float(logs["loss"]), np.asarray(logs["confusion"]))


@pytest.mark.parametrize("impl", ["xla", "pallas_fused"])
def test_shard_train_step_matches_jax_shard_map(case, jax_steps, impl):
    data, results, _, _ = case
    steps, want_grads, want1, want, (eval_loss, eval_confusion) = jax_steps
    got = [r[f"step_{impl}"] for r in results]
    for name, g in got[0]["grads"].items():
        w = want_grads[name].numpy()
        assert (np.abs(g - w) <= 2e-4 + 2e-3 * np.abs(w)).all(), name
        np.testing.assert_array_equal(g, got[1]["grads"][name])  # one update on every rank
    for name, b in got[0]["buffers1"].items():  # the first step's running statistics
        _close(b, want1[name].numpy(), rtol=1e-5, atol=1e-6)
    for k, (loss, confusion) in enumerate(steps):
        for r in got:
            np.testing.assert_allclose(r["loss"][k], loss, rtol=1e-5 if k == 0 else 1e-3)
            if k == 0:
                np.testing.assert_array_equal(r["confusion"][k], confusion)
            assert np.abs(r["confusion"][k] - confusion).sum() / 2 <= 5e-3 * confusion.sum()
    # Adam moves every element whose gradient is rounding noise by up to lr
    # per step in either direction: on these batches JAX's own GSPMD and
    # shard_map steps end 0.22 of the distance they moved the weights
    # apart (worst tensor), as the port ends from the shard_map step.
    start = data["start"]
    for name, p in got[0]["params"].items():
        np.testing.assert_array_equal(p, got[1]["params"][name])
        w = want[name].numpy()
        assert (np.abs(p - w) <= 2 * LR * 3).all(), name
        assert np.linalg.norm(p - w) <= 0.5 * np.linalg.norm(w - start[name]), name
    for name, b in got[0]["buffers"].items():
        np.testing.assert_array_equal(b, got[1]["buffers"][name])
        w = want[name].numpy()
        assert np.abs(b - w).max() <= 2e-2 * np.abs(w).max(), name
    # The eval step with a padded row, after the three steps.
    for r in got:
        np.testing.assert_allclose(r["eval_loss"], eval_loss, rtol=1e-4)
        assert (np.abs(r["eval_confusion"] - eval_confusion).sum() / 2
                <= 5e-3 * eval_confusion.sum())


def test_shard_eval_step_matches_jax_at_the_same_state(case):
    """The eval step alone, from the common start: loss 1e-5, confusion
    equal (no optimizer step in between)."""
    data, results, jmodel, jstate = case
    image, target, valid = data["eval"]
    batch = {"image": image, "target": target, "valid": valid}
    logs = jax_shard_eval(jmodel, _jmesh2(), 0)(jstate, {k: jnp.asarray(v)
                                                         for k, v in batch.items()})
    for r in results:
        for impl in ("xla", "pallas_fused"):
            got = r[f"step_{impl}"]
            np.testing.assert_allclose(got["eval0_loss"], float(logs["loss"]), rtol=1e-5)
            np.testing.assert_array_equal(got["eval0_confusion"], np.asarray(logs["confusion"]))


# -- (e) joining a group --------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("how", ["cfg", "env"])
def test_multihost_joins_from_cfg_or_launcher_env(tmp_path, how):
    port, world = _free_port(), 2
    ctx = multiprocessing.get_context("spawn")
    paths = [str(tmp_path / f"rank{r}.json") for r in range(world)]
    procs = [ctx.Process(target=fns.multihost_case, args=(how, port, r, world, paths[r]))
             for r in range(world)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(DEADLINE)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
    assert [p.exitcode for p in procs] == [0, 0]
    for rank, path in enumerate(paths):
        with open(path) as handle:
            got = json.load(handle)
        assert got["joined"] is True and got["again"] is False
        assert (got["index"], got["count"], got["coordinator"]) == (rank, 2, rank == 0)
        assert got["shard"] == [rank, 2] and got["local"] == 2 and got["sum"] == 3.0
        assert got["raised"] == "global batch size 3 not divisible by 2 processes"


def test_one_process_is_a_world_of_one():
    from floodplanet_code_tpu_torch.config import compose
    from floodplanet_code_tpu_torch.parallel import multihost

    assert multihost.initialize_from_env_or_config(compose(overrides=[]), "cpu") is False
    assert (multihost.process_index(), multihost.process_count()) == (0, 1)
    assert multihost.is_coordinator() and multihost.process_shard(make_mesh()) is None
    assert multihost.local_batch_size(5) == 5
    multihost.sync("noop")

"""The data-parallel train and eval steps: the port of
``floodplanet_code_tpu/parallel/shard_step.py``.

The JAX package has two forms of the step over a device mesh: GSPMD, where
the partitioner derives the collectives, and ``shard_map``, where they are
written out in per-device code. PyTorch has no partitioner, so the port
has one step for both ``tpu.spmd_impl`` settings, the ``shard_map``
schedule. Each rank holds its rows of the global batch (``mesh.local_rows``)
and a replicated state, and runs:

- the forward on its rows, with train-mode BatchNorm over the group's
  whole batch (the model built with ``bn_group=batch_group(mesh)``:
  SyncBN, ops/batchnorm.py);
- the global loss (its numerator and count summed over the group, so
  ranks with unequal ignored pixels still give the unsharded loss), then
  the backward, which sums nothing (parallel/collectives.py);
- ONE all-reduce (sum) of every gradient, in one flat buffer: each
  gradient becomes the whole batch's, and every rank takes the same
  update. BatchNorm's dscale and dbias arrive local like every other
  gradient (ops/batchnorm.py), so nothing is counted twice;
- Adam and the EMA (``ema_decay_at`` of the replicated step count);
- the running statistics, already global and so the same on every rank;
- the confusion matrix summed over the group.

The eval step prefers the EMA parameters and masks padded rows through
``batch["valid"]``; its loss and confusion are the global ones. The
train and eval steps are ``train/fit.py``'s with a ``group``: on one
device they are the same code without the sums. ``fit_model`` builds its
steps here, on one rank and on many.
"""

from __future__ import annotations

from floodplanet_code_tpu_torch.data.augment import TransformParams
from floodplanet_code_tpu_torch.parallel.mesh import Mesh, batch_group, check_data_mesh
from floodplanet_code_tpu_torch.train import fit


def make_shard_train_step(
    model,
    mesh: Mesh,
    ignore_index: int,
    loss_cfg=None,
    ema_decay: float = 0.0,
    ema_warmup: bool = True,
):
    """``train_step(state, batch) -> (state, {"loss", "confusion"})`` over
    ``mesh``'s batch axes, for a ``model`` built with
    ``bn_group=batch_group(mesh)``; ``batch`` is this rank's rows. The
    state is updated in place, as ``make_train_step``'s. Augmentation runs
    before it, as its own step (``make_augment_step(..., mesh)``), as the
    JAX fit runs it."""
    check_data_mesh(mesh)
    return fit.make_train_step(model, ignore_index, TransformParams(False, 0, False, 0, False, 0),
                           loss_cfg=loss_cfg, fuse_augmentation=False, ema_decay=ema_decay,
                           ema_warmup=ema_warmup, group=batch_group(mesh))


def make_shard_eval_step(model, mesh: Mesh, ignore_index: int):
    """``eval_step(state, batch) -> {"loss", "confusion", "logits"}`` with
    the global loss and confusion (this rank's logits)."""
    check_data_mesh(mesh)
    return fit.make_eval_step(model, ignore_index, batch_group(mesh))

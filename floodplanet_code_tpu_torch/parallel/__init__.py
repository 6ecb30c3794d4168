"""More than one device: the port of ``floodplanet_code_tpu/parallel``.

The JAX package runs one SPMD program over a device mesh and lets the
partitioner (GSPMD) or ``shard_map`` place the collectives. PyTorch has no
partitioner: here every device is one process (a rank) of a
``torch.distributed`` group, NCCL between cards and gloo on the CPU and for
ranks that share a card, and every collective is written out.

- ``mesh``: the process-group layout (a 1-D data mesh, the hybrid
  pod x data mesh, the rows of a global batch each rank holds) and
  ``replicate_state``;
- ``multihost``: joining a group from the config or a launcher's
  environment, coordinator-only side effects, per-rank loading;
- ``collectives``: all_reduce, broadcast and barrier, and
  ``global_with_local_grad`` for the global losses;
- ``launch``: one process per device from one call (``fit_model`` with
  ``tpu.n_devices > 1``);
- ``shard_step``: the data-parallel train and eval steps.

Spatial partitioning (``tpu.spatial_shards > 1``) is not ported yet
(ROADMAP.md Queue 1, PR 9).
"""

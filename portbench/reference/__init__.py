"""The plain references that decide ``correct``; nothing here imports the
system under test.

A configuration file names its model's reference module,
``"reference": "<module>"``, which is ``reference/<module>.py``
(``harness.reference``). The module exposes, each taking the
configuration dict first:

- ``tensor_shapes(config)``: [(name, shape, kind)] of every tensor the
  system loads, under the names it loads them by;
- ``weights(config, seed, device)``: {name: float32 tensor}, made from the
  seed on ``device``, which both sides are given;
- ``train_steps(config, weights, batches, ignore_index, quant=None)``: the
  optimizer's steps over ``batches`` [(image NCHW, target)], as the
  configuration's ``optimizer`` and ``lr`` say (``common.adam_steps``):
  {"losses", "first_grads", "after"};
- ``probabilities(config, weights, image, tta, quant=None)``: the eval
  forward's softmax [B, H, W, n_classes], averaged over the eight dihedral
  transforms with ``tta``;
- ``batch_statistics(config, weights, image)``: the running statistics
  that ``image``'s batch gives in train mode, {} for a model without any;
- ``work(config, batch, height, width)``: the operations of one forward,
  ``counts.Op`` each.

``quant``: a rounding applied wherever the system would store a value in
its compute dtype (``common.bf16_round``, the witness; ``common.fp8_quant``,
the control). Data (``data.py``), the numbers compared (``judge.py``) and
what every model shares (``common.py``) sit beside the modules.
"""

"""The port's ops: the hand-written CUDA kernels (``conv_fused``,
``rotate``, ``batchnorm``; built by ``cuda_build``) beside their plain
PyTorch versions, and the plain ones (``losses``, ``metrics``).

``LAUNCHES`` counts, per kernel name, the launches its wrapper made. A
wrapper adds one where it launches its kernel and nowhere else, so a run
that clears the counter and reads it afterwards shows which kernels the
path went through.
"""

from collections import Counter

LAUNCHES: Counter = Counter()

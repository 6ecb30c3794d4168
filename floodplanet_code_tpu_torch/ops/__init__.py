"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

``LAUNCHES`` counts, per kernel name, the launches its wrapper made. A
wrapper adds one where it launches its kernel and nowhere else, so a run
that clears the counter and reads it afterwards shows which kernels the
path went through.
"""

from collections import Counter

LAUNCHES: Counter = Counter()

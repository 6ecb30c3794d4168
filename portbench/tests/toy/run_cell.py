"""Run a training cell of the benchmark in the working directory on the
CPU with the toy model registered with the port, once sound and once with
half of each batch left out; print one JSON line of each run's checks,
numbers and work counts.

    python run_cell.py <cell> <port config dir with the toy's yaml> <work dir>

The registration (``MODELS``, the port's config directory) is a
``monkeypatch`` of this process alone."""

import json
import os
import sys
import time

sys.path.insert(0, os.getcwd())
sys.path.insert(1, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import pytest  # noqa: E402
import torch  # noqa: E402

from floodplanet_code_tpu_torch.config import core  # noqa: E402
from floodplanet_code_tpu_torch.models import water_seg  # noqa: E402
from portbench import harness  # noqa: E402
from portbench.reference import judge  # noqa: E402
from program import ToySeg  # noqa: E402
from test_portbench_faults import SEED, _half_batch, _plant  # noqa: E402


def main(cell: str, conf: str, workdir: str) -> None:
    out = {}
    with pytest.MonkeyPatch.context() as patch:
        patch.setitem(water_seg.MODELS, "toy_seg", ToySeg)
        patch.setattr(core, "DEFAULT_CONFIG_DIR", conf)
        spec = harness.cell_files(harness.manifest("."), cell)
        driver = harness.driver(spec["traffic"]["kind"])
        for name in ("sound", "half_batch"):
            if name == "half_batch":
                _plant(patch, _half_batch)
            run = driver.run(spec, SEED, 0.3, False, torch.device("cpu"), time.perf_counter(),
                             workdir)
            out[name] = {"correct": judge.passes(run["checks"]), "checks": run["checks"],
                         "numbers": run["numbers"],
                         "train_flops_per_step": run["ctx"]["train_flops_per_step"],
                         "work_by_kind": run["ctx"]["work_by_kind"]}
    print(json.dumps(out))


if __name__ == "__main__":
    main(*sys.argv[1:4])

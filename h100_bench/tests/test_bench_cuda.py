"""One short run of each cell on the card, held to its limits.  Needs an
NVIDIA card; skips without one."""

import time

import pytest

from bench_helpers import run, spec

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(cell):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch.cuda.is_available() is "
                    "false")
    r = run.run_cell(cell, 2 ** 34 + 11, 2, 0, t_start=time.perf_counter())
    correct, failed, checks = run.judge(r, spec.workload(cell)["limits"])
    assert correct, checks
    rates = [v["value"] for k, v in r["metrics"].items()
             if k.split(".")[0] == "moves_per_s"]
    assert rates and min(rates) > 0

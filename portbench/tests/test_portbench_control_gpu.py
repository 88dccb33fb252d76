"""On the card: each cell's control fails its check and a sound run of
the program passes it, at the cell's own sizes, on three seeds.

    python3 -m pytest portbench/tests/test_portbench_control_gpu.py -m gpu

The control is the reference in fp8 in the program's place for the
training cell, and the program's own int8 path for the others. Skips
without a CUDA device."""

import pytest

from portbench.harness import Bench

SEEDS = (41, 42, 2 ** 31 + 43)


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def checks(workload, seed, control):
    import torch

    bench = Bench()
    cell = bench.workload(workload)
    traffic = bench.traffic(cell["traffic"])
    drv = bench.driver(traffic).Driver(bench.config(cell["config"]),
                                       traffic, seed, "cuda",
                                       control=control)
    drv.setup()
    drv.window(3.0)
    drv.release()
    torch.cuda.empty_cache()
    return drv.check(), bench.limits(workload)


def workloads():
    return [cell["name"] for cell in Bench().spec["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("workload", workloads())
def test_control_fails_the_check(cuda, workload, seed):
    got, limits = checks(workload, seed, control=True)
    assert any(got[k] > limits[k] for k in limits), (got, limits)


@pytest.mark.gpu
@pytest.mark.parametrize("workload", workloads())
def test_program_passes_the_check(cuda, workload):
    got, limits = checks(workload, SEEDS[0], control=False)
    assert all(got[k] <= limits[k] for k in limits), (got, limits)

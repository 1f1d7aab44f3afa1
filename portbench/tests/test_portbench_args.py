"""The command line: its arguments, and no result without a card."""
import subprocess
import sys

import pytest

from portbench.harness import runner

from .conftest import ROOT


def test_parse_takes_the_contract_arguments():
    a = runner.parse(["--workload", "cifar10-w4a8-b256-ddim10", "--seed", str(2 ** 33 + 5), "--seconds", "45",
                      "--trace", "1"])
    assert (a.workload, a.seed, a.seconds, a.trace) == ("cifar10-w4a8-b256-ddim10", 2 ** 33 + 5, 45.0, 1)
    assert runner.parse(["--workload", "w", "--seed", "-3", "--seconds", "1"]).trace == 0


@pytest.mark.parametrize("argv", [
    ["--workload", "w", "--seed", "1", "--seconds", "0"],
    ["--workload", "w", "--seed", "1", "--seconds", "nan"],
    ["--workload", "w", "--seed", "1.5", "--seconds", "3"],
    ["--workload", "w", "--seed", "1", "--seconds", "3", "--trace", "2"],
    ["--seed", "1", "--seconds", "3"],
])
def test_parse_refuses(argv):
    with pytest.raises(SystemExit):
        runner.parse(argv)


def _run(cwd, *argv):
    return subprocess.run([sys.executable, "portbench/run.py", *argv], cwd=cwd, capture_output=True, text=True,
                          timeout=300)


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_no_result_without_a_card_or_the_program(where, bench_copy):
    """Without CUDA (this machine) the run exits non-zero and prints nothing
    on standard output; so does a directory holding only BENCHMARK.json and
    portbench/."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cwd = ROOT if where == "checkout" else bench_copy
    r = _run(cwd, "--workload", "cifar10-w4a8-b256-ddim10", "--seed", "1", "--seconds", "1")
    assert r.returncode != 0 and r.stdout == ""
    assert "no result" in r.stderr or "Error" in r.stderr


def test_unknown_workload_is_named(bench_copy):
    from portbench.harness.registry import Registry

    with pytest.raises(LookupError, match="cifar10-w4a8-b256-ddim10"):
        Registry(bench_copy).cell("no-such-cell")

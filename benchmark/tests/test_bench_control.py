"""The check that decides ``correct``: sound runs pass it, and the control
and every planted fault fail it.

On the CPU each cell runs at a size a test run holds (the 64 MiB mixes at
6 MiB and a little more, with full blocks, a ragged tail and, for the
signal, a raw block), through the rest of a run as ``run.py`` makes it,
without its look for a card.  The card tests run the command itself."""

import json
import os
import subprocess
import sys

import pytest
import torch

from benchmark import controls, harness

ROOT = harness.ROOT
SMALL = {"ramp-f32-lz4.64mib": (6 << 20) + 4096 * 4, "signal-f64-zstd.64mb": 6_000_000,
         "ramp-f32-lz4.1mib": 1 << 20}
CPU = torch.device("cpu")


# a traffic mix kept under traffic/ with no cell of BENCHMARK.json yet, run
# here with its configuration so that the check stays proven on it
KEPT = {"ramp-f32-lz4.64mib": ("ramp-f32-lz4.1mib", "roundtrip.64mib")}


def _cell(cell_name):
    if cell_name not in KEPT:
        return harness.load_cell(cell_name)
    sibling, traffic = KEPT[cell_name]
    cell = harness.load_cell(sibling)
    with open(os.path.join(ROOT, "benchmark", "traffic", traffic + ".json")) as f:
        cell.traffic = json.load(f)
    cell.name = cell_name
    return cell


def _run(cell_name, seed, ctrl=()):
    cell = _cell(cell_name)
    cell.traffic["tensor_bytes"] = SMALL[cell_name]
    return harness.execute(cell, seed, 0.2, False, CPU, 0.0, ctrl)


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_sound_runs_are_correct(cell):
    for seed in (3, 2**31 + 5):
        out = _run(cell, seed)
        assert out["correct"], out["checks"]
        assert all(v == 0 for v, _ in out["checks"].values())
        assert out["judged"]["sampled"] > 0 and out["failed"] == 0


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_the_control_is_not_correct(cell):
    out = _run(cell, 11, (controls.CONTROL,))
    assert not out["correct"]
    assert out["checks"]["frame_bad_bytes"][0] > 0 and out["checks"]["decoded_bad_bytes"][0] > 0


@pytest.mark.parametrize("fault", sorted(controls.FAULTS))
@pytest.mark.parametrize("cell", sorted(SMALL))
def test_every_fault_is_not_correct(cell, fault):
    out = _run(cell, 12, (controls.FAULTS[fault],))
    assert not out["correct"], (fault, out["checks"])


def test_faults_are_undone_after_the_window():
    import tpu_blosc_torch.device as device
    import tpu_blosc_torch.filters as filters

    before = (filters.filter_blocks, filters.unfilter_blocks, device.host_decode,
              device.compress_with_options, device._compress_array_stage2,
              device._decompress_array_devfilter)
    for fault in controls.FAULTS.values():
        _run("ramp-f32-lz4.1mib", 13, (fault,))
    assert before == (filters.filter_blocks, filters.unfilter_blocks, device.host_decode,
                      device.compress_with_options, device._compress_array_stage2,
                      device._decompress_array_devfilter)


def _command(cwd, *args):
    return subprocess.run([sys.executable, "benchmark/run.py", *args], cwd=cwd,
                          capture_output=True, text=True, timeout=300)


def _no_result(proc):
    return not any(line.startswith("{") for line in proc.stdout.splitlines())


def test_without_a_card_the_command_exits_nonzero_with_no_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = _command(ROOT, "--workload", "ramp-f32-lz4.1mib", "--seed", "1", "--seconds", "1")
    assert proc.returncode == 2 and _no_result(proc)


def test_without_the_program_the_command_exits_nonzero_with_no_result(tmp_path):
    import shutil

    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    proc = _command(tmp_path, "--workload", "ramp-f32-lz4.1mib", "--seed", "1",
                    "--seconds", "1")
    assert proc.returncode != 0 and _no_result(proc)


@pytest.mark.card
@pytest.mark.parametrize("trace", ["0", "1"])
def test_the_command_on_the_card(card, trace):
    proc = _command(ROOT, "--workload", "ramp-f32-lz4.1mib", "--seed", str(2**31 + 99),
                    "--seconds", "2", "--trace", trace)
    assert proc.returncode == 0, proc.stderr[-2000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
    assert list(result)[-1] == "checks"
    assert proc.stderr.strip().splitlines()[-1].startswith("check ")


@pytest.mark.card
def test_the_control_on_the_card(card):
    proc = subprocess.run([sys.executable, "benchmark/control.py", "--workload",
                           "ramp-f32-lz4.1mib", "--seconds", "1", "--seeds", "1,2",
                           "--control-seeds", "3", "--faults"],
                          cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1])["holds"]

#!/usr/bin/env python3
"""The readings that the check's limits are set from, for one cell, in one process.

Run from the root of a checkout, on a machine with the cell's devices:

    python3 benchmark/control.py --workload <cell> --seconds 3 \\
        --seeds 11,12,13 --control-seeds 21,22,23 [--faults]

Each seed is one run of the cell as ``run.py`` makes it, with a window
of ``--seconds``: ``--seeds`` as it is, ``--control-seeds`` with the
control in the timed path's place (``controls.py``) and, with
``--faults``, each planted fault on the control seeds.  One line a run
(its numbers compared and ``correct``; a run that crashes gives no
number and is not correct), then one JSON line: the largest
reading of each number over the sound runs (the lower reading), the
smallest over the control's and each fault's runs, and whether every
sound run and no other was correct.  The benchmark's own runs never run
this.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _seeds(text: str) -> list:
    return [int(s) for s in text.split(",") if s]


def readings(cell, device, seconds: float, seeds: list, controls, label: str) -> dict:
    from benchmark import harness

    worst: dict = {}
    correct = []
    for seed in seeds:
        try:
            out = harness.execute(cell, seed, seconds, False, device, time.perf_counter(),
                                  controls)
        except Exception as err:  # a run that crashes gives no number and is not correct
            print(f"{label} seed {seed}: crashed: {err!r}", flush=True)
            correct.append(False)
            continue
        values = {k: v for k, (v, _) in out["checks"].items()}
        correct.append(out["correct"])
        print(f"{label} seed {seed}: correct {out['correct']}, {values}, "
              f"{out['judged']}, attempted {out['attempted']}", flush=True)
        for k, v in values.items():
            worst[k] = v if k not in worst else (max if label == "sound" else min)(worst[k], v)
    return {"readings": worst, "correct": correct}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", required=True)
    p.add_argument("--faults", action="store_true")
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from benchmark import controls, harness

    cell = harness.load_cell(args.workload, ROOT)
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    summary = {"workload": cell.name,
               "sound": readings(cell, device, args.seconds, _seeds(args.seeds), (), "sound"),
               "control": readings(cell, device, args.seconds, _seeds(args.control_seeds),
                                   (controls.CONTROL,), "control")}
    if args.faults:
        summary["faults"] = {name: readings(cell, device, args.seconds,
                                            _seeds(args.control_seeds), (fault,), name)
                             for name, fault in controls.FAULTS.items()}
    others = [summary["control"]] + list(summary.get("faults", {}).values())
    summary["holds"] = all(summary["sound"]["correct"]) and not any(
        c for o in others for c in o["correct"])
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Readings that the limits of ``correct`` are set from, for one cell on
the card at its own size: the compared numbers of sound runs of the
program, and of the control (the program with its outputs in bfloat16),
each on the requests a run of that seed compares.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,... --control-seeds 7,8,9

Prints one JSON line a request, then a summary line with the largest sound
reading and the smallest control reading of each number.  The benchmark's
own runs do not run it.
"""

import argparse
import contextlib
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark.harness import runner  # noqa: E402


def readings(workload, seeds, control_seeds, device="cuda", overrides=None):
    """A dict a compared request: seed, request, kind ("sound" or
    "control") and the compared numbers."""
    import torch

    cell, config, traffic, _ = runner.load_cell(workload)
    if overrides:
        config = {**config, **overrides.get("config", {})}
        traffic = {**traffic, **overrides.get("traffic", {})}
    rows = []
    with open(os.devnull, "w") as quiet, contextlib.redirect_stdout(quiet):
        for n, seed in enumerate(sorted(set(seeds) | set(control_seeds))):
            run = runner.Cell(config, traffic, seed, device, torch)
            if n == 0:
                run.request(-1)  # warm-up
            for i in run.samples:
                for control in (False, True):
                    if seed not in (control_seeds if control else seeds):
                        continue
                    got = run.request(i, control=control)[0].cpu()
                    if device != "cpu":
                        torch.cuda.empty_cache()
                    nums = run.numbers(i, got)
                    rows.append({"seed": seed, "request": i,
                                 "kind": "control" if control else "sound", **nums})
                    print(json.dumps(rows[-1]), file=sys.stderr, flush=True)
    return rows


def summary(rows):
    keys = sorted({k for r in rows for k, v in r.items()
                   if k.endswith("_gap") and isinstance(v, float)})
    out = {}
    for key in keys:
        sound = [r[key] for r in rows if r["kind"] == "sound"]
        control = [r[key] for r in rows if r["kind"] == "control"]
        out[key] = {"sound_max": max(sound) if sound else None,
                    "control_min": min(control) if control else None,
                    "sound_n": len(sound), "control_n": len(control)}
    return out


def _ints(text):
    return [int(x) for x in text.split(",") if x]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    args = ap.parse_args()
    rows = readings(args.workload, _ints(args.seeds), _ints(args.control_seeds))
    print(json.dumps({"workload": args.workload, "summary": summary(rows)}), flush=True)


if __name__ == "__main__":
    main()

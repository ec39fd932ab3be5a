"""Readings that set a cell's limits: the program's numbers over many
seeds and the control's (the reference in a lower precision, in the
program's place, on the same blocks), at the cell's own size and load.

    python3 -m sdrbench.calibrate --workload wbfm8.batch \\
        --seeds 1,2,3 --seconds 3 [--out FILE]

One process: the program is built once and driven for ``--seconds`` on
each seed's capture, as a run drives it.  Prints one JSON line a seed
and a summary (the largest program reading and the smallest control
reading of each number); ``--out`` writes them all.  The benchmark's
own runs never run this.
"""

import argparse
import json
import sys
import time

from sdrbench import run as _run  # noqa: F401  (fixes the caches)

# the configurations state float32 contractions with TF32 off: the
# control is the reference in TF32
CONTROL = "tf32"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out")
    args = ap.parse_args(argv)

    import torch

    from sdrbench import harness

    if args.device == "cuda" and not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    cfg = cell["config"]
    system = harness.module("systems", cfg["system"]).System(cfg,
                                                             args.device)
    rows = []
    for seed in [int(s) for s in args.seeds.split(",")]:
        t0 = time.perf_counter()
        run, sample, nb, host = harness.measure(
            cell, seed, args.seconds, False, args.device, t0, system=system)
        row = {"seed": seed, "blocks": run.blocks}
        for side, control in (("program", None), ("control", CONTROL)):
            row[side] = {n: d["value"] for n, d in harness.check(
                cell, sample, nb, host, args.device,
                control=control)["numbers"].items()}
        print(json.dumps(row), flush=True)
        rows.append(row)
        del run, sample, host
    names = rows[0]["program"]
    summary = {"workload": args.workload, "seeds": len(rows),
               "program_max": {n: max(r["program"][n] for r in rows)
                               for n in names},
               "control_min": {n: min(r["control"][n] for r in rows)
                               for n in names}}
    print(json.dumps(summary), flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump({"rows": rows, "summary": summary}, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())

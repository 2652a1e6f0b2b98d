"""The readings a cell's ``logit_gap`` limit is set from, on the card:
the program's gap on many seeds, and the fp8 control's gap on some.

    python3 perfbench/calibrate.py --workload <cell> --first <seed>
        --seeds 12 --control 3 --seconds <s>

Runs the cell's whole path once per seed in one process (a short window
at the cell's own load, long enough to finish the requests the check
compares), each time with freshly drawn weights, and prints one JSON line
per seed: ``correct``, the program's ``logit_gap`` and every other
comparison.  On the first ``--control`` seeds the fp8 control is put in
the program's place for the comparison, through the harness's own
``correct`` at the cell's limit: the line's ``correct`` and
``logit_gap`` are then the control's, and ``served_gap`` the program's.
The benchmark's own runs never run the control.
"""
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--first", type=int, required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    from perfbench import harness, peaks, run, spec
    run._environment()
    import torch
    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        print("calibrate.py: needs a CUDA card", file=sys.stderr)
        return 3
    cell = spec.cell(args.workload)
    card = torch.cuda.get_device_name(0)
    for i in range(args.seeds):
        seed = args.first + i
        t0 = time.perf_counter()
        res = harness.execute(cell, seed, args.seconds, False, "cuda:0", t0,
                              card, peaks.peaks(card),
                              control=i < args.control)
        line = {"seed": seed, "s": time.perf_counter() - t0,
                "control": i < args.control, "correct": res["correct"],
                **{k: v["value"] for k, v in res["checks"].items()}}
        if i < args.control:
            line["served_gap"] = res["served_gap"]
        print(json.dumps(line), flush=True)
        del res
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

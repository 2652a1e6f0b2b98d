"""The highest rate a cell's configuration sustains, found once by a
sweep on the card: the cell's mix offered as an open loop of whole waves
(``max_batch`` requests together, at a fixed period) at several rates.

    python3 perfbench/sweep.py --workload <cell> --seed <n>
        --seconds <s> --rates <waves per second> ...

Prints one JSON line per rate: offered and completed tokens per second
and the first-token and gap tails.  A rate the engine sustains completes
what it is offered, and its first-token tail holds no queue.  The cells'
own runs never sweep: their load is fixed in their mix.
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
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    from perfbench import harness, peaks, run, spec
    run._environment()
    import torch
    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        print("sweep.py: needs a CUDA card", file=sys.stderr)
        return 3
    card = torch.cuda.get_device_name(0)
    for i, rate in enumerate(args.rates):
        cell = spec.cell(args.workload)
        mix = cell.traffic
        cell.traffic = {**mix, "loop": "open", "rate_per_s": rate,
                        "burst": mix["max_batch"]}
        res = harness.execute(cell, args.seed + i, args.seconds, False,
                              "cuda:0", time.perf_counter(), card,
                              peaks.peaks(card))
        m = {k: v["value"] for k, v in res["metrics"].items()}
        offered = rate * mix["max_batch"] * mix["new_tokens"]
        print(json.dumps({"waves_per_s": rate,
                          "offered_tokens_per_s": offered,
                          "correct": res["correct"],
                          "attempted": res["attempted"], **m}), flush=True)
        del res                 # the engine's wrappers hold it in a cycle
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Run one cell of the benchmark on one NVIDIA card and print its result.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

From the root of a checkout.  ``--trace 0`` prints the cell's end-to-end
metrics, ``--trace 1`` its per-layer metrics from a traced run.  The last
line of standard output is the result object (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` ``breakdown``,
and last ``checks``: each number compared with its limit); the last lines
of standard error repeat the comparisons.  Exits non-zero, printing no
result, without a CUDA card, without the program beside ``perfbench/``
(``src/repro_torch``), or if the JAX package or JAX was loaded.  Build
and kernel caches live under ``build/`` in the checkout.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _environment() -> None:
    """Every build and kernel cache at a fixed path inside the checkout,
    and one host thread for the CPU's own kernels: the host's work here
    is launching the card's, and idle worker threads only add noise."""
    os.environ["OMP_NUM_THREADS"] = "1"
    build = ROOT / "build"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(build / sub)


def loaded_forbidden(modules=None) -> list:
    """Modules of JAX or of the JAX package in ``modules`` (this
    process's), by top-level name taken whole."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    from perfbench import spec
    bench = spec.benchmark(ROOT)
    cell = spec.cell(args.workload, bench, ROOT)
    chips = {w["name"]: w["chips"] for w in bench["workloads"]}[cell.name]
    import torch
    torch.set_num_threads(1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"run.py: {cell.name} needs {chips} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}",
              file=sys.stderr)
        return 3
    from perfbench import harness, peaks
    card = torch.cuda.get_device_name(0)
    cell.power_limit = peaks.power_limit()
    result = harness.execute(cell, args.seed, args.seconds, bool(args.trace),
                             "cuda:0", T_START, card, peaks.peaks(card))
    bad = loaded_forbidden()
    if bad:
        print(f"run.py: the process loaded {bad}: the benchmark runs the "
              f"PyTorch port alone", file=sys.stderr)
        return 4
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

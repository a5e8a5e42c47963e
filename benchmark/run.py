"""Run one cell of the benchmark of ``sda_tpu_torch`` on the attached card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The last line of standard output is one JSON
object (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` ``breakdown``, and last ``checks``); the last lines of
standard error give each number compared with the reference beside its
limit. With ``--trace 0`` the metrics are the cell's end-to-end metrics,
with ``--trace 1`` its per-layer metrics, read from a few traced rounds.

The run exits with another code than 0, and prints no result, when there
is no CUDA card or fewer cards than the cell asks for, or when JAX or the
JAX package has been loaded into this process.
"""

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# every cache a build or a kernel compile could write stays in the checkout,
# at fixed paths, so that only the first run of a cell there builds
for _var, _dir in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                   ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[_var] = str(ROOT / "build" / _dir)
sys.path.insert(0, str(ROOT))

FORBIDDEN = {"jax", "jaxlib", "flax", "sda_tpu"}
# host cores a run keeps to: the recipient's loop is one Python thread, and
# the card's driver threads take the other
HOST_CORES = 2


def pin_host() -> list[int]:
    """Hold this process, and the threads it starts, to the last
    ``HOST_CORES`` cores it may use; returns them."""
    cores = sorted(os.sched_getaffinity(0))[-HOST_CORES:]
    os.sched_setaffinity(0, cores)
    return cores


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is JAX's,
    its libraries' or the JAX package's, compared whole."""
    return sorted({name.split(".")[0] for name in sys.modules} & FORBIDDEN)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    import torch

    from benchmark.core import driver, spec, trace

    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    if cell.chips != 1:
        print(f"{cell.name}: only one-card cells are driven", file=sys.stderr)
        return 2
    cores = pin_host()
    torch.set_num_threads(len(cores))
    try:
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        card = f"nvidia-smi not read: {exc!r}"
    print(f"card: {card}; host cores {cores}", file=sys.stderr, flush=True)
    try:
        result, checks = driver.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                                         torch.device("cuda", 0), t0=_T0)
    except trace.TraceRefused as exc:
        print(f"refused: {exc}", file=sys.stderr)
        return 4
    found = forbidden_modules()
    if found:
        print(f"refused: the process loaded {', '.join(found)}", file=sys.stderr)
        return 3
    emit(result, checks)
    return 0


def emit(result: dict, checks: dict, out=None, err=None):
    """The result as the last line of ``out`` and each number compared with
    the reference, beside its limit, as the last lines of ``err``."""
    out, err = out or sys.stdout, err or sys.stderr
    print(json.dumps(result), file=out, flush=True)
    for name, c in checks.items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=err)
    err.flush()


if __name__ == "__main__":
    sys.exit(main())

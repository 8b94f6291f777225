"""Run one cell of the benchmark once and print its result line.

    python3 hopbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with the card(s) the cell asks
for. The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1`` also
``breakdown``, and last ``checks``: each number compared with its limit);
the checks are also the last lines on standard error. Without a card, or
with fewer cards than the cell asks for, it exits with code 3 and prints
no result; with JAX or the JAX package loaded once the window has closed,
with code 4.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "hopbench" / "_cache"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    # every kernel cache at a fixed path inside the checkout
    os.environ.setdefault("TRITON_CACHE_DIR", str(CACHE / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(CACHE / "torch_extensions"))
    os.environ.setdefault("USE_FLAX", "0")
    sys.path[0] = str(ROOT)

    import torch

    from hopbench import harness

    cell = harness.resolve(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"error: cell {cell.name} needs {cell.chips} CUDA device(s), found {found}", file=sys.stderr)
        return 3
    torch.set_num_threads(min(4, torch.get_num_threads()))
    out = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace), t_start=T_START)
    bad = harness.forbidden_modules()
    if bad:
        print(f"error: JAX or the JAX package is loaded: {bad}", file=sys.stderr)
        return 4
    print(out["checks_text"], file=sys.stderr)
    print(json.dumps(out["result"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Run one cell of the port's benchmark once.

    python -m vqabench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Needs as many CUDA devices as the cell asks for, else exits 2 with no
result. The last line of standard output is the result, one JSON object;
the last lines of standard error are the check's numbers beside their
limits. A run that finds JAX, or the JAX package, loaded once it is done
exits 3 with no result.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=[0, 1], default=0)
    args = ap.parse_args(argv)

    import torch

    from vqabench import guard, harness

    cell = harness.cell(harness.load_benchmark(), args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    harness.fix_caches()
    result = harness.execute(cell, args.seed, args.seconds, bool(args.trace),
                             torch.device("cuda", 0), T0)
    found = guard.forbidden_loaded()
    if found:
        print(f"loaded, and not allowed in a run: {', '.join(found)}", file=sys.stderr)
        return 3
    sys.stdout.flush()
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

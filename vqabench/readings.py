"""The check's numbers over many seeds in one process, and of the controls:
the readings that each cell's limits are set from.

    python -m vqabench.readings --workload <name> --seeds 1,2,3 \\
        [--controls int4_tower,fp8_head --control_seeds 1,2,3] [--seconds 2] \\
        [--leaves] [--fault half_batch]

One JSON line a seed: the program's numbers after a window of
``--seconds``, and, on the control seeds, each control's numbers (the
reference at the precision below the configuration's, put in the
program's place). ``--leaves`` adds a training cell's norms leaf by leaf;
``--fault`` plants one of ``vqabench.faults`` in the program. The
benchmark's runs never run a control or a fault.
"""

import argparse
import json
import sys


def detail(outputs: dict, reference: dict) -> dict:
    """A training cell's numbers leaf by leaf: [program's first gradient
    norm, reference's, program's change norm, reference's, the first
    gradients' difference over the reference's norm], and both sides' losses."""
    from vqabench import judge
    return {"leaves": {k: [outputs["grad"].get(k), v, outputs["change"][k],
                           reference["change"][k],
                           judge.diff(outputs["first"].get(k), reference["first"][k])]
                       for k, v in reference["grad"].items()},
            "loss": [outputs["loss"], reference["loss"]]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--controls", default="")
    ap.add_argument("--control_seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--leaves", action="store_true")
    ap.add_argument("--fault", default="")
    args = ap.parse_args(argv)

    import torch

    from vqabench import faults, harness
    from vqabench.reference import steps as ref_steps

    if args.fault:
        getattr(faults, args.fault)(setattr)

    bench = harness.load_benchmark()
    c = harness.cell(bench, args.workload, limits={})
    harness.fix_caches()
    device = torch.device("cuda", 0)
    controls = tuple(n for n in args.controls.split(",") if n)
    control_seeds = {int(s) for s in args.control_seeds.split(",") if s}
    for seed in (int(v) for v in args.seeds.split(",")):
        loop = harness.load_module("traffic", c.traffic["loop"]).Loop(c, seed, device)
        loop.setup()
        loop.window(args.seconds)
        loop.release()
        reference = loop.reference()
        out = {"workload": args.workload, "seed": seed, "fault": args.fault,
               "program": loop.numbers(loop.outputs, reference)}
        leaves = args.leaves and loop.kind == "train"
        if leaves:
            out["program_detail"] = detail(loop.outputs, reference)
        for name in controls if seed in control_seeds else ():
            outputs = loop.control_outputs(ref_steps.CONTROLS[name])
            out[name] = loop.numbers(outputs, reference)
            if leaves:
                out[f"{name}_detail"] = detail(outputs, reference)
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

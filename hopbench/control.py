"""The control: the reference one precision step below the configuration,
put in the program's place, and an answer altered where it is produced.

    python3 hopbench/control.py --workload <cell> --seeds 11,12,13

For each seed it builds the cell's set-up as a run does (the program, the
seeded weights and inputs), makes the checked calls a run makes, then
reads each number that decides ``correct`` three ways, each against the
reference:

- ``program``: the program's own outputs (the lower readings);
- ``control``: the reference in ``mode="control"`` (fp8 conv operands for
  the bfloat16 conv stacks, TF32 products for the float32 lookups and
  prior), which has to come out as not correct; for drawn levels, the
  level the control puts first at each position of the program's grid;
- ``altered``: the program's answer with one item altered (the last image
  of a call negated, or one drawn level moved up by one).

It prints one JSON line for each seed.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

if __name__ == "__main__":
    sys.path[0] = str(Path(__file__).resolve().parents[1])

import numpy as np
import torch

from hopbench import checks, harness
from hopbench.reference.model import Model, exact_f32, stated_mode


def readings(name: str, seed: int, device=None, config_overrides=None, traffic_overrides=None, calls: int = 0) -> dict:
    """``{"program": numbers, "control": numbers, "altered": numbers}`` for
    one seed. ``calls``: calls to make after set-up, as a window does,
    before the checked ones."""
    device = torch.device("cuda" if device is None else device)
    cell = harness.resolve(name, config_overrides=config_overrides, traffic_overrides=traffic_overrides)
    session = harness.load_driver(cell.traffic["kind"]).Session(cell, seed, device)
    kind = cell.traffic["kind"]
    for _ in range(max(calls, 1)):
        session._call()
    if hasattr(session, "after_window"):
        session.after_window()
    session.release()
    harness.release(torch, device)
    out = {"program": session.check()}
    cfg, stated = session.cfg, stated_mode(cell.precision)
    models = {m: Model(cfg, session.state, m) for m in ("reference", stated, "control")}
    with torch.no_grad(), exact_f32():
        if kind == "recon":
            images = {m: [model.forward(session.inputs(at))[0].cpu() for at, _ in session.kept.items]
                      for m, model in models.items()}
            altered = [torch.from_numpy(np.asarray(y)).clone() for _, y in session.kept.items]
            altered[0][-1] = -altered[0][-1]
            out["control"] = checks.image_numbers("recon", images["control"], images["reference"], images[stated])
            out["altered"] = checks.image_numbers("recon", altered, images["reference"], images[stated])
        elif kind == "sample":
            gap = {"control": 0.0, "altered": 0.0}
            for stream, grid, _ in session.checked:
                grid, noise = grid.to(device).float(), session.scores_noise(stream)
                logits = models["reference"].pixelcnn_logits(grid)
                first = (models["control"].pixelcnn_logits(grid) + noise).argmax(-1).float()
                moved = grid.clone()
                moved[0, 0, 0, 0] = (moved[0, 0, 0, 0] + 1) % cfg.num_levels
                gap["control"] = max(gap["control"], checks.logit_gap(logits, noise, first))
                gap["altered"] = max(gap["altered"], checks.logit_gap(logits, noise, moved))
            images = {m: [model.decode_grid(grid.to(device).float()).cpu() for _, grid, _ in session.checked]
                      for m, model in models.items()}
            out["control"] = {"logit_gap": gap["control"],
                              **checks.image_numbers("decode", images["control"], images["reference"], images[stated])}
            out["altered"] = {**out["program"], "logit_gap": gap["altered"]}
        else:
            raise ValueError(f"no control for traffic kind {kind!r}")
    return out


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description="the control's and an altered answer's readings of a cell")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True, help="comma-separated seeds")
    parser.add_argument("--calls", type=int, default=0, help="calls after set-up, before the checked ones")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("error: the control runs on the card", file=sys.stderr)
        return 3
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        r = readings(args.workload, seed, calls=args.calls)
        print(json.dumps({"cell": args.workload, "seed": seed, "seconds": round(time.perf_counter() - t0, 1), **r}),
              flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

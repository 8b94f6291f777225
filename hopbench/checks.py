"""The numbers that decide ``correct``, each held to the limit of its cell.

A cell's limits sit in ``limits/<cell>.json`` (``{"name": limit}``): the
numbers it compares, each correct when it is finite and at most its
limit; the other numbers read are printed beside them. The readings each
limit was set from are in PERF.md.

- Answers (reconstructions, decoded samples): ``*_err``, the checked
  images' L2 distance to the reference's over the reference's L2 norm, and
  ``*_ratio``, that distance over the one the stated precisions give (the
  reference with its conv stacks in bfloat16, ``mode="stated"``).
- Drawn levels: ``logit_gap``, the widest gap by which a drawn level's
  reference score (its logit plus the noise it was drawn with) lies below
  the best reference score at that position.
"""

from __future__ import annotations

import json
import math
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent


def limits(cell: str, root: Path = HERE.parent) -> dict:
    path = root / "hopbench" / "limits" / f"{cell}.json"
    if not path.exists():
        raise FileNotFoundError(f"no limits for cell {cell!r}: {path}")
    return json.loads(path.read_text())


def image_err(program, reference) -> float:
    """The relative L2 distance over all the images (arrays or tensors of
    one shape, or lists of them); a shape mismatch or a non-finite value
    reads infinite."""
    if isinstance(program, (list, tuple)):
        if len(program) != len(reference) or not program:
            return math.inf
        program, reference = torch.cat([torch.as_tensor(p).reshape(-1) for p in program]), \
            torch.cat([torch.as_tensor(r).reshape(-1) for r in reference])
    program, reference = torch.as_tensor(program), torch.as_tensor(reference)
    if tuple(program.shape) != tuple(reference.shape):
        return math.inf
    p, r = program.double().reshape(-1), reference.double().reshape(-1)
    err = float(torch.linalg.vector_norm(p - r) / torch.linalg.vector_norm(r).clamp(min=1e-30))
    return err if math.isfinite(err) else math.inf


def image_numbers(name: str, program: list, reference: list, stated: list) -> dict:
    """``<name>_err`` (the program's images against the reference's) and
    ``<name>_ratio`` (that over the stated precisions' own distance)."""
    err, rounding = image_err(program, reference), image_err(stated, reference)
    return {f"{name}_err": err, f"{name}_ratio": err / max(rounding, 1e-30), f"stated_{name}_err": rounding}


def logit_gap(logits: torch.Tensor, noise: torch.Tensor, levels: torch.Tensor) -> float:
    """The widest gap between the best reference score and the drawn
    level's, over every position and channel; a score is a logit plus the
    noise the level was drawn with. ``logits`` and ``noise`` ``(..., L)``,
    ``levels`` ``(...)`` of whole levels."""
    idx = levels.round().long()
    if idx.min() < 0 or idx.max() >= logits.shape[-1] or (levels - idx).abs().max() > 0:
        return math.inf
    scores = logits + noise
    drawn = torch.gather(scores, -1, idx[..., None])[..., 0]
    return float((scores.amax(-1) - drawn).max())


def judge(numbers: dict, cell_limits: dict) -> tuple[bool, dict]:
    """``(correct, {name: {"value", "limit"}})`` over the numbers the limits
    name; a limit without its number is not correct."""
    out, ok = {}, bool(cell_limits)
    for name in sorted(cell_limits):
        value, limit = numbers.get(name, math.nan), cell_limits[name]
        out[name] = {"value": value, "limit": limit}
        ok = ok and math.isfinite(value) and value <= limit
    return ok, out

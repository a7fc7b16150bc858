#!/usr/bin/env python3
"""Is S²FL training on the card bitwise repeatable, and how far does a
resumed run land from a straight one? (One NVIDIA card; run from the
repo root.)

    python3 tools/card_repeatability.py

Prints one JSON line per measurement and nvidia-smi's name and power
limit:

* ``repeat``: chip_smoke.py's 2-round vgg16 run (fp32, and int8 with
  error feedback), twice each with cuDNN's default algorithms and twice
  with ``torch.backends.cudnn.deterministic = True``, which this script
  sets for its own runs only (the port never sets it): the number of
  param values that differ between the two runs and the largest
  difference.
* ``resume``: chip_smoke.py's ``train_service`` run (vgg16, 3 rounds,
  int8 + EF, churn, a snapshot a round), straight 4 times and resumed 4
  times from the first straight run's round-1 snapshot: the largest
  param difference of each pair of straight runs, of each resumed run
  against the first straight run, and of each pair of resumed runs.
"""
from __future__ import annotations

import itertools
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("card_repeatability: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as cs
    from repro_torch.utils.device import resolve_device
    from repro_torch.utils.tree import tree_leaves
    resolve_device("cuda")

    def max_diff(x, y):
        return max(float(np.abs(a.astype(np.float64)
                                - b.astype(np.float64)).max())
                   for a, b in zip(x, y))

    with tempfile.TemporaryDirectory() as d:
        tmp = Path(d)

        def train(tag, extra):
            with cs.Capture() as cap:
                cs.run_train([*cs.VGG, "--device", "cuda", *extra], tmp, tag)
            return [p.detach().cpu().numpy()
                    for p in tree_leaves(cap.engines[-1].params)]

        for name, extra in (("fp32", []),
                            ("int8_ef", ["--codec", "int8",
                                         "--error-feedback"])):
            for det in (False, True):
                torch.backends.cudnn.deterministic = det
                a, b = (train(f"{name}{det}{i}", extra) for i in range(2))
                cs.emit("repeat", run=name, cudnn_deterministic=det,
                        values_differing=int(sum((x != y).sum()
                                                 for x, y in zip(a, b))),
                        max_param_diff=max_diff(a, b))
        torch.backends.cudnn.deterministic = False

        def service(tag, extra=()):
            ck = tmp / tag
            cs.run_train([*cs.VGG, "--device", "cuda", *cs.SERVICE,
                          "--checkpoint-dir", str(ck), *extra], tmp, tag)
            return list(cs._params_of(ck / "round00003.npz").values())

        straight = [service(f"s{i}") for i in range(4)]
        snap = str(tmp / "s0" / "round00001.npz")
        resumed = [service(f"r{i}", ["--resume-from", snap])
                   for i in range(4)]
        pairs = list(itertools.combinations(range(4), 2))
        cs.emit("resume", args=cs.SERVICE,
                straight_pairs=[max_diff(straight[i], straight[j])
                                for i, j in pairs],
                resumed_vs_first=[max_diff(r, straight[0])
                                  for r in resumed],
                resumed_pairs=[max_diff(resumed[i], resumed[j])
                               for i, j in pairs])
    print(cs.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Quickstart: one S²FL round, spelled out with the public API.

  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
import argparse

from repro_torch.configs import get_config
from repro_torch.core.balance import greedy_groups, label_histogram
from repro_torch.core.engine import EngineConfig, S2FLEngine
from repro_torch.core.split import default_plan
from repro_torch.data.partition import federate
from repro_torch.data.synthetic import make_image_dataset
from repro_torch.models import SplitModel


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    # 1. a model the paper used, as a sequential unit stack
    model = SplitModel(get_config("resnet8"))
    plan = default_plan(model.n_units, k=3)
    print(f"ResNet8: {model.n_units} units, split points {plan.split_points}")

    # 2. non-IID federated data (Dirichlet alpha = 0.3, 10 devices)
    data = make_image_dataset(1500, seed=0)
    fed = federate(data, 10, alpha=0.3, seed=0)
    hists = [label_histogram(fed[c]["y"], 10) for c in sorted(fed)]
    print("per-device label histograms (first 3):")
    for h in hists[:3]:
        print("  ", h.astype(int))

    # 3. the data-balance mechanism groups complementary devices (Eq. 2)
    groups = greedy_groups(hists, group_size=2)
    print("balance groups:", groups)

    # 4. run five S²FL rounds (sliding split + balance + Alg. 1 aggregation)
    engine = S2FLEngine(model, fed, EngineConfig(
        mode="s2fl", rounds=5, clients_per_round=6, batch_size=16,
        group_size=2, lr=0.05), device=args.device)
    test = make_image_dataset(300, seed=9)
    print("initial:", engine.evaluate(test))
    engine.run()
    print("after 5 rounds:", engine.evaluate(test))
    print(f"simulated wall clock: {engine.clock:.1f}s, "
          f"comm: {engine.comm:.3e} bytes")
    return engine


if __name__ == "__main__":
    main()

"""Split-federated LM training: S²FL over a reduced assigned architecture
on domain-skewed synthetic token data — shows the paper's mechanism is
model-agnostic (the 'label' driving Eq.-2 balance is the domain id).

  PYTHONPATH=src python -m repro_torch.examples.federated_lm \
      --arch internlm2-1.8b [--device cpu]
"""
import argparse

from repro_torch.configs import get_config, make_reduced
from repro_torch.core.engine import EngineConfig, S2FLEngine
from repro_torch.data.partition import federate
from repro_torch.data.synthetic import make_lm_dataset
from repro_torch.models import SplitModel


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--seq-len", type=int, default=48)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    cfg = make_reduced(get_config(args.arch))
    vocab = min(cfg.vocab_size, 256)
    train = make_lm_dataset(800, seq_len=args.seq_len, vocab=vocab, seed=0)
    test = make_lm_dataset(200, seq_len=args.seq_len, vocab=vocab, seed=9)
    fed = federate(train, 8, alpha=0.3, seed=0)

    model = SplitModel(cfg)
    eng = S2FLEngine(model, fed, EngineConfig(
        mode="s2fl", rounds=args.rounds, clients_per_round=4,
        batch_size=16, group_size=2, lr=0.05), device=args.device)
    print("initial:", eng.evaluate(test))
    eng.run(eval_data=test, eval_every=max(args.rounds // 4, 1),
            verbose=True)
    print("final:", eng.evaluate(test))
    print(f"split plan: {eng.plan.split_points} over {cfg.n_layers} blocks")
    return eng


if __name__ == "__main__":
    main()

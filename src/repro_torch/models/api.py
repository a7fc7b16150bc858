"""SplitModel — the uniform protocol the S²FL core consumes.

A model is a sequence of *units* plus an output head. A split index
``s`` places ``units[:s]`` on the client and ``units[s:] + head`` on the
server; the tensor crossing the cut is the paper's intermediate feature
``fx``.

Both forward halves take the FULL parameter tree (the other half's
leaves simply receive no gradient) — portion sizes / upload costs are
accounted by ``repro_torch.utils.flops`` from the segment map, and
Algorithm-1 aggregation operates on segments. Only the CNN families are
ported; the LM families raise.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import CNNConfig
from repro_torch.models import cnn as cnn_mod
from repro_torch.utils.tree import get_subtree  # noqa: F401 (re-export)

_LM = "LM families: slice 2"


class SplitModel:
    def __init__(self, cfg):
        if not (isinstance(cfg, CNNConfig) or cfg.arch_type == "cnn"):
            raise NotImplementedError(_LM)
        self.cfg = cfg
        self.is_cnn = True

    # -- parameters ---------------------------------------------------------
    def defs(self):
        return cnn_mod.cnn_defs(self.cfg)

    def init(self, seed: int, *, device):
        return cnn_mod.init_cnn(self.cfg, seed, device=device)

    # -- structure ----------------------------------------------------------
    @property
    def n_units(self) -> int:
        return cnn_mod.cnn_n_units(self.cfg)

    def segments(self):
        """Ordered (name, path) segment map over the param tree.
        Paths index into the params dict."""
        segs = [(f"unit:{i}", ("units", i)) for i in range(self.n_units)]
        segs.append(("head", ("head",)))
        return segs

    def client_segments(self, split: int):
        """Segment names trained on the client for split s."""
        return {f"unit:{i}" for i in range(split)}

    # -- forward halves -----------------------------------------------------
    def client_forward(self, params, batch, split: int, train: bool = True):
        """Returns features dict {'h': NHWC tensor, 'aux': scalar}."""
        x = batch["x"]
        h = cnn_mod.cnn_apply_range(self.cfg, params, x, 0, split)
        return {"h": h, "aux": torch.zeros((), dtype=torch.float32,
                                           device=x.device)}

    def server_loss(self, params, feats, batch, split: int,
                    train: bool = True):
        """CE(+aux) from the cut to the loss. Returns (loss, metrics)."""
        h = cnn_mod.cnn_apply_range(self.cfg, params, feats["h"], split,
                                    self.n_units)
        logits = cnn_mod.cnn_head(self.cfg, params, h)
        ce, acc = cnn_mod.ce_and_acc(logits, batch["y"], self.cfg.n_classes)
        return ce + feats["aux"], {"ce": ce, "acc": acc}

    def full_loss(self, params, batch, train: bool = True):
        """Monolithic loss (FedAvg baseline / sanity oracle)."""
        return cnn_mod.cnn_loss(self.cfg, params, batch)

    # -- inference (LM only) -------------------------------------------------
    def prefill(self, params, tokens, max_len, prefix=None):
        raise NotImplementedError(_LM)

    def decode_step(self, params, token, caches, index):
        raise NotImplementedError(_LM)

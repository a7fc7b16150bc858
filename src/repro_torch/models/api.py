"""SplitModel — the uniform protocol the S²FL core consumes.

A model is a sequence of *units* (transformer blocks or CNN units) plus an
input stem (embedding) and an output head. A split index ``s`` places
``stem + units[:s]`` on the client and ``units[s:] + head`` on the server;
the tensor crossing the cut is the paper's intermediate feature ``fx``.

Both forward halves take the FULL parameter tree (the other half's
leaves simply receive no gradient) — portion sizes / upload costs are
accounted by ``repro_torch.utils.flops`` from the segment map, and
Algorithm-1 aggregation operates on segments. The LM half serves
(``prefill`` / ``decode_step``) and computes split losses; S²FL training
of the LM families is a later slice.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import CNNConfig
from repro_torch.models import cnn as cnn_mod
from repro_torch.models import transformer as tf_mod
from repro_torch.models.layers import cross_entropy
from repro_torch.models.params import init_params
from repro_torch.utils.tree import get_subtree  # noqa: F401 (re-export)


class SplitModel:
    def __init__(self, cfg):
        self.cfg = cfg
        self.is_cnn = isinstance(cfg, CNNConfig) or cfg.arch_type == "cnn"

    # -- parameters ---------------------------------------------------------
    def defs(self):
        return (cnn_mod.cnn_defs(self.cfg) if self.is_cnn
                else tf_mod.model_defs(self.cfg))

    def init(self, seed: int, *, device, draw_on_device: bool = False):
        """``draw_on_device`` (LM only): draw the weights on ``device``
        (see ``models/params.py``)."""
        if self.is_cnn:
            return cnn_mod.init_cnn(self.cfg, seed, device=device)
        return init_params(self.defs(), seed, self.cfg.param_dtype,
                           device=device, draw_on_device=draw_on_device)

    # -- structure ----------------------------------------------------------
    @property
    def n_units(self) -> int:
        return (cnn_mod.cnn_n_units(self.cfg) if self.is_cnn
                else self.cfg.n_layers)

    def segments(self):
        """Ordered (name, path) segment map over the param tree.
        Paths index into the params dict."""
        if self.is_cnn:
            segs = [(f"unit:{i}", ("units", i)) for i in range(self.n_units)]
            segs.append(("head", ("head",)))
            return segs
        segs = [("embed", ("embed",))]
        segs += [(f"block:{i}", ("blocks", i))
                 for i in range(self.cfg.n_layers)]
        d = self.defs()
        if "shared_attn" in d:
            segs.append(("shared_attn", ("shared_attn",)))
        segs.append(("final_norm", ("final_norm",)))
        if "head" in d:
            segs.append(("head", ("head",)))
        return segs

    def client_segments(self, split: int):
        """Segment names trained on the client for split s."""
        if self.is_cnn:
            return {f"unit:{i}" for i in range(split)}
        names = {"embed"} | {f"block:{i}" for i in range(split)}
        if any(self.cfg.pattern()[i][0] == "shared_attn"
               for i in range(split)):
            names.add("shared_attn")
        return names

    # -- forward halves -----------------------------------------------------
    def client_forward(self, params, batch, split: int, train: bool = True):
        """Returns features dict {'h': ..., 'aux': scalar}."""
        if self.is_cnn:
            x = batch["x"]
            h = cnn_mod.cnn_apply_range(self.cfg, params, x, 0, split)
            return {"h": h, "aux": torch.zeros((), dtype=torch.float32,
                                               device=x.device)}
        h = tf_mod.apply_embed(self.cfg, params, batch["tokens"],
                               batch.get("prefix"))
        positions = torch.arange(h.shape[1], dtype=torch.int32,
                                 device=h.device)
        h, _, aux = tf_mod.apply_blocks(self.cfg, params, h, 0, split,
                                        positions, train=train)
        return {"h": h, "aux": aux}

    def server_loss(self, params, feats, batch, split: int,
                    train: bool = True):
        """CE(+aux) from the cut to the loss. Returns (loss, metrics)."""
        if self.is_cnn:
            h = cnn_mod.cnn_apply_range(self.cfg, params, feats["h"], split,
                                        self.n_units)
            logits = cnn_mod.cnn_head(self.cfg, params, h)
            ce, acc = cnn_mod.ce_and_acc(logits, batch["y"],
                                         self.cfg.n_classes)
            return ce + feats["aux"], {"ce": ce, "acc": acc}
        h = feats["h"]
        positions = torch.arange(h.shape[1], dtype=torch.int32,
                                 device=h.device)
        h, _, aux = tf_mod.apply_blocks(self.cfg, params, h, split,
                                        self.cfg.n_layers, positions,
                                        train=train)
        logits = tf_mod.apply_head(self.cfg, params, h)
        P = logits.shape[1] - batch["tokens"].shape[1]
        if P:
            logits = logits[:, P:]
        ce = cross_entropy(logits, batch["labels"], self.cfg.vocab_size)
        return ce + aux + feats["aux"], {"ce": ce, "aux": aux + feats["aux"]}

    def full_loss(self, params, batch, train: bool = True):
        """Monolithic loss (FedAvg baseline / sanity oracle)."""
        if self.is_cnn:
            return cnn_mod.cnn_loss(self.cfg, params, batch)
        return tf_mod.lm_loss(self.cfg, params, batch, train=train)

    # -- inference (LM only) -------------------------------------------------
    def prefill(self, params, tokens, max_len, prefix=None):
        return tf_mod.prefill(self.cfg, params, tokens, max_len, prefix)

    def decode_step(self, params, token, caches, index):
        return tf_mod.decode_step(self.cfg, params, token, caches, index)

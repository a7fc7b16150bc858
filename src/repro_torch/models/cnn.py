"""The paper's CNN families (ResNet8 / VGG16 / MobileNet, CIFAR-scale),
as sequential unit stacks so the S²FL sliding split applies at unit
granularity (the paper's three split layers are unit indices).

BatchNorm is the stateless, batch-statistics form (running stats don't
aggregate across clients): population variance, no running stats, in
training and evaluation alike.

Layouts: parameters keep the reference's shapes (conv weights HWIO) and
the public functions take and return NHWC activations, so the feature
tensor that crosses the cut flattens in the reference's order. Inside a
range of units the activations run NCHW, torch's native conv layout.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.params import ParamDef, init_params

_NONE4 = ("none",) * 4


def _conv_defs(k, cin, cout, name="w"):
    return {name: ParamDef((k, k, cin, cout), _NONE4, init="conv")}


def _bn_defs(c):
    return {"scale": ParamDef((c,), ("none",), init="ones"),
            "bias": ParamDef((c,), ("none",), init="zeros")}


def _same_pad(x, k: int, stride: int):
    """XLA "SAME" padding of an NCHW tensor: out = ceil(n / stride), and
    the odd pixel of the total pad goes at the bottom/right (at stride 2
    on even sizes a 3x3 conv pads 0 top/left and 1 bottom/right, which
    torch's symmetric ``padding=1`` would not)."""
    pads = []
    for n in (x.shape[3], x.shape[2]):          # F.pad order: W, then H
        out = -(-n // stride)
        total = max((out - 1) * stride + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads) if any(pads) else x


def _conv(p, x, stride=1, groups=1, name="w"):
    w = p[name]                                  # HWIO
    x = _same_pad(x, w.shape[0], stride)
    return F.conv2d(x, w.permute(3, 2, 0, 1).to(x.dtype), stride=stride,
                    groups=groups)


def _bn(p, x, eps=1e-5):
    mean = x.mean(dim=(0, 2, 3), keepdim=True)
    var = x.var(dim=(0, 2, 3), correction=0, keepdim=True)
    xn = (x - mean) * torch.rsqrt(var + eps)
    return xn * p["scale"].view(1, -1, 1, 1) + p["bias"].view(1, -1, 1, 1)


def _maxpool(x):
    return F.max_pool2d(x, 2, 2)                 # 2x2 "VALID"


# ---------------------------------------------------------------------------
# unit builders per family: each unit -> (defs, apply_fn on NCHW)
# ---------------------------------------------------------------------------
def _resnet_units(cfg):
    units = []
    c_in = cfg.in_channels

    def stem_defs(c_in=c_in):
        return {"conv": _conv_defs(3, c_in, 16), "bn": _bn_defs(16)}

    def stem_apply(p, x):
        return F.relu(_bn(p["bn"], _conv(p["conv"], x)))

    units.append((stem_defs(), stem_apply))
    c_prev = 16
    for c, n_blocks, stride in cfg.stages:
        for b in range(n_blocks):
            s = stride if b == 0 else 1
            proj = (s != 1) or (c_prev != c)

            def blk_defs(c_prev=c_prev, c=c, proj=proj):
                d = {"conv1": _conv_defs(3, c_prev, c), "bn1": _bn_defs(c),
                     "conv2": _conv_defs(3, c, c), "bn2": _bn_defs(c)}
                if proj:
                    d["proj"] = _conv_defs(1, c_prev, c)
                return d

            def blk_apply(p, x, s=s, proj=proj):
                h = F.relu(_bn(p["bn1"], _conv(p["conv1"], x, s)))
                h = _bn(p["bn2"], _conv(p["conv2"], h))
                skip = _conv(p["proj"], x, s) if proj else x
                return F.relu(h + skip)

            units.append((blk_defs(), blk_apply))
            c_prev = c
    return units, c_prev


def _vgg_units(cfg):
    units = []
    c_prev = cfg.in_channels
    for si, (c, n_convs) in enumerate(cfg.stages):
        for ci in range(n_convs):
            last = ci == n_convs - 1

            def u_defs(c_prev=c_prev, c=c):
                return {"conv": _conv_defs(3, c_prev, c), "bn": _bn_defs(c)}

            def u_apply(p, x, last=last):
                h = F.relu(_bn(p["bn"], _conv(p["conv"], x)))
                return _maxpool(h) if last else h

            units.append((u_defs(), u_apply))
            c_prev = c
    return units, c_prev


def _mobilenet_units(cfg):
    units = []

    def stem_defs():
        return {"conv": _conv_defs(3, cfg.in_channels, 32),
                "bn": _bn_defs(32)}

    def stem_apply(p, x):
        return F.relu(_bn(p["bn"], _conv(p["conv"], x, 1)))

    units.append((stem_defs(), stem_apply))
    c_prev = 32
    for c, stride in cfg.stages:
        def u_defs(c_prev=c_prev, c=c):
            return {"dw": _conv_defs(3, 1, c_prev, "w"),
                    "bn1": _bn_defs(c_prev),
                    "pw": _conv_defs(1, c_prev, c), "bn2": _bn_defs(c)}

        def u_apply(p, x, stride=stride, c_prev=c_prev):
            h = _conv(p["dw"], x, stride, groups=c_prev)   # depthwise
            h = F.relu(_bn(p["bn1"], h))
            h = F.relu(_bn(p["bn2"], _conv(p["pw"], h)))
            return h

        units.append((u_defs(), u_apply))
        c_prev = c
    return units, c_prev


_BUILDERS = {"resnet": _resnet_units, "vgg": _vgg_units,
             "mobilenet": _mobilenet_units}


def cnn_units(cfg):
    return _BUILDERS[cfg.family](cfg)


def cnn_defs(cfg):
    units, c_final = cnn_units(cfg)
    return {
        "units": [d for d, _ in units],
        "head": {"w": ParamDef((c_final, cfg.n_classes), ("none", "none")),
                 "b": ParamDef((cfg.n_classes,), ("none",), init="zeros")},
    }


def init_cnn(cfg, seed: int, *, device):
    return init_params(cnn_defs(cfg), seed, cfg.param_dtype, device=device)


def cnn_apply_range(cfg, params, x, lo: int, hi: int):
    """Units [lo, hi) on an NHWC batch; returns NHWC."""
    units, _ = cnn_units(cfg)
    x = x.permute(0, 3, 1, 2)
    for i in range(lo, hi):
        x = units[i][1](params["units"][i], x)
    return x.permute(0, 2, 3, 1)


def cnn_head(cfg, params, x):
    x = x.mean(dim=(1, 2))                                # global avg pool
    return x @ params["head"]["w"] + params["head"]["b"]


def cnn_n_units(cfg):
    return len(_BUILDERS[cfg.family](cfg)[0])


def ce_and_acc(logits, y, n_classes: int):
    # a comparison, not F.one_hot: the same 0/1 values (an out-of-range
    # label gives a zero row, as jax.nn.one_hot does), and no
    # data-dependent range check, so torch.func.vmap takes it
    onehot = (y.long()[..., None]
              == torch.arange(n_classes, device=y.device)).to(logits.dtype)
    ce = -torch.mean(torch.sum(onehot * F.log_softmax(logits, -1), -1))
    acc = torch.mean((torch.argmax(logits, -1) == y).to(torch.float32))
    return ce, acc


def cnn_loss(cfg, params, batch):
    """batch: {'x': (B,H,W,C), 'y': (B,)}"""
    h = cnn_apply_range(cfg, params, batch["x"], 0, cnn_n_units(cfg))
    logits = cnn_head(cfg, params, h)
    ce, acc = ce_and_acc(logits, batch["y"], cfg.n_classes)
    return ce, {"ce": ce, "acc": acc}

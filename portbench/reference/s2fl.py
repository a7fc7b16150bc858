"""Plain reference of S²FL's rounds (the paper's Algorithm 2 with sliding
splits, balanced groups and Algorithm-1 aggregation), float32, written
from the method: client forward to the cut, the int8 codec with error
feedback on the features up and their gradients down, each balanced
group's summed loss (Eq. 3) and its backward on the group's server copy,
each member from its own split, client backward, SGD, and the data-size
weighted aggregation of each segment from its trainer (Algorithm 1).
Beside the numbers it works out the wire bytes and the Eq.-1 simulated
clock of each round.

The sliding split (§3.1): in the first K rounds (the warm-up) round r
sends split point r mod K to every device, and every device's Eq.-1 time
at that split enters the client time table; afterwards each participant
gets the split whose recorded time lies closest to the median of the
participants' recorded times, and its observed time enters the table (an
EMA of weight 1/2). The participants and each client's batch rows are
drawn from one ``numpy.random.default_rng(seed)`` in the method's order
(the cohort, then the members of each group in turn), the device kinds
(Table 1) from another, seeded apart, as the method's simulation
specifies.
"""
from __future__ import annotations

import itertools

import numpy as np
import torch

from portbench import yardstick
from portbench.reference import lm

F32 = torch.float32

# Table 1: device FLOP/s and link rates (elements/s), the server's FLOP/s
FLOPS_SETTINGS = {"low": 5e9, "mid": 1e10, "high": 2e10}
RATE_SETTINGS = {"low": 1e6, "mid": 2e6, "high": 5e6}
SERVER_FLOPS = 5e10
BYTES_PER_ELEM = 4.0
AUX_BYTES = 4.0          # the scalar aux-loss rider on each message
INT8_GROUP = 256         # values per (scale, zero point) pair
TABLE_EMA = 0.5          # weight of a new observation in the time table


# ----------------------------------------------------------------- devices
def device_grid(n: int, seed: int):
    """[(FLOP/s, rate)] of devices 0..n-1: the 9 kinds round robin, then
    shuffled."""
    rng = np.random.default_rng(seed)
    kinds = list(itertools.product(FLOPS_SETTINGS, RATE_SETTINGS))
    picks = [kinds[i % len(kinds)] for i in range(n)]
    rng.shuffle(picks)
    return [(FLOPS_SETTINGS[f], RATE_SETTINGS[r]) for f, r in picks]


# ---------------------------------------------------------------- Eq. 2
def _dist(h):
    total = h.sum()
    if total == 0:
        return float(np.sqrt(len(h))) / len(h)
    return float(np.linalg.norm(h / total - 1.0 / len(h)))


def balanced_groups(hists, group_size: int):
    """Groups of about ``group_size`` client indices whose summed label
    histograms are closest to uniform (Eq. 2): greedy seeding from the
    most skewed client, then one pass of pairwise swaps."""
    hists = np.asarray(hists, dtype=np.float64)
    x = len(hists)
    n_groups = max(1, round(x / group_size))
    sizes = [x // n_groups + (1 if i < x % n_groups else 0)
             for i in range(n_groups)]
    left = set(range(x))
    skew = {c: _dist(hists[c]) for c in left}
    groups = []
    for gs in sizes:
        first = max(left, key=lambda c: skew[c])
        group, acc = [first], hists[first].copy()
        left.discard(first)
        for _ in range(gs - 1):
            if not left:
                break
            best = min(left, key=lambda c: _dist(acc + hists[c]))
            group.append(best)
            left.discard(best)
            acc += hists[best]
        groups.append(group)

    def gd(g):
        return _dist(np.sum([hists[c] for c in g], axis=0))
    for gi in range(len(groups)):
        for gj in range(gi + 1, len(groups)):
            for ii in range(len(groups[gi])):
                for jj in range(len(groups[gj])):
                    base = gd(groups[gi]) + gd(groups[gj])
                    a, b = groups[gi][ii], groups[gj][jj]
                    groups[gi][ii], groups[gj][jj] = b, a
                    if gd(groups[gi]) + gd(groups[gj]) >= base - 1e-12:
                        groups[gi][ii], groups[gj][jj] = a, b
    return [tuple(g) for g in groups]


# ------------------------------------------------------------------ codec
def int8_roundtrip(x):
    """Affine int8 per group of 256 consecutive values (the tail group
    edge-padded) -> (what the receiver decodes, wire bytes)."""
    flat = x.reshape(-1).to(F32)
    n = flat.numel()
    g = max(1, min(INT8_GROUP, n))
    pad = (-n) % g
    rows = torch.cat([flat, flat[-1:].expand(pad)]) if pad else flat
    rows = rows.reshape(-1, g)
    mn = rows.amin(1, keepdim=True)
    mx = rows.amax(1, keepdim=True)
    scale = torch.clamp_min((mx - mn) / 254.0, 1e-12)
    zp = -127.0 - mn / scale
    q = torch.clamp(torch.round(rows / scale + zp), -127.0, 127.0)
    y = (scale * (q - zp)).reshape(-1)[:n].reshape(x.shape)
    return y, int8_bytes(n)


def int8_bytes(n: int) -> float:
    """Wire bytes of n values under the int8 codec: one byte a value of
    each group (the tail edge-padded) and a float32 scale and zero point
    a group."""
    g = max(1, min(INT8_GROUP, n))
    groups = -(-n // g)
    return float(groups * g) + 8.0 * groups


class Link:
    """One direction of the cut layer with error feedback per device."""

    def __init__(self):
        self.residual = {}

    def send(self, cid, x):
        r = self.residual.get(cid)
        if r is not None and r.shape == x.shape:
            x = x + r
        y, nbytes = int8_roundtrip(x)
        self.residual[cid] = x - y
        return y, nbytes + AUX_BYTES


# ------------------------------------------------------------- the model
def segments(cfg):
    """[(name, path)] of the model's segments in order."""
    segs = [("embed", ("embed",))]
    segs += [(f"block:{i}", ("blocks", i)) for i in range(cfg.n_layers)]
    segs.append(("final_norm", ("final_norm",)))
    if not cfg.tie_embeddings:
        segs.append(("head", ("head",)))
    return segs


def client_segments(split: int):
    return {"embed"} | {f"block:{i}" for i in range(split)}


def _flat(tree, path=()):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], path + (k,)))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, path + (i,)))
        return out
    return {path: tree}


def _tree(flat):
    """A nested params tree over ``flat``'s tensors (lists for blocks)."""
    root = {}
    for path, v in flat.items():
        node = root
        for i, k in enumerate(path[:-1]):
            nxt = path[i + 1]
            if isinstance(node, list):
                while len(node) <= k:
                    node.append(None)
                if node[k] is None:
                    node[k] = [] if isinstance(nxt, int) else {}
                node = node[k]
            else:
                if k not in node:
                    node[k] = [] if isinstance(nxt, int) else {}
                node = node[k]
        if isinstance(node, list):
            while len(node) <= path[-1]:
                node.append(None)
        node[path[-1]] = v
    return root


def client_forward(cfg, params, tokens, split, rnd):
    S = tokens.shape[1]
    pos = torch.arange(S, device=tokens.device)
    return lm.blocks(cfg, params, lm.embed(params, tokens), 0, split, pos,
                     rnd)


def server_loss(cfg, params, h, labels, split, rnd):
    S = h.shape[1]
    pos = torch.arange(S, device=h.device)
    h = lm.blocks(cfg, params, h, split, cfg.n_layers, pos, rnd)
    return lm.cross_entropy(lm.head(cfg, params, h, rnd), labels,
                            cfg.vocab_size)


def _grads(loss_or_out, wrt, grad_outputs=None):
    return torch.autograd.grad(loss_or_out, wrt, grad_outputs=grad_outputs,
                               allow_unused=True)


# ---------------------------------------------------------------- rounds
def steady_splits(part, table, split_points) -> dict:
    """§3.1 after the warm-up: {cid: the split whose recorded time lies
    closest to the median of all the participants' recorded times}
    (ties to the earlier split point)."""
    times = [table[c][s] for c in part for s in split_points
             if s in table[c]]
    median = float(np.median(times))
    return {c: min(((s, table[c][s]) for s in split_points
                    if s in table[c]),
                   key=lambda st: abs(st[1] - median))[0] for c in part}


def rounds(cfg, weights, data, *, seed, rounds, per_round, batch, lr,
           group_size, split_points, n_classes, local_steps=1,
           device_seed, rnd=lm.ident, device):
    """The first ``rounds`` rounds of S²FL from ``weights``: the K
    warm-up rounds, then the sliding split's steady state.

    ``data``: {cid: {'tokens', 'labels', 'y'}} numpy arrays. Returns
    [{'loss', 'params' (flat {path: tensor}), 'clock', 'comm',
    'splits'}] after each round; clock and comm cumulative, splits
    {cid: split} of the round."""
    if any(f == "moe" for f in cfg.ffn_pattern):
        raise ValueError("no reference for training an MoE model")
    rng = np.random.default_rng(seed)
    cids = sorted(data)
    devs = device_grid(len(cids), device_seed)
    hists = {c: np.bincount(np.asarray(data[c]["y"]).reshape(-1),
                            minlength=n_classes).astype(np.float64)
             [:n_classes] for c in cids}
    W = {p: t.detach().to(F32) for p, t in _flat(weights).items()}
    up, down = Link(), Link()
    segs = segments(cfg)
    seq = next(iter(data.values()))["tokens"].shape[1]
    samples = {c: local_steps * min(batch, len(data[c]["tokens"]))
               for c in cids}
    K = len(split_points)
    table = {c: {} for c in cids}
    clock = comm = 0.0
    out = []
    for r in range(rounds):
        part = list(rng.choice(cids, size=min(per_round, len(cids)),
                               replace=False))
        if r < K:
            # warm-up: one split for all; every device's time is recorded
            split = split_points[r % K]
            splits = {c: split for c in part}
            for c in cids:
                if c not in part:
                    _observe(table, c, split, _device_time(
                        cfg, devs[c], split, samples[c], seq,
                        _payload_bytes(samples[c] * seq * cfg.d_model)))
        else:
            splits = steady_splits(part, table, split_points)
        groups = [tuple(part[i] for i in g) for g in balanced_groups(
            [hists[c] for c in part], group_size)]
        client = {c: dict(W) for c in part}
        server = {gi: dict(W) for gi in range(len(groups))}
        sent = {c: 0.0 for c in part}
        losses = []
        cpaths = {c: [p for p in W if p[0] == "embed"
                      or (p[0] == "blocks" and p[1] < splits[c])]
                  for c in part}
        for step in range(local_steps):
            for gi, group in enumerate(groups):
                batches = []
                for c in group:
                    n = len(data[c]["tokens"])
                    idx = rng.choice(n, size=min(batch, n),
                                     replace=n < batch)
                    batches.append(
                        (torch.as_tensor(data[c]["tokens"][idx],
                                         device=device).long(),
                         torch.as_tensor(data[c]["labels"][idx],
                                         device=device).long()))
                feats = []
                for c, (tok, _) in zip(group, batches):
                    with torch.no_grad():
                        h = client_forward(cfg, _tree(client[c]), tok,
                                           splits[c], rnd)
                    y, nb = up.send(c, h)
                    sent[c] += nb
                    feats.append(y.detach().requires_grad_(True))
                # the group's server copy: each member from its own split
                lo = min(splits[c] for c in group)
                spaths = [p for p in W if p[0] != "embed"
                          and not (p[0] == "blocks" and p[1] < lo)]
                sp = {p: server[gi][p].detach().requires_grad_(p in spaths)
                      for p in W}
                tree = _tree(sp)
                loss = sum(server_loss(cfg, tree, y, lab, splits[c], rnd)
                           for c, y, (_, lab) in zip(group, feats, batches))
                wrt = [sp[p] for p in spaths] + feats
                g = _grads(loss, wrt)
                if step == local_steps - 1:
                    losses.append(float(loss.detach()))
                for p, gp in zip(spaths, g[:len(spaths)]):
                    if gp is not None:
                        server[gi][p] = (server[gi][p] - lr * gp).detach()
                for c, (tok, _), dfx in zip(group, batches,
                                            g[len(spaths):]):
                    dfx, nb = down.send(c, dfx)
                    sent[c] += nb
                    cp = {p: client[c][p].detach().requires_grad_(
                        p in cpaths[c]) for p in W}
                    h = client_forward(cfg, _tree(cp), tok, splits[c], rnd)
                    gc = _grads(h, [cp[p] for p in cpaths[c]], dfx)
                    for p, gp in zip(cpaths[c], gc):
                        if gp is not None:
                            client[c][p] = (client[c][p] - lr * gp).detach()
        # Algorithm 1: each segment from its trainer, weighted by |D_i|
        sizes = {c: float(len(data[c]["tokens"])) for c in part}
        total = sum(sizes[c] for g in groups for c in g)
        newW = {}
        for name, path in segs:
            src = [(client[c] if name in client_segments(splits[c])
                    else server[gi], sizes[c])
                   for gi, g in enumerate(groups) for c in g]
            for p in W:
                if p[:len(path)] == path:
                    newW[p] = sum(s[p] * (w / total) for s, w in src)
        W = newW
        # Eq. 1: each device's time; the round lasts the slowest
        t0, times, rcomm = clock, [], 0.0
        for c in part:
            t = _device_time(cfg, devs[c], splits[c], samples[c], seq,
                             sent[c])
            _observe(table, c, splits[c], t)
            times.append(t0 + t)
            rcomm += _wire_bytes(cfg, splits[c], seq, sent[c])
        clock = max(times)
        comm += rcomm
        out.append({"loss": sum(losses) / len(part), "params": W,
                    "clock": clock, "comm": comm,
                    "splits": {int(c): int(s) for c, s in splits.items()}})
    return out


def _observe(table, c, split, t):
    old = table[c].get(split)
    table[c][split] = t if old is None else \
        (1 - TABLE_EMA) * old + TABLE_EMA * t


def _payload_bytes(n_values: int) -> float:
    """Cut-layer bytes of a device-round whose tensors never
    materialise: the features up and their gradients down, int8, each
    with its rider."""
    return 2.0 * (int8_bytes(n_values) + AUX_BYTES)


def _wire_bytes(cfg, split, seq, payload) -> float:
    """2|Wc| in float32 (dispatch and collect) and the cut layer's
    payload."""
    return 2.0 * (_split_costs(cfg, split, seq)["wc"] * BYTES_PER_ELEM) \
        + payload


def _device_time(cfg, dev, split, p, seq, payload) -> float:
    """Eq. 1: the device-round's wire time at the device's rate, its
    share of the FLOPs at its speed, the server's at the server's."""
    comp, rate = dev
    costs = _split_costs(cfg, split, seq)
    return (_wire_bytes(cfg, split, seq, payload) / (rate * BYTES_PER_ELEM)
            + p * costs["fc"] / comp + p * costs["fs"] / SERVER_FLOPS)


def _split_costs(cfg, split: int, S: int) -> dict:
    """|Wc| (elements) and the per-sample fwd+bwd FLOPs of the client and
    server portions (backward = 2 x forward)."""
    fwd = yardstick.transformer_unit_flops(cfg, S)
    head = yardstick.head_flops(cfg, S)
    wc = yardstick.vocab_padded(cfg) * cfg.d_model + split * _block_params(cfg)
    return {"wc": float(wc), "fc": 3.0 * sum(fwd[:split]),
            "fs": 3.0 * (sum(fwd[split:]) + head)}


def _block_params(cfg) -> int:
    d, H, K, D = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return 2 * d + d * D * (H + 2 * K) + H * D * d + 3 * d * cfg.d_ff

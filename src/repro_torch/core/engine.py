"""Algorithm 2 — the S²FL round engine (plus SFL and FedAvg baselines and
the paper's ablation variants S²FL+{R,B,M,MB}).

This is the host-level engine: exact per-device client portions, per-group
server copies, E local SGD steps per round, Eq.-1 simulated clock, and
Algorithm-1 aggregation.

Workflow per round (Fig. 1 steps 1–9):
  1/2  scheduler picks Wc per device (client time table), W dispatched
  3/4  devices run client fwd, upload features + labels
  5    Main Server groups features (Eq. 2) and makes per-group Ws copies
  6    per-group combined loss, backward, Ws update
  7/8  feature gradients return, devices update Wc
  9    Fed Server aggregates (Algorithm 1)

Parameters are trees of tensors shared between the global model, the
per-group server copies and the per-device client copies, so every
update here is out of place (``w - lr * g``): an in-place step would
write through to every copy. Gradients come from
``torch.autograd.grad(..., allow_unused=True)``; a leaf the loss does not
reach gets no gradient and is kept as it is. The multi-group server step
(``fused_server``) takes them from ``torch.func.grad_and_value`` under
``torch.func.vmap`` instead, where such a leaf gets a zero gradient:
``w - lr * 0`` is ``w`` bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.comm import make_channel
from repro_torch.configs.base import CommConfig, DriverConfig
from repro_torch.core import simulation as sim
from repro_torch.core.aggregation import (ClientState, aggregate,
                                          fedavg_aggregate)
from repro_torch.core.balance import greedy_groups, label_histogram
from repro_torch.core.driver import FedAvgCost, MeteredCost, RoundDriver
from repro_torch.core.scheduler import (FixedSplitScheduler,
                                        JointKnobScheduler,
                                        MinTimeScheduler,
                                        SlidingSplitScheduler)
from repro_torch.core.split import SplitPlan, default_plan
from repro_torch.models.api import SplitModel
from repro_torch.models.transformer import without_remat
from repro_torch.utils import flops as flops_util
from repro_torch.utils.device import resolve_device
from repro_torch.utils.tree import (get_subtree, set_subtree, tree_flatten,
                                    tree_map, tree_unflatten)


@dataclasses.dataclass
class EngineConfig:
    mode: str = "s2fl"            # 's2fl' | 'sfl' | 'fedavg'
    use_balance: bool = True      # +B (False -> each device its own group)
    use_sliding: bool = True      # +M (False -> fixed largest split)
    scheduler: str = "median"     # 'median' (paper §3.1) | 'mintime'
                                  # | 'joint' (beyond-paper, scheduler.py)
    batch_fracs: tuple = ()       # 'joint' candidate batch fractions;
                                  # () -> (1.0, 0.75, 0.5)
    rounds: int = 50
    clients_per_round: int = 10
    local_steps: int = 1          # E
    batch_size: int = 32
    lr: float = 0.01
    group_size: int = 2           # devices per balance group
    split_k: int = 3
    seed: int = 0
    n_classes: int = 10
    # transport: codecs + link model for the cut-layer exchange
    # (repro_torch.comm; fp32/static reproduces the seed's semantics,
    # comm is accounted in bytes)
    comm: CommConfig = dataclasses.field(default_factory=CommConfig)
    # round-loop execution: sync barrier vs semi-async event queue, and
    # predictive (link-forecasting) split selection
    driver: DriverConfig = dataclasses.field(default_factory=DriverConfig)
    # batched hot path (both default off: the seed path stays bit-exact).
    # fused_comm flushes each direction's whole cohort through ONE
    # fused kernel call (comm/fused.py) — bytes metered bit-equal,
    # tensors ≤1e-6 vs the sequential chain. fused_server stacks
    # same-signature concurrent groups into one vmapped server step
    # (losses/params may drift ~1e-4 from batched-kernel numerics).
    fused_comm: bool = False
    fused_server: bool = False


def _tree_stack(trees):
    """Stack a list of same-structure trees leaf-wise: (…)->(G, …)."""
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def _tree_index(tree, i):
    """Leaf-wise slice of a stacked tree: (G, …)[i] -> (…)."""
    return tree_map(lambda x: x[i], tree)


def _sgd(params, grads, lr):
    """Out-of-place SGD over a tree; a None gradient keeps the leaf."""
    leaves, skel = tree_flatten(params)
    new = [w if g is None else (w - lr * g.to(w.dtype)).to(w.dtype)
           for w, g in zip(leaves, grads)]
    return tree_unflatten(skel, new)


def _with_grad(params):
    """-> (leaves that require grad, tree over them)."""
    leaves, skel = tree_flatten(params)
    req = [w.detach().requires_grad_(True) for w in leaves]
    return req, tree_unflatten(skel, req)


class S2FLEngine:
    """Drives FedAvg / SFL / S²FL over a federated dataset.

    data: {cid: {'x'|'tokens': ..., 'y'|'labels': ...}} host numpy arrays;
    ``device``: where the models train ('cuda' or 'cpu')."""

    def __init__(self, model: SplitModel, data: dict, ecfg: EngineConfig,
                 devices: Optional[list] = None,
                 plan: Optional[SplitPlan] = None, recorder=None,
                 fault_plan=None, *, device):
        self.device = resolve_device(device)
        self.model = model
        # the multi-group server step's model: remat off under torch.func
        self._func_model = (model if model.is_cnn
                            else SplitModel(without_remat(model.cfg)))
        self.data = data
        self.ecfg = ecfg
        self.rng = np.random.default_rng(ecfg.seed)
        self.plan = plan or default_plan(model.n_units, k=ecfg.split_k)
        # fleet mode (core/fleet.py): the population lives as (P,)
        # tables, cohorts are fleet-sampled, and the object grid is
        # never materialized — each fleet cid trains on the data shard
        # cid mod n_shards
        self.fleet = None
        if ecfg.driver.fleet_size and devices is None:
            from repro_torch.core.fleet import Fleet
            self.fleet = Fleet.table1(ecfg.driver.fleet_size,
                                      seed=ecfg.seed,
                                      clusters=ecfg.driver.clusters)
            self.devices = []
        else:
            self.devices = devices or sim.make_device_grid(len(data),
                                                           seed=ecfg.seed)
        self.dev_by_id = {d.cid: d for d in self.devices}
        self._shards = sorted(data)

        if ecfg.mode == "s2fl" and ecfg.use_sliding:
            if ecfg.scheduler == "mintime":
                self.scheduler = MinTimeScheduler(self.plan)
            elif ecfg.scheduler == "joint":
                self.scheduler = JointKnobScheduler(
                    self.plan,
                    batch_fracs=ecfg.batch_fracs or (1.0, 0.75, 0.5))
            else:
                self.scheduler = SlidingSplitScheduler(self.plan)
        else:
            self.scheduler = FixedSplitScheduler(self.plan)

        self.params = model.init(ecfg.seed, device=self.device)
        self.channel = make_channel(ecfg.comm)
        # observability (observe/): one recorder feeds both the driver's
        # flight/window hooks and the channel's wire counters; None (the
        # default) keeps every hook site a dead branch
        self.recorder = recorder
        self.channel.recorder = recorder
        self.history = []          # per round dicts
        self._hists = {cid: self._client_hist(cid) for cid in data}
        # the words of the reference's PRNGKey(seed + 1): the port draws
        # no key, but its run-state snapshots carry them so that either
        # package restores the other's (checkpoint/state.py)
        s = ecfg.seed + 1
        self._key = np.array([(s >> 32) & 0xFFFFFFFF, s & 0xFFFFFFFF],
                             dtype=np.uint32)

        # the unified round loop (core/driver.py): the engine's rounds
        # are metered-cost driver rounds; clock/comm live on the driver
        dcfg = ecfg.driver
        if ecfg.mode == "fedavg":
            cost = FedAvgCost(
                lambda: flops_util.split_costs(self.model,
                                               self.model.n_units,
                                               seq_len=self._seq_len()),
                p_of=self._p_of, channel=self.channel)
        else:
            cost = MeteredCost(
                self.channel,
                lambda s: flops_util.split_costs(self.model, s,
                                                 seq_len=self._seq_len()),
                p_of=self._p_of)
        # the engine scales its REAL batches by the joint scheduler's
        # selected fracs (_batch_size_of feeds both _p_of and
        # _sample_batch), so the cost model's frac_of hook must stay
        # inert — a unit sentinel here stops the driver's auto-wiring
        # from scaling the already-scaled p a second time
        cost.frac_of = lambda cid: 1.0
        knobs = None
        if dcfg.auto_knobs and dcfg.exec_mode == "semi_async":
            from repro_torch.core.control import (AggregationController,
                                                  default_knob_grid)
            knobs = AggregationController(
                default_knob_grid(dcfg.quorum, dcfg.staleness_cap))
        self.driver = RoundDriver(
            self.scheduler, cost, self.devices, mode=dcfg.exec_mode,
            staleness_cap=dcfg.staleness_cap, quorum=dcfg.quorum,
            predictive=dcfg.predictive, pipeline=dcfg.pipeline,
            server_concurrency=dcfg.server_concurrency,
            gate_redispatch=dcfg.gate_redispatch,
            resource_aware=dcfg.resource_aware,
            warmup_devices=[d for d in self.devices if d.cid in data],
            recorder=recorder, fault_plan=fault_plan,
            knob_controller=knobs, fleet=self.fleet,
            clusters=dcfg.clusters, cluster_quorum=dcfg.cluster_quorum)
        self._held = {}            # gid -> un-committed round results
        self._next_gid = 0

    # ------------------------------------------------------- timeline
    @property
    def clock(self) -> float:
        """Simulated Eq.-1 wall clock (owned by the RoundDriver)."""
        return self.driver.clock

    @property
    def comm(self) -> float:
        """Accumulated wire bytes (owned by the RoundDriver)."""
        return self.driver.comm

    # ------------------------------------------------------------------ data
    def _shard_key(self, cid):
        """Data shard a cid trains on. Object-grid cids own their shard
        outright; fleet cids fold onto the federated partition by
        ``cid mod n_shards`` (a 10^6-device population shares the same
        non-IID shards, many devices per shard)."""
        if self.fleet is None or cid in self.data:
            return cid
        return self._shards[int(cid) % len(self._shards)]

    def _client_hist(self, cid):
        d = self.data[self._shard_key(cid)]
        labels = d["y"] if "y" in d else d["labels"]
        return label_histogram(labels, self.ecfg.n_classes)

    def _batch_size_of(self, cid):
        """Configured batch size scaled by the joint scheduler's selected
        fraction for this round ({} / absent -> full batch). Single
        source of truth for BOTH the cost model (_p_of) and the real
        sampled batch, so priced and executed sample counts agree."""
        b = self.ecfg.batch_size
        fracs = getattr(self.scheduler, "selected_fracs", None)
        if fracs:
            f = fracs.get(cid, 1.0)
            if f != 1.0:
                b = max(1, int(round(b * f)))
        return b

    def _sample_batch(self, cid):
        d = self.data[self._shard_key(cid)]
        n = len(d["y"] if "y" in d else d["labels"])
        b = self._batch_size_of(cid)
        idx = self.rng.choice(n, size=min(b, n), replace=n < b)
        return {k: torch.as_tensor(v[idx]).to(self.device)
                for k, v in d.items()}

    def _data_size(self, cid):
        d = self.data[self._shard_key(cid)]
        return float(len(d["y"] if "y" in d else d["labels"]))

    def _p_of(self, cid):
        """Samples cid actually processes per round: _sample_batch
        truncates to the client's data size, so Eq.-1 compute terms and
        the warm-up payload estimate must truncate identically or the
        time table would disagree with the metered post-warm-up times."""
        return self.ecfg.local_steps * min(self._batch_size_of(cid),
                                           int(self._data_size(cid)))

    # ------------------------------------------------- model wire legs
    def _wc_leg(self, cid, params, split, leg):
        """Route the client-portion segments through the channel's model
        leg (``leg``: 'dispatch' server->device Wc, 'collect'
        device->server updated Wc), so dispatch-codec round-trip error
        reaches training and the 2|Wc| term is metered exactly. The
        fp32 passthrough (lossless: nothing to compress or feed back)
        skips the walk entirely — the cost models then price the legs
        analytically (bit-exact seed path)."""
        if self.channel.dispatch_passthrough:
            return params
        names = self.model.client_segments(split)
        paths = [p for n, p in self.model.segments() if n in names]
        subs = [get_subtree(params, p) for p in paths]
        leaves, skel = tree_flatten(subs)
        fn = (self.channel.dispatch_leaves if leg == "dispatch"
              else self.channel.collect_leaves)
        new = tree_unflatten(skel, fn(cid, leaves))
        out = params
        for p, sub in zip(paths, new):
            out = set_subtree(out, p, sub)
        return out

    def _wc_leg_cohort(self, cids, params_map, splits, leg):
        """Batched ``_wc_leg``: the whole cohort's client portions cross
        the model leg in one fused call (leaves flattened in (cid,
        leaf-index) order — the sequential transfer order, so rand-k
        draw streams and residual keys are identical)."""
        if self.channel.dispatch_passthrough:
            return {c: params_map[c] for c in cids}
        pairs, meta = [], []
        for c in cids:
            names = self.model.client_segments(splits[c])
            paths = [p for n, p in self.model.segments() if n in names]
            subs = [get_subtree(params_map[c], p) for p in paths]
            leaves, skel = tree_flatten(subs)
            pairs.append((c, leaves))
            meta.append((c, paths, skel))
        fn = (self.channel.dispatch_leaves_cohort if leg == "dispatch"
              else self.channel.collect_leaves_cohort)
        outs = fn(pairs)
        result = {}
        for (c, paths, skel), new_leaves in zip(meta, outs):
            new = tree_unflatten(skel, new_leaves)
            out = params_map[c]
            for p, sub in zip(paths, new):
                out = set_subtree(out, p, sub)
            result[c] = out
        return result

    def _with_dispatch_report(self, report, participants):
        """Attach the metered model-leg bytes to the driver report. On
        the fp32 passthrough nothing was metered and the keys stay
        absent, so cost models fall back to the analytic 2|Wc| term —
        the exact seed pricing."""
        if self.channel.dispatch_passthrough:
            return report
        per_dir = {c: self.channel.round_dispatch_split(c)
                   for c in participants}
        report["dispatch_bytes"] = {c: per_dir[c][0] + per_dir[c][1]
                                    for c in participants}
        report["dispatch_down_bytes"] = {c: per_dir[c][0]
                                         for c in participants}
        report["dispatch_up_bytes"] = {c: per_dir[c][1]
                                       for c in participants}
        return report

    # ------------------------------------------------------ model pieces
    def _client_fwd(self, params, batch, split):
        """Step 3: the client half's forward; the features leave the
        device as plain tensors (the update recomputes the forward)."""
        with torch.no_grad():
            return self.model.client_forward(params, batch, split)

    def _server_step(self, sp, feats_list, batches, splits):
        """Steps 5/6 for one group: the Eq.-3 combined loss and its
        gradients. -> (loss, sgrads as leaf list, [dfx_i])."""
        m = self.model
        sp_leaves, sp_tree = _with_grad(sp)
        feats = [{k: v.detach().requires_grad_(True) for k, v in f.items()}
                 for f in feats_list]
        losses = [m.server_loss(sp_tree, f, b, s)[0]
                  for s, f, b in zip(splits, feats, batches)]
        # Eq. 3: loss = UNION of per-client losses -> SUM. A mean
        # halves per-client gradients vs SFL's singleton groups and
        # measurably slows S²FL.
        loss = torch.sum(torch.stack(losses))
        wrt = sp_leaves + [v for f in feats for v in f.values()]
        grads = torch.autograd.grad(loss, wrt, allow_unused=True)
        sgrads, fgrads = grads[:len(sp_leaves)], iter(grads[len(sp_leaves):])
        dfxs = [{k: next(fgrads) for k in f} for f in feats]
        return loss.detach(), sgrads, dfxs

    def _multi_server_step(self, gsplits, sp_stack, feats_stack,
                           batches_stack):
        """Batched dual of ``_server_step`` + its SGD update: every
        concurrent group with the same signature (member splits +
        feature/batch shapes) rides ONE call — the per-group Eq.-3 loss,
        its gradients and the Eq.-4 update under ``torch.func.vmap``
        over the stacked (G, …) server copies, features and batches.
        ``torch.func`` refuses checkpoint's saved-tensor hooks, so the
        blocks run here with ``remat`` off (the same numbers).
        -> (new stacked copies, losses (G,), stacked [dfx_i])."""
        m, lr = self._func_model, self.ecfg.lr

        def loss_fn(sp, feats_list, batches):
            return torch.sum(torch.stack(
                [m.server_loss(sp, f, b, s)[0]
                 for s, f, b in zip(gsplits, feats_list, batches)]))

        def one(sp, feats_list, batches):
            (sgrads, dfxs), val = torch.func.grad_and_value(
                loss_fn, argnums=(0, 1))(sp, feats_list, batches)
            # a leaf the loss does not reach has a zero gradient here
            # (None on the sequential path): w - lr * 0 is w exactly
            new_sp = tree_map(
                lambda w, g: (w - lr * g.to(w.dtype)).to(w.dtype),
                sp, sgrads)
            return new_sp, val, dfxs

        return torch.func.vmap(one)(sp_stack, feats_stack, batches_stack)

    def _client_update(self, p, batch, dfx, split):
        """Steps 7/8: backprop dfx through the client forward; SGD."""
        leaves, tree = _with_grad(p)
        h = self.model.client_forward(tree, batch, split)["h"]
        grads = torch.autograd.grad(h, leaves, grad_outputs=dfx["h"],
                                    allow_unused=True)
        return _sgd(p, grads, self.ecfg.lr)

    def _fedavg_step(self, p, batch):
        leaves, tree = _with_grad(p)
        loss, _ = self.model.full_loss(tree, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        return _sgd(p, grads, self.ecfg.lr), loss.detach()

    # ------------------------------------------------- fused local step
    def _local_step_fused(self, groups, splits, server_copies,
                          client_params):
        """One local step with the batched hot paths: cohort the uplink
        and downlink through ONE fused call per direction
        (``fused_comm``) and stack same-signature concurrent groups'
        server backwards into one vmapped step (``fused_server``). Batch
        sampling, wire transfers and loss recording all happen in the
        sequential path's order, so RNG streams, rand-k draw counters,
        residual keys and every byte metered are identical to the
        per-device loop; delivered tensors match ≤1e-6 and vmapped
        numerics may drift ~1e-4. Returns the per-group losses in group
        order; mutates server_copies / client_params in place."""
        ecfg = self.ecfg
        # 1. draw batches group-major — the sequential RNG call order
        batches_by_g = [[self._sample_batch(c) for c in group]
                        for group in groups]
        fwd = {}
        for gi, group in enumerate(groups):
            for c, b in zip(group, batches_by_g[gi]):
                fwd[c] = self._client_fwd(client_params[c], b, splits[c])
        # 2. step 4 — the whole cohort's features cross the uplink at
        # once (one fused call; bytes metered per device, bit-equal)
        if ecfg.fused_comm:
            rx = iter(self.channel.uplink_features_cohort(
                [(c, fwd[c]) for group in groups for c in group]))
            feats_by_g = [[next(rx) for _ in group] for group in groups]
        else:
            feats_by_g = [[self.channel.uplink_features(c, fwd[c])
                           for c in group] for group in groups]
        # 3. steps 5/6 — server backwards, bucketed by signature and
        # vmapped when batching is on
        losses = [None] * len(groups)
        dfx_by_g = [None] * len(groups)

        def seq_step(gi):
            gsplits = tuple(splits[c] for c in groups[gi])
            loss, sgrads, dfxs = self._server_step(
                server_copies[gi], feats_by_g[gi], batches_by_g[gi],
                gsplits)
            server_copies[gi] = _sgd(server_copies[gi], sgrads, ecfg.lr)
            losses[gi], dfx_by_g[gi] = float(loss), dfxs

        if ecfg.fused_server:
            buckets = {}
            for gi, group in enumerate(groups):
                payload = (feats_by_g[gi], batches_by_g[gi])
                sig = (tuple(splits[c] for c in group),
                       repr(tree_map(lambda x: None, payload)),
                       tuple((tuple(x.shape), x.dtype)
                             for x in tree_flatten(payload)[0]))
                buckets.setdefault(sig, []).append(gi)
            for (gsplits, _, _), gis in buckets.items():
                if len(gis) == 1:          # nothing to batch with
                    seq_step(gis[0])
                    continue
                new_sp, vals, dfx_stack = self._multi_server_step(
                    gsplits,
                    _tree_stack([server_copies[gi] for gi in gis]),
                    _tree_stack([feats_by_g[gi] for gi in gis]),
                    _tree_stack([batches_by_g[gi] for gi in gis]))
                for j, gi in enumerate(gis):
                    server_copies[gi] = _tree_index(new_sp, j)
                    dfx_by_g[gi] = _tree_index(dfx_stack, j)
                    losses[gi] = float(vals[j])
        else:
            for gi in range(len(groups)):
                seq_step(gi)
        # 4. steps 7/8 — dfx back over the downlink (cohort flush), then
        # per-device Wc updates
        if ecfg.fused_comm:
            rx = iter(self.channel.downlink_grads_cohort(
                [(c, dfx) for gi, group in enumerate(groups)
                 for c, dfx in zip(group, dfx_by_g[gi])]))
            dfx_by_g = [[next(rx) for _ in group] for group in groups]
        else:
            dfx_by_g = [[self.channel.downlink_grads(c, dfx)
                         for c, dfx in zip(group, dfx_by_g[gi])]
                        for gi, group in enumerate(groups)]
        for gi, group in enumerate(groups):
            for c, b, dfx in zip(group, batches_by_g[gi], dfx_by_g[gi]):
                client_params[c] = self._client_update(
                    client_params[c], b, dfx, splits[c])
        return losses

    # ------------------------------------------------------------- rounds
    def run_round(self):
        ecfg = self.ecfg
        if self.fleet is not None:
            # seeded fleet draw — churn/diurnal availability applied
            # inside sample_cohort, dead devices never selected
            participants = [int(c) for c in self.fleet.sample_cohort(
                self.driver.round, ecfg.clients_per_round)]
        else:
            participants = list(self.rng.choice(
                sorted(self.data), size=min(ecfg.clients_per_round,
                                            len(self.data)),
                replace=False))
        if ecfg.mode == "fedavg":
            return self._fedavg_round(participants)
        return self._sfl_round(participants)

    def _sfl_round(self, participants):
        ecfg = self.ecfg
        group_losses = []              # last local step's per-group losses

        def execute(splits):
            # the driver filters fault-killed devices from the cohort
            # before selection, so the alive list is exactly splits'
            # keys (== participants when no fault plan is armed)
            alive = [c for c in participants if c in splits]
            # Step 5: grouping (Eq. 2) — balance on, else singletons
            if not alive:
                groups = []
            elif ecfg.mode == "s2fl" and ecfg.use_balance:
                groups = greedy_groups(
                    [self._hists[self._shard_key(c)] for c in alive],
                    ecfg.group_size)
                groups = [tuple(alive[i] for i in g) for g in groups]
            else:
                groups = [(c,) for c in alive]

            server_copies = {gi: self.params for gi in range(len(groups))}

            self.channel.reset_round()
            # Steps 1/2: Wc crosses the downlink through the dispatch
            # codec (passthrough when fp32: lossless)
            if ecfg.fused_comm:
                client_params = self._wc_leg_cohort(
                    alive, {c: self.params for c in alive},
                    splits, "dispatch")
            else:
                client_params = {c: self._wc_leg(c, self.params,
                                                 splits[c], "dispatch")
                                 for c in alive}
            fused = ecfg.fused_comm or ecfg.fused_server
            for step_i in range(ecfg.local_steps):
                if fused:
                    step_losses = self._local_step_fused(
                        groups, splits, server_copies, client_params)
                    if step_i == ecfg.local_steps - 1:
                        group_losses.extend(step_losses)
                    continue
                for gi, group in enumerate(groups):
                    batches = [self._sample_batch(c) for c in group]
                    # Step 4: features cross the uplink (codec
                    # round-trip applied, exact wire bytes metered)
                    feats = [self.channel.uplink_features(
                        c, self._client_fwd(client_params[c], b,
                                            splits[c]))
                        for c, b in zip(group, batches)]
                    gsplits = tuple(splits[c] for c in group)
                    loss, sgrads, dfxs = self._server_step(
                        server_copies[gi], feats, batches, gsplits)
                    if step_i == ecfg.local_steps - 1:
                        group_losses.append(float(loss))
                    # W_s update (Eq. 4)
                    server_copies[gi] = _sgd(server_copies[gi], sgrads,
                                             ecfg.lr)
                    # Steps 7/8: dfx back over the downlink
                    for c, b, dfx in zip(group, batches, dfxs):
                        dfx = self.channel.downlink_grads(c, dfx)
                        client_params[c] = self._client_update(
                            client_params[c], b, dfx, splits[c])

            # step 8.5: the trained Wc rides back over the collect leg
            # (codec round-trip + exact metering, passthrough on fp32)
            if ecfg.fused_comm:
                client_params = self._wc_leg_cohort(
                    alive, client_params, splits, "collect")
            else:
                for c in alive:
                    client_params[c] = self._wc_leg(c, client_params[c],
                                                    splits[c], "collect")

            # hand the driver commit-granularity work items: one per
            # group, held here until its completion event lands
            keyed = {}
            for gi, group in enumerate(groups):
                gid = self._next_gid
                self._next_gid += 1
                keyed[gid] = group
                states = [ClientState(cid=c, params=client_params[c],
                                      split=splits[c],
                                      data_size=self._data_size(c),
                                      group=gid) for c in group]
                self._held[gid] = (states, server_copies[gi])
            # per-direction byte split: the pipelined timeline prices the
            # metered uplink (features) and downlink (dfx) separately
            per_dir = {c: self.channel.round_payload_split(c)
                       for c in alive}
            return self._with_dispatch_report(
                {"groups": keyed,
                 "payload_bytes": {c: self.channel.round_payload(c)
                                   for c in alive},
                 "payload_up_bytes": {c: per_dir[c][0]
                                      for c in alive},
                 "payload_down_bytes": {c: per_dir[c][1]
                                        for c in alive}},
                alive)

        rec = self.driver.run_round(participants, execute=execute)
        # a kill abandoned these work items: drop their held state (the
        # driver guarantees their commit events can never fire)
        for gid in rec.abandoned:
            self._held.pop(gid, None)
        self._commit(rec.committed)

        # Eq.-3 group losses are SUMS over members, so divide the total
        # by the participant count: a per-client mean comparable across
        # group sizes and with the FedAvg curve; nan when no training
        # happened (local_steps == 0 or no participants)
        loss = (float(np.sum(group_losses)) / max(len(rec.splits), 1)
                if group_losses else float("nan"))
        return self._record(loss, rec)

    def _fedavg_round(self, participants):
        ecfg = self.ecfg
        losses = []

        def execute(splits):
            alive = [c for c in participants if c in splits]
            self.channel.reset_round()
            keyed = {}
            for c in alive:
                # broadcast leg: W reaches the client through the
                # dispatch codec (passthrough on fp32: lossless)
                rx = self._fedavg_broadcast(c)
                p, l = rx, None
                for _ in range(ecfg.local_steps):
                    p, l = self._fedavg_step(p, self._sample_batch(c))
                if l is not None:
                    losses.append(float(l))
                # QSGD-style collect leg: the client uploads its
                # compressed model DELTA; the server reconstructs
                # rx + decode(encode(p - rx))
                p = self._fedavg_collect(c, rx, p)
                gid = self._next_gid
                self._next_gid += 1
                keyed[gid] = (c,)
                self._held[gid] = (p, self._data_size(c))
            return self._with_dispatch_report({"groups": keyed}, alive)

        rec = self.driver.run_round(participants, execute=execute)
        for gid in rec.abandoned:
            self._held.pop(gid, None)
        self._commit(rec.committed)
        # mean over participating clients (not the last client's)
        loss = float(np.mean(losses)) if losses else float("nan")
        return self._record(loss, rec)

    def _fedavg_broadcast(self, cid):
        """Server -> client full-model broadcast through the dispatch
        codec."""
        if self.channel.dispatch_passthrough:
            return self.params
        leaves, skel = tree_flatten(self.params)
        return tree_unflatten(skel,
                              self.channel.dispatch_leaves(cid, leaves))

    def _fedavg_collect(self, cid, base, p):
        """Client -> server QSGD-style update: compress the model delta
        against the broadcast the client actually received (error
        feedback, when on, accumulates per (device, leaf))."""
        if self.channel.dispatch_passthrough:
            return p
        lb, skel = tree_flatten(base)
        lp, _ = tree_flatten(p)
        deltas = self.channel.collect_leaves(
            cid, [a - b for a, b in zip(lp, lb)])
        return tree_unflatten(
            skel, [(b + d.to(b.dtype)).to(b.dtype)
                   for b, d in zip(lb, deltas)])

    def _commit(self, gids):
        """Aggregate the work items whose completion events landed in
        this window (sync: always exactly this round's; semi_async:
        possibly fewer, plus stragglers from earlier rounds)."""
        if not gids:
            return
        if self.ecfg.mode == "fedavg":
            locals_, weights = [], []
            for gid in gids:
                p, w = self._held.pop(gid)
                locals_.append(p)
                weights.append(w)
            self.params = fedavg_aggregate(locals_, weights)
            return
        states, copies = [], {}
        for gid in gids:
            st, sc = self._held.pop(gid)
            states.extend(st)
            copies[gid] = sc
        if states:                     # Step 9 + Alg. 1
            self.params = aggregate(self.model, states, copies)

    def _record(self, loss, rec):
        entry = {"round": len(self.history),
                 "clock": self.clock, "comm": self.comm,
                 "comm_up": self.channel.up_bytes,
                 "comm_down": self.channel.down_bytes,
                 # model-leg bytes actually metered (0.0 on the fp32
                 # passthrough, where the 2|Wc| term is priced
                 # analytically inside "comm")
                 "comm_dispatch": self.channel.disp_up_bytes
                 + self.channel.disp_down_bytes,
                 "loss": loss,
                 "committed": len(rec.committed),
                 "pending": rec.pending}
        if rec.phases:
            # the window's critical-path phase split (max over devices)
            entry.update(
                t_upload=max(p["up"] for p in rec.phases.values()),
                t_server=max(p["srv"] for p in rec.phases.values()),
                t_download=max(p["down"] for p in rec.phases.values()),
                downloads_in_flight=rec.downloads)
        self.history.append(entry)
        # the aggregation controller scores probes on accuracy too: the
        # observed loss trajectory disqualifies knob settings whose
        # per-round loss delta regresses past the anchor's
        kc = self.driver.knob_controller
        if kc is not None:
            kc.observe_loss(loss)
        return self.history[-1]

    def _seq_len(self):
        if self.model.is_cnn:
            return 0
        any_d = next(iter(self.data.values()))
        return any_d["tokens"].shape[1]

    # -------------------------------------------------------------- eval
    def evaluate(self, test_data, batch_size: int = 256):
        m = self.model
        n = len(test_data["y"] if "y" in test_data else test_data["labels"])
        correct, total, loss_sum = 0.0, 0, 0.0
        with torch.no_grad():
            for i in range(0, n, batch_size):
                batch = {k: torch.as_tensor(v[i:i + batch_size])
                         .to(self.device) for k, v in test_data.items()}
                l, met = m.full_loss(self.params, batch, train=False)
                bsz = len(next(iter(batch.values())))
                loss_sum += float(l) * bsz
                if "acc" in met:
                    correct += float(met["acc"]) * bsz
                total += bsz
        return {"loss": loss_sum / total,
                "acc": correct / total if correct else None}

    def run(self, rounds: Optional[int] = None, eval_data=None,
            eval_every: int = 10, verbose: bool = False, on_round=None):
        # rounds=0 is honored (flush-only call), only None falls back to
        # the configured count
        for r in range(self.ecfg.rounds if rounds is None else rounds):
            rec = self.run_round()
            if eval_data is not None and (r + 1) % eval_every == 0:
                rec.update(self.evaluate(eval_data))
            if verbose:
                print(rec)
            if on_round is not None:
                on_round(rec)
        # semi_async/pipeline: wait out and aggregate any still-in-flight
        # stragglers so no trained update is dropped at shutdown, and
        # fold the flush tail into the final record so
        # history[-1]['clock'] is the true total wall-clock. Only patch
        # when the flush actually advanced anything.
        committed, _ = self.driver.flush()
        self._commit(committed)
        if self.history:
            last = self.history[-1]
            if committed or last["pending"] \
                    or last.get("downloads_in_flight"):
                last["clock"] = self.clock
                last["committed"] += len(committed)
                last["pending"] = 0
                if "downloads_in_flight" in last:
                    last["downloads_in_flight"] = 0
        return self.history

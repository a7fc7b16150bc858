"""CommChannel — the metered transport between devices and the Main
Server.

Everything that crosses the cut goes through here: uplink features
(step 4 of Fig. 1) and downlink feature-gradients (step 7). The channel
(a) applies the codec round-trip so the receiver trains on exactly what
the wire delivered, and (b) meters exact payload bytes per direction and
per device-round, which the engine's Eq.-1 tick converts to transfer
time using the link model's rate at the current simulated clock.

Byte convention: payload bytes are exact from the
encoded arrays. Model dispatch/collection defaults to fp32
(``elements * BYTES_PER_ELEM``, matching the paper's Eq.-1 structure);
with a non-fp32 ``dispatch_codec`` the Wc legs cross the wire through
that codec too — the engine routes the client-portion parameters
through ``dispatch_leaves`` / ``collect_leaves`` so dispatch
compression error reaches training and the legs are metered exactly.

``error_feedback=True`` turns the channel stateful: per-(device,
direction) residual accumulators hold the compression error of the last
transfer and add it back before the next encode (SEC/EF-style), so
quantization/sparsification error is compensated across rounds instead
of dropped. A residual is keyed by direction + device (+ leaf index for
model legs) and resets whenever the tensor shape changes (a re-split
changes the cut). fp32 stays bit-exact: its round-trip error is zero,
so the accumulators never hold anything.

Two transport-delay knobs ride on the channel (both default off, so the
fp32/static seed regime is untouched):

``latency``          per-message seconds. A device-round exchanges four
                     messages (Wc dispatch, features up, gradients down,
                     Wc collect), so the atomic Eq.-1 time gains
                     ``4 * latency``; the phase pipeline charges two
                     latencies to the upload phase and two to the
                     download phase. With a non-constant
                     ``latency_dist`` each device-round draws its own
                     latency around this mean (``links.LatencySampler``,
                     deterministic per (seed, device, round) — the
                     driver advances ``sim_round``).
``uplink_capacity``  the Main Server's shared ingress in Table-1
                     elements/s (0 = uncontended). Only the phase-level
                     pipeline can observe overlap, so contention prices
                     only pipelined timelines — see
                     ``links.shared_link_finish_times`` /
                     ``links.FluidLink``.
``downlink_capacity`` the Main Server's shared egress (elements/s, 0 =
                     uncontended): concurrent dfx downloads in the
                     pipeline contend for it with the same max-min fair
                     fluid schedule as the uplink.
"""
from __future__ import annotations

import copy

import torch

from repro_torch.comm.codecs import Codec, get_codec
from repro_torch.comm.links import LatencySampler, StaticLink

AUX_BYTES = 4.0          # the scalar aux-loss rider on each feature msg
MESSAGES_PER_ROUND = 4   # dispatch, features up, grads down, collect


def _l2(r) -> float:
    return float(torch.sum(r.to(torch.float32) ** 2) ** 0.5)


class CommChannel:
    def __init__(self, codec="fp32", grad_codec=None, link=None, *,
                 dispatch_codec="fp32", error_feedback: bool = False,
                 topk_frac: float = None,
                 latency: float = 0.0, uplink_capacity: float = 0.0,
                 downlink_capacity: float = 0.0,
                 latency_dist: str = "constant",
                 latency_jitter: float = 0.5, latency_seed: int = 0):
        def _codec(c, role):
            if not isinstance(c, Codec):
                c = get_codec(c, topk_frac=topk_frac)
                if getattr(c, "name", "") == "randk":
                    # decorrelate the index masks of the up / down /
                    # dispatch legs (same seed + lock-stepped call
                    # counters would drop features and their gradients
                    # at identical positions)
                    c.seed = role
            if error_feedback and getattr(c, "name", "") == "randk" \
                    and c.unbiased:
                # the n/k-scaled operator is not a contraction and
                # makes the feedback accumulators diverge; the residual
                # re-injection compensates the bias instead. Copy a
                # caller-supplied instance rather than mutating it.
                c = copy.copy(c)
                c.unbiased = False
            return c

        self.feature_codec = _codec(codec, 0)
        if grad_codec is None or grad_codec == "":
            grad_codec = self.feature_codec.name
        self.grad_codec = _codec(grad_codec, 1)
        self.dispatch_codec = _codec(dispatch_codec or "fp32", 2)
        self.error_feedback = bool(error_feedback)
        self.link = link or StaticLink()
        if latency < 0:
            raise ValueError(f"latency must be >= 0: {latency}")
        if uplink_capacity < 0:
            raise ValueError(
                f"uplink_capacity must be >= 0 (0 = uncontended): "
                f"{uplink_capacity}")
        if downlink_capacity < 0:
            raise ValueError(
                f"downlink_capacity must be >= 0 (0 = uncontended): "
                f"{downlink_capacity}")
        self.latency = float(latency)
        self.latency_sampler = LatencySampler(
            latency, latency_dist, latency_jitter, latency_seed)
        self.sim_round = 0           # advanced by the RoundDriver
        self.uplink_capacity = float(uplink_capacity)
        self.downlink_capacity = float(downlink_capacity)
        self.up_bytes = 0.0          # device -> server (features)
        self.down_bytes = 0.0        # server -> device (dfx)
        self.disp_up_bytes = 0.0     # device -> server (Wc/update collect)
        self.disp_down_bytes = 0.0   # server -> device (Wc dispatch)
        self._round_up = {}          # cid -> uplink payload bytes this round
        self._round_down = {}        # cid -> downlink payload bytes
        self._round_disp_up = {}     # cid -> collect-leg bytes this round
        self._round_disp_down = {}   # cid -> dispatch-leg bytes
        self._residuals = {}         # (direction, cid[, leaf]) -> tensor
        # fault injection: a killed device's residuals sit here until it
        # rejoins (restored) or forever (discarded, with metered mass)
        self._quarantine = {}        # cid -> {residual key: tensor}
        self.ef_discarded_mass = 0.0  # L2 mass of discarded residuals
        # observability: an observe.TraceRecorder injected by the
        # engine/caller (None or disabled = zero overhead — the wire
        # hooks guard before touching it)
        self.recorder = None

    # --------------------------------------------------- error feedback
    @property
    def dispatch_passthrough(self) -> bool:
        """True when the model legs need no tensor round-trip at all:
        fp32 is lossless, so there is no compression error to inject or
        feed back regardless of ``error_feedback``. The engine then
        skips the dispatch/collect walk entirely and cost models price
        the legs analytically (identical bytes), which keeps the seed
        path bit-exact by construction."""
        return self.dispatch_codec.name == "fp32"

    def _ef_roundtrip(self, codec, key, x):
        """Codec round-trip with the residual accumulator folded in:
        the error of THIS transfer is held under ``key`` and added back
        before the NEXT transfer's encode. Without error feedback —
        or for lossless fp32, whose residual is identically zero — this
        is a plain round-trip."""
        return self._ef_roundtrip_many(codec, [key], [x])[0]

    def _ef_roundtrip_many(self, codec, keys, xs):
        """``_ef_roundtrip`` of each (key, tensor) pair, through one
        ``codec.roundtrip_many`` call: every residual is added first,
        then the list crosses, then every residual is stored."""
        if not self.error_feedback or codec.name == "fp32":
            return codec.roundtrip_many(xs)
        sent = []
        for key, x in zip(keys, xs):
            r = self._residuals.get(key)
            if r is not None and r.shape == x.shape:
                x = x + r.to(x.dtype)
            sent.append(x)
        out = codec.roundtrip_many(sent)
        for key, x, (y, _) in zip(keys, sent, out):
            self._residuals[key] = x - y
        return out

    def residual_norm(self) -> float:
        """Total L2 mass currently held by the feedback accumulators
        (0.0 when feedback is off or nothing has been dropped yet)."""
        return float(sum(_l2(r) for r in self._residuals.values()))

    def residual_norm_of(self, cid) -> float:
        """L2 mass of the feedback accumulators a single device holds
        (residual keys are (direction, cid[, leaf]))."""
        return float(sum(_l2(r) for k, r in self._residuals.items()
                         if k[1] == cid))

    def residual_elements_of(self, cid) -> float:
        """Element count of the device's live feedback accumulators —
        what a cut-layer re-split would discard (shape change resets
        the residual), priced by the resource-aware forecast as bytes
        that must cross the wire again."""
        return float(sum(r.numel() for k, r in self._residuals.items()
                         if k[1] == cid))

    def reset_feedback(self):
        self._residuals = {}

    # ------------------------------------------- residual fault handling
    def quarantine_residuals(self, cid):
        """A device died: move every feedback accumulator it owns out of
        the live set (its next transfer — if it ever rejoins — must not
        re-inject error from its dead incarnation until the plan's
        residual policy decides). Residual keys are (direction, cid[,
        leaf]); everything keyed to ``cid`` moves. Idempotent per kill:
        a second quarantine before release merges into the held set."""
        moved = {k: v for k, v in self._residuals.items() if k[1] == cid}
        if moved:
            for k in moved:
                del self._residuals[k]
            self._quarantine.setdefault(cid, {}).update(moved)

    def release_residuals(self, cid, *, restore: bool = True):
        """The device rejoined. ``restore=True`` puts its quarantined
        accumulators back live (compression error from the dead
        incarnation is compensated as if nothing happened — valid
        because the residual is additive error state, not model state);
        ``restore=False`` discards them, metering the dropped L2 mass
        in ``ef_discarded_mass`` so the loss is observable, not silent.
        A device with nothing quarantined is a no-op."""
        held = self._quarantine.pop(cid, None)
        if not held:
            return
        if restore:
            # live state under the same key wins: the rejoined device
            # may already have fresh residuals from its new incarnation
            for k, v in held.items():
                self._residuals.setdefault(k, v)
        else:
            self.ef_discarded_mass += float(
                sum(_l2(r) for r in held.values()))

    # ------------------------------------------------------ codec state
    def _stateful_codecs(self):
        return (("feature", self.feature_codec),
                ("grad", self.grad_codec),
                ("dispatch", self.dispatch_codec))

    def export_codec_state(self) -> dict:
        """Snapshot the replayable state of any stateful codec (rand-k's
        per-call counter stream) for checkpoint/resume: restoring it
        makes every subsequent index draw identical to an uninterrupted
        run."""
        return {role: c.state() for role, c in self._stateful_codecs()
                if hasattr(c, "state")}

    def restore_codec_state(self, state: dict):
        for role, c in self._stateful_codecs():
            if role in state and hasattr(c, "set_state"):
                c.set_state(state[role])

    def reset_codecs(self):
        """Rewind every stateful codec to the start of its stream."""
        for _, c in self._stateful_codecs():
            if hasattr(c, "reset"):
                c.reset()

    # ------------------------------------------------- checkpoint state
    def export_state(self) -> dict:
        """JSON-safe channel state for full-run checkpoints: cumulative
        byte meters, the simulated round the latency sampler keys on,
        discarded-residual mass, and every stateful codec's stream
        position. Residual TENSORS travel separately (they are arrays —
        see ``export_residual_state``); config knobs are reconstructed
        by the caller."""
        return {"sim_round": self.sim_round,
                "up_bytes": self.up_bytes,
                "down_bytes": self.down_bytes,
                "disp_up_bytes": self.disp_up_bytes,
                "disp_down_bytes": self.disp_down_bytes,
                "ef_discarded_mass": self.ef_discarded_mass,
                "codecs": self.export_codec_state()}

    def restore_state(self, st: dict):
        self.sim_round = int(st["sim_round"])
        self.up_bytes = float(st["up_bytes"])
        self.down_bytes = float(st["down_bytes"])
        self.disp_up_bytes = float(st["disp_up_bytes"])
        self.disp_down_bytes = float(st["disp_down_bytes"])
        self.ef_discarded_mass = float(st["ef_discarded_mass"])
        self.restore_codec_state(st.get("codecs", {}))

    def export_residual_state(self) -> dict:
        """Flatten live + quarantined feedback accumulators to a
        {string name: array} dict an ``.npz`` can hold: live keys become
        ``"r:" + json([direction, cid, leaf?])``, quarantined ones
        ``"q:" + json([cid, [direction, cid, leaf?]])`` (np-integer cids
        coerced to plain ints — they hash/compare equal on restore)."""
        import json

        def _py(o):
            return o.item() if hasattr(o, "item") else o

        out = {}
        for k, v in self._residuals.items():
            out["r:" + json.dumps([_py(p) for p in k])] = v
        for cid, held in self._quarantine.items():
            for k, v in held.items():
                out["q:" + json.dumps([_py(cid),
                                       [_py(p) for p in k]])] = v
        return out

    def restore_residual_state(self, flat: dict):
        import json
        self._residuals = {}
        self._quarantine = {}
        for name, v in flat.items():
            tag, payload = name[:2], json.loads(name[2:])
            if tag == "r:":
                self._residuals[tuple(payload)] = v
            elif tag == "q:":
                cid, key = payload
                self._quarantine.setdefault(cid, {})[tuple(key)] = v
            else:
                raise ValueError(f"unknown residual entry {name!r}")

    # ------------------------------------------------------------ wire
    def _xfer(self, codec, cid, msg, meter, direction):
        """msg: {'h': tensor, ...riders} or bare tensor."""
        if isinstance(msg, dict):
            h, nbytes = self._ef_roundtrip(codec, (direction, cid),
                                           msg["h"])
            out = dict(msg, h=h)
            nbytes += AUX_BYTES * (len(msg) - 1)
        else:
            out, nbytes = self._ef_roundtrip(codec, (direction, cid), msg)
        meter[cid] = meter.get(cid, 0.0) + nbytes
        rec = self.recorder
        if rec is not None and rec.enabled:
            rec.count(f"comm.{direction}.msgs")
            rec.count(f"comm.{direction}.bytes", nbytes)
        return out, nbytes

    def uplink_features(self, cid, feats):
        """Device cid uploads its cut-layer features. Returns what the
        server receives (codec round-trip applied)."""
        out, nbytes = self._xfer(self.feature_codec, cid, feats,
                                 self._round_up, "up")
        self.up_bytes += nbytes
        return out

    def downlink_grads(self, cid, dfx):
        """Server returns the feature gradient to device cid."""
        out, nbytes = self._xfer(self.grad_codec, cid, dfx,
                                 self._round_down, "down")
        self.down_bytes += nbytes
        return out

    # -------------------------------------------------- batched cohort
    def _xfer_cohort(self, codec, pairs, meter, direction):
        """One fused call for a cohort flushed together. ``pairs``:
        [(cid, msg)] in the order the sequential path would have sent
        them. Metering, recorder counts and residual mutations are the
        sequential semantics exactly (see comm/fused.py's contract);
        unsupported codecs or singleton cohorts just loop ``_xfer``."""
        from repro_torch.comm import fused
        if not fused.supports(codec) or len(pairs) < 2:
            return [self._xfer(codec, cid, msg, meter, direction)
                    for cid, msg in pairs]
        items = [((direction, cid),
                  msg["h"] if isinstance(msg, dict) else msg)
                 for cid, msg in pairs]
        results = fused.cohort_roundtrip(codec, items, self._residuals,
                                         self.error_feedback)
        rec = self.recorder
        out = []
        for (cid, msg), (h, nbytes) in zip(pairs, results):
            if isinstance(msg, dict):
                nbytes += AUX_BYTES * (len(msg) - 1)
                out.append((dict(msg, h=h), nbytes))
            else:
                out.append((h, nbytes))
            meter[cid] = meter.get(cid, 0.0) + nbytes
            if rec is not None and rec.enabled:
                rec.count(f"comm.{direction}.msgs")
                rec.count(f"comm.{direction}.bytes", nbytes)
        return out

    def uplink_features_cohort(self, pairs):
        """Batched ``uplink_features``: pairs = [(cid, feats)], returns
        what the server receives for each, in order."""
        results = self._xfer_cohort(self.feature_codec, pairs,
                                    self._round_up, "up")
        for _, nbytes in results:
            self.up_bytes += nbytes
        return [out for out, _ in results]

    def downlink_grads_cohort(self, pairs):
        """Batched ``downlink_grads``: pairs = [(cid, dfx)]."""
        results = self._xfer_cohort(self.grad_codec, pairs,
                                    self._round_down, "down")
        for _, nbytes in results:
            self.down_bytes += nbytes
        return [out for out, _ in results]

    # ------------------------------------------------------ model legs
    def dispatch_leaves(self, cid, leaves):
        """Server -> device: the Wc dispatch leg (or the FedAvg model
        broadcast). Each leaf crosses the wire through the dispatch
        codec; exact bytes are metered per device-round. Residual keys
        carry the leaf index so per-(device, tensor) feedback state
        survives across rounds (and resets on shape changes)."""
        return self._model_leg(cid, leaves, "disp_down",
                               self._round_disp_down)

    def collect_leaves(self, cid, leaves):
        """Device -> server: the updated-Wc collect leg (or the FedAvg
        QSGD-style update upload)."""
        return self._model_leg(cid, leaves, "disp_up",
                               self._round_disp_up)

    def dispatch_leaves_cohort(self, pairs):
        """Batched Wc dispatch: pairs = [(cid, leaves)], one fused call
        for the whole cohort's client portions (leaves flattened in
        (cid, leaf-index) order — the sequential transfer order)."""
        return self._model_leg_cohort(pairs, "disp_down",
                                      self._round_disp_down)

    def collect_leaves_cohort(self, pairs):
        """Batched updated-Wc collect leg."""
        return self._model_leg_cohort(pairs, "disp_up",
                                      self._round_disp_up)

    def _model_leg_cohort(self, pairs, direction, meter):
        if self.dispatch_passthrough:
            return [list(leaves) for _, leaves in pairs]
        from repro_torch.comm import fused
        if not fused.supports(self.dispatch_codec) or len(pairs) < 2:
            return [self._model_leg(cid, leaves, direction, meter)
                    for cid, leaves in pairs]
        items = [((direction, cid, i), x)
                 for cid, leaves in pairs
                 for i, x in enumerate(leaves)]
        results = fused.cohort_roundtrip(self.dispatch_codec, items,
                                         self._residuals,
                                         self.error_feedback)
        rec = self.recorder
        outs, pos = [], 0
        for cid, leaves in pairs:
            ys, nbytes = [], 0.0
            for _ in leaves:
                y, b = results[pos]
                pos += 1
                ys.append(y)
                nbytes += b
            meter[cid] = meter.get(cid, 0.0) + nbytes
            if direction == "disp_down":
                self.disp_down_bytes += nbytes
            else:
                self.disp_up_bytes += nbytes
            if rec is not None and rec.enabled:
                rec.count(f"comm.{direction}.msgs")
                rec.count(f"comm.{direction}.bytes", nbytes)
            outs.append(ys)
        return outs

    def _model_leg(self, cid, leaves, direction, meter):
        if self.dispatch_passthrough:
            return list(leaves)
        results = self._ef_roundtrip_many(
            self.dispatch_codec,
            [(direction, cid, i) for i in range(len(leaves))], leaves)
        out = [y for y, _ in results]
        nbytes = 0.0
        for _, b in results:
            nbytes += b
        meter[cid] = meter.get(cid, 0.0) + nbytes
        if direction == "disp_down":
            self.disp_down_bytes += nbytes
        else:
            self.disp_up_bytes += nbytes
        rec = self.recorder
        if rec is not None and rec.enabled:
            rec.count(f"comm.{direction}.msgs")
            rec.count(f"comm.{direction}.bytes", nbytes)
        return out

    # ------------------------------------------------------- accounting
    @property
    def total_bytes(self) -> float:
        return self.up_bytes + self.down_bytes \
            + self.disp_up_bytes + self.disp_down_bytes

    def round_payload(self, cid) -> float:
        """Exact cut-layer payload bytes metered for cid since the last
        reset (model legs are under ``round_dispatch``)."""
        return self._round_up.get(cid, 0.0) \
            + self._round_down.get(cid, 0.0)

    def round_payload_split(self, cid):
        """(uplink, downlink) payload bytes metered for cid this round —
        the per-direction split the phase pipeline prices."""
        return (self._round_up.get(cid, 0.0),
                self._round_down.get(cid, 0.0))

    def round_dispatch(self, cid) -> float:
        """Exact model-leg bytes (Wc dispatch + collect) metered for cid
        this round; 0.0 on the fp32 passthrough (cost models then price
        the legs analytically — identical by construction)."""
        return self._round_disp_up.get(cid, 0.0) \
            + self._round_disp_down.get(cid, 0.0)

    def round_dispatch_split(self, cid):
        """(dispatch-down, collect-up) model-leg bytes for cid."""
        return (self._round_disp_down.get(cid, 0.0),
                self._round_disp_up.get(cid, 0.0))

    def reset_round(self):
        self._round_up = {}
        self._round_down = {}
        self._round_disp_up = {}
        self._round_disp_down = {}

    def estimate_uplink_payload(self, n_values: float,
                                last_dim: int = 0) -> float:
        """Analytic uplink (feature) payload bytes for n_values cut-layer
        elements — the upload phase's wire traffic."""
        return self.feature_codec.estimate_bytes(n_values, last_dim) \
            + AUX_BYTES

    def estimate_downlink_payload(self, n_values: float,
                                  last_dim: int = 0) -> float:
        """Analytic downlink (feature-gradient) payload bytes."""
        return self.grad_codec.estimate_bytes(n_values, last_dim) \
            + AUX_BYTES

    def estimate_round_payload(self, n_values: float,
                               last_dim: int = 0) -> float:
        """Analytic up+down payload bytes for n_values cut-layer elements
        each way — for devices whose tensors are never materialized
        (warm-up observation of non-participants)."""
        return (self.feature_codec.estimate_bytes(n_values, last_dim)
                + self.grad_codec.estimate_bytes(n_values, last_dim)
                + 2 * AUX_BYTES)

    def estimate_dispatch_leg(self, wc_size: float) -> float:
        """Analytic one-way model-leg bytes for a wc_size-element client
        portion under the dispatch codec (fp32 reproduces the seed's
        ``wc_size * BYTES_PER_ELEM``)."""
        return self.dispatch_codec.estimate_bytes(wc_size)

    def estimate_dispatch_round(self, wc_size: float) -> float:
        """Dispatch + collect legs (the Eq.-1 ``2|Wc|`` term, now priced
        through the dispatch codec)."""
        return 2.0 * self.estimate_dispatch_leg(wc_size)

    def latency_of(self, cid) -> float:
        """This device-round's per-message latency: the constant knob
        unless a distribution is configured, in which case the draw is
        seeded by (latency_seed, cid, sim_round) — deterministic under
        replay, identical across re-pricings of the same round."""
        return self.latency_sampler.sample(cid, self.sim_round)

    def analytic_round_time(self, dev, *, wc_size: float, n_values: float,
                            fc: float, fs: float, t: float):
        """Eq.-1 device-round (time, bytes) from analytic payloads: the
        single formula shared by the engine's warm-up branch, the
        benchmark sweep, and the scheduler tests — change the payload
        convention here and every consumer follows."""
        from repro_torch.core.simulation import device_round_time_bytes
        nbytes = self.estimate_dispatch_round(wc_size) \
            + self.estimate_round_payload(n_values)
        t_round = device_round_time_bytes(dev, comm_bytes=nbytes, fc=fc,
                                          fs=fs, rate=self.rate(dev, t)) \
            + MESSAGES_PER_ROUND * self.latency_of(dev.cid)
        return t_round, nbytes

    def rate(self, dev, t: float) -> float:
        return self.link.rate(dev, t)

    def mean_rate(self, dev, t0: float, t1: float) -> float:
        """Average link rate over [t0, t1] (predictive forecasts price a
        transfer spanning the projected window with this); links without
        a mean fall back to the instantaneous rate at t0."""
        if hasattr(self.link, "mean_rate"):
            return self.link.mean_rate(dev, t0, t1)
        return self.link.rate(dev, t0)

"""Full-training-state snapshots: everything an ``S2FLEngine`` run needs
to resume bit-exactly, in ONE ``.npz`` — the reference's
``s2fl-run-state-v1`` format, key for key, so a snapshot of either
package restores into the other.

``save_checkpoint``'s tree layer carries every array (model params, the
``prng_key`` words, error-feedback residuals — live and quarantined —
and the un-committed held work's client/server copies), while the JSON
``extra`` side-channel carries the simulator state: the driver's whole
timeline (clock, event/download heaps, live flights, FluidLink flows,
server queue, fault ledger, scheduler EMA table), the channel's byte
meters + stateful-codec stream positions, the numpy Generator state,
and the run history.

The port draws no key of its own: ``prng_key`` holds the words of the
reference's ``PRNGKey(seed + 1)`` (``S2FLEngine._key``), and a restore
keeps whatever the file holds.

Bit-exactness argument: every float crosses JSON via ``repr`` (exact
round-trip), arrays cross ``.npz`` verbatim and come back on the
engine's device in their dtype, the numpy RNG state is restored to the
word, and the driver/channel/scheduler restores rebuild the exact heaps
and maps — so on the fp32 sync path a crash-and-resume run replays the
uninterrupted run's arithmetic operation-for-operation.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.utils.tree import tree_map


def _on(tree, device):
    """numpy leaves -> tensors on ``device``, dtype kept."""
    return tree_map(lambda a: torch.from_numpy(np.array(a)).to(device), tree)


def save_run_state(path: str, engine) -> None:
    """Snapshot ``engine`` (an ``S2FLEngine``) between rounds."""
    from repro_torch.checkpoint import save_checkpoint
    held_arrays, held_meta = {}, {}
    if engine.ecfg.mode == "fedavg":
        for gid, (params, weight) in engine._held.items():
            held_arrays[str(gid)] = {"params": params}
            held_meta[str(gid)] = float(weight)
    else:
        for gid, (states, server_copy) in engine._held.items():
            held_arrays[str(gid)] = {
                "server": server_copy,
                "clients": [st.params for st in states]}
            held_meta[str(gid)] = [[st.cid, st.split, st.data_size,
                                    st.group] for st in states]
    tree = {"params": engine.params,
            "prng_key": engine._key,
            "residuals": engine.channel.export_residual_state(),
            "held": held_arrays}
    extra = {"format": "s2fl-run-state-v1",
             "mode": engine.ecfg.mode,
             "history": engine.history,
             "next_gid": engine._next_gid,
             "rng_state": engine.rng.bit_generator.state,
             "driver": engine.driver.export_state(),
             "channel": engine.channel.export_state(),
             "held_meta": held_meta}
    save_checkpoint(path, tree, extra=extra)


def restore_run_state(path: str, engine) -> dict:
    """Restore a ``save_run_state`` snapshot into a freshly-constructed,
    identically-configured engine. Returns the ``extra`` metadata (the
    restored ``history`` is also installed on the engine, so
    ``len(engine.history)`` is the next round index)."""
    from repro_torch.checkpoint import load_checkpoint
    from repro_torch.core.aggregation import ClientState
    tree, extra = load_checkpoint(path)
    if extra.get("format") != "s2fl-run-state-v1":
        raise ValueError(f"{path}: not a run-state checkpoint "
                         f"(format={extra.get('format')!r})")
    if extra["mode"] != engine.ecfg.mode:
        raise ValueError(
            f"checkpoint mode {extra['mode']!r} != engine mode "
            f"{engine.ecfg.mode!r} — reconstruct the engine with the "
            "config the run was started with")
    dev = engine.device
    engine.params = _on(tree["params"], dev)
    engine._key = np.asarray(tree["prng_key"])
    engine.channel.restore_residual_state(_on(tree["residuals"], dev))
    engine.channel.restore_state(extra["channel"])
    engine.driver.restore_state(extra["driver"])
    engine.rng = np.random.default_rng()
    engine.rng.bit_generator.state = extra["rng_state"]
    engine.history = list(extra["history"])
    engine._next_gid = int(extra["next_gid"])
    engine._held = {}
    held_arrays = tree.get("held", {})
    for sgid, meta in extra["held_meta"].items():
        gid = int(sgid)
        if engine.ecfg.mode == "fedavg":
            engine._held[gid] = (_on(held_arrays[sgid]["params"], dev),
                                 float(meta))
        else:
            clients = held_arrays[sgid]["clients"]
            states = [ClientState(cid=cid, params=_on(clients[i], dev),
                                  split=int(split),
                                  data_size=float(dsz), group=gid)
                      for i, (cid, split, dsz, _g) in enumerate(meta)]
            engine._held[gid] = (states,
                                 _on(held_arrays[sgid]["server"], dev))
    return extra

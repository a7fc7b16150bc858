"""Accounting of a traced SPMD step: collective bytes, FLOPs, bytes moved,
memory, and the roofline terms they give.

The reference reads these from XLA's compiled HLO. The port has no HLO:
its dry-run runs the step once on fake tensors (``FakeTensorMode``) over
a fake process group, and the modes here watch the ops that one rank
runs on its local shards. Each mode hands an op on DTensors back to
DTensor (``NotImplemented``), which then runs the rank's local ops, and
those the mode sees. The ops that DTensor's sharding propagation runs
on global shapes to learn an output's shape are not part of the rank's
work, and ``local_ops_only`` keeps every mode from counting them.

What the numbers mean (per rank):

- ``hlo_flops``: the sum of ``torch.utils.flop_counter``'s formulas
  (``FlopCounterMode``'s registry) over the local ops. It counts matrix
  products, convolutions and attention, not elementwise work; XLA's
  ``cost_analysis`` counts elementwise work too, so ``useful_ratio``
  reads a little higher here than the reference's would.
- ``hlo_bytes``: the sum, over every local op that is not a view, a
  metadata query or an allocation, of its input and output bytes. This
  is eager, unfused traffic: what the port as written moves, more than
  a fused XLA program would.
- ``coll_bytes``: the output bytes of every functional collective
  (``_c10d_functional.*``) that DTensor's redistributions issue, by
  kind, as the reference sums each collective's output buffer. A
  collective's ``wait_tensor`` is not a second collective.
- memory: ``peak_bytes`` is the most bytes held at once by live
  storages (views are not storages) during the step, the arguments
  included; a storage is freed when its last tensor goes, seen through
  a weakref finalizer on the storage.

Hardware constants, one NVIDIA H100 SXM5 (NVIDIA's H100 data sheet,
dense rates, 700 W):

- ``PEAK_FLOPS``: 989.4 TFLOP/s, bf16 on the tensor cores.
- ``HBM_BW``: 3.35 TB/s, HBM3.
- ``LINK_BW``: 50 GB/s, the counterpart of the reference's ICI link.
  The production mesh's ``model`` axis of 16 spans two 8-GPU NVLink
  nodes, so its collectives cross the network card: one 400 Gb/s NDR
  InfiniBand port per GPU (NVIDIA DGX H100 system spec).
"""
from __future__ import annotations

import contextlib
import dataclasses
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode

PEAK_FLOPS = 989.4e12        # per GPU, bf16 dense
HBM_BW = 3.35e12             # per GPU, bytes/s
LINK_BW = 50e9               # per GPU, bytes/s (400 Gb/s NDR InfiniBand)

_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                "collective-permute")

# functional collective (``torch.ops._c10d_functional``) -> the kind the
# reference names it by
_KIND = {
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}

_META_OPS = frozenset({"prim::device", "prim::layout", "aten::detach",
                       "aten::lift_fresh", "_c10d_functional::wait_tensor"})
_ALLOC_OPS = frozenset({"aten::empty", "aten::empty_like",
                        "aten::empty_strided", "aten::new_empty",
                        "aten::new_empty_strided"})

_PROPAGATING = [0]


@contextlib.contextmanager
def local_ops_only():
    """While open, DTensor's sharding propagation (which picks each op's
    placements, and runs the op on global shapes to learn its output's
    shape and strides) is counted by no mode here, and runs outside the
    fake mode: its planning reads small index tensors (a strided
    shard's offsets), which a fake tensor cannot give, and which a real
    run reads on the host the same way. The propagator is DTensor's one
    instance; its entry points are wrapped for the span of the block and
    put back."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.placement_types import _StridedShard
    prop = DTensor._op_dispatcher.sharding_propagator
    names = ("propagate_op_sharding", "propagate_op_sharding_non_cached",
             "_propagate_tensor_meta_non_cached")
    inner = {n: getattr(prop, n) for n in names}

    def planning(fn):
        def run(*args, **kwargs):
            _PROPAGATING[0] += 1
            try:
                with unset_fake_temporarily():
                    return fn(*args, **kwargs)
            finally:
                _PROPAGATING[0] -= 1
        return run

    for n, fn in inner.items():
        setattr(prop, n, planning(fn))
    strided = _StridedShard.local_shard_size_and_offset
    _StridedShard.local_shard_size_and_offset = planning(strided)
    try:
        yield
    finally:
        for n, fn in inner.items():
            setattr(prop, n, fn)
        _StridedShard.local_shard_size_and_offset = strided


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


class _LocalOpMode(TorchDispatchMode):
    """Calls ``record(func, args, kwargs, out)`` once for each op a rank
    runs on its local tensors (not on DTensors, not in propagation, not
    on the ``meta`` device: shapes only, no storage on any rank)."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if not _PROPAGATING[0] and not any(
                t.device.type == "meta" for t in _tensors((args, out))):
            self.record(func, args, kwargs, out)
        return out

    def record(self, func, args, kwargs, out):
        raise NotImplementedError


class CollectiveBytes(_LocalOpMode):
    """Output bytes of each collective, summed by kind; ``result()`` has
    the reference's keys (each kind, ``_counts`` and ``_total``)."""

    def __init__(self):
        super().__init__()
        self.bytes = {k: 0 for k in _COLLECTIVES}
        self.counts = {k: 0 for k in _COLLECTIVES}

    def record(self, func, args, kwargs, out):
        ns, _, name = func._schema.name.partition("::")
        if ns != "_c10d_functional" or name == "wait_tensor":
            return
        if name not in _KIND:
            raise NotImplementedError(f"collective {func} has no kind")
        kind = _KIND[name]
        self.bytes[kind] += sum(_nbytes(t) for t in _tensors(out))
        self.counts[kind] += 1

    def result(self) -> dict:
        out = dict(self.bytes)
        out["_counts"] = dict(self.counts)
        out["_total"] = sum(self.bytes.values())
        return out


class FlopCount(_LocalOpMode):
    """FLOPs of the local ops by ``FlopCounterMode``'s formulas."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._registry = flop_registry
        self.flops = 0

    def record(self, func, args, kwargs, out):
        f = self._registry.get(func._overloadpacket)
        if f is not None:
            self.flops += int(f(*args, **kwargs, out_val=out))


class BytesAndMemory(_LocalOpMode):
    """Bytes each local op reads and writes, and the live storages'
    bytes over the step (``track`` the arguments first)."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self._seen = {}                  # id(storage) -> bytes, while alive

    def track(self, tensors) -> int:
        """Count these tensors' storages as live (the step's arguments);
        -> the bytes newly counted."""
        added = 0
        for t in tensors:
            added += self._hold(t)
        self.peak = max(self.peak, self.live)
        return added

    def _hold(self, t) -> int:
        st = t.untyped_storage()
        key = id(st)
        if key in self._seen:
            return 0
        n = st.nbytes()
        self._seen[key] = n
        self.live += n
        weakref.finalize(st, self._free, key)
        return n

    def _free(self, key):
        self.live -= self._seen.pop(key)

    def record(self, func, args, kwargs, out):
        name = func._schema.name
        if name in _META_OPS or func.is_view:
            return
        outs = list(_tensors(out))
        for t in outs:
            self._hold(t)
        self.peak = max(self.peak, self.live)
        if name in _ALLOC_OPS:
            return
        ins = {id(t): t for t in _tensors((args, kwargs))}
        moved = {**ins, **{id(t): t for t in outs}}   # in place: once
        self.bytes += sum(_nbytes(t) for t in moved.values())


def storage_bytes(tensors) -> int:
    """Bytes of the distinct storages under ``tensors``."""
    seen = {}
    for t in tensors:
        st = t.untyped_storage()
        seen[id(st)] = st.nbytes()
    return sum(seen.values())


@dataclasses.dataclass
class Roofline:
    """Per-rank terms of one step: ``hlo_flops`` / ``hlo_bytes`` /
    ``coll_bytes`` are one rank's (see the module docstring for what
    each counts); ``model_flops`` is the global 6·N·D useful compute, so
    ``useful_ratio`` divides it by the FLOPs of all ranks."""
    arch: str
    shape: str
    n_chips: int
    hlo_flops: float             # per rank
    hlo_bytes: float             # per rank
    coll_bytes: float            # per rank collective traffic
    model_flops: float           # global 6·N·D useful compute
    coll_detail: dict = dataclasses.field(default_factory=dict)

    @property
    def t_compute(self) -> float:
        return self.hlo_flops / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.hlo_bytes / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.coll_bytes / LINK_BW

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_ratio(self) -> float:
        total = self.hlo_flops * self.n_chips
        return self.model_flops / total if total else 0.0

    def row(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "chips": self.n_chips,
            "t_compute_s": self.t_compute, "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective, "dominant": self.dominant,
            "hlo_flops": self.hlo_flops, "hlo_bytes": self.hlo_bytes,
            "coll_bytes": self.coll_bytes, "model_flops": self.model_flops,
            "useful_ratio": self.useful_ratio,
        }


def analyze(flops: FlopCount, traffic: BytesAndMemory,
            coll: CollectiveBytes, *, arch: str, shape: str, n_chips: int,
            model_flops: float) -> Roofline:
    """The roofline of a step traced under the three modes."""
    detail = coll.result()
    return Roofline(arch=arch, shape=shape, n_chips=n_chips,
                    hlo_flops=float(flops.flops),
                    hlo_bytes=float(traffic.bytes),
                    coll_bytes=float(detail["_total"]),
                    model_flops=model_flops, coll_detail=detail)

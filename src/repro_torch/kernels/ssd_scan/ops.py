"""Public entry of the SSD scan: the kernel wrapper takes the model's
(b,s,h,p) layout as it is, so no adapter sits in front of it. On a
device mesh (DTensor inputs) each rank scans its own batch rows
(``_build.on_batch_shards``); ``A`` (per head) is replicated."""
from __future__ import annotations

from repro_torch.kernels import _build
from repro_torch.kernels.ssd_scan import kernel


def ssd_scan(x, dt, A, B, C, *, chunk: int = 128, initial_state=None):
    def run(x, dt, A, B, C, init):
        return kernel.ssd_scan(x, dt, A, B, C, chunk=chunk,
                               initial_state=init)
    return _build.on_batch_shards(run, (x, dt, A, B, C, initial_state),
                                  (True, True, False, True, True, True))

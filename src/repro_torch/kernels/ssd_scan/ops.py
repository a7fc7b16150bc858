"""Public entry of the SSD scan: the kernel wrapper takes the model's
(b,s,h,p) layout as it is, so no adapter sits in front of it. Plain
tensors only (a kernel reads raw device pointers): on a device mesh
``models/ssm.py`` calls it on each rank's own batch rows and heads."""
from __future__ import annotations

from repro_torch.kernels.ssd_scan.kernel import ssd_scan  # noqa: F401

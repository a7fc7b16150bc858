"""Public entry of the SSD scan: the kernel wrapper takes the model's
(b,s,h,p) layout as it is, so no adapter sits in front of it."""
from repro_torch.kernels.ssd_scan.kernel import ssd_scan  # noqa: F401

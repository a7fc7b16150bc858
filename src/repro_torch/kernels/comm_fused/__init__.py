from repro_torch.kernels.comm_fused.ops import (  # noqa: F401
    fused_cast_roundtrip, fused_int8_roundtrip, fused_sparse_roundtrip,
    int8_group_geometry)

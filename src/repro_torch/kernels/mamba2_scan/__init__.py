from repro_torch.kernels.mamba2_scan.ops import (
    mamba2_scan,
    mamba2_scan_mt_jvps,
    mamba2_scan_mt_jvps_ref,
    mamba2_scan_mt_ref,
    mamba2_scan_mt_tangents,
    mamba2_scan_ref,
)

from repro_torch.kernels.wkv6_scan.ops import (
    wkv6_scan,
    wkv6_scan_mt_jvps,
    wkv6_scan_mt_jvps_ref,
    wkv6_scan_mt_ref,
    wkv6_scan_mt_tangents,
    wkv6_scan_ref,
)

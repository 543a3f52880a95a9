from repro_torch.kernels.linear_scan.ops import linear_scan, linear_scan_bwd
from repro_torch.kernels.linear_scan.ref import (linear_scan_bwd_ref,
                                                 linear_scan_ref,
                                                 rglru_coefficients)

from repro_torch.kernels.linear_scan.ops import linear_scan
from repro_torch.kernels.linear_scan.ref import (linear_scan_ref,
                                                 rglru_coefficients)

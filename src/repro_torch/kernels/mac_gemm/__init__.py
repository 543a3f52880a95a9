from repro_torch.kernels.mac_gemm.ops import mac_gemm, mac_gemm_dequant
from repro_torch.kernels.mac_gemm.ref import (mac_gemm_dequant_ref,
                                              mac_gemm_ref)

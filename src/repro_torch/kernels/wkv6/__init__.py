from repro_torch.kernels.wkv6.ops import wkv6, wkv6_bwd
from repro_torch.kernels.wkv6.ref import wkv6_bwd_ref, wkv6_ref

from repro_torch.kernels.wkv6.ops import wkv6
from repro_torch.kernels.wkv6.ref import wkv6_ref

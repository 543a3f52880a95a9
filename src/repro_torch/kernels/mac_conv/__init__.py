from repro_torch.kernels.mac_conv.ops import mac_conv2d
from repro_torch.kernels.mac_conv.ref import conv_geometry, mac_conv2d_ref

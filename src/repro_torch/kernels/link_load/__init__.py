from repro_torch.kernels.link_load.ops import link_loads_csc
from repro_torch.kernels.link_load.ref import (link_loads_csc_ref,
                                               link_loads_ref)

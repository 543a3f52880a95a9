from repro_torch.kernels.link_load.ops import link_loads_csc, noc_link_loads
from repro_torch.kernels.link_load.ref import (link_loads_csc_ref,
                                               link_loads_ref,
                                               noc_link_loads_ref)

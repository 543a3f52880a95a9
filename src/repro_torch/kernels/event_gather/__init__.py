from repro_torch.kernels.event_gather.ops import (active_source_set,
                                                  event_link_loads,
                                                  gather_entries)
from repro_torch.kernels.event_gather.ref import event_link_loads_ref

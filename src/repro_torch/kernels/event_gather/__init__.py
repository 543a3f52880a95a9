from repro_torch.kernels.event_gather.ops import (active_source_set,
                                                  compact_lanes,
                                                  event_link_loads,
                                                  gather_entries)
from repro_torch.kernels.event_gather.ref import (compact_lanes_ref,
                                                  event_link_loads_ref)

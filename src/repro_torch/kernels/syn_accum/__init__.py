from repro_torch.kernels.syn_accum.ops import syn_accum
from repro_torch.kernels.syn_accum.ref import (pack_spikes, popcount_words,
                                               spike_words, syn_accum_ref,
                                               unpack_spikes)

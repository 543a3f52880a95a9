from repro_torch.kernels.flash_attn.ops import (flash_attention_bwd,
                                                flash_attention_kernel)
from repro_torch.kernels.flash_attn.ref import (flash_attention_bwd_ref,
                                                flash_attention_ref)

from repro_torch.kernels.lif.ops import lif_params_fx, lif_step
from repro_torch.kernels.lif.ref import fx_mul, lif_step_ref

from repro_torch.kernels.explog.ops import fx_exp, to_fx
from repro_torch.kernels.explog.ref import FX_ONE, fx_exp_ref

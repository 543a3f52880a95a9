from repro_torch.kernels.explog.ops import (from_fx, fx_exp, fx_log,
                                            fx_log_float, to_fx)
from repro_torch.kernels.explog.ref import FX_ONE, fx_exp_ref, fx_log_ref

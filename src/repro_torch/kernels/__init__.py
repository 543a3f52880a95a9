"""Hand-written CUDA kernels (``csrc/``) behind device-dispatching
wrappers, each beside its plain PyTorch version (``<name>/ref.py``).

Every wrapper counts its kernel launches in a plain integer attribute
``launches``; ``launch_counts``/``reset_launch_counts`` read and zero all
of them, so a run can show that it went through the kernels.
"""
from __future__ import annotations

from repro_torch.kernels.event_gather.ops import (compact_lanes,
                                                  event_link_loads)
from repro_torch.kernels.explog.ops import fx_exp, fx_log
from repro_torch.kernels.flash_attn.ops import (flash_attention_bwd,
                                                flash_attention_kernel)
from repro_torch.kernels.lif.ops import lif_step
from repro_torch.kernels.linear_scan.ops import linear_scan
from repro_torch.kernels.link_load.ops import link_loads_csc, noc_link_loads
from repro_torch.kernels.mac_conv.ops import mac_conv2d
from repro_torch.kernels.mac_gemm.ops import mac_gemm
from repro_torch.kernels.syn_accum.ops import syn_accum
from repro_torch.kernels.wkv6.ops import wkv6

WRAPPERS = {"fx_exp": fx_exp, "lif_step": lif_step,
            "link_loads_csc": link_loads_csc,
            "noc_link_loads": noc_link_loads, "syn_accum": syn_accum,
            "event_link_loads": event_link_loads, "mac_gemm": mac_gemm,
            "fx_log": fx_log, "mac_conv2d": mac_conv2d,
            "flash_attention_kernel": flash_attention_kernel,
            "flash_attention_bwd": flash_attention_bwd,
            "compact_lanes": compact_lanes, "linear_scan": linear_scan,
            "wkv6": wkv6}


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0
    wkv6.route_launches.update(dict.fromkeys(wkv6.route_launches, 0))

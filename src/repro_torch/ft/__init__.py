from repro_torch.ft.loop import FaultTolerantLoop, LoopConfig

from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.queue import RequestQueue, percentiles, select_width

__all__ = ["Request", "RequestQueue", "ServeEngine", "percentiles",
           "select_width"]

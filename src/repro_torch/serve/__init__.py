from repro_torch.serve.queue import RequestQueue, percentiles, select_width

__all__ = ["RequestQueue", "percentiles", "select_width"]

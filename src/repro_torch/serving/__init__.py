from repro_torch.serving.engine import Request, ServeEngine
from repro_torch.serving.kv_cache import (PagedKVManager, fetch_holes,
                                          spill_cold_pages)

__all__ = ["ServeEngine", "Request", "PagedKVManager", "spill_cold_pages",
           "fetch_holes"]

"""Serving: the static-batching engine and the continuous-batching engine
over a paged, prefix-shared KV pool."""
from .continuous import ContinuousEngine                      # noqa: F401
from .engine import Request, Result, ServingEngine            # noqa: F401
from .kv_pool import (PagedKVPool, apply_page_permutation,    # noqa: F401
                      copy_pages, invalidate_pages)
from .prefix_cache import PrefixCache                         # noqa: F401
from .scheduler import Scheduler, ServeRequest                # noqa: F401

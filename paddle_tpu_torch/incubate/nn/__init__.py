from .paged_cache import PagedKVCacheManager, paged_attention  # noqa: F401

from .paged_cache import PagedKVCacheManager  # noqa: F401

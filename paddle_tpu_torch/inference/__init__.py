from .paged_llama import PagedLlamaAdapter  # noqa: F401
from .prefix_cache import PrefixMatch, RadixPrefixCache  # noqa: F401
from .serving import (  # noqa: F401
    BatchScheduler,
    QueueFullError,
    Request,
    RequestState,
    bucket_packed_tokens,
)

from .paged_llama import PagedLlamaAdapter  # noqa: F401
from .serving import (  # noqa: F401
    BatchScheduler,
    Request,
    RequestState,
    bucket_packed_tokens,
)

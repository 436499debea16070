from .paged_llama import PagedLlamaAdapter  # noqa: F401
from .prefix_cache import PrefixMatch, RadixPrefixCache  # noqa: F401
from .serving import (  # noqa: F401
    BatchScheduler,
    QueueFullError,
    Request,
    RequestState,
    bucket_packed_tokens,
)
from .engine import (  # noqa: F401
    EngineClosedError,
    EngineOverloadError,
    ServingEngine,
    TokenStream,
)
from .disagg import (  # noqa: F401
    DecodeWorker,
    DisaggReplica,
    PrefillWorker,
    SessionRouter,
    SessionStream,
    apply_role_budgets,
    role_scheduler_kwargs,
)

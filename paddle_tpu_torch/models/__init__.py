from .convert import from_reference_state  # noqa: F401
from .llama import (  # noqa: F401
    LlamaAttention,
    LlamaConfig,
    LlamaDecoderLayer,
    LlamaForCausalLM,
    LlamaMLP,
    LlamaModel,
    llama3_8b,
    llama_tiny,
    mistral_7b,
    qwen2_0_5b,
)

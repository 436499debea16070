from .convert import from_hf, from_reference_state, load_hf_llama  # noqa: F401
from .generation import generate, speculative_generate  # noqa: F401
from .llama import (  # noqa: F401
    LlamaAttention,
    LlamaConfig,
    LlamaDecoderLayer,
    LlamaForCausalLM,
    LlamaMLP,
    LlamaModel,
    LlamaPretrainingCriterion,
    llama2_7b,
    llama2_13b,
    llama3_8b,
    llama3_70b,
    llama_headline,
    llama_tiny,
    mistral_7b,
    qwen2_0_5b,
    qwen2_7b,
)

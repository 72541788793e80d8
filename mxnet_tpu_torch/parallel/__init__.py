"""Model code: the transformer LM (decode serving over either KV cache,
generation, the single-device train step with MoE layers and remat) and
the MoE routing it uses."""
from .moe import moe_apply, stack_expert_params, top_k_gating
from .ring_attention import ring_attention_local
from .transformer import (PagedKVCache, TransformerConfig, TransformerParams,
                          init_kv_cache, init_kv_pages,
                          init_transformer_params_np,
                          make_transformer_train_step,
                          transformer_decode_step,
                          transformer_decode_step_paged,
                          transformer_forward_single, transformer_generate,
                          transformer_prefill, transformer_prefill_paged)

__all__ = ["PagedKVCache", "TransformerConfig", "TransformerParams",
           "init_kv_cache", "init_kv_pages", "init_transformer_params_np",
           "make_transformer_train_step", "moe_apply", "ring_attention_local",
           "stack_expert_params", "top_k_gating", "transformer_decode_step",
           "transformer_decode_step_paged", "transformer_forward_single",
           "transformer_generate", "transformer_prefill",
           "transformer_prefill_paged"]

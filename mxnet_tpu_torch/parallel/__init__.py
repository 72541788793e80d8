"""Model code: the transformer LM's decode-serving paths and its
single-device train step."""
from .ring_attention import ring_attention_local
from .transformer import (PagedKVCache, TransformerConfig, TransformerParams,
                          init_kv_pages, init_transformer_params_np,
                          make_transformer_train_step,
                          transformer_decode_step,
                          transformer_decode_step_paged,
                          transformer_forward_single,
                          transformer_prefill_paged)

__all__ = ["PagedKVCache", "TransformerConfig", "TransformerParams",
           "init_kv_pages", "init_transformer_params_np",
           "make_transformer_train_step", "ring_attention_local",
           "transformer_decode_step", "transformer_decode_step_paged",
           "transformer_forward_single", "transformer_prefill_paged"]

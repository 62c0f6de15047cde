"""grok-1-314b [hf:xai-org/grok-1]: 64L d=6144 48H (GQA kv=8) ff=32768
vocab=131072, MoE 8 experts top-2, bf16 params, Adafactor (factored
second moments: AdamW's state for 314B params would not fit).  The JAX
config's mesh rules (experts replicated, tensor parallelism inside each
expert) have no counterpart on one card."""
from repro_torch.configs.base import ArchSpec, LMConfig, LM_SHAPES, register

CONFIG = LMConfig(
    name="grok-1-314b", n_layers=64, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=32768, moe_d_ff=32768, vocab_size=131072, act="gelu",
    norm="rmsnorm", n_experts=8, n_experts_per_tok=2,
    param_dtype="bfloat16", optimizer="adafactor")

register(ArchSpec("grok-1-314b", "lm", CONFIG, LM_SHAPES,
                  source="hf:xai-org/grok-1"))

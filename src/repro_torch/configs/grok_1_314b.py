"""grok-1-314b [hf:xai-org/grok-1]: 64L d=6144 48H (GQA kv=8) ff=32768
vocab=131072, MoE 8 experts top-2, bf16 params, Adafactor (factored
second moments: AdamW's state for 314B params would not fit).

8 experts do not divide the 16-way model axis, so under a mesh the
experts are replicated over ``model`` (``RULES_OVERRIDE``, the JAX
config's): ``_moe_block`` then takes the dense loop where a data rank
has 1,024 tokens or more.  The override's ``expert_mlp -> model`` is
tensor parallelism inside each expert, the only split of the experts:
each model rank holds every expert's ``w_gate`` and ``w_up`` columns and
``w_down`` rows of its block of the expert ff (``models/lm/model.py``,
under ``_moe_dense`` and ``_moe_scatter``)."""
from repro_torch.configs.base import ArchSpec, LMConfig, LM_SHAPES, register

CONFIG = LMConfig(
    name="grok-1-314b", n_layers=64, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=32768, moe_d_ff=32768, vocab_size=131072, act="gelu",
    norm="rmsnorm", n_experts=8, n_experts_per_tok=2,
    param_dtype="bfloat16", optimizer="adafactor")

RULES_OVERRIDE = {"expert": None, "expert_mlp": "model"}

register(ArchSpec("grok-1-314b", "lm", CONFIG, LM_SHAPES,
                  source="hf:xai-org/grok-1"))

"""kimi-k2-1t-a32b [arXiv:2501.kimi2]: 61L d=7168 64H (GQA kv=8), head
dim 112, expert-ff=2048 vocab=163840, MoE 384 experts top-8 (~1T params,
32B active), bf16 params, Adafactor.  As in the JAX config, every layer
is a uniform MoE layer (the real K2 has a dense first layer and a shared
expert)."""
from repro_torch.configs.base import ArchSpec, LMConfig, LM_SHAPES, register

CONFIG = LMConfig(
    name="kimi-k2-1t-a32b", n_layers=61, d_model=7168, n_heads=64,
    n_kv_heads=8, d_ff=2048, moe_d_ff=2048, vocab_size=163840, act="silu",
    norm="rmsnorm", n_experts=384, n_experts_per_tok=8,
    capacity_factor=1.25, param_dtype="bfloat16", optimizer="adafactor")

register(ArchSpec("kimi-k2-1t-a32b", "lm", CONFIG, LM_SHAPES,
                  source="arXiv:2501.kimi2 (paper-table)"))

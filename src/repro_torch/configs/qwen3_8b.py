"""Qwen3-8B (dense).  [hf:Qwen/Qwen3-8B]
36L d_model=4096 32H (GQA kv=8, head_dim=128) d_ff=12288 vocab=151936,
per-head qk-norm."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-8b", family="dense",
    num_layers=36, d_model=4096, num_heads=32, num_kv_heads=8, head_dim=128,
    d_ff=12288, vocab_size=151936,
    qk_norm=True, rope_theta=1_000_000.0, tie_embeddings=False,
    max_seq_len=131_072,
)

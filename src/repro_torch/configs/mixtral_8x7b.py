"""Mixtral-8x7B.  [arXiv:2401.04088]
32L d_model=4096 32H (GQA kv=8, head_dim=128) vocab=32000.
MoE: 8 experts (d_ff 14336 each) top-2; sliding-window attention (4096) --
the window-bounded KV cache is why this arch runs the long_500k cell."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b", family="moe",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=32000,
    num_experts=8, num_experts_per_tok=2, moe_d_ff=14336,
    sliding_window=4096, tie_embeddings=False, max_seq_len=524_288,
)

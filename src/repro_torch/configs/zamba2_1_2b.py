"""Zamba2-1.2B (hybrid Mamba2 + shared attention).  [arXiv:2411.15242]
38 Mamba2 layers d_model=2048 (ssm_state=64) with one SHARED transformer
block (32H kv=32, d_ff=8192) applied every 6 layers (parameters reused).
O(1) SSM state + small shared-attn KV -> runs the long_500k cell."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b", family="hybrid",
    num_layers=38, d_model=2048, num_heads=32, num_kv_heads=32, head_dim=64,
    d_ff=8192, vocab_size=32000,
    ssm_state_dim=64, ssm_head_dim=64, ssm_expand=2, ssm_chunk=256,
    hybrid_attn_every=6, tie_embeddings=True, max_seq_len=524_288,
)

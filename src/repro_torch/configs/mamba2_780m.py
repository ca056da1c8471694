"""Mamba2-780m (pure SSM / SSD).  [arXiv:2405.21060; unverified]
48L d_model=1536 (attn-free) vocab=50280, ssm_state=128, expand 2
(d_inner=3072, 48 heads of dim 64).  State-space duality: chunked parallel
scan for train/prefill, O(1) recurrent state for decode -> long_500k runs."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-780m", family="ssm",
    num_layers=48, d_model=1536, num_heads=0, num_kv_heads=0,
    d_ff=0, vocab_size=50280, head_dim=64,
    ssm_state_dim=128, ssm_head_dim=64, ssm_expand=2, ssm_chunk=512,
    tie_embeddings=True, max_seq_len=524_288,
)

"""Whisper-medium.  [arXiv:2212.04356; unverified]
Enc-dec: 24+24L d_model=1024 16H (kv=16, head_dim=64) d_ff=4096 vocab=51865.
Conv audio frontend is a STUB: input_specs() provides 1500 precomputed frame
embeddings.  Plain (non-gated) GELU MLPs."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium", family="audio",
    num_layers=24, d_model=1024, num_heads=16, num_kv_heads=16, head_dim=64,
    d_ff=4096, vocab_size=51865,
    is_encoder_decoder=True, encoder_layers=24, encoder_seq=1500,
    mlp_variant="plain", activation="gelu", tie_embeddings=True,
    max_seq_len=448,
)

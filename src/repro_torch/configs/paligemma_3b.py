"""PaliGemma-3B backbone.  [arXiv:2407.07726]
18L d_model=2048 8H (MQA kv=1, head_dim=256) d_ff=16384 vocab=257216.
SigLIP vision tower is a STUB: input_specs() provides 256 precomputed patch
embeddings; prefix-LM mask is bidirectional over the image prefix."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b", family="vlm",
    num_layers=18, d_model=2048, num_heads=8, num_kv_heads=1, head_dim=256,
    d_ff=16384, vocab_size=257216,
    num_image_tokens=256, scale_embeddings=True, activation="gelu",
    tie_embeddings=True, max_seq_len=8192,
)

"""Gemma2-2B (dense).  [arXiv:2408.00118]
26L d_model=2304 8H (GQA kv=4, head_dim=256) d_ff=9216 vocab=256000.
Alternating local(4096)/global attention, attn logit softcap 50, final
logit softcap 30, sandwich norms, sqrt(d)-scaled embeddings, GeGLU."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-2b", family="dense",
    num_layers=26, d_model=2304, num_heads=8, num_kv_heads=4, head_dim=256,
    d_ff=9216, vocab_size=256000,
    sliding_window=4096, local_global_pattern=True,
    attn_logit_softcap=50.0, final_logit_softcap=30.0,
    sandwich_norm=True, scale_embeddings=True, activation="gelu",
    tie_embeddings=True, max_seq_len=8192,
)

"""Command-R v01 (35B dense).  [hf:CohereForAI/c4ai-command-r-v01; unverified]
40L d_model=8192 64H (GQA kv=8, head_dim=128) d_ff=22528 vocab=256000,
no biases, tied embeddings."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="command-r-35b", family="dense",
    num_layers=40, d_model=8192, num_heads=64, num_kv_heads=8, head_dim=128,
    d_ff=22528, vocab_size=256000,
    rope_theta=8_000_000.0, tie_embeddings=True, max_seq_len=131_072,
)

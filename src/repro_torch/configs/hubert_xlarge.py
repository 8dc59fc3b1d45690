"""HuBERT X-Large [arXiv:2106.07447].

Encoder-only audio transformer (same backbone as wav2vec2).  The
mel/conv feature extractor is a stub, as in the reference:
``repro_torch.data.inputs.input_specs`` supplies frame embeddings, and the
loss is masked-prediction cross entropy over the 504-unit (500 clusters +
specials) codebook.  No decode step exists (encoder-only).
"""
from repro_torch.configs.base import ArchConfig, register, reduce_config

FULL = ArchConfig(
    name="hubert-xlarge",
    family="audio",
    source="arXiv:2106.07447",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    d_ff=5120,
    vocab=504,
    causal=False,          # encoder-only
    norm="layernorm",
    act="gelu",
    frontend_tokens=-1,    # the whole input is frontend frames
    optimizer="adamw",
)

register(FULL, lambda: reduce_config(FULL))

"""CodeQwen1.5-7B [hf:Qwen/CodeQwen1.5-7B] — qwen1.5 arch, MHA kv=32."""
from repro_torch.configs.base import ArchConfig, register, reduce_config

FULL = ArchConfig(
    name="codeqwen1.5-7b",
    family="dense",
    source="hf:Qwen/CodeQwen1.5-7B",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    d_ff=13440,
    vocab=92_416,
    sliding_window=8192,
    optimizer="adamw",
)

register(FULL, lambda: reduce_config(FULL))

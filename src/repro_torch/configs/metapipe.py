"""The paper's own workload config: Meta-pipe incremental analysis with a
small encoder for neural-BLAST corpus embedding (``core/search.py``).

metapipe is not one of the architectures the serving launcher names
(``ARCH_IDS``), so it is not in ``PORTED`` either: import this module."""
from .base import ModelConfig

# compact encoder used to embed corpus/query sequences
ENCODER = ModelConfig(
    name="metapipe-encoder", family="dense", n_layers=4, d_model=256,
    n_heads=8, n_kv_heads=8, d_ff=1024, vocab=512, head_dim=32,
    norm="rmsnorm", tie_embeddings=True)

SMOKE = ENCODER
CONFIG = ENCODER

"""The paper's own workload config: the FaaS function-suite runtime family
(benchmarks Table 1 analogue). A mid-size dense LM whose ~51 MB state makes
restore I/O measurable against execution on this container; the 10 bench
functions (3 dependency classes) are built over it in benchmarks/common.py.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="faas-bench",
    family="dense",
    num_layers=4,
    d_model=384,
    num_heads=6,
    num_kv_heads=6,
    d_ff=1024,
    vocab_size=16384,
    tie_embeddings=True,
    dtype="float32",
)

"""Models of the port: the Llama-style decoder LM (dense, or with Switch
mixture-of-experts layers, ``moe``), its sampler, and the weight bridge
from the JAX reference."""

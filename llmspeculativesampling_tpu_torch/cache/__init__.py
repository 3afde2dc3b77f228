"""See the package docstring of ``llmspeculativesampling_tpu_torch``."""

"""Serving (counterpart of ``llmspeculativesampling_tpu/serve``)."""

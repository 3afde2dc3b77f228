"""Tokenizer singleton for cosmetic decoding
(counterpart of ``llmspeculativesampling_tpu/utils/decoder.py``).

The engines are ids-in/ids-out; the tokenizer is attached at the harness
and serving layer only, for printing tokens as text.
"""

from __future__ import annotations


class Singleton(type):
    """Metaclass: one instance a class (this package's own registry)."""

    _instances: dict = {}

    def __call__(cls, *args, **kwargs):
        if cls not in cls._instances:
            cls._instances[cls] = super().__call__(*args, **kwargs)
        return cls._instances[cls]


class Decoder(metaclass=Singleton):
    def __init__(self):
        self.tokenizer = None

    def set_tokenizer(self, tokenizer) -> None:
        self.tokenizer = tokenizer

    def encode(self, text: str, **kwargs):
        assert self.tokenizer is not None, "Decoder tokenizer not set"
        return self.tokenizer.encode(text, **kwargs)

    def decode(self, token_ids, **kwargs) -> str:
        assert self.tokenizer is not None, "Decoder tokenizer not set"
        return self.tokenizer.decode(list(token_ids), **kwargs)

from .bpe import ByteLevelBPE, bytes_to_unicode
from .tokenizer import (
    BPETokenizer,
    build_vidsitu_gpt2_tokenizer,
    make_gpt2_tokenizer,
    make_roberta_tokenizer,
)
from .train_bpe import train_byte_level_bpe
from .vocab import Vocabulary

__all__ = [
    "ByteLevelBPE",
    "BPETokenizer",
    "Vocabulary",
    "bytes_to_unicode",
    "build_vidsitu_gpt2_tokenizer",
    "make_gpt2_tokenizer",
    "make_roberta_tokenizer",
    "train_byte_level_bpe",
]

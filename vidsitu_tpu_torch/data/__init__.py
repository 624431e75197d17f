from .comm import build_comm
from .dataset import VsituDS
from .loader import DataLoader, DataWrap, get_data, get_dataloader, stack_collate
from .pad import add_prev_tokens, pad_tokens, pad_words_new

__all__ = [
    "DataLoader",
    "DataWrap",
    "VsituDS",
    "add_prev_tokens",
    "build_comm",
    "get_data",
    "get_dataloader",
    "pad_tokens",
    "pad_words_new",
    "stack_collate",
]

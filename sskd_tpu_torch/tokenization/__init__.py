from sskd_tpu_torch.tokenization.wordpiece import (
    WordPieceTokenizer,
    get_default_tokenizer,
)

__all__ = ["WordPieceTokenizer", "get_default_tokenizer"]

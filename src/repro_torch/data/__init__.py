from repro_torch.data.loader import DataConfig, make_loader
from repro_torch.data.synthetic import synthetic_corpus, zipf_token_stream
from repro_torch.data.tokenizer import ByteTokenizer

__all__ = ["DataConfig", "make_loader", "ByteTokenizer", "synthetic_corpus",
           "zipf_token_stream"]

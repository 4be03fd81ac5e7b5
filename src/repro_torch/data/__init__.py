from repro_torch.data.loader import DataConfig, make_loader
from repro_torch.data.synthetic import synthetic_corpus, zipf_token_stream

__all__ = ["DataConfig", "make_loader", "synthetic_corpus",
           "zipf_token_stream"]

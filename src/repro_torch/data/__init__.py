from repro_torch.data.pipeline import (DataConfig, MemmapDataset,
                                       make_stream, write_corpus)

__all__ = ["DataConfig", "MemmapDataset", "make_stream", "write_corpus"]

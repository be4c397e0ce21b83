"""The paper's configurations (PyTorch port of `repro.configs.relexi_hit`)."""

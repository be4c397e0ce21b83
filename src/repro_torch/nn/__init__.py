"""Functional layers of the port (counterpart of `repro.nn`)."""
from .layers import (ParamTree, dense, dense_init, embedding, embedding_init,
                     gathered_rows, layernorm, layernorm_init, lecun_normal,
                     normal_init, rmsnorm, rmsnorm_init, rows_gathered_grad)

__all__ = ["ParamTree", "dense", "dense_init", "embedding", "embedding_init",
           "gathered_rows", "layernorm", "layernorm_init", "lecun_normal",
           "normal_init", "rmsnorm", "rmsnorm_init", "rows_gathered_grad"]

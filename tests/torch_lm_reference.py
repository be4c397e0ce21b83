"""Helpers shared by the port's LM family tests (`test_torch_lm_families.py`,
`test_torch_rwkv_moe.py`): the same reduced float32 config in both
packages, the reference's parameters carried into the port, a reference
tree by the port's parameter names, and the error measure."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import configs as jconfigs
from repro.models import api as japi
from repro_torch import configs
from repro_torch.models import api, lm


def cfgs(arch: str, **kw):
    """The same reduced float32 config in both packages: the reference
    without remat, on its Pallas scan in interpret mode (the path that
    passes the explicit zero u the port passes) and its plain chunked
    attention."""
    jcfg = dataclasses.replace(jconfigs.get_reduced(arch), remat=False,
                               dtype="float32", scan_impl="kernel",
                               attn_impl="chunked", **kw)
    pcfg = dataclasses.replace(configs.get_reduced(arch), dtype="float32",
                               **kw)
    return jcfg, pcfg


def np_tree(tree):
    return jax.tree.map(lambda x: np.asarray(x.astype(jnp.float32)), tree)


def by_port_name(tree, n_groups: int) -> dict:
    """A tree in the reference's `lm.init` layout (its params or their
    gradient) as {port parameter name: numpy leaf}."""
    return {name: np.asarray(leaf)
            for name, leaf in lm.jax_param_leaves(tree, n_groups)}


def rel(got: torch.Tensor, want) -> float:
    """max |got - want| over max |want|."""
    want = np.asarray(want, dtype=np.float32)
    return float(np.max(np.abs(got.detach().float().numpy() - want))
                 / max(np.max(np.abs(want)), 1e-30))


def jbatch(batch: dict) -> dict:
    return {k: jnp.asarray(v.numpy().astype(
        np.int32 if v.dtype == torch.int64 else np.float32))
        for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def models(arch: str):
    """The reference's reduced float32 parameters, and the port's with them
    carried over (drawn once per arch and test process)."""
    jcfg, pcfg = cfgs(arch)
    jparams = japi.init(jax.random.PRNGKey(0), jcfg)
    params = api.init(pcfg, device="cpu")
    lm.load_jax_params(params, np_tree(jparams))
    return jparams, params

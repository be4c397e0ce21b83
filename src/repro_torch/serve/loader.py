"""Restore a trained multitask policy from a fleet checkpoint, params only
(PyTorch port of `repro.serve.loader`).

`FleetRunner` checkpoints its whole durability tree `{"params", "opt",
"broker"}` (`core/checkpoints.py` layout: one .npy per leaf and a manifest
of key paths).  Serving needs none of the optimizer moments or broker
rings, so the loader reads the manifest, selects exactly the
`['params'][...]` leaves (`checkpoints.restore_arrays`; the other leaves
are never read), and rebuilds the policy against a template made from the
checkpoint's own metadata:

  * scenario names come from `meta["scenarios"]`, each resolved through the
    env registry so the serving `MultiTaskConfig` carries the same
    `HeadSpec`s training used;
  * the trunk's width and depth come from `meta["d_embed"]` and
    `meta["n_shared_layers"]`, checked against what the arrays imply (the
    layer count from the `['params']['params.shared.actor.{i}.w']` keys,
    the width from their shapes), and inferred from the arrays where the
    meta lacks them;
  * every selected leaf is checked (name, shape, dtype) against
    `MultiTaskPolicy(mcfg).named_parameters()` before it is loaded, so a
    config/checkpoint mismatch raises instead of serving garbage.

The port's checkpoint keys are `named_parameters()` names
(`['params']['params.shared.actor.0.w']`), where the reference nests
(`['params']['shared']['actor'][0]['w']`).  The training mesh does not
constrain the serving one: `mesh=` places the restored tree replicated on
any mesh (`core/elastic.reshard`, rank 0's copy broadcast), so a policy
trained over two ranks serves from one and vice versa.
"""
from __future__ import annotations

import dataclasses
import re

import torch

from .. import resolve_device
from ..core import checkpoints, elastic
from ..fleet import multitask

_PARAMS_PREFIX = "['params']['params."
_ACTOR_LAYER_RE = re.compile(
    r"^\['params'\]\['params\.shared\.actor\.(\d+)\.w'\]$")


@dataclasses.dataclass(frozen=True)
class LoadedPolicy:
    """A restored, serve-ready policy: the parameter tree (an `nn.ParamTree`
    on the serving device, no gradients), the static config that routes
    scenario names to heads, and the checkpoint's provenance."""

    params: torch.nn.Module
    mcfg: multitask.MultiTaskConfig
    step: int
    meta: dict

    @property
    def scenarios(self) -> tuple[str, ...]:
        return self.mcfg.names


def _infer_trunk_shape(manifest: dict) -> tuple[int, int]:
    """(d_embed, n_shared_layers) read off the manifest's actor-trunk keys."""
    layers: dict[int, list[int]] = {}
    for key, shape in zip(manifest["keys"], manifest["shapes"]):
        m = _ACTOR_LAYER_RE.match(key)
        if m:
            layers[int(m.group(1))] = shape
    if not layers:
        raise checkpoints.IntegrityError(
            "checkpoint has no ['params']['params.shared.actor.*'] leaves: "
            "not a fleet (multitask) checkpoint")
    return int(layers[0][-1]), int(max(layers) + 1)


def _mcfg_from_manifest(manifest: dict, env_overrides: dict | None
                        ) -> multitask.MultiTaskConfig:
    from .. import envs

    meta = manifest.get("meta", {})
    names = meta.get("scenarios")
    if not names:
        raise checkpoints.IntegrityError(
            "checkpoint meta carries no 'scenarios' list: cannot rebuild "
            "the multitask heads (was this written by FleetRunner?)")
    d_embed, n_layers = _infer_trunk_shape(manifest)
    for field, inferred in (("d_embed", d_embed),
                            ("n_shared_layers", n_layers)):
        declared = meta.get(field)
        if declared is not None and int(declared) != inferred:
            raise checkpoints.IntegrityError(
                f"checkpoint meta declares {field}={declared} but the stored "
                f"arrays imply {inferred}")
    overrides = env_overrides or {}
    named = [(n, envs.make(n, **overrides.get(n, {}))) for n in names]
    return multitask.MultiTaskConfig.from_envs(
        named, d_embed=d_embed, n_shared_layers=n_layers)


def load_policy(checkpoint_dir: str, step: int | None = None, *,
                device: str | torch.device | None = None, mesh=None,
                verify: bool = True,
                env_overrides: dict[str, dict] | None = None
                ) -> LoadedPolicy:
    """Restore the newest (or a specific) fleet checkpoint for serving, on
    `device` (None: the GPU; without one this raises unless device="cpu"
    is asked for), replicated on `mesh` when one is given.
    `env_overrides` maps scenario name -> registry keyword overrides, for
    serving a head against a re-parameterized env (the specs must stay
    identical)."""
    device = resolve_device(device)
    if step is None:
        step = checkpoints.latest_step(checkpoint_dir)
        if step is None:
            raise FileNotFoundError(
                f"no complete checkpoint under {checkpoint_dir!r}")
    arrays, manifest = checkpoints.restore_arrays(
        checkpoint_dir, step, verify=verify,
        select=lambda key: key.startswith(_PARAMS_PREFIX))
    mcfg = _mcfg_from_manifest(manifest, env_overrides)

    stored = {key[len(_PARAMS_PREFIX):-2]: a
              for key, a in zip(manifest["keys"], arrays)
              if key.startswith(_PARAMS_PREFIX)}
    params = multitask.MultiTaskPolicy(mcfg).params.requires_grad_(False)
    template = dict(params.named_parameters())
    if set(template) != set(stored):
        raise checkpoints.IntegrityError(
            f"policy template has {len(template)} leaves, checkpoint stores "
            f"{len(stored)} under ['params']; differing: "
            f"{sorted(set(template) ^ set(stored))[:5]}")
    with torch.no_grad():
        for name, want in template.items():
            got = torch.from_numpy(stored[name])
            if got.shape != want.shape or got.dtype != want.dtype:
                raise checkpoints.IntegrityError(
                    f"params leaf {name}: checkpoint {tuple(got.shape)}/"
                    f"{got.dtype} != template {tuple(want.shape)}/"
                    f"{want.dtype}")
            want.copy_(got)
    params = elastic.reshard(params.to(device), mesh)
    return LoadedPolicy(params=params, mcfg=mcfg, step=int(step),
                        meta=dict(manifest.get("meta", {})))

"""Parameter carry-over between the JAX package's flax trees and the port.

The flax tree of ``GSSupervised`` (and the ``.npz`` checkpoint's ``/``-joined
keys, ``tpu_sage/train/checkpoint.py``) holds, by aggregator and prep::

    params/agg_layers_{i}/fc_self/{kernel,bias}     mean, attention: no bias
    params/agg_layers_{i}/fc_neigh/{kernel,bias}    (pools, lstm: biased)
    params/agg_layers_{i}/fc/{kernel,bias}          gcn (its only branch)
    params/agg_layers_{i}/mlp/{kernel,bias}         max_pool, mean_pool
    params/agg_layers_{i}/att_q/kernel              attention
    params/agg_layers_{i}/att_k/kernel
    params/agg_layers_{i}/lstm/xz/kernel            lstm, (in, 4H)
    params/agg_layers_{i}/lstm/cell/hz/{kernel,bias}     (H, 4H)
    params/prep/fc/kernel                           linear prep
    params/prep/embedding/embedding                 node_embedding, (n_nodes, dim)
    params/fc/kernel, params/fc/bias                the head

The port's modules carry the same names and its ``Dense`` the same
``(in, out)`` layout, so each tensor maps one to one through ``flax_key``.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np
import torch


def flax_key(torch_name: str) -> str:
    """``agg_layers.0.fc_self.kernel`` → ``params/agg_layers_0/fc_self/kernel``."""
    return "params/" + re.sub(r"agg_layers\.(\d+)\.", r"agg_layers_\1.", torch_name).replace(".", "/")


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    flat = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            flat.update(_flatten(v, key))
        else:
            flat[key] = v
    return flat


def load_flax_params(model: torch.nn.Module, tree: Mapping[str, Any]) -> torch.nn.Module:
    """Copy a flax parameter tree into ``model`` in place and return it.

    ``tree`` is a nested mapping of numpy arrays (the flax variables dict,
    ``{"params": {...}}``) or a flat mapping with ``/``-joined keys, such as
    an ``.npz`` checkpoint, whose keys may carry a leading prefix
    (``params/params/...`` in a saved TrainState). Every model parameter must
    be found exactly once, with its shape."""
    flat = _flatten(tree)
    with torch.no_grad():
        for name, p in model.named_parameters():
            want = flax_key(name)
            hits = [k for k in flat if k == want or k.endswith("/" + want)]
            if len(hits) != 1:
                raise KeyError(f"{want}: expected one match in the tree, found {hits}")
            value = torch.from_numpy(np.array(flat[hits[0]], dtype=np.float32))
            if tuple(value.shape) != tuple(p.shape):
                raise ValueError(f"{want}: shape {tuple(value.shape)}, model has {tuple(p.shape)}")
            p.copy_(value)
    return model


def flax_params(model: torch.nn.Module) -> Dict[str, Any]:
    """The model's parameters as a nested flax-layout tree of numpy arrays."""
    tree: Dict[str, Any] = {}
    for name, p in model.named_parameters():
        node = tree
        *path, leaf = flax_key(name).split("/")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = p.detach().float().cpu().numpy()
    return tree

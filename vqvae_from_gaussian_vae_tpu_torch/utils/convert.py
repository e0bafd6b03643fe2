"""Carry JAX-package weights into the port.

``state_dict_from_jax(params)`` maps the JAX engine's parameter tree (nested
dicts of arrays) onto the port's ``pit``-named state_dict:

  * path ``encoder / down_0 / block_1 / conv1 / kernel`` ->
    key ``encoder.down.0.block.1.conv1.weight``: a ``<list>_<i>`` segment
    is list element i, except the mid block's own ``block_1`` / ``block_2``
  * conv kernel HWIO (kh, kw, I, O) -> OIHW (O, I, kh, kw)
  * GroupNorm ``scale`` -> ``weight``
  * latent statistics (1, 1, 1, C) -> the reference's (1, C, 1, 1)

The reverse direction needs no code here: the JAX package's
``utils/torch_convert.py:convert_state_dict`` loads a port state_dict.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np
import torch

_LIST_SEGMENT = re.compile(r"^(down|up|block|attn)_(\d+)$")


def _key(path) -> str:
    out = []
    for i, seg in enumerate(path[:-1]):
        m = _LIST_SEGMENT.match(seg)
        parent = path[i - 1] if i else ""
        if m and not (parent == "mid" and m.group(1) == "block"):
            out += [m.group(1), m.group(2)]
        else:
            out.append(seg)
    leaf = path[-1]
    out.append({"kernel": "weight", "scale": "weight"}.get(leaf, leaf))
    return ".".join(out)


def _flatten(tree: Mapping[str, Any], prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def state_dict_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX engine param tree (nested mappings of numpy or array leaves) ->
    port state_dict."""
    sd = {}
    for path, value in _flatten(params):
        v = np.asarray(value, dtype=np.float32)
        if path[-1] in ("latent_mean", "latent_std"):
            v = v.transpose(0, 3, 1, 2)
        elif v.ndim == 4:
            v = v.transpose(3, 2, 0, 1)
        sd[_key(path)] = torch.tensor(v)  # a copy: the source may be read-only
    return sd

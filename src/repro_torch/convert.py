"""Hand the reference's numpy parameter and input dicts to the port.

``repro.gnn.models.init_params`` / ``init_inputs`` (and their copies in
:mod:`repro_torch.gnn.models`) make float32 numpy arrays from a seed; these
helpers turn them into float32 tensors on the device, checked against the
shapes the trace declares, so both packages run on identical weights.
:func:`lm_params_from_reference` does the same for an LM's parameter tree
(the reference's ``materialize`` output, as numpy), checked against the
port's ``model_template``.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Union

import numpy as np
import torch

from .device import resolve

Device = Optional[Union[str, torch.device]]


def to_device(arr, device: torch.device) -> torch.Tensor:
    """``arr`` (numpy or tensor) as a float32 tensor on ``device``."""
    return torch.as_tensor(arr, dtype=torch.float32, device=device)


def params_from_reference(np_params: Mapping, device: Device = None,
                          trace=None) -> Dict[str, torch.Tensor]:
    """Parameter dict -> float32 tensors on ``device`` (``cuda`` unless
    named).  With ``trace``, names and shapes must match ``trace.params``."""
    dev = resolve(device)
    if trace is not None:
        if set(np_params) != set(trace.params):
            raise ValueError(f"params {sorted(np_params)} do not match the "
                             f"trace's {sorted(trace.params)}")
        for name, shape in trace.params.items():
            if tuple(np.shape(np_params[name])) != tuple(shape):
                raise ValueError(f"param {name!r} has shape "
                                 f"{tuple(np.shape(np_params[name]))}, the "
                                 f"trace declares {tuple(shape)}")
    return {k: to_device(v, dev) for k, v in np_params.items()}


def inputs_from_reference(np_inputs: Mapping, device: Device = None,
                          trace=None) -> Dict[str, torch.Tensor]:
    """Input dict -> float32 tensors on ``device`` (``cuda`` unless named).
    With ``trace``, every declared input must be present as a (rows, dim)
    array of the declared width."""
    dev = resolve(device)
    if trace is not None:
        for n in trace.nodes:
            if n.op != "input":
                continue
            name = n.attrs["name"]
            if name not in np_inputs:
                raise ValueError(f"input {name!r} is missing")
            shape = tuple(np.shape(np_inputs[name]))
            if len(shape) != 2 or shape[1] != n.dim:
                raise ValueError(f"input {name!r} has shape {shape}, the "
                                 f"trace declares (rows, {n.dim})")
    return {k: to_device(v, dev) for k, v in np_inputs.items()}


def lm_params_from_reference(np_tree: Mapping, cfg, device: Device = None) -> Dict:
    """An LM parameter tree (nested dicts of arrays, as the reference's
    ``materialize(key, lm.model_template(cfg))`` makes it, converted to
    numpy) -> the same tree of tensors on ``device`` (``cuda`` unless
    named), each in its template's dtype unless the array is float32 (the
    reference's ``dtype_override="float32"``).  Names and shapes must match
    :func:`repro_torch.models.lm.model_template`."""
    from .models.common import ParamLeaf, torch_dtype, tree_items
    from .models.lm import model_template

    dev = resolve(device)
    tmpl = dict(tree_items(model_template(cfg)))
    got = dict(tree_items(dict(np_tree)))
    if set(got) != set(tmpl):
        missing = sorted(".".join(p) for p in set(tmpl) - set(got))
        extra = sorted(".".join(p) for p in set(got) - set(tmpl))
        raise ValueError(f"parameter names differ from model_template({cfg.name}): "
                         f"missing {missing}, unexpected {extra}")
    out: Dict = {}
    for path, arr in got.items():
        l: ParamLeaf = tmpl[path]
        if tuple(np.shape(arr)) != l.shape:
            raise ValueError(f"param {'.'.join(path)!r} has shape "
                             f"{tuple(np.shape(arr))}, the template declares {l.shape}")
        arr = np.asarray(arr)
        dt = torch.float32 if arr.dtype == np.float32 else torch_dtype(l.dtype)
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = torch.as_tensor(arr.astype(np.float32)).to(device=dev, dtype=dt)
    return out

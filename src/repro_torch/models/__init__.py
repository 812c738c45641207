"""The LM stack (``repro.models``), every family of the ten configs
(dense, MoE, SSD, RG-LRU hybrid, encoder-decoder, VLM stub): parameters
as nested dicts in the reference's layout, the training loss, and the
carrier between the two packages' parameter trees."""
from .convert import (flatten_params, params_from_reference,
                      params_to_reference, unflatten_params)
from .model import decode_fn, loss_fn, prefill_fn
from .transformer import ParamSpec, init_params, param_specs
from .tree import param_leaves

__all__ = [
    "decode_fn", "loss_fn", "prefill_fn", "ParamSpec", "init_params",
    "param_specs", "flatten_params", "param_leaves", "params_from_reference",
    "params_to_reference", "unflatten_params",
]

# The model stack on PyTorch: the dense and MoE transformers behind one
# ModelApi (prefill + decode_step is all serve needs); the other families
# are not ported yet. `convert` carries the reference's parameters across.
from .common import ArchConfig, ParamDef, init_params
from .registry import ModelApi, get_model
from .convert import params_from_numpy, params_to_numpy, tensor_bytes

__all__ = ["ArchConfig", "ParamDef", "init_params", "ModelApi", "get_model",
           "params_from_numpy", "params_to_numpy", "tensor_bytes"]

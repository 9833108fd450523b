# The model stack on PyTorch: every family of the reference behind one
# ModelApi (prefill + decode_step is all serve needs): the dense, MoE and
# vlm transformers, whisper's encoder-decoder, RecurrentGemma's RG-LRU
# hybrid and xLSTM. `convert` carries the reference's parameters across.
from .common import ArchConfig, ParamDef, init_params
from .registry import ModelApi, get_model
from .convert import params_from_numpy, params_to_numpy, tensor_bytes
from . import rglru, whisper, xlstm

__all__ = ["ArchConfig", "ParamDef", "init_params", "ModelApi", "get_model",
           "params_from_numpy", "params_to_numpy", "tensor_bytes",
           "rglru", "whisper", "xlstm"]

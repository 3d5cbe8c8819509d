from .device import BackendType, BuildFlag, Device, backend_init
from .errors import VispError, get_last_error, raise_error, set_last_error
from .gguf import GGMLType, GGUFFile, GGUFWriter, model_load
from .params import Params
from .weights import load_weights, params_from_numpy

__all__ = [
    "BackendType",
    "BuildFlag",
    "Device",
    "backend_init",
    "VispError",
    "get_last_error",
    "raise_error",
    "set_last_error",
    "GGMLType",
    "GGUFFile",
    "GGUFWriter",
    "model_load",
    "Params",
    "load_weights",
    "params_from_numpy",
]

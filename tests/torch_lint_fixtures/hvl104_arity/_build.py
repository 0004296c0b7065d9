"""HVL104 trigger fixture (a wrong arity): the Python side of a kernel ABI."""

import ctypes

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
SOURCES = {"kern": "kern.cu"}
SIGNATURES = {
    "hvd_kern": ("kern", [_I, _I, _P, _P, _F, _P]),  # n missing
    "hvd_kern_info": ("kern", [_I, _I, _P]),
}

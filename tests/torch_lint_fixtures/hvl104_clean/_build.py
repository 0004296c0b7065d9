"""HVL104 clean fixture: the Python side of a kernel ABI."""

import ctypes

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
SOURCES = {"kern": "kern.cu"}
SIGNATURES = {
    "hvd_kern": ("kern", [_I, _I, _P, _P, _I, _F, _P]),
    "hvd_kern_info": ("kern", [_I, _I, _P]),
}

"""HVL104 clean fixture: the dtype codes and widths of the dispatch."""

import torch

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KERNEL_HEAD_DIMS = (64, 128)
_KERNEL_WIDE = 0

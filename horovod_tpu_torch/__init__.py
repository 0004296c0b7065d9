"""horovod_tpu_torch: the PyTorch + CUDA port of horovod_tpu.

The JAX package ``horovod_tpu`` is the reference; this package mirrors its
layout and never imports it (nor JAX). Entry points run on the CUDA device
unless the caller passes ``device="cpu"``.
"""

from horovod_tpu_torch.common.basics import (cross_rank, cross_size, device,
                                             init, is_initialized,
                                             local_rank, local_size, rank,
                                             shutdown, size)
from horovod_tpu_torch.common.reduce_ops import (Adasum, Average, Max, Min,
                                                 Op, Product, Sum)
from horovod_tpu_torch.compression import Compression

__all__ = ["init", "shutdown", "is_initialized", "rank", "size",
           "local_rank", "local_size", "cross_rank", "cross_size", "device",
           "Op", "Average", "Sum", "Min", "Max", "Product", "Adasum",
           "Compression"]

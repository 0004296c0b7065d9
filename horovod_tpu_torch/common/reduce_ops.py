"""Reduction-op constants of the PyTorch port.

Counterpart of ``horovod_tpu/common/reduce_ops.py`` (the ``Op`` enum), kept
as the port's own copy so the port never imports the JAX package.
"""

from __future__ import annotations

import enum


class Op(enum.Enum):
    """Reduction ops (reference: horovod/common/common.h ReduceOp)."""

    AVERAGE = "average"
    SUM = "sum"
    ADASUM = "adasum"
    MIN = "min"
    MAX = "max"
    PRODUCT = "product"


Average = Op.AVERAGE
Sum = Op.SUM
Adasum = Op.ADASUM
Min = Op.MIN
Max = Op.MAX
Product = Op.PRODUCT

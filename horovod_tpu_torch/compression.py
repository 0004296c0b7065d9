"""Gradient wire compression.

Counterpart of ``horovod_tpu/jax/compression.py:49-102`` (none, fp16, bf16):
the wire format is the dtype the allreduce runs in, so a 16-bit cast halves
the bytes NCCL moves. The int8 block compressor is a later slice.
"""

from __future__ import annotations

import torch


class Compressor:
    """Interface: ``compress(t) -> (t', ctx)``, ``decompress(t', ctx)``."""

    @staticmethod
    def compress(tensor):
        raise NotImplementedError

    @staticmethod
    def decompress(tensor, ctx):
        raise NotImplementedError


class NoneCompressor(Compressor):
    """Pass-through."""

    @staticmethod
    def compress(tensor):
        return tensor, None

    @staticmethod
    def decompress(tensor, ctx):
        return tensor


class _CastCompressor(Compressor):
    wire_dtype: torch.dtype

    @classmethod
    def compress(cls, tensor):
        ctx = tensor.dtype
        if tensor.is_floating_point():
            tensor = tensor.to(cls.wire_dtype)
        return tensor, ctx

    @staticmethod
    def decompress(tensor, ctx):
        return tensor.to(ctx) if ctx.is_floating_point else tensor


class FP16Compressor(_CastCompressor):
    """Floating tensors travel as float16."""

    wire_dtype = torch.float16


class BF16Compressor(_CastCompressor):
    """Floating tensors travel as bfloat16."""

    wire_dtype = torch.bfloat16


class Compression:
    """Namespace of the available compressors."""

    none = NoneCompressor
    fp16 = FP16Compressor
    bf16 = BF16Compressor

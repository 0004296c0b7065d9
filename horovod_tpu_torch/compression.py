"""Gradient wire compression.

Counterpart of ``horovod_tpu/jax/compression.py`` (none, fp16, bf16, int8):
for the cast compressors the wire format is the dtype the allreduce runs
in, so a 16-bit cast halves the bytes NCCL moves. ``int8`` goes further:
symmetric int8 payloads with one fp32 scale per ``block_size`` elements,
about a quarter of the fp32 bytes. int8 values of different replicas carry
different scales and cannot be summed by an allreduce, so the step routes
a compressor with ``quantized = True`` through the quantized collectives of
``parallel/collectives.py``. The quantizer is plain torch ops, as the
reference's is jnp code (no Pallas kernel).
"""

from __future__ import annotations

import torch


def block_quantize_rows(rows: torch.Tensor, block_size: int):
    """Symmetric per-block int8 quantization of a ``[rows, cols]`` float
    tensor (``cols`` divisible by ``block_size``; reference
    compression.py:24-38). Returns ``(payload int8 [rows, cols], scales
    fp32 [rows, cols / block_size])`` with ``payload * scale`` about
    ``rows``; each element is within ``scale / 2 = max|block| / 254``.
    All-zero blocks get scale 0 and round-trip exactly. The same fp32
    division and round-half-to-even as the reference give the same bits."""
    r, c = rows.shape
    blocks = rows.float().reshape(r, c // block_size, block_size)
    scale = blocks.abs().amax(-1) / 127.0
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(blocks / safe[..., None]), -127, 127)
    return q.to(torch.int8).reshape(r, c), scale


def block_dequantize_rows(payload: torch.Tensor, scales: torch.Tensor,
                          block_size: int) -> torch.Tensor:
    """Inverse of :func:`block_quantize_rows`; fp32 ``[rows, cols]``."""
    r, c = payload.shape
    blocks = payload.float().reshape(r, c // block_size, block_size)
    return (blocks * scales[..., None]).reshape(r, c)


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


class Int8Compressor(Compressor):
    """Per-block int8 wire format (reference compression.py:105-139).
    ``quantized = True`` tells the train step to reduce through the
    quantized collectives; ``compress``/``decompress`` are the local round
    trip (a ``[1, padded]`` payload and its scales)."""

    quantized = True
    block_size = 256

    @classmethod
    def compress(cls, tensor):
        ctx = (tensor.dtype, tensor.shape)
        if not tensor.is_floating_point():
            return tensor, (ctx, None)
        flat = tensor.reshape(1, -1)
        pad = (-flat.shape[1]) % cls.block_size
        if pad:
            flat = torch.cat([flat, flat.new_zeros(1, pad)], dim=1)
        payload, scales = block_quantize_rows(flat, cls.block_size)
        return payload, (ctx, scales)

    @classmethod
    def decompress(cls, tensor, ctx):
        (dtype, shape), scales = ctx
        if scales is None:
            return tensor
        rows = block_dequantize_rows(tensor, scales, cls.block_size)
        return rows.reshape(-1)[:shape.numel()].reshape(shape).to(dtype)


class Compression:
    """Namespace of the available compressors."""

    none = NoneCompressor
    fp16 = FP16Compressor
    bf16 = BF16Compressor
    int8 = Int8Compressor

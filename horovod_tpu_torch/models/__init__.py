"""Models of the port: the GPT family and its transformer blocks."""

from horovod_tpu_torch.models.gpt import GptDecoder, GptMedium, GptSmall

__all__ = ["GptDecoder", "GptSmall", "GptMedium"]

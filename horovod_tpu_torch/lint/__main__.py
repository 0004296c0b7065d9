"""``python -m horovod_tpu_torch.lint`` — see
horovod_tpu_torch/lint/cli.py."""

from horovod_tpu_torch.lint.cli import main

if __name__ == "__main__":
    raise SystemExit(main())

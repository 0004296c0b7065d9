"""``python -m horovod_tpu_torch.verify`` — see
horovod_tpu_torch/verify/cli.py."""

from horovod_tpu_torch.verify.cli import main

if __name__ == "__main__":
    raise SystemExit(main())

"""Request tracing of the serving plane (counterpart of
``horovod_tpu/obs``, its ``tracing`` module only)."""

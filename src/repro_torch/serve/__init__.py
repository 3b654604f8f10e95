from repro_torch.serve.scheduler import BatchScheduler, Request  # noqa: F401

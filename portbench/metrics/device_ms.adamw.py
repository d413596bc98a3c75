"""Device ms a train step spends in the optimizer: the program's
``repro_torch.train_step.optimizer`` span (AdamW over every leaf)."""
from portbench import spanread


def read(ctx):
    return spanread.device_ms(ctx, {"repro_torch.train_step.optimizer"})

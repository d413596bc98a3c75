"""Device ms a train step spends inside the program's ``repro_torch.dot_f32``
spans: forward, remat's recompute and backward, each stretch of the step's
device timeline counted once."""
from portbench import spanread


def read(ctx):
    return spanread.device_ms(ctx, {"repro_torch.dot_f32"})

"""Device ms a train step spends in the Mamba2 mixers: the program's
``repro_torch.mamba`` spans (in_proj, the convolution, the SSD, the gated
norm and out_proj), forward, remat's recompute and backward, each stretch
of the step's device timeline counted once."""
from portbench import spanread


def read(ctx):
    return spanread.device_ms(ctx, {"repro_torch.mamba"})

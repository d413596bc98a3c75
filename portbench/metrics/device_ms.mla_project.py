"""Device ms a train step spends projecting latent attention's inputs: the
program's ``repro_torch.mla.project`` spans (the normed x to q, k and v
ready for the attention: the four products, the latent's norm, RoPE and
the concatenations), forward, remat's recompute and backward, each stretch
of the step's device timeline counted once."""
from portbench import spanread


def read(ctx):
    return spanread.device_ms(ctx, {"repro_torch.mla.project"})

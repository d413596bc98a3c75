"""Device ms a train step spends routing tokens to the experts and back:
the program's ``repro_torch.moe.route``, ``.dispatch`` and ``.combine``
spans (the experts' own products excluded), forward, remat's recompute and
backward."""
from portbench import spanread

NAMES = {"repro_torch.moe.route", "repro_torch.moe.dispatch", "repro_torch.moe.combine"}


def read(ctx):
    return spanread.device_ms(ctx, NAMES)
